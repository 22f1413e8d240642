"""Open-loop arrival sampling: seeded Poisson process + heavy-tail sizes.

The schedule is generated up front from one `random.Random(seed)` so a
soak is reproducible bit-for-bit: same seed, same rate, same duration ->
the identical (t_sched, size) sequence, independent of how fast the
cluster absorbs it. Open-loop discipline lives in the generator (the
next arrival is never gated on an in-flight response); this module only
decides WHEN requests arrive and HOW BIG they are.

Size mix: a bounded-Pareto tail over a fixed base, the classic
heavy-tail request mix (most requests small, a seeded minority 10-100x
larger) that makes queue collapse visible — a uniform mix lets the
p99 hide behind the mean.
"""

from __future__ import annotations

import random
from typing import List, NamedTuple


class Arrival(NamedTuple):
    t_s: float   # scheduled arrival offset from run start, seconds
    size: int    # request payload size, bytes


class SizeMix(NamedTuple):
    """Heavy-tail request-size distribution (bounded Pareto tail)."""
    base: int = 1024        # typical request size, bytes
    heavy_frac: float = 0.1  # fraction of requests drawn from the tail
    alpha: float = 1.3       # Pareto shape (smaller -> heavier tail)
    cap: int = 1 << 18       # tail cut-off, bytes (bounds memory)
    jitter: float = 0.25     # +/- relative jitter on base sizes

    def sample(self, rng: random.Random) -> int:
        if rng.random() < self.heavy_frac:
            # Bounded Pareto via inverse CDF on U(0,1]; the cap keeps a
            # pathological draw from OOMing the store mid-soak.
            u = max(rng.random(), 1e-12)
            size = self.base * u ** (-1.0 / self.alpha)
            return int(min(size, self.cap))
        spread = 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(1, int(self.base * spread))


def generate_schedule(rate_hz: float, duration_s: float, seed: int,
                      mix: SizeMix = SizeMix()) -> List[Arrival]:
    """Poisson arrivals at `rate_hz` for `duration_s`: exponential
    inter-arrival gaps, each arrival stamped with a heavy-tail size.
    Deterministic in `seed`."""
    if rate_hz <= 0:
        return []
    rng = random.Random(seed)
    out: List[Arrival] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate_hz)
        if t >= duration_s:
            return out
        out.append(Arrival(t, mix.sample(rng)))
