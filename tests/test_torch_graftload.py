"""The port's soak harness (``ray_tpu_torch.load``): the cases of
``tests/test_graftload.py`` with the same inputs and assertions on the
port's runtime — the arrival sampler (seeded determinism, rate, the
bounded-Pareto tail), the open-loop invariant, the Chrome-trace
exporter, the smoke soak end to end (the full profile stays ``slow``, as
in the reference) — and the port's schedules against the JAX package's,
arrival for arrival.
"""

import io
import json
import math
import random
import threading
import time

import pytest

from ray_tpu_torch.load.arrivals import SizeMix, generate_schedule
from ray_tpu_torch.load.generator import OpenLoopRunner, summarize


# ---------------------------------------------------------------------------
# arrival sampler: determinism, rate, heavy tail
# ---------------------------------------------------------------------------

def test_schedule_deterministic_in_seed():
    a = generate_schedule(50.0, 5.0, seed=7)
    b = generate_schedule(50.0, 5.0, seed=7)
    c = generate_schedule(50.0, 5.0, seed=8)
    assert a == b                      # bit-for-bit reproducible
    assert a != c                      # and the seed actually matters
    assert len(a) > 0


def test_schedule_rate_duration_and_ordering():
    sched = generate_schedule(50.0, 10.0, seed=1)
    # Poisson(rate * duration) = Poisson(500): +/-30% is ~7 sigma.
    assert 350 <= len(sched) <= 650, len(sched)
    ts = [a.t_s for a in sched]
    assert ts == sorted(ts)
    assert all(0.0 <= t < 10.0 for t in ts)
    assert all(a.size >= 1 for a in sched)
    assert generate_schedule(0.0, 10.0, seed=1) == []


def test_size_mix_bounded_pareto_tail():
    mix = SizeMix(base=1024, heavy_frac=0.2, alpha=1.1, cap=1 << 14)
    rng = random.Random(42)
    sizes = [mix.sample(rng) for _ in range(4000)]
    assert all(1 <= s <= mix.cap for s in sizes)
    # The tail is real: a seeded minority lands far above base...
    assert sum(1 for s in sizes if s > 4 * mix.base) > 50
    # ...and the cap bites (P[draw > cap] ~ 1% of the heavy draws).
    assert max(sizes) == mix.cap
    # heavy_frac=0 collapses to jittered base sizes only.
    flat = SizeMix(base=1024, heavy_frac=0.0, jitter=0.25)
    rng = random.Random(42)
    assert all(768 <= flat.sample(rng) <= 1280 for _ in range(1000))


def test_schedules_match_the_jax_package():
    """The port draws the reference's arrivals, arrival for arrival: the
    same seed and rate give the same times and sizes, for every
    workload of every soak profile and for the mixes above."""
    from ray_tpu.load import arrivals as ref_arrivals
    from ray_tpu.load import scenario as ref_scenario
    from ray_tpu_torch.load import scenario

    cases = [(50.0, 5.0, 7, {}), (20.0, 1.0, 3, dict(heavy_frac=0.0)),
             (8.0, 30.0, 11, dict(base=1024, heavy_frac=0.2, alpha=1.1,
                                  cap=1 << 14))]
    for name in ("smoke", "bench", "full"):
        spec = scenario.profile(name)
        ref = ref_scenario.profile(name)
        assert spec.seed == ref.seed and spec.duration_s == ref.duration_s
        for i, (w, rw) in enumerate(zip(spec.workloads, ref.workloads,
                                        strict=True)):
            assert (w.kind, w.rate_hz) == (rw.kind, rw.rate_hz)
            cases.append((w.rate_hz, spec.duration_s,
                          spec.seed + 1000 * i, w.mix._asdict()))
    for rate, duration, seed, mix in cases:
        got = generate_schedule(rate, duration, seed, SizeMix(**mix))
        want = ref_arrivals.generate_schedule(
            rate, duration, seed, ref_arrivals.SizeMix(**mix))
        assert len(got) > 0
        assert [tuple(a) for a in got] == [tuple(a) for a in want]
    rng, ref_rng = random.Random(42), random.Random(42)
    mix = SizeMix(base=1024, heavy_frac=0.2, alpha=1.1, cap=1 << 14)
    ref_mix = ref_arrivals.SizeMix(**mix._asdict())
    assert [mix.sample(rng) for _ in range(4000)] == \
        [ref_mix.sample(ref_rng) for _ in range(4000)]


# ---------------------------------------------------------------------------
# the open-loop invariant
# ---------------------------------------------------------------------------

class _SlowWorkload:
    """Responses take 0.4s; submission must not care."""

    name = "slow"

    def __init__(self):
        self.submitted = []
        self._lock = threading.Lock()

    def submit(self, size):
        with self._lock:
            self.submitted.append(time.monotonic())
        return size

    def wait(self, handle, timeout):
        time.sleep(0.4)  # artificially slowed response


def test_open_loop_arrivals_never_gated_on_responses():
    """20 arrivals/s against 0.4s responses and 2 waiters: a closed
    loop would throttle to 5/s and stall submissions by seconds; the
    open-loop submitter must stay on schedule regardless."""
    sched = generate_schedule(20.0, 1.0, seed=3,
                              mix=SizeMix(heavy_frac=0.0))
    assert len(sched) >= 10
    wl = _SlowWorkload()
    runner = OpenLoopRunner(wl, sched, timeout_s=10.0, waiters=2)
    runner.start(time.monotonic())
    assert runner.join(30.0), "runner never drained"
    slips = [r.t_submit - r.t_sched for r in runner.requests]
    assert all(not math.isnan(s) for s in slips)
    assert max(slips) < 0.25, f"submitter was gated: max slip {slips}"
    # Latency is measured from the SCHEDULED arrival, so queueing at
    # the waiter pool is visible: the drain tail must show it growing.
    assert all(r.ok for r in runner.requests)
    s = summarize("slow", runner.requests, 1.0)
    assert s["completed"] == len(sched)
    assert s["p99_ms"] > 400.0  # queue delay surfaced, not hidden


# ---------------------------------------------------------------------------
# Chrome trace exporter (graftscope timeline -> Perfetto)
# ---------------------------------------------------------------------------

def test_to_chrome_trace_shape():
    from ray_tpu_torch.state import to_chrome_trace
    events = [
        {"name": "taskA", "ph": "X", "ts": 100.0, "dur": 50.0,
         "pid": "node-aaa", "tid": "worker-1", "args": {"k": 1}},
        {"name": "spanB", "ph": "X", "ts": 120.0, "dur": 5.0,
         "pid": "node-bbb", "tid": "native"},
    ]
    doc = to_chrome_trace(events)
    assert set(doc) >= {"traceEvents", "displayTimeUnit"}
    rows = doc["traceEvents"]
    meta = [e for e in rows if e["ph"] == "M"]
    data = [e for e in rows if e["ph"] != "M"]
    # Chrome/Perfetto require integer pid/tid; names move to metadata.
    assert all(isinstance(e["pid"], int) for e in rows)
    assert all(isinstance(e["tid"], int) for e in rows)
    assert {m["name"] for m in meta} == {"process_name", "thread_name"}
    assert {m["args"]["name"] for m in meta
            if m["name"] == "process_name"} == {"node-aaa", "node-bbb"}
    # Distinct string pids map to distinct ints; the doc stays JSON.
    assert data[0]["pid"] != data[1]["pid"]
    json.dumps(doc)


# ---------------------------------------------------------------------------
# the soak itself
# ---------------------------------------------------------------------------

def _run_profile(name, **kw):
    from ray_tpu_torch.load import scenario
    from ray_tpu_torch.load.soak import run_soak
    out, log = io.StringIO(), io.StringIO()
    spec = scenario.profile(name, **kw)
    result = run_soak(spec, out=out, log=log)
    # stdout must be machine-readable rows ONLY (it feeds `| tee
    # BENCH_LOAD.json`), narration goes to the log stream.
    rows = [json.loads(line) for line in
            out.getvalue().strip().splitlines()]
    return result, rows, log.getvalue()


@pytest.mark.timeout(170)
def test_smoke_soak_end_to_end():
    """Every PR runs the whole loop: open-loop load on serve+data+train,
    one injected worker kill, verdicts read back from the planes."""
    result, rows, log = _run_profile("smoke", duration_s=6.0)
    assert result["ok"], (rows, log)
    by_check = {r["check"]: r for r in rows if r.get("row") == "verdict"}
    assert by_check["chaos_schedule_executed"]["ok"]
    assert by_check["trail_audit_clean"]["ok"]
    assert by_check["no_silent_nodes"]["ok"]
    # The cross-plane join: the killed worker's tasks carry salvaged
    # crash-ring tails on their trail records.
    salv = by_check["salvage_tails_attached"]
    assert salv["worker_kills"] == 1 and salv["ok"], salv
    assert salv["tasks_with_tails"] >= 1
    kills = [r for r in rows if r.get("row") == "chaos"]
    assert len(kills) == 1 and kills[0]["ok"], kills
    assert kills[0]["salvaged_tasks"], kills
    assert 0 < kills[0]["recovery_s"] <= 15.0
    wl = {r["workload"]: r for r in rows if r.get("row") == "workload"}
    assert set(wl) == {"serve", "data", "train"}
    assert all(r["slo_ok"] for r in wl.values()), wl
    assert all(r["requests"] > 0 for r in wl.values())


@pytest.mark.slow
@pytest.mark.timeout(470)
def test_full_soak_two_kill_rounds():
    """The full profile: higher rates, worker kill + node kill +
    replacement node + second worker kill. Both kill rounds must
    produce salvaged tails; the node kill must be detected DEAD and
    excused by the silent-node check."""
    result, rows, log = _run_profile("full", duration_s=30.0)
    assert result["ok"], (rows, log)
    chaos = [r for r in rows if r.get("row") == "chaos"]
    assert len(chaos) == 4 and all(r["ok"] for r in chaos), chaos
    worker_kills = [r for r in chaos if r["kind"] == "kill_worker"]
    assert len(worker_kills) == 2
    assert all(r["salvaged_tasks"] for r in worker_kills)
    node_kills = [r for r in chaos if r["kind"] == "kill_node"]
    assert node_kills and node_kills[0]["node"]
    by_check = {r["check"]: r for r in rows if r.get("row") == "verdict"}
    assert by_check["no_silent_nodes"]["intentionally_killed"] == \
        [node_kills[0]["node"]]
    assert by_check["trail_audit_clean"]["ok"]
    assert by_check["salvage_tails_attached"]["worker_kills"] == 2
    assert by_check["timeline_covers_failures"]["ok"]
