"""ScalingPolicy — when and how the Train worker group resizes.

Analogue of the reference's scaling-policy seam (reference:
python/ray/train/v2/_internal/execution/scaling_policy/ ScalingPolicy ->
ResizeDecision, executed by controller.py:171 _execute_resize_decision).
A decision is just a target WORLD SIZE — the controller
checkpoints, rebuilds the gang (new PG, new torch.distributed world, a
new mesh), and resumes from the latest committed
checkpoint. SPMD jobs can't absorb workers in place the way a
parameter-server could; a clean re-gang IS the resize primitive.
"""

from __future__ import annotations

from typing import Dict, List


class ScalingPolicy:
    """Seam: map observed cluster state to a target worker count."""

    def target_workers(self, current: int, nodes: List[dict],
                       bundle: Dict[str, float]) -> int:
        raise NotImplementedError


class FixedScalingPolicy(ScalingPolicy):
    """Always the configured world size (the non-elastic default)."""

    def __init__(self, num_workers: int):
        self.num_workers = num_workers

    def target_workers(self, current, nodes, bundle) -> int:
        return self.num_workers


class ElasticScalingPolicy(ScalingPolicy):
    """Track cluster capacity between [min_workers, max_workers]: a node
    join grows the job at the next decision point; a node loss shrinks
    it instead of wedging the gang (reference: elastic resize decisions
    in train/v2 controller).

    Growth is computed from AVAILABLE resources (what a resize could
    actually reserve beyond the running group — other jobs' usage is
    respected); shrink-to-capacity uses TOTAL resources (on a node loss
    the dead node's totals vanish)."""

    def __init__(self, min_workers: int, max_workers: int):
        assert 1 <= min_workers <= max_workers
        self.min_workers = min_workers
        self.max_workers = max_workers

    @staticmethod
    def _fits(res: Dict[str, float], bundle: Dict[str, float]) -> int:
        fits = None
        for r, amount in bundle.items():
            if amount <= 0:
                continue
            n = int(float(res.get(r, 0.0)) // amount)
            fits = n if fits is None else min(fits, n)
        return fits or 0

    def target_workers(self, current, nodes, bundle) -> int:
        alive = [n for n in nodes
                 if n.get("state", "ALIVE") == "ALIVE"]
        cap_total = sum(self._fits(n.get("resources_total", {}), bundle)
                        for n in alive)
        extra = sum(self._fits(n.get("resources_available", {}), bundle)
                    for n in alive)
        # Up to current+extra is reservable right now; never above what
        # the (possibly shrunken) cluster could hold at all.
        target = min(cap_total, current + extra)
        return max(self.min_workers, min(self.max_workers, target))
