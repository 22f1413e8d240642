"""streaming_split — n consumers over one shared streaming execution.

Analogue of the reference's streaming_split (reference:
python/ray/data/dataset.py:1826 + _internal/execution/operators/
output_splitter.py, coordinated by a SplitCoordinator actor): a coordinator
actor drives the dataset's streaming executor once and hands out block refs
to consumers on demand. First-come-first-served hand-out doubles as dynamic
load balancing (the reference's equal=False mode); equal=True enforces
strict round-robin so every consumer sees the same number of blocks (SPMD
train loops need equal step counts).
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

import ray_tpu_torch


class _SplitCoordinator:
    """Actor: owns the single streaming execution; consumers pull blocks.

    equal=True slices EVERY upstream block into n equal-row sub-blocks
    (consumer i always gets slice i), so all consumers see identical block
    AND row counts regardless of upstream block-count divisibility — an
    SPMD train loop running a collective per batch stays in lockstep. Up
    to n-1 remainder rows per block are dropped (the reference's
    equal=True similarly discards rows to equalize output splits).
    """

    def __init__(self, ds_blob: bytes, n: int, equal: bool):
        import cloudpickle

        ds = cloudpickle.loads(ds_blob)
        self._n = n
        self._equal = equal
        self._it = ds.iter_block_refs()
        self._lock = threading.Lock()
        self._exhausted = False
        # equal mode: per-consumer queues of equal-row sub-block refs.
        self._queues: List[List[Any]] = [[] for _ in range(n)]

    def _pump_equal_once(self) -> bool:
        """Slice one upstream block into n equal sub-blocks; False at end."""
        import ray_tpu_torch
        from ray_tpu_torch.data.block import BlockAccessor

        try:
            ref = next(self._it)
        except StopIteration:
            self._exhausted = True
            return False
        acc = BlockAccessor(ray_tpu_torch.get(ref))
        rows = acc.num_rows()
        per = rows // self._n
        if per == 0:
            return True  # block smaller than n rows: drop (all-equal: none)
        for i in range(self._n):
            self._queues[i].append(
                ray_tpu_torch.put(acc.slice(i * per, (i + 1) * per)))
        return True

    def next_block(self, split_idx: int):
        """Next block ref for consumer split_idx, or None when exhausted."""
        with self._lock:
            if self._equal:
                q = self._queues[split_idx]
                while not q and not self._exhausted:
                    self._pump_equal_once()
                return q.pop(0) if q else None
            # Dynamic mode: whoever asks first gets the next block.
            if self._exhausted:
                return None
            try:
                return next(self._it)
            except StopIteration:
                self._exhausted = True
                return None


def create_streaming_split(ds, n: int, *, equal: bool = False):
    import cloudpickle

    from ray_tpu_torch.data.dataset import DataIterator

    coordinator = ray_tpu_torch.remote(_SplitCoordinator).remote(
        cloudpickle.dumps(ds), n, equal)

    def make_factory(idx: int):
        def factory():
            while True:
                ref = ray_tpu_torch.get(coordinator.next_block.remote(idx))
                if ref is None:
                    return
                yield ref

        return factory

    iters = [DataIterator(make_factory(i), name=f"split{i}/{n}")
             for i in range(n)]
    # Keep the coordinator alive as long as the iterators are.
    for it in iters:
        it._coordinator = coordinator
    return iters
