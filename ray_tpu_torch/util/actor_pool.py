"""ActorPool — load-balance tasks over a fixed set of actors (counterpart of
``ray_tpu/util/actor_pool.py``).

Analogue of the reference's ActorPool (reference:
python/ray/util/actor_pool.py — submit(fn, value) round-robins onto free
actors; get_next/get_next_unordered collect; map/map_unordered stream).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._inflight_by_ref = {}
        self._ref_by_seq = {}
        self._submit_seq = 0
        self._consume_seq = 0
        self._backlog: List[tuple] = []

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """fn(actor, value) -> ObjectRef; queues when all actors busy."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._inflight_by_ref[ref] = (self._submit_seq, actor)
            self._ref_by_seq[self._submit_seq] = ref
            self._submit_seq += 1
        else:
            self._backlog.append((fn, value))

    def _return_actor(self, actor) -> None:
        self._idle.append(actor)
        if self._backlog:
            self.submit(*self._backlog.pop(0))

    def has_next(self) -> bool:
        return bool(self._ref_by_seq)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in SUBMISSION order. On timeout the task stays
        pending and its actor stays busy (popping before the result is
        ready would lose the result and double-book the actor)."""
        if not self.has_next():
            raise StopIteration("no pending results")
        ref = self._ref_by_seq[self._consume_seq]
        if timeout is not None:
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1,
                                          timeout=timeout)
            if not ready:
                raise TimeoutError("next result not ready within timeout")
        self._ref_by_seq.pop(self._consume_seq)
        self._consume_seq += 1
        _, actor = self._inflight_by_ref.pop(ref)
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._return_actor(actor)

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next COMPLETED result, any order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._inflight_by_ref),
                                num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        index, actor = self._inflight_by_ref.pop(ref)
        self._ref_by_seq.pop(index)
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._return_actor(actor)

    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def push(self, actor: Any) -> None:
        """Add an idle actor to the pool."""
        self._return_actor(actor)
