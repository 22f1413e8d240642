"""Queue — a distributed FIFO backed by an async actor (counterpart of
``ray_tpu/util/queue.py``).

Analogue of the reference's queue (reference: python/ray/util/queue.py —
an asyncio.Queue inside a dedicated actor; producers/consumers block
server-side, so gets long-poll instead of spinning).
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)

    async def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        try:
            if timeout is None:
                await self._q.put(item)
            else:
                await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        try:
            if timeout is None:
                return (True, await self._q.get())
            return (True, await asyncio.wait_for(self._q.get(), timeout))
        except asyncio.TimeoutError:
            return (False, None)

    async def put_nowait_batch(self, items: List[Any]) -> int:
        n = 0
        for it in items:
            if self._q.full():
                break
            self._q.put_nowait(it)
            n += 1
        return n

    async def qsize(self) -> int:
        return self._q.qsize()

    async def empty(self) -> bool:
        return self._q.empty()

    async def full(self) -> bool:
        return self._q.full()


class Queue:
    def __init__(self, maxsize: int = 0):
        self._actor = ray_tpu_torch.remote(_QueueActor).remote(maxsize)

    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        ok = ray_tpu_torch.get(self._actor.put.remote(item, timeout),
                         timeout=None if timeout is None else timeout + 30)
        if not ok:
            raise Full("queue full")

    def get(self, timeout: Optional[float] = None) -> Any:
        ok, item = ray_tpu_torch.get(
            self._actor.get.remote(timeout),
            timeout=None if timeout is None else timeout + 30)
        if not ok:
            raise Empty("queue empty")
        return item

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote(), timeout=30)

    def empty(self) -> bool:
        return ray_tpu_torch.get(self._actor.empty.remote(), timeout=30)

    def full(self) -> bool:
        return ray_tpu_torch.get(self._actor.full.remote(), timeout=30)

    def shutdown(self) -> None:
        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:
            pass
