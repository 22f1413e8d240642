"""Asyncio helpers.

``spawn`` exists because asyncio event loops keep only WEAK references to
tasks: a fire-and-forget ``ensure_future(...)`` whose return value is
discarded can be garbage-collected mid-flight, which closes the coroutine by
throwing GeneratorExit into its current await — surfacing as phantom
"WorkerCrashedError: GeneratorExit()" failures under load. Every
fire-and-forget task in the runtime must go through ``spawn`` (the reference
runtime doesn't have this class of bug because its event loops are C++
boost::asio, where handlers are owned by the io_context).
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Set

_BACKGROUND: Set["asyncio.Task"] = set()


def spawn(coro: Awaitable) -> "asyncio.Task":
    """ensure_future with a strong reference until completion."""
    task = asyncio.ensure_future(coro)
    _BACKGROUND.add(task)
    task.add_done_callback(_discard)
    return task


def _discard(task: "asyncio.Task") -> None:
    _BACKGROUND.discard(task)
    if not task.cancelled():
        exc = task.exception()
        if exc is not None and not isinstance(exc, asyncio.CancelledError):
            import logging
            logging.getLogger("ray_tpu_torch.aio").error(
                "background task %r failed: %r", task.get_coro(), exc)
