"""ReplicaActor — hosts one copy of the user's deployment.

Analogue of the reference's replica (reference: serve/_private/replica.py
ReplicaActor:1095 — user callable wrapping, concurrent request handling,
health checks, ongoing-request metrics for the router and autoscaler).
Async actor: requests run concurrently on the io loop up to
max_ongoing_requests; queue_len() answers router probes instantly even
while requests are in flight.
"""

from __future__ import annotations

import asyncio
import inspect
import time
from typing import Any, Dict, Optional

import cloudpickle


class Replica:
    """One deployment copy (created via the actor runtime)."""

    def __init__(self, cls_blob: bytes, init_args_blob: bytes,
                 deployment_name: str, max_ongoing: int = 100):
        cls = cloudpickle.loads(cls_blob)
        args, kwargs = cloudpickle.loads(init_args_blob)
        # App composition (reference: serve/handle.py model composition):
        # bound child deployments arrive as markers; resolve each to a
        # live DeploymentHandle here, in the replica process.
        from ray_tpu_torch.serve.api import _resolve_handle_markers
        args, kwargs = _resolve_handle_markers(args, kwargs)
        self._user = cls(*args, **kwargs)
        self._name = deployment_name
        self._max_ongoing = max_ongoing
        self._ongoing = 0
        self._total = 0
        self._sem = asyncio.Semaphore(max_ongoing)
        self._started = time.time()

    async def handle_request(self, method: str, args_blob: bytes,
                             model_id: str = ""):
        """Run one request through the user callable (async-concurrent).
        Sync callables go to a thread pool — running them on the io loop
        would stall health checks and queue probes, and the controller
        would kill a merely-busy replica."""
        import contextvars

        from ray_tpu_torch.serve.multiplex import _set_current_model_id

        args, kwargs = cloudpickle.loads(args_blob)
        fn = getattr(self._user, method)
        self._ongoing += 1
        self._total += 1
        try:
            async with self._sem:
                _set_current_model_id(model_id)
                if inspect.iscoroutinefunction(fn):
                    return await fn(*args, **kwargs)
                loop = asyncio.get_running_loop()
                # copy_context: run_in_executor does NOT propagate
                # contextvars, and get_multiplexed_model_id must work
                # inside sync callables too.
                ctx = contextvars.copy_context()
                return await loop.run_in_executor(
                    None, lambda: ctx.run(fn, *args, **kwargs))
        finally:
            self._ongoing -= 1

    def handle_request_streaming(self, method: str, args_blob: bytes,
                                 model_id: str = ""):
        """Streaming variant: the user method is a (sync) generator; items
        stream back through the runtime's ObjectRefGenerator."""
        from ray_tpu_torch.serve.multiplex import _set_current_model_id

        args, kwargs = cloudpickle.loads(args_blob)
        fn = getattr(self._user, method)
        self._ongoing += 1
        self._total += 1
        try:
            _set_current_model_id(model_id)
            yield from fn(*args, **kwargs)
        finally:
            self._ongoing -= 1

    async def queue_len(self) -> int:
        """Router probe (reference: pow_2_router queue-length probes)."""
        return self._ongoing

    async def health(self) -> dict:
        ok = True
        check = getattr(self._user, "check_health", None)
        if check is not None:
            try:
                res = check()
                if inspect.isawaitable(res):
                    await res
            except Exception:
                ok = False
        return {"healthy": ok, "ongoing": self._ongoing,
                "total": self._total, "uptime_s": time.time() - self._started}
