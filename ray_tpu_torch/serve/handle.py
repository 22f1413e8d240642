"""DeploymentHandle + Router — the data-plane client.

Analogue of the reference's handle/router (reference: serve/handle.py
DeploymentHandle, serve/_private/router.py Router:433, request_router/
pow_2_router.py PowerOfTwoChoicesRequestRouter:27): each handle owns a
router that picks a replica per request by power-of-two-choices — probe
two random replicas' queue lengths, send to the shorter — with a local
routing-table cache refreshed on version bumps and on replica failure.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch


class DeploymentResponse:
    """Future-like result of handle.remote() (reference: serve/handle.py
    DeploymentResponse). Replica death surfaces here (actor submission is
    async), so result() re-routes the request once through the router."""

    def __init__(self, ref, retry=None):
        self._ref = ref
        self._retry = retry

    def result(self, timeout: Optional[float] = None):
        from ray_tpu_torch.core.common import (ActorDiedError, ObjectLostError,
                                         WorkerCrashedError)
        try:
            return ray_tpu_torch.get(self._ref, timeout=timeout)
        except (ActorDiedError, WorkerCrashedError, ObjectLostError):
            if self._retry is None:
                raise
            self._ref = self._retry()
            self._retry = None  # one re-route per request
            return ray_tpu_torch.get(self._ref, timeout=timeout)

    @property
    def ref(self):
        return self._ref


# ONE pubsub subscription per CORE WORKER invalidates every live router
# (weakly referenced, so handles still GC); per-router subscriptions
# would leak a perpetual poll loop per handle. Keyed by the worker, not
# a process-lifetime boolean: a shutdown + re-init gets a fresh
# subscription on the new worker's loop.
_routers: "Any" = None
_sub_cw: "Any" = None  # weakref to the core worker currently subscribed


def _ttl_warning() -> None:
    from ray_tpu_torch.utils import get_logger
    get_logger("serve").warning(
        "serve router push-invalidation unavailable; falling back "
        "to the %ss table TTL", Router._TABLE_TTL_S)


def _register_router(router: "Router") -> None:
    global _routers, _sub_cw
    import weakref

    if _routers is None:
        _routers = weakref.WeakSet()
    _routers.add(router)
    try:
        from ray_tpu_torch.core.pubsub import Subscription
        from ray_tpu_torch.core.ref import get_core_worker
        cw = get_core_worker()
    except Exception:
        _ttl_warning()  # no runtime (unit tests): TTL still refreshes
        return
    if _sub_cw is not None and _sub_cw() is cw:
        return  # this worker already runs the subscription

    def _invalidate(_event):
        for r in list(_routers):
            r._checked = 0.0  # next choose re-reads the table

    async def _start():
        global _sub_cw
        try:
            Subscription(cw.controller, "serve_events", _invalidate,
                         from_latest=True).start()
        except Exception:
            _sub_cw = None  # a later router retries
            _ttl_warning()

    _sub_cw = weakref.ref(cw)
    cw._spawn(_start())


class Router:
    """Pow-2 replica chooser with a push-invalidated routing table.

    The serve controller publishes every version bump on the runtime's
    pubsub hub (channel "serve_events"); the router subscribes and drops
    its cache the moment a deploy/scale lands — the TTL below is only a
    safety net against a lost push (reference:
    serve/_private/long_poll.py:228 LongPollHost push updates)."""

    _TABLE_TTL_S = 30.0  # fallback only; pushes invalidate immediately

    _QLEN_TTL_S = 0.1  # probe cache: bounds probe RPCs to ~20/s per pair

    def __init__(self, deployment: str, controller_handle):
        self._deployment = deployment
        self._controller = controller_handle
        self._replicas: List[Any] = []
        self._version = -1
        self._checked = 0.0
        self._lock = threading.Lock()
        self._qlen_cache: Dict[bytes, tuple] = {}  # aid -> (qlen, ts)
        # model_id -> replica actor_id: sticky multiplexing affinity
        # (reference: serve/multiplex.py routes to replicas holding the
        # model; ours is client-side stickiness with pow-2 fallback).
        self._model_affinity: Dict[str, bytes] = {}
        _register_router(self)

    def _refresh(self, force: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            if not force and now - self._checked < self._TABLE_TTL_S \
                    and self._replicas:
                return
            self._checked = now
            table = ray_tpu_torch.get(self._controller.routing_table.remote(),
                                timeout=30)
            if table["version"] != self._version:
                self._version = table["version"]
                self._replicas = table["deployments"].get(
                    self._deployment, [])

    def choose_replica(self, model_id: str = ""):
        """Power-of-two-choices over live queue lengths (reference:
        pow_2_router.py:52 choose_replicas); multiplexed requests stick
        to the replica that last served their model id."""
        self._refresh()
        replicas = self._replicas
        if not replicas:
            raise RuntimeError(
                f"deployment {self._deployment!r} has no replicas")
        if model_id:
            aid = self._model_affinity.get(model_id)
            if aid is not None:
                for r in replicas:
                    if r.actor_id.binary() == aid:
                        return r
            chosen = self._choose_pow2(replicas)
            self._model_affinity[model_id] = chosen.actor_id.binary()
            return chosen
        return self._choose_pow2(replicas)

    def _choose_pow2(self, replicas):
        if len(replicas) == 1:
            return replicas[0]
        a, b = random.sample(replicas, 2)
        try:
            qa = self._queue_len(a)
            qb = self._queue_len(b)
        except Exception:
            self._refresh(force=True)
            return random.choice(self._replicas or replicas)
        return a if qa <= qb else b

    def _queue_len(self, replica) -> int:
        """Cached queue-length probe: a hot request path must not pay two
        RPC round trips per request (reference routers cache replica
        load similarly)."""
        aid = replica.actor_id.binary()
        now = time.monotonic()
        hit = self._qlen_cache.get(aid)
        if hit is not None and now - hit[1] < self._QLEN_TTL_S:
            return hit[0]
        q = ray_tpu_torch.get(replica.queue_len.remote(), timeout=5)
        self._qlen_cache[aid] = (q, now)
        return q

    def on_replica_error(self) -> None:
        # Sticky affinity must not outlive a failure: retries have to be
        # free to fail over to a healthy replica.
        self._model_affinity.clear()
        self._refresh(force=True)


class DeploymentHandle:
    def __init__(self, deployment: str, controller_handle,
                 method: str = "__call__", multiplexed_model_id: str = "",
                 _router: Optional[Router] = None):
        self._deployment = deployment
        self._controller = controller_handle
        self._method = method
        self._model_id = multiplexed_model_id
        # A Router owns a live pubsub subscription: options() MUST share
        # the parent's instead of constructing a throwaway one.
        self._router = _router or Router(deployment, controller_handle)

    def options(self, *, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None
                ) -> "DeploymentHandle":
        return DeploymentHandle(
            self._deployment, self._controller,
            method_name if method_name is not None else self._method,
            multiplexed_model_id if multiplexed_model_id is not None
            else self._model_id,
            _router=self._router)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        blob = cloudpickle.dumps((args, kwargs))

        def dispatch():
            # Synchronous submission failures (stale table, dead handle)
            # refresh the router and retry a couple of times; deaths that
            # surface later are covered by the result()-side re-route.
            last: Optional[Exception] = None
            for _ in range(3):
                try:
                    replica = self._router.choose_replica(self._model_id)
                    return replica.handle_request.remote(
                        self._method, blob, self._model_id)
                except Exception as e:
                    last = e
                    self._router.on_replica_error()
            raise RuntimeError(
                f"could not route request to {self._deployment!r}: "
                f"{last!r}")

        def re_route():
            # Replica died after dispatch: refresh the table and resend.
            self._router.on_replica_error()
            return dispatch()

        return DeploymentResponse(dispatch(), retry=re_route)

    def stream(self, *args, **kwargs):
        """Streaming call: the deployment method must be a generator;
        yields values as the replica produces them (reference: Serve
        streaming responses over ObjectRefGenerator)."""
        blob = cloudpickle.dumps((args, kwargs))
        replica = self._router.choose_replica(self._model_id)
        gen = replica.handle_request_streaming.options(
            num_returns="streaming").remote(self._method, blob,
                                            self._model_id)
        for ref in gen:
            yield ray_tpu_torch.get(ref)
