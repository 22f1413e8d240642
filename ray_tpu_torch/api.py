"""Public API: init/shutdown, @remote, get/put/wait, actors, placement groups.

Analogue of the reference's python surface (reference:
python/ray/_private/worker.py ray.init:1422/get:2847/put:2986/wait:3057,
python/ray/remote_function.py RemoteFunction._remote:314, python/ray/actor.py
ActorClass._remote:792, python/ray/util/placement_group.py).
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch.core.common import Address
from ray_tpu_torch.core.core_worker import CoreWorker
from ray_tpu_torch.core.ids import ActorID, PlacementGroupID
from ray_tpu_torch.core.node import LocalNode
from ray_tpu_torch.core.ref import ActorHandle, ObjectRef, get_core_worker
from ray_tpu_torch.utils import get_logger

logger = get_logger("api")

_global_node: Optional[LocalNode] = None
_core_worker: Optional[CoreWorker] = None


def is_initialized() -> bool:
    return _core_worker is not None


def init(address: Optional[str] = None, *,
         resources: Optional[Dict[str, float]] = None,
         agent_address: Optional[str] = None,
         graftprof: Optional[bool] = None) -> Dict[str, Any]:
    """Start a local cluster (head) or connect to an existing controller.

    address: "host:port" of a running controller; None starts controller +
    node agent locally (the reference's `ray.init()` head path).
    graftprof: override the continuous-profiling flag for this process
    and its spawned workers (None = config/env default; the
    RAY_TPU_TORCH_GRAFTPROF=0 escape hatch reaches the same flag).
    """
    global _global_node, _core_worker
    if _core_worker is not None:
        return {"already_initialized": True}
    if graftprof is not None:
        from ray_tpu_torch.utils.config import GlobalConfig
        GlobalConfig.initialize({"graftprof": bool(graftprof)})
    if address is None:
        # Driver scripts launched by job submission (and the reference's
        # RAY_ADDRESS convention) connect via env.
        import os
        address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
    if address is None:
        _global_node = LocalNode(resources=resources)
        controller_addr = _global_node.controller_addr
        agent_addr = _global_node.agent_addr
    else:
        host, port = address.rsplit(":", 1)
        controller_addr = (host, int(port))
        if agent_address:
            h, p = agent_address.rsplit(":", 1)
            agent_addr = (h, int(p))
        else:
            # Discover an agent on this host via the controller.
            from ray_tpu_torch.core.rpc import SyncRpcClient
            c = SyncRpcClient(controller_addr)
            agent_addr = None
            for n in c.call("get_nodes"):
                if n["state"] == "ALIVE":
                    agent_addr = tuple(n["addr"])
                    break
            c.close()
            if agent_addr is None:
                raise RuntimeError("no alive nodes in cluster")
    _core_worker = CoreWorker(
        "driver", agent_addr, controller_addr,
        _global_node.session_dir if _global_node else "/tmp")
    return {"controller_address": controller_addr,
            "agent_address": agent_addr}


def shutdown() -> None:
    global _global_node, _core_worker
    if _core_worker is not None:
        _core_worker.shutdown()
        _core_worker = None
    from ray_tpu_torch.core import ref as _ref
    _ref._core_worker = None
    if _global_node is not None:
        _global_node.stop()
        _global_node = None


def _cw() -> CoreWorker:
    if _core_worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _core_worker


# ---------------------------------------------------------------------------
# tasks & actors
# ---------------------------------------------------------------------------

class RemoteFunction:
    def __init__(self, func, **default_opts):
        self._func = func
        self._opts = default_opts
        functools.update_wrapper(self, func)

    def remote(self, *args, **kwargs):
        opts = self._opts
        num_returns = opts.get("num_returns", 1)
        refs = _cw().submit_task(
            self._func, args, kwargs,
            num_returns=num_returns,
            resources=_resources_from_opts(opts),
            max_retries=opts.get("max_retries", 0),
            placement_group=_pg_id(opts.get("placement_group")),
            pg_bundle_index=opts.get("placement_group_bundle_index", -1),
            scheduling_strategy=opts.get("scheduling_strategy"),
            label_selector=opts.get("label_selector"),
            name=opts.get("name", ""))
        if num_returns == "streaming":
            return refs  # an ObjectRefGenerator
        return refs[0] if num_returns == 1 else refs

    def options(self, **opts):
        merged = dict(self._opts)
        merged.update(opts)
        return RemoteFunction(self._func, **merged)

    def __call__(self, *a, **kw):
        raise TypeError("Remote functions must be called with .remote()")


class ActorClass:
    def __init__(self, cls, **default_opts):
        self._cls = cls
        self._opts = default_opts

    def remote(self, *args, **kwargs) -> ActorHandle:
        opts = self._opts
        return _cw().create_actor(
            self._cls, args, kwargs,
            name=opts.get("name", ""),
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 0),
            # Actors hold 0 CPU at rest by default (reference behavior) so a
            # small node isn't starved of task leases by resident actors.
            resources=_resources_from_opts(opts, default_cpu=0.0),
            placement_group=_pg_id(opts.get("placement_group")),
            pg_bundle_index=opts.get("placement_group_bundle_index", -1),
            runtime_env=opts.get("runtime_env"),
            label_selector=opts.get("label_selector"))

    def options(self, **opts):
        merged = dict(self._opts)
        merged.update(opts)
        return ActorClass(self._cls, **merged)


def _resources_from_opts(opts: dict, default_cpu: float = 1.0
                         ) -> Dict[str, float]:
    res = dict(opts.get("resources") or {})
    res["CPU"] = float(opts.get("num_cpus", res.get("CPU", default_cpu)))
    if "num_gpus" in opts:
        n = float(opts["num_gpus"])
        if n != int(n) or n < 0:
            # GPUs are pinned to workers as whole devices.
            raise ValueError(f"num_gpus must be a whole number of GPUs, "
                             f"got {opts['num_gpus']}")
        res["GPU"] = n
    if "memory" in opts:
        res["memory"] = float(opts["memory"])
    return res


def remote(*args, **opts):
    """@remote decorator for functions and classes (mirrors reference
    python/ray/_private/worker.py:3445)."""

    def wrap(obj):
        if inspect.isclass(obj):
            return ActorClass(obj, **opts)
        return RemoteFunction(obj, **opts)

    if len(args) == 1 and not opts and callable(args[0]):
        return wrap(args[0])
    return wrap


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    cw = _cw()
    if isinstance(refs, ObjectRef):
        return cw.get([refs], timeout)[0]
    return cw.get(list(refs), timeout)


def put(value: Any) -> ObjectRef:
    return _cw().put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None) -> Tuple[list, list]:
    return _cw().wait(refs, num_returns, timeout)


def cancel(target, *, force: bool = False) -> None:
    """Cancel a task by ObjectRef or ObjectRefGenerator (mirrors reference
    ray.cancel, python/ray/_private/worker.py:3268). Queued tasks are
    dropped; running tasks get TaskCancelledError raised in their exec
    thread; force=True kills the executing worker."""
    _cw().cancel(target, force)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    cw = _cw()
    cw._run(cw.controller.call("kill_actor", actor.actor_id.binary(),
                               no_restart)).result()
    if no_restart:
        cw.release_actor_arg_refs(actor.actor_id.binary())


def get_actor(name: str) -> ActorHandle:
    cw = _cw()
    info = cw._run(cw.controller.call("get_actor_by_name", name)).result()
    if info is None:
        raise ValueError(f"no actor named {name!r}")
    import cloudpickle
    creation = cloudpickle.loads(info["spec_blob"])
    cls = cloudpickle.loads(creation["cls_blob"])
    method_names = [m for m in dir(cls)
                    if not m.startswith("_") and callable(getattr(cls, m))]
    return ActorHandle(ActorID(info["actor_id"]), info["name"] or "actor",
                       method_names)


# ---------------------------------------------------------------------------
# placement groups
# ---------------------------------------------------------------------------

class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[dict],
                 state: Optional[str] = None):
        self.id = pg_id
        self.bundles = bundles
        # graftsched one-op create replies carry the terminal state, so
        # ready() resolves locally with zero RPCs. Deserialized handles
        # (and legacy creates) fall back to the wait_pg_ready long-poll.
        self._state = state

    def ready(self, timeout: float = 60.0) -> bool:
        if self._state == "CREATED":
            return True
        cw = _cw()
        state = cw._run(cw.controller.call(
            "wait_pg_ready", self.id.binary(), timeout)).result()
        if state == "CREATED":
            self._state = state
        return state == "CREATED"

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles))


def _pg_id(pg) -> Optional[bytes]:
    if pg is None:
        return None
    if isinstance(pg, PlacementGroup):
        return pg.id.binary()
    return pg


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    bundle_label_selector: Optional[List[dict]] = None
                    ) -> PlacementGroup:
    """bundle_label_selector: one node-label selector per bundle
    (reference: label_selector.cc operators — "v", "!v", "in(a,b)",
    "!in(a,b)"); the special value "$same" gangs all such bundles onto
    nodes sharing one value of that label, all-or-nothing (gang
    reservation)."""
    if bundle_label_selector is not None and \
            len(bundle_label_selector) != len(bundles):
        raise ValueError("bundle_label_selector must have one entry "
                         "per bundle")
    cw = _cw()
    pg_id = PlacementGroupID.random()
    reply = cw._run(cw.controller.call(
        "create_placement_group", pg_id.binary(), bundles,
        strategy, bundle_label_selector)).result()
    state = reply.get("state") if isinstance(reply, dict) else None
    return PlacementGroup(pg_id, bundles, state)


def remove_placement_group(pg: PlacementGroup) -> None:
    cw = _cw()
    cw._run(cw.controller.call(
        "remove_placement_group", pg.id.binary())).result()
    pg._state = None  # ready() consults the controller again


# ---------------------------------------------------------------------------
# cluster state
# ---------------------------------------------------------------------------

def nodes() -> List[dict]:
    cw = _cw()
    return cw._run(cw.controller.call("get_nodes")).result()


def cluster_resources() -> Dict[str, float]:
    cw = _cw()
    return cw._run(cw.controller.call("cluster_resources")).result()["total"]


def available_resources() -> Dict[str, float]:
    cw = _cw()
    return cw._run(cw.controller.call(
        "cluster_resources")).result()["available"]
