"""Public Serve API: @deployment, bind, run, handles, @batch.

Analogue of the reference's surface (reference: serve/api.py serve.run:685,
serve/deployment.py Deployment/@serve.deployment, serve/batching.py
@serve.batch). The controller is a named detached-style actor; deploys are
idempotent upserts.
"""

from __future__ import annotations

import asyncio
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.handle import DeploymentHandle


class Application:
    """A bound deployment (class + init args), deployable via serve.run
    (reference: Application returned by Deployment.bind)."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs


class Deployment:
    def __init__(self, cls: type, name: str, config: Dict[str, Any]):
        self._cls = cls
        self.name = name
        self._config = config

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def options(self, **overrides) -> "Deployment":
        cfg = dict(self._config)
        name = overrides.pop("name", self.name)
        cfg.update(overrides)
        return Deployment(self._cls, name, cfg)


def deployment(cls: Optional[type] = None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 100,
               num_cpus: Optional[float] = None, num_gpus: int = 0,
               autoscaling_config: Optional[dict] = None):
    """@serve.deployment decorator (reference: serve/deployment.py).
    ``num_gpus`` whole cards per replica (the JAX package's ``num_tpus``)."""
    if num_gpus != int(num_gpus) or num_gpus < 0:
        raise ValueError(f"num_gpus must be a whole number of GPUs, got "
                         f"{num_gpus}")

    def wrap(c: type) -> Deployment:
        return Deployment(c, name or c.__name__, {
            "num_replicas": num_replicas,
            "max_ongoing_requests": max_ongoing_requests,
            "num_cpus": num_cpus,
            "num_gpus": int(num_gpus),
            "autoscaling_config": autoscaling_config,
        })

    return wrap(cls) if cls is not None else wrap


# ---------------------------------------------------------------------------
# controller lifecycle
# ---------------------------------------------------------------------------

_controller_handle = None
_proxy = None
_grpc_proxy = None


def start(*, http: bool = False, http_port: int = 0,
          http_host: str = "127.0.0.1", grpc: bool = False,
          grpc_port: int = 0):
    """Ensure the Serve controller (and optionally the HTTP and/or gRPC
    ingress proxies) is up (reference: serve.start + proxies per node,
    serve/_private/proxy.py HTTPProxy:706 / gRPCProxy:530)."""
    global _controller_handle, _proxy, _grpc_proxy
    if _controller_handle is None:
        try:
            _controller_handle = ray_tpu_torch.get_actor(
                ServeController.CONTROLLER_NAME)
        except ValueError:
            _controller_handle = ray_tpu_torch.remote(ServeController).options(
                name=ServeController.CONTROLLER_NAME,
                max_restarts=1).remote()
            # Wait until it answers.
            ray_tpu_torch.get(_controller_handle.routing_version.remote(),
                        timeout=60)
    if http and _proxy is None:
        from ray_tpu_torch.serve.proxy import HttpProxy
        _proxy = HttpProxy(_controller_handle, http_host, http_port)
    if grpc and _grpc_proxy is None:
        from ray_tpu_torch.serve.grpc_proxy import GrpcProxy
        _grpc_proxy = GrpcProxy(_controller_handle, http_host, grpc_port)
    return _controller_handle


def get_proxy():
    """The in-process HTTP proxy started by serve.start(http=True)."""
    return _proxy


def get_grpc_proxy():
    """The in-process gRPC proxy started by serve.start(grpc=True)."""
    return _grpc_proxy


class _HandleMarker:
    """Serialization-safe stand-in for a bound child deployment inside a
    parent's init args; replicas resolve it to a DeploymentHandle at
    construction (reference: serve model composition —
    Deployment.bind(child.bind()) wires handles through init args)."""

    def __init__(self, deployment_name: str):
        self.deployment_name = deployment_name


def _map_nested(convert, v):
    """Apply convert through lists/tuples/dicts (init args commonly
    carry children inside containers)."""
    out = convert(v)
    if out is not v:
        return out
    if isinstance(v, list):
        return [_map_nested(convert, x) for x in v]
    if isinstance(v, tuple):
        return tuple(_map_nested(convert, x) for x in v)
    if isinstance(v, dict):
        return {k: _map_nested(convert, x) for k, x in v.items()}
    return v


def _resolve_handle_markers(args: tuple, kwargs: dict):
    """Replica-side: markers -> live DeploymentHandles."""
    def convert(v):
        if isinstance(v, _HandleMarker):
            return get_deployment_handle(v.deployment_name)
        return v

    return tuple(_map_nested(convert, a) for a in args), \
        {k: _map_nested(convert, v) for k, v in kwargs.items()}


def _deploy_children(args: tuple, kwargs: dict):
    """Caller-side: deploy every bound child Application found in the
    parent's init args (recursing through containers) and substitute
    markers."""
    def convert(v):
        if isinstance(v, Application):
            child_handle = run(v)
            return _HandleMarker(child_handle._deployment)
        if isinstance(v, Deployment):
            child_handle = run(v.bind())
            return _HandleMarker(child_handle._deployment)
        return v

    return tuple(_map_nested(convert, a) for a in args), \
        {k: _map_nested(convert, v) for k, v in kwargs.items()}


def run(app: "Application | Deployment", *, name: Optional[str] = None,
        route_prefix: Optional[str] = None) -> DeploymentHandle:
    """Deploy (upsert) an application; blocks until replicas are live
    (reference: serve.run, serve/api.py:685). Bound child deployments in
    the init args deploy first and arrive in the constructor as
    DeploymentHandles (app composition)."""
    controller = start()
    if isinstance(app, Deployment):
        app = app.bind()
    dep = app.deployment
    dep_name = name or dep.name
    init_args, init_kwargs = _deploy_children(app.init_args,
                                              app.init_kwargs)
    config = dict(dep._config)
    config["cls_blob"] = cloudpickle.dumps(dep._cls)
    config["init_args_blob"] = cloudpickle.dumps(
        (init_args, init_kwargs))
    config["route_prefix"] = route_prefix or f"/{dep_name}"
    ray_tpu_torch.get(controller.deploy.remote(dep_name,
                                         cloudpickle.dumps(config)),
                timeout=120)
    handle = DeploymentHandle(dep_name, controller)
    # Block until at least one replica has PASSED a health check (heavy
    # init — weights + CUDA start — happens in the constructor).
    deadline = time.monotonic() + 600
    while time.monotonic() < deadline:
        try:
            if ray_tpu_torch.get(controller.ready_replicas.remote(dep_name),
                           timeout=30) > 0:
                handle._router._refresh(force=True)
                return handle
        except Exception:
            pass
        time.sleep(0.5)
    raise TimeoutError(f"deployment {dep_name!r} never became ready")


def get_deployment_handle(name: str) -> DeploymentHandle:
    controller = start()
    return DeploymentHandle(name, controller)


def delete(name: str) -> None:
    controller = start()
    ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=60)


def shutdown() -> None:
    global _controller_handle, _proxy, _grpc_proxy
    if _proxy is not None:
        _proxy.stop()
        _proxy = None
    if _grpc_proxy is not None:
        try:
            _grpc_proxy.stop()
        except Exception:
            pass
        _grpc_proxy = None
    if _controller_handle is not None:
        try:
            ray_tpu_torch.get(_controller_handle.shutdown_serve.remote(),
                        timeout=30)
            ray_tpu_torch.kill(_controller_handle)
        except Exception:
            pass
        _controller_handle = None


# ---------------------------------------------------------------------------
# @serve.batch (reference: serve/batching.py)
# ---------------------------------------------------------------------------

def batch(fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Coalesce concurrent single calls into one batched call: the wrapped
    async method receives a LIST of inputs and must return a list of
    outputs in order. Model replicas want full batches (a card's tensor
    cores idle on one row at a time), so sizes are capped at
    max_batch_size (padding to fixed shapes is the model's concern)."""

    def wrap(f: Callable):
        # Per-instance queue stored ON the instance (a closure-level lock
        # would make the deployment class unpicklable; and replica async
        # methods all run on one io loop, so no lock is needed).
        attr = f"__serve_batch_queue_{f.__name__}"

        async def flush(self_obj):
            batch_items = getattr(self_obj, attr, None)
            if not batch_items:
                return
            setattr(self_obj, attr, [])
            inputs = [i for i, _ in batch_items]
            try:
                outputs = await f(self_obj, inputs)
                assert len(outputs) == len(inputs), \
                    "@batch fn must return one output per input"
                for (_, fut), out in zip(batch_items, outputs):
                    if not fut.done():
                        fut.set_result(out)
            except BaseException as e:  # noqa: BLE001
                for _, fut in batch_items:
                    if not fut.done():
                        fut.set_exception(e)

        @functools.wraps(f)
        async def wrapper(self_obj, item):
            fut = asyncio.get_running_loop().create_future()
            q = getattr(self_obj, attr, None)
            if q is None:
                q = []
                setattr(self_obj, attr, q)
            q.append((item, fut))
            if len(q) >= max_batch_size:
                await flush(self_obj)
            else:
                from ray_tpu_torch.utils.aio import spawn

                async def delayed():
                    await asyncio.sleep(batch_wait_timeout_s)
                    await flush(self_obj)
                spawn(delayed())
            return await fut

        return wrapper

    return wrap(fn) if fn is not None else wrap
