"""Explicit collective groups over actor sets (counterpart of
``ray_tpu/collective.py``).

Analogue of the reference's collective API (reference:
python/ray/util/collective/collective.py init_collective_group:166 /
allreduce:311 / broadcast:426 / allgather:476 / barrier:351, with the
rendezvous via a named actor, nccl_collective_group.py:28). Groups whose
workers run one program under ``torch.distributed`` use the parallel
layer's NCCL collectives inside that program (``ray_tpu_torch.parallel``,
the train path); THIS module is the out-of-band host plane (the
reference's gloo analogue, ``collective_cpu_fallback``): a coordinator
actor is the rendezvous AND the reduction point. Each rank's
``contribute()`` long-polls until every rank has arrived, so one
actor-call round trip completes the collective.

Tensors: a ``torch.Tensor`` goes to the coordinator as host bytes (a
numpy array, or the CPU tensor itself for a dtype numpy lacks, such as
bf16) and comes back as a ``torch.Tensor`` on the caller's device. Where
numpy holds the dtype the coordinator reduces with numpy, so the result
dtypes are the reference's (``sum`` of int32 gives int64, ``mean`` of
ints float64); bf16 is reduced by torch on the CPU, summed in f32 and
returned in bf16. Other inputs (numpy arrays, scalars) come back as numpy.
"""

from __future__ import annotations

import asyncio
import sys
from typing import Any, Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.utils.config import GlobalConfig

_REDUCERS = {
    "sum": lambda arrs: np.sum(arrs, axis=0),
    "mean": lambda arrs: np.mean(arrs, axis=0),
    "max": lambda arrs: np.max(arrs, axis=0),
    "min": lambda arrs: np.min(arrs, axis=0),
}


def _reduce_tensors(parts: list, reduce_op: str):
    """The reducers for CPU torch tensors of a dtype numpy lacks (bf16):
    sum and mean in f32, the result in the inputs' dtype."""
    import torch

    if reduce_op not in _REDUCERS:
        raise KeyError(reduce_op)
    stack = torch.stack([torch.as_tensor(p) for p in parts])
    if reduce_op == "max":
        return stack.amax(0)
    if reduce_op == "min":
        return stack.amin(0)
    acc = stack.float().sum(0)
    if reduce_op == "mean":
        acc = acc / len(parts)
    return acc.to(stack.dtype)


class _Coordinator:
    """Rendezvous + reduction actor (async: each contribute long-polls)."""

    def __init__(self, world: int):
        self._world = world
        self._pending: Dict[tuple, dict] = {}  # (op_key, step) -> state

    def _state(self, key) -> dict:
        st = self._pending.get(key)
        if st is None:
            st = self._pending[key] = {
                "parts": {}, "event": asyncio.Event(), "result": None}
        return st

    async def contribute(self, op: str, name: str, step: int, rank: int,
                         payload, reduce_op: str = "sum",
                         src_rank: int = 0):
        key = (op, name, step)
        st = self._state(key)
        st["parts"][rank] = payload
        if len(st["parts"]) == self._world:
            parts = st["parts"]
            try:
                if op == "allreduce":
                    ordered = [parts[r] for r in range(self._world)]
                    if any(_is_tensor(p) for p in ordered):
                        st["result"] = _reduce_tensors(ordered, reduce_op)
                    else:
                        arrs = [np.asarray(p) for p in ordered]
                        st["result"] = _REDUCERS[reduce_op](arrs)
                elif op == "allgather":
                    st["result"] = [parts[r] for r in range(self._world)]
                elif op == "broadcast":
                    st["result"] = parts[src_rank]
                elif op == "barrier":
                    st["result"] = True
                else:
                    raise ValueError(f"unknown collective op {op!r}")
            except BaseException as e:  # noqa: BLE001
                # The error must reach EVERY rank — leaving the event
                # unset would hang world-1 ranks until their timeouts.
                st["error"] = e
            st["event"].set()
        else:
            try:
                # A rank that died before contributing must not wedge the
                # group forever: time out, surface the failure.
                await asyncio.wait_for(st["event"].wait(), 300.0)
            except asyncio.TimeoutError:
                # Mark failed IN PLACE (don't pop): late/concurrent ranks
                # must see the same failure, not complete against an
                # orphaned entry or start a fresh 300s wait.
                if st.get("error") is None and not st["event"].is_set():
                    st["error"] = RuntimeError(
                        f"only {len(st['parts'])}/{self._world} ranks "
                        f"arrived within 300s")
                    st["event"].set()

                    async def _gc_later(key=key):
                        # Dead ranks never read: drop the failed entry
                        # (and its payload arrays) eventually.
                        await asyncio.sleep(600)
                        self._pending.pop(key, None)

                    from ray_tpu_torch.utils.aio import spawn
                    spawn(_gc_later())
        err = st.get("error")
        result = st["result"]
        # Last reader cleans up (every rank reads exactly once).
        st["readers"] = st.get("readers", 0) + 1
        if st["readers"] == self._world:
            self._pending.pop(key, None)
        if err is not None:
            raise RuntimeError(f"collective {op!r} failed: {err!r}")
        return result


class _GroupInfo:
    def __init__(self, coordinator, rank: int, world: int):
        self.coordinator = coordinator
        self.rank = rank
        self.world = world
        self.step = 0


_groups: Dict[str, _GroupInfo] = {}


def _declare_group(group_name: str, coordinator, rank: int,
                   world: int) -> None:
    """Called inside each member actor (via init_collective_group)."""
    _groups[group_name] = _GroupInfo(coordinator, rank, world)


def init_collective_group(actors: List[Any],
                          group_name: str = "default") -> None:
    """Driver-side setup: create the coordinator, tell every member actor
    its rank (reference: collective.py:203 create_collective_group —
    declare_collective_group on each actor)."""
    if not GlobalConfig.collective_cpu_fallback:
        raise RuntimeError(
            "out-of-band collectives disabled "
            "(collective_cpu_fallback=False); use the NCCL collectives of "
            "a torch.distributed group through ray_tpu_torch.parallel "
            "(ParallelContext) instead")
    world = len(actors)
    coordinator = ray_tpu_torch.remote(_Coordinator).remote(world)
    ray_tpu_torch.get([
        a.declare_collective_group.remote(group_name, coordinator, rank,
                                          world)
        for rank, a in enumerate(actors)], timeout=120)


class CollectiveMixin:
    """Mix into an actor class to make it collective-group-capable
    (provides the declare_collective_group method init_collective_group
    calls on every member)."""

    def declare_collective_group(self, group_name, coordinator, rank,
                                 world):
        _declare_group(group_name, coordinator, rank, world)
        return rank


def _group(group_name: str) -> _GroupInfo:
    g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} not declared in this process")
    return g


def _is_tensor(x) -> bool:
    """A torch tensor (torch is not imported for numpy payloads)."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _to_host(tensor):
    """The payload a rank ships: a numpy array, or for a torch dtype that
    numpy lacks (bf16) the CPU tensor itself."""
    if not _is_tensor(tensor):
        return np.asarray(tensor)
    host = tensor.detach().cpu()
    try:
        return host.numpy()
    except TypeError:
        return host


def _nbytes(payload) -> int:
    if isinstance(payload, np.ndarray):
        return payload.nbytes
    return payload.numel() * payload.element_size()


def _like(result, tensor):
    """A torch tensor in -> a torch tensor on its device out; anything else
    comes back as it came from the coordinator."""
    if not _is_tensor(tensor):
        return result
    import torch

    if not isinstance(result, torch.Tensor):
        # A copy: the runtime may hand back a read-only view of its store.
        result = torch.from_numpy(np.array(result))
    return result.to(tensor.device)


def _call(g: _GroupInfo, op: str, name: str, payload, **kw):
    g.step += 1
    return ray_tpu_torch.get(g.coordinator.contribute.remote(
        op, name, g.step, g.rank, payload, **kw), timeout=600)


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group(group_name).world


_HUB_WARN_BYTES = 32 * 1024 * 1024
_hub_warned = False


def _guard_hub_size(nbytes: int, world: int, what: str) -> None:
    """The host-plane collectives funnel every rank's payload through ONE
    coordinator actor — O(world x bytes) through a single process. Fine
    for control-plane data; silently catastrophic for gradients. Warn
    once and point at the NCCL path."""
    global _hub_warned
    if _hub_warned or nbytes * max(1, world - 1) < _HUB_WARN_BYTES:
        return
    _hub_warned = True
    from ray_tpu_torch.utils import get_logger
    get_logger("collective").warning(
        "%s is moving ~%.0f MB through the coordinator-actor hub "
        "(O(world) through one process). For tensors this size use the "
        "NCCL collectives of ray_tpu_torch.parallel inside one "
        "torch.distributed program, or DeviceRef transfers — the hub path "
        "is built for control-plane payloads.", what,
        nbytes * max(1, world - 1) / 1e6)


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    """Reduce across the group; returns the reduced value (a torch tensor
    on the caller's device for a torch tensor; the host hop is the
    plane's)."""
    g = _group(group_name)
    host = _to_host(tensor)
    _guard_hub_size(_nbytes(host), g.world, "allreduce")
    out = _call(g, "allreduce", group_name, host, reduce_op=op)
    return _like(out, tensor)


def allgather(tensor, group_name: str = "default") -> List[Any]:
    g = _group(group_name)
    host = _to_host(tensor)
    _guard_hub_size(_nbytes(host), g.world, "allgather")
    outs = _call(g, "allgather", group_name, host)
    return [_like(o, tensor) for o in outs]


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    g = _group(group_name)
    # Only the source's payload matters: non-src ranks contribute None
    # (the rendezvous key alone synchronizes them) — no point shipping
    # world-1 full tensors that get discarded.
    payload = _to_host(tensor) if g.rank == src_rank else None
    if payload is not None:
        _guard_hub_size(_nbytes(payload), g.world, "broadcast")
    out = _call(g, "broadcast", group_name, payload, src_rank=src_rank)
    return _like(out, tensor)


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    """Reduce then return this rank's equal slice along axis 0."""
    g = _group(group_name)
    host = _to_host(tensor)
    _guard_hub_size(_nbytes(host), g.world, "reducescatter")
    out = _call(g, "allreduce", group_name, host, reduce_op=op)
    if not _is_tensor(out):
        out = np.asarray(out)
    if out.shape[0] % g.world != 0:
        raise ValueError(
            f"reducescatter needs dim0 ({out.shape[0]}) divisible by the "
            f"group size ({g.world})")
    n = out.shape[0] // g.world
    return _like(out[g.rank * n:(g.rank + 1) * n], tensor)


def barrier(group_name: str = "default") -> None:
    g = _group(group_name)
    _call(g, "barrier", group_name, None)
