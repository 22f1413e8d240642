"""The per-process device-transfer plane: CUDA IPC within a node
(counterpart of ``ray_tpu/experimental/device_plane.py``).

The JAX package moves arrays between processes through the PJRT transfer
server. Here a CUDA tensor moves between two processes of one node by CUDA
IPC, with no host copy:

  * the owner stages the tensor (``stage``): torch's CUDA IPC reduction
    (``torch.multiprocessing.reductions.reduce_tensor``) gives the handle
    of the caching allocator's block that holds it, the tensor's offset in
    that block, an interprocess event recorded on the owner's stream, and
    a reference counter in shared memory. Only that small tuple crosses the
    control plane (``device_pull_info``);
  * the puller (``pull``) maps the block, waits on the event, copies the
    tensor into its own allocation on a copy stream of its own (so the
    copy does not queue behind the puller's other work, a decode loop's
    chunks on the default stream), synchronizes that stream, and drops
    the mapping. The owner keeps its tensor until ``free_ref`` (or
    the last reference) drops it, after the copy is done; torch's counter
    keeps the block out of the owner's allocator until every mapping of it
    is gone.

A tensor moves by CUDA IPC only when its owner is on this node and it lies
on a card this process sees. The route is chosen before anything is staged
(``choose_route``): a CPU tensor, one whose owner is on another node (CUDA
IPC cannot cross hosts), or one on a card this process does not see (a
replica pinned to another card) goes as host bytes through the owner's
``fetch_device_object``, the JAX package's cross-slice relay with the node
in the slice's place. A
failed IPC pull raises: there is no fallback to host bytes. Every pull is
counted by route (``DevicePlane.pulls_by_route``) and every host relay by
its reason (``relays_by_reason``), so a run can show which plane moved
each tensor. One ``DevicePlane`` per process, made on first use.
"""

from __future__ import annotations

import inspect
import threading
import time
from typing import Dict, Optional, Tuple

import torch

ROUTE_IPC = "cuda_ipc"
ROUTE_HOST = "host_relay"
# Why a pull went as host bytes
RELAY_OTHER_NODE = "other_node"
RELAY_CPU_TENSOR = "cpu_tensor"
RELAY_CARD_NOT_VISIBLE = "card_not_visible"

_lock = threading.Lock()
_instance: Optional["DevicePlane"] = None


def choose_route(owner_node: str, local_node: str, device_type: str,
                 card_visible: bool) -> Tuple[str, str]:
    """(route, reason) for a pull of a tensor on ``device_type`` ("cuda" or
    "cpu") owned on ``owner_node`` into a process on ``local_node`` that
    sees (``card_visible``) the owner's card or not: CUDA IPC for a CUDA
    tensor of this node on a card seen here, else the host relay."""
    if owner_node != local_node:
        return ROUTE_HOST, RELAY_OTHER_NODE
    if device_type != "cuda":
        return ROUTE_HOST, RELAY_CPU_TENSOR
    if not card_visible:
        return ROUTE_HOST, RELAY_CARD_NOT_VISIBLE
    return ROUTE_IPC, "same_node"


def device_uuid(index: int) -> str:
    """The UUID of this process's card ``index``: the same card has the
    same UUID in every process, whatever its index there."""
    return str(torch.cuda.get_device_properties(index).uuid)


def local_index(uuid: str) -> Optional[int]:
    """This process's index of the card ``uuid``; None if not visible."""
    for i in range(torch.cuda.device_count()):
        if device_uuid(i) == uuid:
            return i
    return None


class DevicePlane:
    """Stages this process's CUDA tensors for CUDA IPC pulls and pulls
    other processes' tensors; counts both."""

    def __init__(self):
        from torch.multiprocessing import reductions

        self._reductions = reductions
        # Where the owner's device index sits in the rebuild arguments: the
        # puller puts its own index of the same card there (the two
        # processes may number their visible cards differently).
        self._dev_arg = list(inspect.signature(
            reductions.rebuild_cuda_tensor).parameters).index(
                "storage_device")
        self._count_lock = threading.Lock()
        self.staged = 0
        self.pulls = 0
        self.pulls_by_route: Dict[str, int] = {ROUTE_IPC: 0, ROUTE_HOST: 0}
        self.relays_by_reason: Dict[str, int] = {
            RELAY_OTHER_NODE: 0, RELAY_CPU_TENSOR: 0,
            RELAY_CARD_NOT_VISIBLE: 0}
        self.bytes_by_route: Dict[str, int] = {ROUTE_IPC: 0, ROUTE_HOST: 0}
        # Wall seconds inside pulls, from the request to the copy done
        self.seconds_by_route: Dict[str, float] = {ROUTE_IPC: 0.0,
                                                   ROUTE_HOST: 0.0}
        self._streams: Dict[int, torch.cuda.Stream] = {}

    @staticmethod
    def get() -> "DevicePlane":
        global _instance
        with _lock:
            if _instance is None:
                _instance = DevicePlane()
            return _instance

    @staticmethod
    def maybe() -> Optional["DevicePlane"]:
        """The plane if it was ever started in this process."""
        return _instance

    def stats(self) -> dict:
        with self._count_lock:
            return dict(staged=self.staged, pulls=self.pulls,
                        pulls_by_route=dict(self.pulls_by_route),
                        relays_by_reason=dict(self.relays_by_reason),
                        bytes_by_route=dict(self.bytes_by_route),
                        seconds_by_route=dict(self.seconds_by_route))

    def _stream(self, dev: int) -> torch.cuda.Stream:
        """This plane's own stream on card ``dev``."""
        with self._count_lock:
            side = self._streams.get(dev)
            if side is None:
                side = self._streams[dev] = torch.cuda.Stream(dev)
            return side

    # ------------------------------------------------------------------
    def stage(self, tensor: torch.Tensor) -> dict:
        """Owner side: make ``tensor`` pullable by one peer of this node;
        returns the control-plane descriptor. Raises for a CPU tensor (the
        route sends those as host bytes, never here)."""
        if not isinstance(tensor, torch.Tensor) or not tensor.is_cuda:
            raise ValueError("only a CUDA tensor is staged for CUDA IPC, "
                             f"got {type(tensor).__name__} on "
                             f"{getattr(tensor, 'device', None)}")
        # The IPC event is recorded on an idle stream: device_put_ref has
        # synchronized the tensor's producer, and an event on the default
        # stream would make the puller wait for the owner's later work too.
        with torch.cuda.device(tensor.device), \
                torch.cuda.stream(self._stream(tensor.device.index)):
            _, args = self._reductions.reduce_tensor(tensor.detach())
        with self._count_lock:
            self.staged += 1
        return {"uuid": device_uuid(tensor.device.index), "args": args,
                "nbytes": tensor.numel() * tensor.element_size()}

    def pull(self, desc: dict, t0: float) -> torch.Tensor:
        """Puller side: map the owner's block, copy the tensor into this
        process's own allocation, synchronize, and drop the mapping.
        ``t0``: ``time.perf_counter()`` when the pull was asked for."""
        dev = local_index(desc["uuid"])
        if dev is None:
            raise RuntimeError(f"the card {desc['uuid']} that holds the "
                               f"device object is not visible here")
        args = list(desc["args"])
        args[self._dev_arg] = dev
        side = self._stream(dev)
        caller = torch.cuda.current_stream(dev)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            # The rebuild makes this stream wait on the owner's event.
            mapped = self._reductions.rebuild_cuda_tensor(*args)
            out = mapped.clone()
            side.synchronize()
        del mapped  # the mapping closes with its last storage
        # ``out`` was allocated on the copy stream and is used on the
        # caller's: its block must not be reused before that work is done.
        out.record_stream(caller)
        self.count(ROUTE_IPC, desc["nbytes"], t0)
        return out

    def count(self, route: str, nbytes: int, t0: float,
              reason: str = "") -> None:
        """One pull done, asked for at ``t0`` (``time.perf_counter()``)."""
        seconds = time.perf_counter() - t0
        with self._count_lock:
            self.pulls += 1
            self.pulls_by_route[route] += 1
            self.bytes_by_route[route] += int(nbytes)
            self.seconds_by_route[route] += seconds
            if reason:
                self.relays_by_reason[reason] += 1
