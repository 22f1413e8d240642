"""Device-resident object refs: tensors that stay in their owner's device
memory (counterpart of ``ray_tpu/device_objects.py``).

Analogue of the reference's Ray Direct Transport (reference:
python/ray/experimental/gpu_object_manager/gpu_object_manager.py:61
GPUObjectManager — the ObjectRef travels the control plane, the tensor
stays in device memory on its owner and moves out-of-band on demand):

    ref = device_put_ref(tensor)       # stays in this process's memory
    # ... ship `ref` through actor calls / task args (tiny metadata) ...
    t = device_get(ref)                # a copy in the caller's memory

Ownership rides the ObjectRef protocol: a DeviceRef wraps a real
ObjectRef, so serializing it inside values registers borrows, and the
owner's tensor is dropped when the last reference anywhere drops
(core_worker frees the device twin with the ledger entry). free_ref()
remains as an explicit early free.

Between two processes of one node a CUDA tensor moves by CUDA IPC
(``experimental/device_plane.py``); a CPU tensor, or a tensor whose owner
is on another node, moves as host bytes through the owner's
``fetch_device_object``. The route is chosen from the owner's node and the
tensor's device before anything is staged, and a failed IPC pull raises.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.ref import ObjectRef, get_core_worker
from ray_tpu_torch.device import DeviceLike, resolve_device


class DeviceRef:
    """Handle to a tensor resident in its owner process's memory.

    Wraps an ObjectRef (`.ref`) so reference counting, borrows, and
    owner-death cleanup work exactly like host objects. Carries the
    owner's node id, the tensor's device type ("cuda" or "cpu") and its
    card's UUID, from which a reader picks the route: CUDA IPC for a CUDA
    tensor of its own node on a card it sees, host bytes otherwise."""

    __slots__ = ("ref", "shape", "dtype", "node", "device", "card")

    def __init__(self, ref: ObjectRef, shape, dtype: str, node: str = "",
                 device: str = "cpu", card: str = ""):
        self.ref = ref
        self.shape = tuple(shape)
        self.dtype = dtype
        self.node = node
        self.device = device
        self.card = card

    @property
    def owner_addr(self):
        return self.ref.owner_addr

    @property
    def key(self) -> bytes:
        return self.ref.binary()

    def __reduce__(self):
        # Pickling recurses into self.ref -> ObjectRef.__reduce__ ->
        # note_contained_ref: borrower accounting comes for free.
        return (DeviceRef, (self.ref, self.shape, self.dtype, self.node,
                            self.device, self.card))

    def __repr__(self):
        return (f"DeviceRef({self.ref.hex()[:12]}, shape={self.shape}, "
                f"dtype={self.dtype}, device={self.device}, "
                f"owner={self.owner_addr}, node={self.node[:12]!r})")


def _node(cw) -> str:
    return cw.node_id.hex() if cw.node_id else ""


def device_put_ref(tensor: torch.Tensor) -> DeviceRef:
    """Register a tensor as resident in THIS process; the returned ref is
    cheap to pass around the cluster and drops the tensor when the last
    copy drops. A CUDA tensor's producing kernels are finished before this
    returns, so a puller on another stream reads what they wrote."""
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"device_put_ref takes a torch.Tensor, not "
                        f"{type(tensor).__name__}")
    card = ""
    if tensor.is_cuda:
        from ray_tpu_torch.experimental.device_plane import device_uuid
        torch.cuda.current_stream(tensor.device).synchronize()
        card = device_uuid(tensor.device.index)
    cw = get_core_worker()
    oid = ObjectID.from_put()
    ref = ObjectRef(oid, cw.address)
    cw.add_local_ref(ref)
    cw.put_device_object(oid.binary(), tensor)
    # Ledger entry: a tiny READY marker so get/wait/refcount see a normal
    # owned object; the tensor itself lives in the device table. Registered
    # synchronously (callable from exec threads AND async actor methods
    # running on the io loop).
    from ray_tpu_torch.core import serialization
    sv = serialization.serialize({"__device_marker__": True})
    cw.put_inline_marker(oid.binary(), sv)
    return DeviceRef(ref, tensor.shape, str(tensor.dtype).replace(
        "torch.", ""), node=_node(cw), device=tensor.device.type, card=card)


def device_get(ref: DeviceRef, *, device: DeviceLike = None,
               timeout: float = 120.0) -> torch.Tensor:
    """Materialize the tensor in this process. Same process: the owner's
    tensor itself (moved to ``device`` when one is given). Another process
    of the owner's node that sees its card, CUDA tensor: a CUDA IPC pull
    into this process's own memory on that card. Otherwise host bytes from
    the owner, put on ``device``: ``None`` is the card, as the reference's
    ``jax.device_put`` puts them on the default accelerator, and raises
    without one; pass ``device="cpu"`` to keep them on the CPU."""
    cw = get_core_worker()
    if ref.owner_addr is None or tuple(ref.owner_addr) == cw.address:
        # CUDA IPC cannot open a handle in the process that made it.
        local = cw.get_device_object_local(ref.key)
        if local is None:
            raise KeyError(f"device object freed: {ref}")
        return local if device is None else local.to(resolve_device(device))
    return pull(tuple(ref.owner_addr), ref.key, ref.node, ref.device,
                ref.card, device=device, timeout=timeout, what=repr(ref))


def pull(owner_addr, key: bytes, node: str, device_type: str, card: str, *,
         device: DeviceLike = None, timeout: float = 120.0,
         wait_s: float = 0.0, what: str = "") -> torch.Tensor:
    """Pull the device object ``key`` held by the process at
    ``owner_addr`` (another process), whose tensor lies on
    ``device_type`` ("cuda" or "cpu") on the card ``card`` of the node
    ``node``, by the route ``choose_route`` picks: CUDA IPC into this
    process's memory on that card, else host bytes put on ``device``
    (``None``: the card). ``wait_s`` > 0 waits that long at the owner for
    the key to be registered (a rendezvous). Raises ``KeyError`` when the
    owner no longer holds it; a failed IPC pull raises, with no fallback.
    Device channels and the DAG's allreduce pull through here too."""
    from ray_tpu_torch.experimental.device_plane import (ROUTE_HOST,
                                                         ROUTE_IPC,
                                                         DevicePlane,
                                                         choose_route,
                                                         local_index)

    cw = get_core_worker()
    client = cw._client_for_worker(tuple(owner_addr))
    # Decided BEFORE device_pull_info: staging ties up the owner's block.
    same_node_cuda = node == _node(cw) and device_type == "cuda"
    route, reason = choose_route(
        node, _node(cw), device_type,
        same_node_cuda and torch.cuda.is_available()
        and local_index(card) is not None)
    plane = DevicePlane.get()
    t0 = time.perf_counter()
    if route == ROUTE_IPC:
        desc = cw._run(client.call("device_pull_info", key,
                                   wait_s=wait_s)).result(timeout + wait_s)
        if desc is None:
            raise KeyError(f"device object freed on owner: {what}")
        out = plane.pull(desc, t0)
        return out if device is None else out.to(resolve_device(device))
    dev = resolve_device(device)  # before the fetch: raises without a card
    got = cw._run(client.call("fetch_device_object", key,
                              wait_s=wait_s)).result(timeout + wait_s)
    if got is None:
        raise KeyError(f"device object freed on owner: {what}")
    host = got[0]
    out = host.to(dev)
    plane.count(ROUTE_HOST, host.numel() * host.element_size(), t0, reason)
    return out


def device_ingest(ref: ObjectRef, *, device: DeviceLike = None) -> Any:
    """Host-store object -> device, WITHOUT materializing intermediate
    host bytes.

    ``get(ref)`` on the graftshm plane already yields numpy arrays that
    are zero-copy READ-ONLY views into the store's shared mapping
    (pickle-5 out-of-band buffers over the sealed slab). The missing leg
    is handing those views to torch: numpy refuses ``__dlpack__`` on
    read-only arrays, so each array leaf is wrapped in a hand-rolled
    DLPack capsule (graftshm.DLPackExporter) and ingested with
    ``torch.from_dlpack`` (a CPU tensor over the mapped pages, no copy),
    then copied to ``device`` (``None``: the card; ``"cpu"`` keeps the
    zero-copy view, which pins the mapping while it lives).

    Leaves of dicts, lists and tuples are converted; other leaves pass
    through. Arrays whose dtype or layout has no DLPack mapping are copied
    into a tensor instead, and arrays torch cannot hold (object dtype)
    stay host-side untouched."""
    import numpy as np

    from ray_tpu_torch import api
    from ray_tpu_torch.core._native.graftshm import DLPackExporter

    dev = resolve_device(device)
    value = api.get(ref)

    def leaf(x):
        if not isinstance(x, np.ndarray):
            return x
        try:
            t = torch.from_dlpack(DLPackExporter(x))
        except (TypeError, ValueError, RuntimeError, BufferError):
            try:
                t = torch.from_numpy(np.ascontiguousarray(x))
            except TypeError:
                return x
        return t if dev.type == "cpu" else t.to(dev)

    def walk(v):
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(walk(x) for x in v)
        return leaf(v)

    return walk(value)


def free_ref(ref: DeviceRef) -> None:
    """Explicitly drop the owner's tensor now (idempotent). The ledger
    entry still follows normal refcounting."""
    cw = get_core_worker()
    if ref.owner_addr is None or tuple(ref.owner_addr) == cw.address:
        cw.free_device_object(ref.key)
        return
    client = cw._client_for_worker(tuple(ref.owner_addr))
    try:
        cw._run(client.call("free_device_object_remote",
                            ref.key)).result(30)
    except Exception:
        pass
