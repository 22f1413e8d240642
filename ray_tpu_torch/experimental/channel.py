"""Device channels: single-writer, multi-reader rings with
acquire/release backpressure over the device transfer plane (counterpart
of ``ray_tpu/experimental/channel.py``).

Analogue of the reference's experimental mutable-object channels
(src/ray/core_worker/experimental_mutable_object_manager.h:44 — a ring of
mutable buffers with acquire/release; NCCL variants in
python/ray/experimental/channel/torch_tensor_accelerator_channel.py:49).
The plane is pull-based: the writer keeps item n in its own device table
under a key of (channel, n) and publishes that key, with the tensor's
node, device and card, to every reader (a tiny control RPC). Each reader
pulls by the route ``device_get`` takes: CUDA IPC into its own memory
within the node, host bytes for a CPU tensor or from another node, and the
writer's tensor itself when the reader is the writer. The writer blocks
once ``capacity`` items are unreleased — the same backpressure contract as
the reference's ring, without a pinned mutable buffer — and frees its copy
of an item as soon as the last reader releases it.

    ch = DeviceChannel.create([actor_a], capacity=2)   # anywhere
    # writer process:            reader process:
    ch.write(tensor)             val = ch.read()        # pull + release
    ch.write(tensor2)            val2 = ch.read()

Handles pickle freely; per-process state initializes lazily, so the same
handle object works on the writer, every reader, and the driver.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

# Per-process writer/reader state, keyed by channel id.
_writer_states: Dict[bytes, "_WriterState"] = {}
_reader_states: Dict[bytes, "_ReaderState"] = {}
_state_lock = threading.Lock()


class _WriterState:
    def __init__(self):
        self.seq = 0


class _ReaderState:
    def __init__(self):
        self.pending_release: Optional[int] = None
        self.pending_writer: Optional[tuple] = None


def _resolve_reader_addr(reader) -> tuple:
    """An actor handle -> its worker address; None -> this process."""
    from ray_tpu_torch.core.ref import ActorHandle, get_core_worker

    cw = get_core_worker()
    if reader is None:
        return tuple(cw.address)
    if isinstance(reader, ActorHandle):
        client = cw._run(
            cw._actor_client(reader.actor_id.binary())).result(30)
        return tuple(client._address)
    return tuple(reader)  # already an address


def _item_key(channel_id: bytes, seq: int) -> bytes:
    """The writer's device-table key of item ``seq``."""
    return channel_id + seq.to_bytes(8, "little")


class DeviceChannel:
    """Picklable channel handle. Exactly one process writes; each address
    in `reader_addrs` reads."""

    def __init__(self, channel_id: bytes, reader_addrs: List[tuple],
                 capacity: int):
        self.channel_id = channel_id
        self.reader_addrs = [tuple(a) for a in reader_addrs]
        self.capacity = capacity

    @staticmethod
    def create(readers: List[Any], capacity: int = 2) -> "DeviceChannel":
        """readers: actor handles (or None for the driver/this process).
        Callable from any process in the cluster."""
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        addrs = [_resolve_reader_addr(r) for r in readers]
        if not addrs:
            raise ValueError("a channel needs at least one reader")
        if len(set(addrs)) != len(addrs):
            # Acks key by reader address; duplicates would make the
            # writer's release barrier unsatisfiable (permanent timeout).
            raise ValueError("duplicate reader processes in channel")
        return DeviceChannel(os.urandom(16), addrs, capacity)

    def __reduce__(self):
        return (DeviceChannel, (self.channel_id, self.reader_addrs,
                                self.capacity))

    # ------------------------------------------------------------------
    # writer side
    # ------------------------------------------------------------------
    def write(self, value: Any, timeout: Optional[float] = 60.0) -> None:
        """Publish one tensor. Blocks (acquire) while `capacity` items are
        outstanding, until every reader releases the oldest. The writer
        holds ``value`` until the last reader releases it: do not modify
        it in place meanwhile."""
        import torch

        from ray_tpu_torch.core.ref import get_core_worker
        from ray_tpu_torch.device_objects import _node

        if not isinstance(value, torch.Tensor):
            raise TypeError(f"a device channel carries a torch.Tensor, "
                            f"not {type(value).__name__}")
        cw = get_core_worker()
        with _state_lock:
            st = _writer_states.setdefault(self.channel_id, _WriterState())
        n = st.seq + 1
        if n > self.capacity:
            # Acquire BEFORE committing the seq: a timed-out write leaves
            # the ring unchanged and is safely retryable.
            cw._run(cw.channel_wait_acks(
                self.channel_id, n - self.capacity,
                len(self.reader_addrs), timeout)).result()
        st.seq = n
        card = ""
        if value.is_cuda:
            from ray_tpu_torch.experimental.device_plane import device_uuid
            # Readers copy on streams of their own: the producer's kernels
            # must be done first.
            torch.cuda.current_stream(value.device).synchronize()
            card = device_uuid(value.device.index)
        key = _item_key(self.channel_id, n)
        cw.channel_publish(self.channel_id, n, key, value,
                           len(self.reader_addrs))
        item = {"key": key, "node": _node(cw), "device": value.device.type,
                "card": card, "shape": tuple(value.shape)}
        for reader in self.reader_addrs:
            if reader == tuple(cw.address):
                cw._run(cw.channel_notify(
                    self.channel_id, n, cw.address, item)).result(timeout)
            else:
                client = cw._client_for_worker(reader)
                cw._run(client.call(
                    "channel_notify", self.channel_id, n, cw.address,
                    item)).result(timeout)

    # ------------------------------------------------------------------
    # reader side
    # ------------------------------------------------------------------
    def read(self, timeout: Optional[float] = 60.0,
             release: bool = True) -> Any:
        """Next item (acquire): waits for the writer's publish, pulls the
        tensor, and (by default) releases the slot. A CUDA tensor lands on
        this process's card (CUDA IPC within the node), a CPU tensor on
        the CPU. Pass release=False to hold the slot until an explicit
        release() — the writer's ring stays blocked meanwhile."""
        from ray_tpu_torch import device_objects
        from ray_tpu_torch.core.ref import get_core_worker

        cw = get_core_worker()
        with _state_lock:
            rst = _reader_states.setdefault(self.channel_id,
                                            _ReaderState())
        if rst.pending_release is not None:
            self.release()
        seq, writer_addr, item = cw._run(
            cw.channel_next(self.channel_id, timeout)).result()
        if tuple(writer_addr) == tuple(cw.address):
            # CUDA IPC cannot open a handle in the process that made it.
            value = cw.get_device_object_local(item["key"])
            if value is None:
                raise KeyError(f"channel item {seq} freed on the writer")
        else:
            value = device_objects.pull(
                tuple(writer_addr), item["key"], item["node"],
                item["device"], item["card"],
                device="cpu" if item["device"] == "cpu" else None,
                timeout=60.0 if timeout is None else timeout,
                what=f"channel {self.channel_id.hex()[:8]} item {seq}")
        rst.pending_release = seq
        rst.pending_writer = writer_addr
        if release:
            self.release()
        return value

    def release(self) -> None:
        """Release the last-read slot back to the writer (idempotent)."""
        from ray_tpu_torch.core.ref import get_core_worker

        rst = _reader_states.get(self.channel_id)
        if rst is None or rst.pending_release is None:
            return
        cw = get_core_worker()
        seq, writer_addr = rst.pending_release, rst.pending_writer
        rst.pending_release = rst.pending_writer = None
        if tuple(writer_addr) == tuple(cw.address):
            cw._run(cw.channel_release(
                self.channel_id, cw.address, seq)).result(30)
        else:
            client = cw._client_for_worker(tuple(writer_addr))
            cw._run(client.call("channel_release", self.channel_id,
                                cw.address, seq)).result(30)

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Drop local channel state (both roles; idempotent). On the
        writer this frees the items no reader has released yet."""
        from ray_tpu_torch.core.ref import get_core_worker

        with _state_lock:
            _writer_states.pop(self.channel_id, None)
            _reader_states.pop(self.channel_id, None)
        try:
            get_core_worker().drop_channel(self.channel_id)
        except Exception:
            pass
