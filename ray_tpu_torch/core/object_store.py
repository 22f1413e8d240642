"""Python binding + client for the native shared-memory object store.

The node agent hosts one `LocalObjectStore` (in-process, backed by
libraytpu_torch_store.so — see ray_tpu_torch/csrc/object_store.cc, the analogue of the reference's
in-raylet plasma store, reference: src/ray/object_manager/plasma/store_runner.cc).
Workers use `StoreClient`, which performs control operations through the
agent's RPC and maps object bytes directly from tmpfs for zero-copy reads
(the reference's equivalent zero-copy path is the plasma client mmap,
reference: src/ray/object_manager/plasma/client.cc).

The native library is built on demand (first import) from the port's own
``ray_tpu_torch/csrc`` into ``ray_tpu_torch/_build/``, never at install.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import subprocess
from typing import Optional, Tuple

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.utils import get_logger

logger = get_logger("object_store")

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "_build")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libraytpu_torch_store.so")
_CSRC = os.path.join(os.path.dirname(__file__), "..", "csrc")


def _build_native() -> None:
    # Serialize concurrent builds (parallel agents/test sessions on a fresh
    # clone) so no process CDLLs a half-written .so.
    import fcntl
    os.makedirs(_NATIVE_DIR, exist_ok=True)
    with open(os.path.join(_NATIVE_DIR, ".store_build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _lib_stale():
            subprocess.run(["make", "-s"], cwd=os.path.abspath(_CSRC),
                           check=True)


def _lib_stale() -> bool:
    """Rebuild when absent or older than any csrc source (the .so is a build
    artifact, never committed — see .gitignore)."""
    if not os.path.exists(_LIB_PATH):
        return True
    built = os.path.getmtime(_LIB_PATH)
    csrc = os.path.abspath(_CSRC)
    for name in os.listdir(csrc):
        if name.endswith((".cc", ".h")) or name == "Makefile":
            if os.path.getmtime(os.path.join(csrc, name)) > built:
                return True
    return False


def _load_lib() -> ctypes.CDLL:
    if _lib_stale():
        _build_native()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.store_create.restype = ctypes.c_void_p
    lib.store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.store_destroy.argtypes = [ctypes.c_void_p]
    lib.store_create_object.restype = ctypes.c_int
    lib.store_create_object.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_int]
    lib.store_seal.restype = ctypes.c_int
    lib.store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.store_ingest_object.restype = ctypes.c_int
    lib.store_ingest_object.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_int]
    lib.store_get.restype = ctypes.c_int
    lib.store_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
    for fn in ("store_release", "store_delete", "store_contains"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.store_pin.restype = ctypes.c_int
    lib.store_pin.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    for fn in ("store_used", "store_capacity", "store_num_objects",
               "store_num_evictions"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    # Fast-path sidecar (store_server.cc).
    lib.store_server_start.restype = ctypes.c_void_p
    lib.store_server_start.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.store_server_drain.restype = ctypes.c_int
    lib.store_server_drain.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.store_server_stop.argtypes = [ctypes.c_void_p]
    lib.store_server_shm_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.store_client_connect.restype = ctypes.c_int
    lib.store_client_connect.argtypes = [ctypes.c_char_p]
    lib.store_client_request.restype = ctypes.c_int
    lib.store_client_request.argtypes = [
        ctypes.c_int, ctypes.c_uint8, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_char_p, ctypes.c_int]
    lib.store_client_send.restype = ctypes.c_int
    lib.store_client_send.argtypes = [
        ctypes.c_int, ctypes.c_uint8, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_char_p]
    lib.store_client_recv.restype = ctypes.c_int
    lib.store_client_recv.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_char_p, ctypes.c_int]
    lib.store_client_close.argtypes = [ctypes.c_int]
    # graftshm shared-memory put plane (shm_core.cc + store_server.cc).
    lib.store_client_create.restype = ctypes.c_int
    lib.store_client_create.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.store_client_seal.restype = ctypes.c_int
    lib.store_client_seal.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
    # graftcopy engine (copy_core.cc).
    lib.copy_engine_create.restype = ctypes.c_void_p
    lib.copy_engine_create.argtypes = [ctypes.c_int]
    lib.copy_engine_destroy.argtypes = [ctypes.c_void_p]
    lib.copy_engine_threads.restype = ctypes.c_int
    lib.copy_engine_threads.argtypes = [ctypes.c_void_p]
    lib.copy_write_scatter.restype = ctypes.c_int
    lib.copy_write_scatter.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.copy_linkat.restype = ctypes.c_int
    lib.copy_linkat.argtypes = [ctypes.c_int, ctypes.c_char_p]
    # graftscope flight recorder (scope_core.cc).
    lib.scope_emit.argtypes = [
        ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint16, ctypes.c_uint32,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64]
    lib.scope_enabled.restype = ctypes.c_int
    lib.scope_enabled.argtypes = []
    lib.scope_set_enabled.argtypes = [ctypes.c_int]
    lib.scope_now_ns.restype = ctypes.c_uint64
    lib.scope_now_ns.argtypes = []
    lib.scope_drain.restype = ctypes.c_int
    lib.scope_drain.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.scope_counters.restype = ctypes.c_int
    lib.scope_counters.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
    lib.scope_histograms.restype = ctypes.c_int
    lib.scope_histograms.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
    lib.scope_dropped.restype = ctypes.c_uint64
    lib.scope_dropped.argtypes = []
    # graftprof continuous profiler (prof_core.cc).
    lib.prof_register_thread.restype = ctypes.c_int
    lib.prof_register_thread.argtypes = [ctypes.c_char_p]
    lib.prof_set_gil_fns.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.prof_start.restype = ctypes.c_int
    lib.prof_start.argtypes = [ctypes.c_int]
    lib.prof_stop.argtypes = []
    lib.prof_enabled.restype = ctypes.c_int
    lib.prof_enabled.argtypes = []
    lib.prof_set_enabled.argtypes = [ctypes.c_int]
    lib.prof_drain.restype = ctypes.c_int
    lib.prof_drain.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.prof_dropped.restype = ctypes.c_uint64
    lib.prof_dropped.argtypes = []
    lib.prof_ticks.restype = ctypes.c_uint64
    lib.prof_ticks.argtypes = []
    lib.prof_thread_count.restype = ctypes.c_int
    lib.prof_thread_count.argtypes = []
    lib.prof_thread_cpu_ns.restype = ctypes.c_int
    lib.prof_thread_cpu_ns.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
    lib.prof_thread_name.restype = ctypes.c_int
    lib.prof_thread_name.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.prof_gil_wait_ns.restype = ctypes.c_uint64
    lib.prof_gil_wait_ns.argtypes = []
    lib.prof_gil_probes.restype = ctypes.c_uint64
    lib.prof_gil_probes.argtypes = []
    # graftlog crash-persistent log ring (log_core.cc).
    lib.log_ring_open.restype = ctypes.c_int
    lib.log_ring_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.log_ring_close.argtypes = []
    lib.log_emit.restype = ctypes.c_uint64
    lib.log_emit.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int]
    lib.log_emit_batch.restype = ctypes.c_uint64
    lib.log_emit_batch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int]
    lib.log_enabled.restype = ctypes.c_int
    lib.log_enabled.argtypes = []
    lib.log_set_enabled.argtypes = [ctypes.c_int]
    lib.log_drain.restype = ctypes.c_int
    lib.log_drain.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.log_emitted.restype = ctypes.c_uint64
    lib.log_emitted.argtypes = []
    lib.log_dropped.restype = ctypes.c_uint64
    lib.log_dropped.argtypes = []
    return lib


_lib: Optional[ctypes.CDLL] = None


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load_lib()
    return _lib


class ObjectStoreFullError(Exception):
    pass


class LocalObjectStore:
    """In-process handle to the native store (hosted by the node agent)."""

    def __init__(self, shm_dir: str, capacity: int):
        self._lib = _get_lib()
        self._handle = self._lib.store_create(shm_dir.encode(), capacity)
        self._dir = shm_dir

    # -- lifecycle ---------------------------------------------------------
    def create(self, oid: ObjectID, data_size: int, meta_size: int = 0) -> str:
        buf = ctypes.create_string_buffer(4096)
        rc = self._lib.store_create_object(
            self._handle, oid.binary(), data_size, meta_size, buf, 4096)
        if rc == -1:
            raise FileExistsError(f"object exists: {oid}")
        if rc == -2:
            raise ObjectStoreFullError(
                f"cannot fit {data_size + meta_size} bytes")
        if rc != 0:
            raise OSError(f"store create failed rc={rc}")
        return buf.value.decode()

    def seal(self, oid: ObjectID) -> None:
        if self._lib.store_seal(self._handle, oid.binary()) != 0:
            raise KeyError(f"seal: no such object {oid}")

    @property
    def dir(self) -> str:
        return self._dir

    def ingest(self, oid: ObjectID, src_path: str, data_size: int,
               meta_size: int = 0, pinned: bool = True) -> None:
        """Adopt a fully-written payload file as a sealed object (the
        one-RPC put path: the writer produced src_path in the store dir;
        the store accounts, evicts if needed, and renames it in under the
        store mutex). `pinned` admits it atomically as a primary copy, so
        a concurrent eviction can never take it between admission and the
        agent's pin (r4 advisor finding)."""
        rc = self._lib.store_ingest_object(
            self._handle, oid.binary(), src_path.encode(), data_size,
            meta_size, 1 if pinned else 0)
        if rc == -1:
            raise FileExistsError(f"object exists: {oid}")
        if rc == -2:
            raise ObjectStoreFullError(
                f"cannot fit {data_size + meta_size} bytes")
        if rc != 0:
            raise OSError(f"store ingest failed rc={rc}")

    def get(self, oid: ObjectID) -> Optional[Tuple[str, int, int]]:
        """Pin + return (path, data_size, meta_size), or None if absent/unsealed."""
        buf = ctypes.create_string_buffer(4096)
        ds = ctypes.c_uint64()
        ms = ctypes.c_uint64()
        rc = self._lib.store_get(self._handle, oid.binary(), buf, 4096,
                                 ctypes.byref(ds), ctypes.byref(ms))
        if rc != 0:
            return None
        return buf.value.decode(), ds.value, ms.value

    def release(self, oid: ObjectID) -> None:
        self._lib.store_release(self._handle, oid.binary())

    def delete(self, oid: ObjectID) -> None:
        self._lib.store_delete(self._handle, oid.binary())

    def contains(self, oid: ObjectID) -> int:
        """0 absent, 1 sealed, 2 present-unsealed."""
        return self._lib.store_contains(self._handle, oid.binary())

    def pin(self, oid: ObjectID, pinned: bool = True) -> None:
        self._lib.store_pin(self._handle, oid.binary(), 1 if pinned else 0)

    # -- local data-plane helpers -----------------------------------------
    def put_bytes(self, oid: ObjectID, data: bytes | memoryview,
                  meta: bytes = b"") -> None:
        path = self.create(oid, len(data), len(meta))
        total = len(data) + len(meta)
        if total:
            with open(path, "r+b") as f:
                with mmap.mmap(f.fileno(), total) as m:
                    m[:len(data)] = data
                    if meta:
                        m[len(data):] = meta
        self.seal(oid)

    # -- stats -------------------------------------------------------------
    def used(self) -> int:
        return self._lib.store_used(self._handle)

    def capacity(self) -> int:
        return self._lib.store_capacity(self._handle)

    def num_objects(self) -> int:
        return self._lib.store_num_objects(self._handle)

    def num_evictions(self) -> int:
        return self._lib.store_num_evictions(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.store_destroy(self._handle)
            self._handle = None


class StoreSidecar:
    """Agent-side handle to the native fast-path server thread
    (csrc/store_server.cc): shares the LocalObjectStore's handle, serves
    workers over a unix socket with zero event-loop work, and feeds
    lifecycle events (ingest/delete) back through `drain()` so Python
    keeps owning the object-lifecycle bookkeeping."""

    EVENT_SIZE = 30  # u8 op | u8 origin | 20B oid | u64 size

    def __init__(self, store: LocalObjectStore, sock_path: str):
        self._lib = _get_lib()
        fd = ctypes.c_int(-1)
        self._handle = self._lib.store_server_start(
            store._handle, sock_path.encode(), ctypes.byref(fd))
        if not self._handle:
            raise OSError("could not start store fast-path server")
        self.notify_fd = fd.value
        self.sock_path = sock_path
        self._buf = ctypes.create_string_buffer(self.EVENT_SIZE * 256)

    def drain(self):
        """-> [(op, origin, oid_bytes, size)] accumulated since the last
        call. ``origin`` is the wire op that caused the journal entry
        (grafttrail provenance: OP_SEAL behind an ingest means the shm
        plane, OP_DROP behind a delete means a fire-and-forget drop,
        OP_CREATE behind a delete means a staged-slab reclaim)."""
        out = []
        while True:
            n = self._lib.store_server_drain(self._handle, self._buf,
                                             len(self._buf))
            raw = self._buf.raw[:n]
            for i in range(0, n, self.EVENT_SIZE):
                rec = raw[i:i + self.EVENT_SIZE]
                out.append((rec[0],
                            int.from_bytes(rec[1:2], "little"),
                            rec[2:22],
                            int.from_bytes(rec[22:30], "little")))
            if n < len(self._buf):
                return out

    def shm_stats(self):
        """-> (free_bytes, free_slabs, reuses) of the graftshm arena."""
        if not self._handle:
            return (0, 0, 0)
        arr = (ctypes.c_uint64 * 3)()
        self._lib.store_server_shm_stats(self._handle, arr)
        return (int(arr[0]), int(arr[1]), int(arr[2]))

    def stop(self) -> None:
        if self._handle:
            self._lib.store_server_stop(self._handle)
            self._handle = None


class FastStoreClient:
    """Worker-side blocking client to the agent's fast-path sidecar: one
    persistent unix-socket connection, one C round-trip per op — no
    event loop on either side (the analogue of the reference's plasma
    client socket, reference: plasma/client.cc)."""

    OP_INGEST, OP_GET, OP_RELEASE, OP_DELETE, OP_CONTAINS = 1, 2, 3, 4, 5
    OP_PUT = 6
    OP_DROP = 7
    OP_SCOPE = 8
    OP_CREATE = 9
    OP_SEAL = 10

    def __init__(self, sock_path: str):
        import threading
        self._lib = _get_lib()
        self._sock_path = sock_path
        self._fd = self._lib.store_client_connect(sock_path.encode())
        if self._fd < 0:
            raise OSError(f"cannot connect store fast path {sock_path}")
        self._lock = threading.Lock()
        self._rc = ctypes.c_int32()
        self._ds = ctypes.c_uint64()
        self._ms = ctypes.c_uint64()
        self._path = ctypes.create_string_buffer(4096)
        # Fire-and-forget deletes (OP_DROP) not yet settled by a
        # counter-carrying reply: [(oid, callback)] in send order.
        self._drops: list = []
        self._drops_acked = 0   # cumulative server counters already
        self._erased_acked = 0  # applied (per connection)
        # The one deferred-ack OP_PUT whose reply has not been read yet:
        # (oid, callback) or None. Depth capped at 1 — every other op
        # drains it first, so the reply stream can never interleave.
        self._pending_put: Optional[tuple] = None

    def _fail_locked(self) -> None:
        # NEVER reuse a desynced connection: a partial write/read would
        # make the next op parse this op's stale reply. In-flight drops
        # settle conservatively (rc 1: outcome unknown); a pending
        # deferred put settles as -4 (connection lost, outcome unknown
        # — the caller repairs through the agent path).
        self._lib.store_client_close(self._fd)
        self._fd = -1
        self._expire_drops_locked()
        raise OSError("store fast path connection lost")

    def _reconnect_locked(self) -> None:
        self._fd = self._lib.store_client_connect(self._sock_path.encode())
        if self._fd < 0:
            raise OSError("store fast path unreachable")
        # Drop counters are per-connection on the server: start clean.
        self._expire_drops_locked()

    def _drain_pending_locked(self) -> None:
        """Collect the deferred put's reply before any other wire use.
        Called at the top of EVERY op that touches the socket, so the
        request/reply streams stay in lockstep (a CREATE's SCM_RIGHTS
        fd, for instance, must never follow a stale queued reply)."""
        if self._pending_put is None:
            return
        oid, cb = self._pending_put
        ok = self._lib.store_client_recv(
            self._fd, ctypes.byref(self._rc), ctypes.byref(self._ds),
            ctypes.byref(self._ms), self._path, 4096)
        if ok != 0:
            self._fail_locked()
        self._pending_put = None
        # An OP_PUT reply carries the connection's cumulative drop
        # counters, exactly like the synchronous put.
        self._settle_drops_locked(self._ds.value, self._ms.value)
        if cb is not None:
            cb(oid, self._rc.value)

    def _expire_drops_locked(self) -> None:
        drops, self._drops = self._drops, []
        self._drops_acked = 0
        self._erased_acked = 0
        for oid, cb in drops:
            if cb is not None:
                cb(oid, 1)
        pending, self._pending_put = self._pending_put, None
        if pending is not None and pending[1] is not None:
            pending[1](pending[0], -4)

    def _settle_drops_locked(self, seen: int, erased: int) -> None:
        """Apply the cumulative drop counters a PUT/CONTAINS reply
        carried: the oldest (seen - acked) in-flight drops are settled.
        Counters are monotonic per connection, so a reply applied out of
        order (two threads racing past _req) is a harmless no-op."""
        n = seen - self._drops_acked
        if n <= 0:
            return
        batch = self._drops[:n]
        del self._drops[:n]
        # rc 0 only when EVERY drop in the batch erased immediately —
        # batch-wide because the counters don't say which ones. The put
        # plane sends one drop per put, so batches are length 1 there.
        all_erased = (erased - self._erased_acked) == n
        self._drops_acked = seen
        self._erased_acked = erased
        for oid, cb in batch:
            if cb is not None:
                cb(oid, 0 if all_erased else 1)

    def _settle_drops(self, seen: int, erased: int) -> None:
        if seen == 0 and not self._drops:
            return
        with self._lock:
            self._settle_drops_locked(seen, erased)

    def _req(self, op: int, oid: bytes, a: int = 0, b: int = 0,
             name: Optional[bytes] = None) -> Tuple[int, int, int, str]:
        with self._lock:
            if self._fd < 0:  # previous transport error: reconnect once
                self._reconnect_locked()
            self._drain_pending_locked()
            ok = self._lib.store_client_request(
                self._fd, op, oid, a, b, name, ctypes.byref(self._rc),
                ctypes.byref(self._ds), ctypes.byref(self._ms),
                self._path, 4096)
            if ok != 0:
                self._fail_locked()
            return (self._rc.value, self._ds.value, self._ms.value,
                    self._path.value.decode())

    def ingest(self, oid: bytes, name: str, data_size: int,
               meta_size: int) -> int:
        rc, _, _, _ = self._req(self.OP_INGEST, oid, data_size, meta_size,
                                name.encode())
        return rc

    def put(self, oid: bytes, name: str, data_size: int,
            meta_size: int) -> int:
        """Fused graftcopy put: adopt the 'put-<oid hex>' staging file as
        a sealed pinned object in one round-trip (OP_PUT; same admission
        as ingest, oid-derived staging names). The reply's ds/ms carry
        the connection's cumulative drop counters; settle them here."""
        rc, ds, ms, _ = self._req(self.OP_PUT, oid, data_size, meta_size,
                                  name.encode())
        self._settle_drops(ds, ms)
        return rc

    def put_deferred(self, oid: bytes, name: str, data_size: int,
                     meta_size: int, cb=None) -> None:
        """Deferred-ack graftcopy put: send the OP_PUT frame and return
        without reading the reply. The server processes requests in
        order on this connection, so the object is visible to every
        later op the moment the sidecar reads the frame — only the
        caller's ack is deferred. The reply (rc + cumulative drop
        counters) is collected by the NEXT client op, which calls
        `cb(oid, rc)` under the client lock (keep it trivial, never
        call back into this client): rc 0 adopted, -1 already stored
        (idempotent success; the caller unlinks its staging file),
        -2/-3 store full / io error (the caller must re-put through a
        spill-capable path), -4 connection lost before the ack (outcome
        unknown; re-put is idempotent either way). At most ONE put is
        in flight — a second put_deferred drains the first."""
        with self._lock:
            if self._fd < 0:
                self._reconnect_locked()
            self._drain_pending_locked()
            # lint: allow(reply-path: deferred ack — the pending-put reply is read by _drain_pending_locked before any later recv, so the stream stays in sync)
            ok = self._lib.store_client_send(
                self._fd, self.OP_PUT, oid, data_size, meta_size,
                name.encode())
            if ok != 0:
                self._fail_locked()
            self._pending_put = (oid, cb)

    def poll_pending(self) -> None:
        """Collect a still-outstanding deferred-put reply, if any.
        Called from the event loop after a put burst so the last ack
        of the burst settles without waiting for the next client op."""
        with self._lock:
            if self._pending_put is not None and self._fd >= 0:
                self._drain_pending_locked()

    def create(self, oid: bytes, data_size: int,
               meta_size: int) -> Tuple[int, str, int, int]:
        """graftshm CREATE: ask the sidecar for a store-owned slab and
        receive its fd over SCM_RIGHTS -> (rc, slab_path, slab_fd,
        reused). rc 0: slab_fd is an open writable descriptor the caller
        maps and serializes into (caller owns it; close after mapping),
        and `reused` is 1 when the slab's pages are warm (recycled). rc
        -1 object exists (idempotent-put case), -2 cannot fit (fall back
        to the graftcopy path whose admission can evict/spill), -3 io
        error; slab_fd is -1 for every nonzero rc."""
        with self._lock:
            if self._fd < 0:
                self._reconnect_locked()
            self._drain_pending_locked()
            slab_fd = ctypes.c_int(-1)
            reused = ctypes.c_uint64()
            ok = self._lib.store_client_create(
                self._fd, oid, data_size, meta_size,
                ctypes.byref(self._rc), ctypes.byref(reused),
                self._path, 4096, ctypes.byref(slab_fd))
            if ok != 0:
                self._fail_locked()
            return (self._rc.value, self._path.value.decode(),
                    slab_fd.value, int(reused.value))

    def seal(self, oid: bytes) -> int:
        """graftshm SEAL: publish a CREATEd object (staged -> sealed,
        pinned primary; journaled like a put so the agent's bookkeeping
        is op-agnostic). The reply's ds/ms carry the connection's
        cumulative drop counters, like PUT. 0 ok, -1 missing or already
        sealed."""
        rc, ds, ms, _ = self._req(self.OP_SEAL, oid)
        self._settle_drops(ds, ms)
        return rc

    def get(self, oid: bytes) -> Optional[Tuple[str, int, int]]:
        rc, ds, ms, path = self._req(self.OP_GET, oid)
        if rc != 0:
            return None
        return path, ds, ms

    def release(self, oid: bytes) -> None:
        self._req(self.OP_RELEASE, oid)

    def delete(self, oid: bytes) -> int:
        """0 erased now, 1 deferred behind live readers, -1 missing."""
        return self._req(self.OP_DELETE, oid)[0]

    def drop_async(self, oid: bytes, cb=None) -> None:
        """Fire-and-forget delete (OP_DROP): the sidecar processes and
        journals it like OP_DELETE but writes NO reply, so a put/drop
        loop costs one context-switch cycle per iteration — a replied
        delete wakes this process mid-pipeline and preempts the sidecar
        before it reaches the put. `cb(oid, rc)` fires when a later
        PUT/CONTAINS reply settles the drop (under the client lock:
        keep it trivial, never call back into this client). rc 0 means
        erased immediately (the staging inode's pages are reclaimable);
        rc 1 means deferred or unknown (connection loss settles all
        in-flight drops as 1)."""
        with self._lock:
            if self._fd < 0:
                self._reconnect_locked()
            self._drain_pending_locked()
            if len(self._drops) >= 64:
                # Runaway guard (a caller that drops but never puts):
                # one replied CONTAINS settles the backlog. The put
                # plane interleaves drops and puts 1:1, so this is the
                # pathological path only.
                ok = self._lib.store_client_request(
                    self._fd, self.OP_CONTAINS, oid, 0, 0, None,
                    ctypes.byref(self._rc), ctypes.byref(self._ds),
                    ctypes.byref(self._ms), self._path, 4096)
                if ok != 0:
                    self._fail_locked()
                self._settle_drops_locked(self._ds.value, self._ms.value)
            ok = self._lib.store_client_send(
                self._fd, self.OP_DROP, oid, 0, 0, None)
            if ok != 0:
                self._fail_locked()
            self._drops.append((oid, cb))

    def contains(self, oid: bytes) -> int:
        rc, ds, ms, _ = self._req(self.OP_CONTAINS, oid)
        self._settle_drops(ds, ms)
        return rc

    def scope_drain(self) -> Tuple[bytes, int, bool]:
        """Drain the SIDECAR process's graftscope rings over the wire
        (OP_SCOPE): -> (records, dropped_total, enabled). Records are
        whole 24-byte graftscope wire records; decode with
        ray_tpu_torch.core._native.graftscope. Touches no store state, so a
        scope reader never contends with the object data plane. The
        reply is binary — bypasses `_req`'s NUL-terminated path decode."""
        with self._lock:
            if self._fd < 0:
                self._reconnect_locked()
            self._drain_pending_locked()
            ok = self._lib.store_client_request(
                self._fd, self.OP_SCOPE, b"\x00" * 20, 0, 0, None,
                ctypes.byref(self._rc), ctypes.byref(self._ds),
                ctypes.byref(self._ms), self._path, 4096)
            if ok != 0:
                self._fail_locked()
            n = max(0, self._rc.value)
            return self._path.raw[:n], self._ds.value, bool(self._ms.value)

    def close(self) -> None:
        with self._lock:
            if self._fd >= 0:
                self._lib.store_client_close(self._fd)
                self._fd = -1
            # In-flight drops and a pending deferred put settle
            # conservatively (1 / -4): the process is letting go of the
            # connection, their outcomes are unknowable.
            self._expire_drops_locked()
            self._fd = -1


class MappedObject:
    """A zero-copy view of a sealed object; releases the pin on close.

    ``data``/``meta`` are memoryviews into the shared mapping — valid until
    close(). Consumers that need the bytes past close() must copy.
    """

    def __init__(self, path: str, data_size: int, meta_size: int,
                 release_cb=None):
        self._release_cb = release_cb
        total = data_size + meta_size
        if total == 0:
            self._mm = None
            self.data = memoryview(b"")
            self.meta = memoryview(b"")
        else:
            with open(path, "rb") as f:
                self._mm = mmap.mmap(f.fileno(), total, prot=mmap.PROT_READ)
            view = memoryview(self._mm)
            self.data = view[:data_size]
            self.meta = view[data_size:total]

    def close(self) -> None:
        self.data.release()
        self.meta.release()
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._release_cb:
            self._release_cb()
            self._release_cb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
