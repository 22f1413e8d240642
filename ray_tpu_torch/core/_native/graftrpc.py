"""graftrpc: Python seam over the native dispatch-plane reactor.

The actor-call hot path rides this instead of the asyncio RpcServer
(which stays the control plane — registration, discovery, long-polls).
csrc/rpc_core.cc moves length-prefixed frames between co-located
workers with per-connection write coalescing and batched wakeups; this
module gives it a Python face:

  * ``GraftEndpoint`` — one per CoreWorker: a listening unix socket plus
    outbound connections, all multiplexed through one notify fd that the
    asyncio loop watches. A burst of inbound frames costs the loop ONE
    reader callback.
  * ``GraftChannel`` — the caller side of one connection: seq-matched
    request futures plus the intern table for the compact TaskSpec
    encoding.
  * the compact binary TaskSpec codec — steady-state actor calls
    (``a.ping.remote()`` in a loop) serialize a fixed header + interned
    template id + arg blob, ~tens of bytes, instead of re-pickling the
    full spec every call. Anything unusual (refs, kwargs, tracing,
    placement, retries in flight) falls back to pickle per spec, so the
    fast encoding never changes semantics.

Wire contract (cross-checked against csrc/rpc_core.cc by the lint
wire-schema pass — keep the constants below in sync field by field):

  frame  : u32 len | header | payload         (len = header + payload)
  header : u8 op | u8 flags | u16 chan | u64 seq   (FRAME_HEADER_SIZE)

The reactor never interprets payloads; every byte past the header is
defined here.
"""

from __future__ import annotations

import asyncio
import ctypes
import dataclasses
import pickle
import struct
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch.core.rpc import RpcConnectionLost
from ray_tpu_torch.utils import get_logger

logger = get_logger("graftrpc")

# --- wire constants (lint-checked against csrc/rpc_core.cc) ---------------

OP_CALL = 1     # task batch: caller -> executor
OP_REPLY = 2    # per-batch reply, seq echoes the CALL frame
OP_INTERN = 3   # registers a TaskSpec template for the compact encoding
OP_PING = 4     # liveness probe (reserved)
OP_GOAWAY = 5   # orderly shutdown (reserved)

# Header layout: field name -> byte width, in wire order.
FRAME_HEADER_FIELDS = (
    ("op", 1),
    ("flags", 1),
    ("chan", 2),
    ("seq", 8),
)
FRAME_HEADER = struct.Struct("<BBHQ")
FRAME_HEADER_SIZE = 12

MAX_FRAME = 64 << 20  # mirror of the reactor's per-frame sanity cap

# Frame-level flags.
FLAG_ERR = 0x01        # REPLY: payload is a pickled whole-batch error

# Compact-record flags (inside a CALL payload).
REC_ARGS_PICKLED = 0x01   # args didn't fit the positional-value encoding
REC_TRACE = 0x02          # explicit (trace_id, parent_span) follows

_CLOSED_LEN = 0xFFFFFFFF  # drain record marker: connection closed

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_REC_FIXED = struct.Struct("<IB16sQB")  # intern_id|flags|task_id|seqno|nret


class GraftError(Exception):
    """Dispatch-plane failure after a frame may have been delivered."""


class GraftSendError(GraftError):
    """The frame was never written — safe to fall back to the asyncio
    path within the same attempt (no double-execution risk)."""


# --- library loading ------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rpc_core_start.restype = ctypes.c_void_p
    lib.rpc_core_start.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int)]
    lib.rpc_core_connect.restype = ctypes.c_int
    lib.rpc_core_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rpc_core_send.restype = ctypes.c_int
    lib.rpc_core_send.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                  ctypes.c_char_p, ctypes.c_uint32]
    lib.rpc_core_drain.restype = ctypes.c_int
    lib.rpc_core_drain.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.rpc_core_close_conn.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.rpc_core_stop.argtypes = [ctypes.c_void_p]
    return lib


def _get_lib() -> ctypes.CDLL:
    """The same shared library the store sidecar loads (rpc_core.cc is
    linked into libraytpu_torch_store.so); bound lazily and only once."""
    global _lib, _lib_failed
    if _lib is None:
        if _lib_failed:
            raise GraftError("native library unavailable")
        try:
            from ray_tpu_torch.core import object_store
            _lib = _bind(object_store._get_lib())
        except Exception as e:
            _lib_failed = True
            raise GraftError(f"native library unavailable: {e!r}") from e
    return _lib


def available() -> bool:
    """True when the native reactor can be used in this process. False
    (never raises) when the .so can't be built/loaded — callers fall
    back to the pure-Python asyncio dispatch path."""
    try:
        _get_lib()
        return True
    except Exception:
        return False


# --- endpoint -------------------------------------------------------------

class GraftEndpoint:
    """One process's face on the dispatch plane. All methods must be
    called from the owning event loop's thread (the reactor itself is
    free-threaded C; this seam is deliberately loop-affine so `close`
    can never race a send)."""

    def __init__(self, loop: asyncio.AbstractEventLoop,
                 listen_path: Optional[str] = None):
        self._lib = _get_lib()
        self._loop = loop
        self.listen_path = listen_path or ""
        notify = ctypes.c_int(-1)
        path = listen_path.encode() if listen_path else None
        self._handle = self._lib.rpc_core_start(path, ctypes.byref(notify))
        if not self._handle:
            raise GraftError(f"rpc_core_start failed ({listen_path!r})")
        self._notify_fd = notify.value
        self._dbuf = ctypes.create_string_buffer(1 << 18)
        self.closed = False
        # Wire these before traffic arrives: frame(conn, op, flags, chan,
        # seq, payload) and close(conn).
        self.on_frame: Optional[Callable] = None
        self.on_close: Optional[Callable] = None
        loop.add_reader(self._notify_fd, self._drain)

    def connect(self, path: str) -> int:
        conn = self._lib.rpc_core_connect(self._handle, path.encode())
        if conn < 0:
            raise GraftError(f"connect failed: {path}")
        return conn

    def send(self, conn: int, op: int, seq: int, payload: bytes,
             flags: int = 0, chan: int = 0) -> bool:
        """Frame and send; False means the frame was NOT written (dead or
        unknown connection) — callers may safely retry elsewhere."""
        if self.closed:
            return False
        data = FRAME_HEADER.pack(op, flags, chan, seq) + payload
        return self._lib.rpc_core_send(self._handle, conn, data,
                                       len(data)) == 0

    def close_conn(self, conn: int) -> None:
        if not self.closed:
            self._lib.rpc_core_close_conn(self._handle, conn)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self._loop.remove_reader(self._notify_fd)
        except Exception:
            pass
        self._lib.rpc_core_stop(self._handle)
        self._handle = None

    # -- inbound ----------------------------------------------------------

    def _drain(self) -> None:
        """Notify-fd reader: pull every pending record out of the reactor
        inbox in one pass (the C side signalled once for the burst)."""
        if self.closed:
            return
        while True:
            n = self._lib.rpc_core_drain(self._handle, self._dbuf,
                                         len(self._dbuf))
            if n < 0:  # first record exceeds the buffer: grow and retry
                self._dbuf = ctypes.create_string_buffer(-n)
                continue
            if n == 0:
                return
            view = memoryview(self._dbuf)[:n]
            off = 0
            while off < n:
                conn, length = _U32.unpack_from(view, off)[0], \
                    _U32.unpack_from(view, off + 4)[0]
                off += 8
                if length == _CLOSED_LEN:
                    if self.on_close is not None:
                        self.on_close(conn)
                    continue
                frame = view[off:off + length]
                off += length
                op, flags, chan, seq = FRAME_HEADER.unpack_from(frame, 0)
                if self.on_frame is not None:
                    self.on_frame(conn, op, flags, chan, seq,
                                  bytes(frame[FRAME_HEADER_SIZE:]))
            # Loop: the C drain stops when the next record wouldn't fit,
            # so a partially-filled buffer can still leave records behind.
            # Only n == 0 proves the inbox is empty.


# --- compact TaskSpec codec ----------------------------------------------

def _intern_key(spec) -> tuple:
    return (spec.actor_id, spec.method_name, spec.name, spec.max_retries,
            spec.fn_async_export)


def _template_of(spec):
    """The per-(actor, method) constant part: the spec with every
    per-call field blanked. Pickled once per connection."""
    return dataclasses.replace(
        spec, task_id=b"", args=[], seqno=0, num_returns=1,
        trace_id=b"", parent_span=b"")


def _matches_template(spec, tmpl) -> bool:
    """Cheap equality on the fields the template froze — anything that
    drifted (unusual resources, retries in flight, placement) drops the
    spec to the pickle fallback rather than mis-encoding it."""
    return (spec.func_id == tmpl.func_id
            and spec.resources == tmpl.resources
            and spec.owner_addr == tmpl.owner_addr
            and spec.owner_worker_id == tmpl.owner_worker_id
            and spec.job_id == tmpl.job_id
            and spec.caller_id == tmpl.caller_id
            and spec.retry_count == 0
            and not spec.streaming
            and spec.actor_creation is None
            and spec.placement_group is None
            and spec.pg_bundle_index == tmpl.pg_bundle_index
            and spec.scheduling_strategy is None
            and spec.label_selector is None
            and spec.runtime_env is None)


def _compact_args(args) -> Optional[list]:
    """Positional inline values only — the steady-state shape. Returns
    the flat [data, meta, ...] list or None to force the pickle path."""
    flat = []
    for a in args:
        if (len(a) != 4 or a[0] != "p" or a[1] != "v"
                or not isinstance(a[2], (bytes, bytearray))
                or not isinstance(a[3], (bytes, bytearray))):
            return None
        flat.append(a[2])
        flat.append(a[3])
    return flat


def encode_call(chan: "GraftChannel", specs: list) -> Tuple[list, bytes]:
    """Encode a batch. Returns (new_intern_frames, call_payload); the
    intern frames must be sent (in order) before the call frame — the
    stream guarantees the peer sees each template before first use."""
    interns: list = []
    parts = [_U16.pack(len(specs))]
    for spec in specs:
        rec = _encode_compact(chan, spec, interns)
        if rec is None:
            blob = pickle.dumps(spec, protocol=5)
            parts.append(b"\x01")
            parts.append(_U32.pack(len(blob)))
            parts.append(blob)
        else:
            parts.append(b"\x00")
            parts.extend(rec)
    return interns, b"".join(parts)


def _encode_compact(chan, spec, interns) -> Optional[list]:
    if (not spec.is_actor_task or spec.streaming
            or len(spec.task_id) != 16 or not (0 <= spec.seqno < 2 ** 63)
            or not (0 <= spec.num_returns <= 255)):
        return None
    key = _intern_key(spec)
    entry = chan.interns.get(key)
    if entry is None:
        tmpl = _template_of(spec)
        if not _matches_template(spec, tmpl):
            return None
        iid = chan.next_intern
        chan.next_intern = iid + 1
        chan.interns[key] = (iid, tmpl)
        interns.append(_U32.pack(iid) + pickle.dumps(tmpl, protocol=5))
    else:
        iid, tmpl = entry
        if not _matches_template(spec, tmpl):
            return None
    flags = 0
    flat = _compact_args(spec.args)
    trace_default = (spec.trace_id == spec.task_id
                     and not spec.parent_span)
    if not trace_default:
        flags |= REC_TRACE
    if flat is None:
        flags |= REC_ARGS_PICKLED
    out = [_REC_FIXED.pack(iid, flags, spec.task_id, spec.seqno,
                           spec.num_returns)]
    if not trace_default:
        out.append(_U16.pack(len(spec.trace_id)))
        out.append(spec.trace_id)
        out.append(_U16.pack(len(spec.parent_span)))
        out.append(spec.parent_span)
    if flat is None:
        blob = pickle.dumps(list(spec.args), protocol=5)
        out.append(_U32.pack(len(blob)))
        out.append(blob)
    else:
        out.append(_U16.pack(len(flat) // 2))
        for b in flat:
            out.append(_U32.pack(len(b)))
            out.append(b)
    return out


def decode_call(payload: bytes, interns: Dict[int, Any]) -> list:
    """Rebuild the TaskSpec list on the executing side. `interns` is the
    per-connection template table filled by OP_INTERN frames."""
    view = memoryview(payload)
    (count,) = _U16.unpack_from(view, 0)
    off = 2
    specs = []
    for _ in range(count):
        kind = view[off]
        off += 1
        if kind == 1:
            (ln,) = _U32.unpack_from(view, off)
            off += 4
            specs.append(pickle.loads(view[off:off + ln]))
            off += ln
            continue
        iid, flags, task_id, seqno, nret = _REC_FIXED.unpack_from(view, off)
        off += _REC_FIXED.size
        tmpl = interns[iid]
        # Cheap clone (copy.copy pays the __reduce_ex__ protocol, ~4x).
        spec = tmpl.__class__.__new__(tmpl.__class__)
        spec.__dict__.update(tmpl.__dict__)
        spec.task_id = task_id
        spec.seqno = seqno
        spec.num_returns = nret
        if flags & REC_TRACE:
            (tl,) = _U16.unpack_from(view, off)
            off += 2
            spec.trace_id = bytes(view[off:off + tl])
            off += tl
            (pl,) = _U16.unpack_from(view, off)
            off += 2
            spec.parent_span = bytes(view[off:off + pl])
            off += pl
        else:
            spec.trace_id = task_id
            spec.parent_span = b""
        if flags & REC_ARGS_PICKLED:
            (ln,) = _U32.unpack_from(view, off)
            off += 4
            spec.args = pickle.loads(view[off:off + ln])
            off += ln
        else:
            (nargs,) = _U16.unpack_from(view, off)
            off += 2
            args = []
            for _i in range(nargs):
                (dl,) = _U32.unpack_from(view, off)
                off += 4
                data = bytes(view[off:off + dl])
                off += dl
                (ml,) = _U32.unpack_from(view, off)
                off += 4
                meta = bytes(view[off:off + ml])
                off += ml
                args.append(("p", "v", data, meta))
            spec.args = args
        specs.append(spec)
    return specs


def intern_frame_apply(payload: bytes, interns: Dict[int, Any]) -> None:
    """Apply an OP_INTERN frame: install the pickled template."""
    (iid,) = _U32.unpack_from(payload, 0)
    interns[iid] = pickle.loads(memoryview(payload)[4:])


def encode_replies(replies: list) -> bytes:
    """Per-batch reply payload. The steady-state shape (single inline
    return, no error, no forwarded refs) is a few length-prefixed byte
    strings; everything else pickles the reply dict unchanged."""
    parts = [_U16.pack(len(replies))]
    for r in replies:
        rets = r.get("returns") if r.get("error") is None else None
        if (rets is not None and len(r) == 2 and len(rets) == 1
                and rets[0][0] == "inline" and len(rets[0]) == 4
                and not rets[0][3]):
            _, data, meta, _descs = rets[0]
            parts.append(b"\x00")
            parts.append(_U32.pack(len(data)))
            parts.append(data)
            parts.append(_U32.pack(len(meta)))
            parts.append(meta)
        else:
            blob = pickle.dumps(r, protocol=5)
            parts.append(b"\x01")
            parts.append(_U32.pack(len(blob)))
            parts.append(blob)
    return b"".join(parts)


def decode_replies(payload: bytes) -> list:
    view = memoryview(payload)
    (count,) = _U16.unpack_from(view, 0)
    off = 2
    out = []
    for _ in range(count):
        status = view[off]
        off += 1
        if status == 0:
            (dl,) = _U32.unpack_from(view, off)
            off += 4
            data = bytes(view[off:off + dl])
            off += dl
            (ml,) = _U32.unpack_from(view, off)
            off += 4
            meta = bytes(view[off:off + ml])
            off += ml
            out.append({"error": None,
                        "returns": [("inline", data, meta, ())]})
        else:
            (ln,) = _U32.unpack_from(view, off)
            off += 4
            out.append(pickle.loads(view[off:off + ln]))
            off += ln
    return out


# --- caller-side channel --------------------------------------------------

class GraftChannel:
    """Caller side of one dispatch-plane connection: seq-matched pending
    futures plus the intern cache. Loop-affine, like the endpoint."""

    def __init__(self, ep: GraftEndpoint, conn: int):
        self.ep = ep
        self.conn = conn
        self.closed = False
        self.interns: Dict[tuple, Tuple[int, Any]] = {}
        self.next_intern = 0
        self._seq = 0
        self._pending: Dict[int, asyncio.Future] = {}

    def call_batch(self, specs: list, chan: int = 0) -> asyncio.Future:
        """Send one CALL frame for the batch; the future resolves to the
        per-task reply dicts (same shape as push_task_batch's return).
        Raises GraftSendError when nothing went on the wire.

        `chan` rides the otherwise-spare u16 header field as the
        graftscope trace tag: the reactor records it on both sides of
        the wire (RpcSend/RpcRecv) and the executor echoes it in the
        REPLY, so the flight recorder can parent the native hops under
        the submitting task's span without parsing any payload."""
        if self.closed or self.ep.closed:
            raise GraftSendError("graftrpc channel closed")
        interns, payload = encode_call(self, specs)
        for blob in interns:
            if not self.ep.send(self.conn, OP_INTERN, 0, blob):
                # In-flight calls WERE sent: those must surface as a
                # retriable transport loss, not a safe-fallback send error.
                self.fail(RpcConnectionLost("graftrpc connection lost"))
                raise GraftSendError("graftrpc intern send failed")
        self._seq += 1
        seq = self._seq
        fut = asyncio.get_running_loop().create_future()
        self._pending[seq] = fut
        if not self.ep.send(self.conn, OP_CALL, seq, payload, chan=chan):
            self._pending.pop(seq, None)
            self.fail(RpcConnectionLost("graftrpc connection lost"))
            raise GraftSendError("graftrpc call send failed")
        return fut

    def on_reply(self, seq: int, flags: int, payload: bytes) -> None:
        fut = self._pending.pop(seq, None)
        if fut is None or fut.done():
            return
        if flags & FLAG_ERR:
            try:
                msg = pickle.loads(payload)
            except Exception:
                msg = "<undecodable graftrpc error>"
            fut.set_exception(GraftError(f"remote dispatch failed: {msg}"))
            return
        try:
            fut.set_result(decode_replies(payload))
        except Exception as e:
            fut.set_exception(GraftError(f"reply decode failed: {e!r}"))

    def fail(self, exc: Exception) -> None:
        """Connection lost (or poisoned): fail every pending call and
        refuse further use — the owner drops the channel from its cache
        and the regular actor-client retry machinery takes over."""
        if self.closed:
            return
        self.closed = True
        pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)
