"""graftscope: Python seam over the native-plane flight recorder.

csrc/scope_core.cc keeps per-thread lock-free ring buffers of fixed
24-byte records emitted at the choke points of the native planes —
graftrpc frame send/recv/flush/wakeup, graftcopy scatter/link, and the
store sidecar's accept/service/rename path. This module is everything
Python needs to make those records useful:

  * decode: the wire-record struct (lint pass 3e cross-checks the
    constants below against csrc/scope_core.h field by field);
  * drain: pull records out of the current process's rings via ctypes
    (the sidecar's rings live in the node-agent process, so the agent
    sees them too; remote readers use ``FastStoreClient.scope_drain`` /
    OP_SCOPE);
  * counters -> metrics: fold the cumulative per-kind counter block
    into the process metrics registry as per-tick deltas, amortized to
    one histogram observation per kind per tick;
  * stitching: ``SpanAssembler`` pairs records into Chrome-trace spans
    and attaches the ambient (trace_id, parent_span) that rode the
    spare u16 ``chan`` field of the graftrpc frame header, so native
    hops become child spans of the submitting task in the cluster
    timeline (reference contrast: src/ray/stats/ publishes counters
    only; the reference has no native-span path into its timeline).

Everything here is best-effort: if the native library is missing the
module degrades to no-ops and the timeline simply has no native spans.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

# --- wire constants (lint-checked against csrc/scope_core.h) --------------

# Record kinds; one per instrumented choke point.
KIND_RPC_SEND = 1      # graftrpc frame accepted for write (caller side)
KIND_RPC_RECV = 2      # graftrpc frame extracted by the reactor
KIND_RPC_FLUSH = 3     # one writev flush pass (span-in-one)
KIND_RPC_WAKE = 4      # notify-fd wakeup written
KIND_COPY_SCATTER = 5  # copy_write_scatter call (span-in-one)
KIND_COPY_LINK = 6     # copy_linkat call
KIND_SC_ACCEPT = 7     # sidecar accepted a client connection
KIND_SC_BEGIN = 8      # sidecar request service started
KIND_SC_END = 9        # sidecar request service finished (dur in size)
KIND_SC_RENAME = 10    # sidecar ingest rename committed
KIND_COUNT = 11

# Record layout: field name -> byte width, in wire order.
SCOPE_RECORD_FIELDS = (
    ("kind", 1),
    ("op", 1),
    ("chan", 2),
    ("size", 4),
    ("seq_or_oid", 8),
    ("t_ns", 8),
)
SCOPE_RECORD = struct.Struct("<BBHIQQ")
SCOPE_RECORD_SIZE = 24

KIND_NAMES = {
    KIND_RPC_SEND: "rpc_send",
    KIND_RPC_RECV: "rpc_recv",
    KIND_RPC_FLUSH: "rpc_flush",
    KIND_RPC_WAKE: "rpc_wake",
    KIND_COPY_SCATTER: "copy_scatter",
    KIND_COPY_LINK: "copy_link",
    KIND_SC_ACCEPT: "sc_accept",
    KIND_SC_BEGIN: "sc_begin",
    KIND_SC_END: "sc_end",
    KIND_SC_RENAME: "sc_rename",
}

# Sidecar op names (store protocol ops, store_server.cc kOp table).
_SC_OPS = {1: "ingest", 2: "get", 3: "release", 4: "delete",
           5: "contains", 6: "put", 7: "drop", 8: "scope",
           9: "create", 10: "seal"}
# graftrpc frame ops (graftrpc.OP_*; inlined to avoid an import cycle).
_RPC_OP_CALL = 1
_RPC_OP_REPLY = 2


class ScopeRec(NamedTuple):
    kind: int
    op: int
    chan: int
    size: int
    seq_or_oid: int
    t_ns: int


def oid64(oid: bytes) -> int:
    """First 8 oid bytes as LE u64 — matches Oid64() in store_server.cc.
    The stitching key between put-side spans and sidecar-side spans."""
    return int.from_bytes(oid[:8].ljust(8, b"\x00"), "little")


# --- library access -------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
_lib_lock = threading.Lock()


def _get_lib() -> Optional[ctypes.CDLL]:
    """The shared library that hosts the recorder (scope_core.cc is
    linked into libraytpu_torch_store.so); bindings are installed by
    object_store._load_lib. None when the native planes are absent."""
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    with _lib_lock:
        if _lib is None and not _lib_failed:
            try:
                from ray_tpu_torch.core import object_store
                _lib = object_store._get_lib()
            except Exception:
                _lib_failed = True
    return _lib


def available() -> bool:
    return _get_lib() is not None


def enabled() -> bool:
    lib = _get_lib()
    return bool(lib.scope_enabled()) if lib is not None else False


def set_enabled(on: bool) -> None:
    lib = _get_lib()
    if lib is not None:
        lib.scope_set_enabled(1 if on else 0)


def configure_from_flags() -> None:
    """Apply the ``graftscope`` config flag to the native recorder.
    RAY_TPU_TORCH_GRAFTSCOPE reaches the C side through getenv as well, so
    this only matters for programmatic ``ray_tpu.init(graftscope=...)``
    overrides."""
    try:
        from ray_tpu_torch.utils.config import GlobalConfig
        set_enabled(bool(GlobalConfig.graftscope))
    except Exception:
        pass


def now_ns() -> int:
    """The recorder's monotonic clock (CLOCK_MONOTONIC)."""
    lib = _get_lib()
    return int(lib.scope_now_ns()) if lib is not None else 0


def wall_anchor_ns() -> int:
    """wall_ns = t_ns + wall_anchor_ns() converts record timestamps to
    wall time for the Chrome-trace timeline (ts fields are wall µs)."""
    lib = _get_lib()
    if lib is None:
        return 0
    return time.time_ns() - int(lib.scope_now_ns())


def dropped() -> int:
    lib = _get_lib()
    return int(lib.scope_dropped()) if lib is not None else 0


def decode(buf: bytes) -> List[ScopeRec]:
    """Decode a blob of wire records (ctypes drain or OP_SCOPE reply).
    A trailing partial record is ignored."""
    out = []
    end = len(buf) - len(buf) % SCOPE_RECORD_SIZE
    for off in range(0, end, SCOPE_RECORD_SIZE):
        out.append(ScopeRec(*SCOPE_RECORD.unpack_from(buf, off)))
    return out


_DRAIN_BUF_SIZE = 64 << 10  # whole multiple of the record size


def drain_raw() -> bytes:
    """One bounded drain pass over this process's rings (raw bytes)."""
    lib = _get_lib()
    if lib is None:
        return b""
    buf = ctypes.create_string_buffer(_DRAIN_BUF_SIZE)
    n = lib.scope_drain(buf, _DRAIN_BUF_SIZE)
    return buf.raw[:n] if n > 0 else b""


def drain_records(max_passes: int = 64) -> List[ScopeRec]:
    """Drain-until-empty (bounded so a write storm can't pin the
    caller), decoded."""
    out: List[ScopeRec] = []
    for _ in range(max_passes):
        raw = drain_raw()
        if not raw:
            break
        out.extend(decode(raw))
    return out


# --- counters -> metrics --------------------------------------------------

def counters() -> Dict[str, Tuple[int, int, int]]:
    """Cumulative {kind_name: (calls, bytes, ns)} since process start."""
    lib = _get_lib()
    if lib is None:
        return {}
    arr = (ctypes.c_uint64 * (3 * KIND_COUNT))()
    k = lib.scope_counters(arr, KIND_COUNT)
    out = {}
    for kind in range(1, min(k, KIND_COUNT)):
        name = KIND_NAMES.get(kind)
        if name:
            out[name] = (int(arr[kind * 3]), int(arr[kind * 3 + 1]),
                         int(arr[kind * 3 + 2]))
    return out


# Log2 histogram geometry; the lint-checked mirrors of kScopeHistBuckets
# / kScopeHistShift live in graftpulse.py (pass 3f), this module only
# needs the array stride to read the block out.
_HIST_BUCKETS = 16


def histograms() -> Dict[str, Tuple[int, ...]]:
    """Cumulative per-kind log2 latency histograms since process start:
    {kind_name: (b0..b15)} where bucket b counts emits with dur_ns in
    [2^(10+b), 2^(11+b)), tails clamped."""
    lib = _get_lib()
    if lib is None:
        return {}
    arr = (ctypes.c_uint64 * (_HIST_BUCKETS * KIND_COUNT))()
    k = lib.scope_histograms(arr, KIND_COUNT)
    out = {}
    for kind in range(1, min(k, KIND_COUNT)):
        name = KIND_NAMES.get(kind)
        if name:
            base = kind * _HIST_BUCKETS
            out[name] = tuple(int(arr[base + b])
                              for b in range(_HIST_BUCKETS))
    return out


_metrics = None
_last_counters: Dict[str, Tuple[int, int, int]] = {}


def _get_metrics():
    global _metrics
    if _metrics is None:
        from ray_tpu_torch.utils import metrics as M
        _metrics = {
            "calls": M.Counter(
                "graftscope_ops_total",
                "Native-plane operations observed by the flight recorder.",
                tag_keys=("kind",)),
            "bytes": M.Counter(
                "graftscope_bytes_total",
                "Bytes moved through instrumented native choke points.",
                tag_keys=("kind",)),
            "ns": M.Histogram(
                "graftscope_op_ns",
                "Mean ns per native op, one amortized observation per "
                "kind per report tick.",
                boundaries=[1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9],
                tag_keys=("kind",)),
            "dropped": M.Gauge(
                "graftscope_dropped_records",
                "Flight-recorder records lost to ring wraparound."),
        }
    return _metrics


def publish_counters() -> None:
    """Fold counter deltas since the previous tick into the metrics
    registry. Called from the node agent's metrics loop (and the worker
    flusher) — the hot path never touches Python metrics; this is the
    amortization point."""
    global _last_counters
    cur = counters()
    if not cur:
        return
    m = _get_metrics()
    for name, (calls, nbytes, ns) in cur.items():
        p = _last_counters.get(name, (0, 0, 0))
        dc, db, dn = calls - p[0], nbytes - p[1], ns - p[2]
        if dc <= 0 and db <= 0:
            continue
        tags = {"kind": name}
        if dc > 0:
            m["calls"].inc(dc, tags)
            if dn > 0:
                m["ns"].observe(dn / dc, tags)
        if db > 0:
            m["bytes"].inc(db, tags)
    _last_counters = cur
    m["dropped"].set(dropped())


# --- span assembly (trace stitching) --------------------------------------

class SpanAssembler:
    """Turns drained records into Chrome-trace span dicts and stitches
    in ambient trace context.

    The graftrpc frame header has a spare u16 ``chan`` field. The
    submitter leases a tag for every traced CALL batch (``lease_tag``),
    remembering the ambient (trace_id, parent_span) plus the Python-side
    submit wall time; the executor echoes the tag on the REPLY frame.
    The recorder logs both frames (KIND_RPC_SEND in the caller thread,
    KIND_RPC_RECV in the reactor), so pairing (chan, seq) inside ONE
    process's rings yields, per batch:

      rpc.dispatch : submit wall time -> frame handed to the reactor
                     (Python encode + dispatch-queue time)
      rpc.wire     : CALL send -> REPLY extracted (wire + remote
                     service round trip)

    both parented under the submitting task's span. Spans without
    ambient context (flush passes, sidecar service, copy scatter) carry
    ``oid64`` where applicable so the controller can back-fill parents
    from put-side registrations.
    """

    MAX_PENDING = 4096

    def __init__(self, pid: str):
        self.pid = pid
        self._lock = threading.Lock()
        self._next_tag = 1
        self._tags: Dict[int, Tuple[str, str, str, int, int]] = {}
        self._sends: Dict[Tuple[int, int], ScopeRec] = {}

    def lease_tag(self, trace_id: str, parent_span: str, label: str,
                  ntasks: int = 1) -> int:
        """Lease a u16 trace tag for one CALL batch (0 = untraced).
        Tags wrap; a stale entry from 65534 batches ago is simply
        overwritten — drains run every couple of seconds."""
        submit_wall_ns = time.time_ns()
        with self._lock:
            tag = self._next_tag
            self._next_tag = tag + 1 if tag < 0xFFFF else 1
            self._tags[tag] = (trace_id, parent_span, label,
                               submit_wall_ns, ntasks)
        return tag

    def feed(self, recs: List[ScopeRec],
             anchor_ns: Optional[int] = None) -> List[dict]:
        """Convert records to span dicts (ts/dur in wall µs, Chrome
        trace "X" shape plus stitching fields)."""
        if anchor_ns is None:
            anchor_ns = wall_anchor_ns()
        spans: List[dict] = []
        # A drain walks the per-thread rings in slot order, so a REPLY
        # recorded in the reactor's ring can precede the CALL recorded
        # in the submit thread's ring. All records share one monotonic
        # clock — restore causal order before pairing.
        recs = sorted(recs, key=lambda r: r.t_ns)
        with self._lock:
            for r in recs:
                if r.kind == KIND_RPC_SEND:
                    if r.op == _RPC_OP_CALL and r.chan:
                        self._sends[(r.chan, r.seq_or_oid)] = r
                        if len(self._sends) > self.MAX_PENDING:
                            # Evict oldest half; replies for them will
                            # simply not produce wire spans.
                            for k in list(self._sends)[
                                    :self.MAX_PENDING // 2]:
                                del self._sends[k]
                elif r.kind == KIND_RPC_RECV:
                    if r.op == _RPC_OP_REPLY and r.chan:
                        send = self._sends.pop(
                            (r.chan, r.seq_or_oid), None)
                        if send is None:
                            # CALL record not drained yet (or lost to
                            # wraparound) — keep the tag for a later
                            # pass; leases wrap, so stale tags are
                            # overwritten rather than leaked.
                            continue
                        ctx = self._tags.pop(r.chan, None)
                        if ctx is None:
                            continue
                        trace_id, parent, label, submit_ns, ntasks = ctx
                        send_wall = send.t_ns + anchor_ns
                        recv_wall = r.t_ns + anchor_ns
                        if submit_ns and submit_ns <= send_wall:
                            spans.append(self._span(
                                "rpc.dispatch", submit_ns,
                                send_wall - submit_ns, trace_id, parent,
                                {"label": label, "tasks": ntasks,
                                 "bytes": send.size}))
                        spans.append(self._span(
                            "rpc.wire", send_wall,
                            max(0, recv_wall - send_wall), trace_id,
                            parent,
                            {"label": label, "seq": r.seq_or_oid,
                             "bytes": send.size,
                             "reply_bytes": r.size}))
                elif r.kind == KIND_RPC_FLUSH:
                    spans.append(self._span(
                        "rpc.flush", r.seq_or_oid + anchor_ns,
                        max(0, r.t_ns - r.seq_or_oid), "", "",
                        {"bytes": r.size}))
                elif r.kind == KIND_COPY_SCATTER:
                    spans.append(self._span(
                        "copy.pwritev", r.seq_or_oid + anchor_ns,
                        max(0, r.t_ns - r.seq_or_oid), "", "",
                        {"bytes": r.size,
                         "error": bool(r.op)}))
                elif r.kind == KIND_SC_END:
                    # Span-in-one: size carries the duration (ns,
                    # clipped to u32), seq_or_oid carries oid64.
                    start = r.t_ns - r.size + anchor_ns
                    spans.append(self._span(
                        "sidecar." + _SC_OPS.get(r.op, str(r.op)),
                        start, r.size, "", "", {},
                        oid=r.seq_or_oid))
                elif r.kind == KIND_SC_RENAME:
                    spans.append(self._span(
                        "sidecar.rename", r.t_ns + anchor_ns, 0,
                        "", "", {}, oid=r.seq_or_oid))
                # RPC_WAKE / COPY_LINK / SC_ACCEPT / SC_BEGIN are
                # counter-only: too frequent or redundant as spans.
        return spans

    def put_span(self, name: str, start_wall_ns: int, end_wall_ns: int,
                 oid: bytes, trace_id: str, parent_span: str,
                 nbytes: int) -> dict:
        """Python-timed put-plane span (staging/ingest around the native
        calls) carrying both the trace context and the oid64 key, so the
        controller learns oid64 -> context from it and can parent the
        sidecar-side spans for the same object."""
        return self._span(name, start_wall_ns,
                          max(0, end_wall_ns - start_wall_ns),
                          trace_id, parent_span, {"bytes": nbytes},
                          oid=oid64(oid))

    def _span(self, name: str, start_wall_ns: int, dur_ns: int,
              trace_id: str, parent_span: str, args: dict,
              oid: int = 0) -> dict:
        s = {"name": name, "cat": "native", "ph": "X",
             "ts": start_wall_ns / 1e3, "dur": dur_ns / 1e3,
             "pid": self.pid, "tid": "native", "args": args}
        if trace_id:
            s["trace_id"] = trace_id
            s["parent_span"] = parent_span
        if oid:
            s["oid64"] = oid
        return s
