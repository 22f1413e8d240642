"""graftpulse: the cluster telemetry plane.

Every node agent assembles one compact fixed-schema *pulse* record per
tick — graftscope cumulative-counter deltas and per-op log2 latency
histograms, graftshm arena occupancy and free-list depth, store object
counts, per-worker queue depth and summed RSS — and ships it to the
controller as a fire-and-forget frame over the existing graftrpc
channel. The controller keeps a bounded ring of decoded pulses per node
(``NodeSeries``), folds them into cluster-level SLO aggregates
(``ClusterAggregator``: p50/p99 per native op, bytes/s per plane,
objects resident) and derives node health from pulse cadence: a node
that misses ``pulse_suspect_ticks`` consecutive ticks becomes *suspect*
and is declared *dead* after ``pulse_dead_ms`` of silence — a proactive
signal that replaces waiting for a connection error (reference
contrast: the GCS resource broadcast + per-node dashboard agents in
src/ray/gcs/; here one fixed-width frame carries resources, latency
SLOs and liveness at once).

Wire layout (lint pass 3f cross-checks the constants below against
``struct PulseWireRec`` in csrc/scope_core.h): a 104-byte little-endian
header followed by ``kind_count`` rows of ``3 + PULSE_HIST_BUCKETS``
u64s — per scope kind the {calls, bytes, ns} deltas since the previous
pulse, then the histogram bucket deltas. Version 2 appended the two
graftprof gauges (worker on-CPU share and GIL-wait share, in permille)
so ``status --live`` can rank hot nodes without a second RPC; widening
the header without bumping PULSE_VERSION is a lint error (pass 3f
checks the version -> size registry on both sides).

Everything degrades gracefully: with the native library absent the
scope sections are empty, and ``RAY_TPU_TORCH_GRAFTPULSE=0`` (or
``ray_tpu.init(graftpulse=False)``) disables assembly and shipping
entirely while heartbeat-based liveness keeps working.
"""

from __future__ import annotations

import os
import struct
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

from ray_tpu_torch.core._native import graftscope

# --- wire constants (lint-checked against csrc/scope_core.h, pass 3f) -----

PULSE_MAGIC = 0x45534C50  # 'PLSE'
PULSE_VERSION = 2

# Every wire version ever shipped -> its header size. Appending fields
# means a new entry here (and in the mirror table in scope_core.h's
# lint pass); silently widening an existing version is schema drift.
PULSE_VERSION_SIZES = {1: 96, 2: 104}

# Log2 histogram geometry (kScopeHistBuckets / kScopeHistShift): bucket b
# counts emits whose dur_ns landed in [2^(SHIFT+b), 2^(SHIFT+b+1)), both
# tails clamped.
PULSE_HIST_BUCKETS = 16
PULSE_HIST_SHIFT = 10

# Header layout: field name -> byte width, in wire order.
PULSE_RECORD_FIELDS = (
    ("magic", 4),
    ("version", 2),
    ("kind_count", 2),
    ("seq", 8),
    ("t_mono_ns", 8),
    ("t_wall_ns", 8),
    ("store_used", 8),
    ("store_capacity", 8),
    ("store_objects", 4),
    ("shm_free_chunks", 4),
    ("shm_arena_bytes", 8),
    ("num_workers", 4),
    ("queue_depth", 4),
    ("rss_bytes", 8),
    ("scope_dropped", 8),
    ("events_dropped", 8),
    ("prof_oncpu_permille", 4),
    ("prof_gil_permille", 4),
)
PULSE_RECORD = struct.Struct("<IHHQQQQQIIQIIQQQII")
PULSE_RECORD_SIZE = 104

# Version 1 header: version 2 minus the two trailing graftprof gauges.
# Kept decodable forever — a rolling upgrade means the controller WILL
# see old-format frames, and a version mismatch must degrade that one
# node's row, not get the node declared dead for "pulse silence".
_V1_RECORD = struct.Struct("<IHHQQQQQIIQIIQQQ")
assert _V1_RECORD.size == PULSE_VERSION_SIZES[1]
assert PULSE_RECORD.size == PULSE_VERSION_SIZES[2] == PULSE_RECORD_SIZE

_ROW_WORDS = 3 + PULSE_HIST_BUCKETS  # calls, bytes, ns, b0..b15


class Pulse(NamedTuple):
    seq: int
    t_mono_ns: int
    t_wall_ns: int
    store_used: int
    store_capacity: int
    store_objects: int
    shm_free_chunks: int
    shm_arena_bytes: int
    num_workers: int
    queue_depth: int
    rss_bytes: int
    scope_dropped: int
    events_dropped: int
    # graftprof: worker on-CPU and GIL-wait shares over the last tick,
    # in permille of wall time (0..1000; 0 when graftprof is off).
    prof_oncpu_permille: int
    prof_gil_permille: int
    # kind_name -> (calls, bytes, ns, (b0..b15)) — deltas for this tick.
    kinds: Dict[str, Tuple[int, int, int, Tuple[int, ...]]]
    # Wire version the frame arrived in (PULSE_VERSION for local
    # assembly; older registry versions survive decode with their
    # missing fields zeroed so the fold can mark the node degraded).
    version: int = PULSE_VERSION


def enabled() -> bool:
    """Pulse assembly/shipping on? (config flag; RAY_TPU_TORCH_GRAFTPULSE=0
    reaches it through the normal env override path)."""
    try:
        from ray_tpu_torch.utils.config import GlobalConfig
        return bool(GlobalConfig.graftpulse)
    except Exception:
        return True


# --- encode / decode ------------------------------------------------------

def encode(p: Pulse) -> bytes:
    """One pulse -> header + KIND_COUNT positional rows (kind 0 unused,
    all-zero). Values are clamped into their wire widths — a pulse must
    never fail to serialize because a counter ran hot."""
    kind_count = graftscope.KIND_COUNT
    head = PULSE_RECORD.pack(
        PULSE_MAGIC, PULSE_VERSION, kind_count,
        p.seq & 0xFFFFFFFFFFFFFFFF, p.t_mono_ns, p.t_wall_ns,
        p.store_used, p.store_capacity,
        min(p.store_objects, 0xFFFFFFFF),
        min(p.shm_free_chunks, 0xFFFFFFFF),
        p.shm_arena_bytes,
        min(p.num_workers, 0xFFFFFFFF),
        min(p.queue_depth, 0xFFFFFFFF),
        p.rss_bytes, p.scope_dropped, p.events_dropped,
        min(p.prof_oncpu_permille, 0xFFFFFFFF),
        min(p.prof_gil_permille, 0xFFFFFFFF))
    words: List[int] = []
    for kind in range(kind_count):
        row = p.kinds.get(graftscope.KIND_NAMES.get(kind, ""))
        if row is None:
            words.extend([0] * _ROW_WORDS)
        else:
            calls, nbytes, ns, hist = row
            words.extend((calls, nbytes, ns))
            h = list(hist[:PULSE_HIST_BUCKETS])
            h.extend([0] * (PULSE_HIST_BUCKETS - len(h)))
            words.extend(h)
    return head + struct.pack("<%dQ" % len(words), *words)


def decode(buf: bytes) -> Pulse:
    """Inverse of encode(). Raises ValueError on a malformed or
    unknown-version frame (the controller drops those, it never dies on
    them). Every version in PULSE_VERSION_SIZES decodes: missing fields
    zero-fill and the returned Pulse carries its wire version so the
    aggregator can mark the node's row degraded instead of letting a
    skewed-but-healthy node rot into pulse-silence death."""
    if len(buf) < 8:
        raise ValueError("pulse frame truncated")
    magic, version, kind_count = struct.unpack_from("<IHH", buf, 0)
    if magic != PULSE_MAGIC:
        raise ValueError("bad pulse magic 0x%x" % magic)
    head_size = PULSE_VERSION_SIZES.get(version)
    if head_size is None:
        raise ValueError("pulse version skew: %d not in %s"
                         % (version, sorted(PULSE_VERSION_SIZES)))
    if len(buf) < head_size:
        raise ValueError("pulse frame truncated")
    if version == PULSE_VERSION:
        (magic, version, kind_count, seq, t_mono_ns, t_wall_ns,
         store_used, store_capacity, store_objects, shm_free_chunks,
         shm_arena_bytes, num_workers, queue_depth, rss_bytes,
         scope_dropped, events_dropped,
         prof_oncpu_permille, prof_gil_permille) = \
            PULSE_RECORD.unpack_from(buf, 0)
    else:  # v1: no graftprof gauges on the wire
        (magic, version, kind_count, seq, t_mono_ns, t_wall_ns,
         store_used, store_capacity, store_objects, shm_free_chunks,
         shm_arena_bytes, num_workers, queue_depth, rss_bytes,
         scope_dropped, events_dropped) = _V1_RECORD.unpack_from(buf, 0)
        prof_oncpu_permille = prof_gil_permille = 0
    need = head_size + kind_count * _ROW_WORDS * 8
    if len(buf) < need:
        raise ValueError("pulse payload truncated")
    words = struct.unpack_from("<%dQ" % (kind_count * _ROW_WORDS), buf,
                               head_size)
    kinds: Dict[str, Tuple[int, int, int, Tuple[int, ...]]] = {}
    for kind in range(kind_count):
        name = graftscope.KIND_NAMES.get(kind)
        if not name:
            continue
        base = kind * _ROW_WORDS
        calls, nbytes, ns = words[base:base + 3]
        hist = tuple(words[base + 3:base + _ROW_WORDS])
        if calls or nbytes or ns or any(hist):
            kinds[name] = (calls, nbytes, ns, hist)
    return Pulse(seq, t_mono_ns, t_wall_ns, store_used, store_capacity,
                 store_objects, shm_free_chunks, shm_arena_bytes,
                 num_workers, queue_depth, rss_bytes, scope_dropped,
                 events_dropped, prof_oncpu_permille, prof_gil_permille,
                 kinds, version)


# --- histogram math -------------------------------------------------------

def bucket_bounds_ns(b: int) -> Tuple[int, int]:
    """[lo, hi) duration range of bucket b (tails are clamped into the
    first/last bucket, so treat them as open-ended when interpreting)."""
    return (1 << (PULSE_HIST_SHIFT + b), 1 << (PULSE_HIST_SHIFT + b + 1))


def percentile_ns(hist, q: float) -> float:
    """Estimate the q-quantile (0 < q <= 1) of a log2 bucket histogram,
    using each bucket's geometric representative (1.5 * lower bound).
    Returns 0.0 for an empty histogram."""
    total = sum(hist)
    if total <= 0:
        return 0.0
    rank = q * total
    acc = 0.0
    for b, n in enumerate(hist):
        acc += n
        if acc >= rank:
            return 1.5 * (1 << (PULSE_HIST_SHIFT + b))
    return 1.5 * (1 << (PULSE_HIST_SHIFT + len(hist) - 1))


def merge_hists(a, b) -> Tuple[int, ...]:
    if not a:
        return tuple(b)
    if not b:
        return tuple(a)
    return tuple(x + y for x, y in zip(a, b))


def proc_rss_bytes(pid: int) -> int:
    """Resident set size of a live process, 0 if unknowable (procfs
    only; cheap enough for one read per worker per tick)."""
    try:
        with open("/proc/%d/statm" % pid, "rb") as f:
            parts = f.read().split()
        return int(parts[1]) * (os.sysconf("SC_PAGE_SIZE") or 4096)
    except Exception:
        return 0


# --- node-side assembly ---------------------------------------------------

class PulseAssembler:
    """Owned by the node agent; folds the cumulative scope counter +
    histogram blocks into per-tick deltas and stamps on the node-local
    stats handed in by the pulse loop.

    Deltas are tracked *per source process*: the agent's own recorder
    (which includes the in-process store sidecar threads) plus any
    worker blocks forwarded over the agent RPC (``report_scope``). The
    hot client-side kinds — rpc_send/flush, copy scatter, in-place shm
    writes — only ever tick in worker processes, so without those
    forwarded blocks a node's pulse would show sidecar service ops and
    nothing else. Per-source bookkeeping is what keeps the fold honest
    when a worker dies (its cumulative block just stops contributing)
    or restarts under the same id (counters reset to zero; a summed
    cumulative would go backwards)."""

    def __init__(self) -> None:
        self._seq = 0
        # source key -> (counter block, histogram block) at last tick
        self._last: Dict[str, Tuple[Dict[str, Tuple[int, int, int]],
                                    Dict[str, Tuple[int, ...]]]] = {}

    def _fold_source(self, kinds: Dict[str, Tuple[int, int, int,
                                                  Tuple[int, ...]]],
                     source: str, cur_c, cur_h) -> None:
        prev_c, prev_h = self._last.get(source, ({}, {}))
        norm_c: Dict[str, Tuple[int, int, int]] = {}
        norm_h: Dict[str, Tuple[int, ...]] = {}
        for name, cb in cur_c.items():
            calls, nbytes, ns = (int(x) for x in cb)
            ch = tuple(int(x) for x in cur_h.get(name, ()))
            norm_c[name] = (calls, nbytes, ns)
            norm_h[name] = ch
            pc = prev_c.get(name, (0, 0, 0))
            ph = prev_h.get(name, (0,) * len(ch))
            if calls < pc[0]:  # same source key, restarted process
                pc, ph = (0, 0, 0), (0,) * len(ch)
            dh = tuple(max(0, a - b) for a, b in zip(ch, ph))
            dc = max(0, calls - pc[0])
            db = max(0, nbytes - pc[1])
            dn = max(0, ns - pc[2])
            if dc or db or dn or any(dh):
                acc = kinds.get(name)
                if acc is None:
                    kinds[name] = (dc, db, dn, dh)
                else:
                    kinds[name] = (acc[0] + dc, acc[1] + db, acc[2] + dn,
                                   merge_hists(acc[3], dh))
        self._last[source] = (norm_c, norm_h)

    def assemble(self, *, store_used: int = 0, store_capacity: int = 0,
                 store_objects: int = 0, shm_free_chunks: int = 0,
                 shm_arena_bytes: int = 0, num_workers: int = 0,
                 queue_depth: int = 0, rss_bytes: int = 0,
                 events_dropped: int = 0,
                 prof_oncpu_permille: int = 0,
                 prof_gil_permille: int = 0,
                 extra_sources: Optional[Dict[str, Tuple[dict, dict]]]
                 = None,
                 banked_deltas: Optional[Dict[str, tuple]] = None) -> Pulse:
        kinds: Dict[str, Tuple[int, int, int, Tuple[int, ...]]] = {}
        self._fold_source(kinds, "self",
                          graftscope.counters(), graftscope.histograms())
        extra = extra_sources or {}
        for source, (cur_c, cur_h) in extra.items():
            self._fold_source(kinds, source, cur_c, cur_h)
        # Pre-aggregated sparse deltas (workers diff their own cumulative
        # blocks and ship only non-zero rows): a straight merge — no
        # per-source normalization, restart detection or `_last`
        # bookkeeping, which is what made the per-tick fold contend with
        # dispatch on small hosts.
        for name, d in (banked_deltas or {}).items():
            acc = kinds.get(name)
            if acc is None:
                kinds[name] = (int(d[0]), int(d[1]), int(d[2]),
                               tuple(int(x) for x in d[3]))
            else:
                kinds[name] = (acc[0] + int(d[0]), acc[1] + int(d[1]),
                               acc[2] + int(d[2]),
                               merge_hists(acc[3],
                                           tuple(int(x) for x in d[3])))
        # Forget sources that vanished (dead workers) so their stale
        # cumulative blocks can't mask a same-key successor's counters.
        live = {"self"} | set(extra)
        for gone in [s for s in self._last if s not in live]:
            del self._last[gone]
        self._seq += 1
        mono = graftscope.now_ns() or time.monotonic_ns()
        return Pulse(
            seq=self._seq, t_mono_ns=mono, t_wall_ns=time.time_ns(),
            store_used=store_used, store_capacity=store_capacity,
            store_objects=store_objects, shm_free_chunks=shm_free_chunks,
            shm_arena_bytes=shm_arena_bytes, num_workers=num_workers,
            queue_depth=queue_depth, rss_bytes=rss_bytes,
            scope_dropped=graftscope.dropped(),
            events_dropped=events_dropped,
            prof_oncpu_permille=min(int(prof_oncpu_permille), 1000),
            prof_gil_permille=min(int(prof_gil_permille), 1000),
            kinds=kinds)


# --- controller-side time series + aggregation ----------------------------

class NodeSeries:
    """Bounded ring of decoded pulses for one node plus its health
    bookkeeping (the FSM itself lives in the controller, which owns the
    restart machinery)."""

    def __init__(self, history: int = 300):
        self.pulses: deque = deque(maxlen=max(2, history))
        self.last_rx_mono = 0.0   # controller clock at last ingest
        self.last_seq = 0
        self.missed_ticks = 0
        self.health = "alive"     # alive | suspect (dead nodes drop out)
        self.wire_version = PULSE_VERSION

    def ingest(self, p: Pulse, rx_mono: float) -> None:
        self.pulses.append(p)
        self.last_rx_mono = rx_mono
        self.last_seq = p.seq
        self.missed_ticks = 0
        self.health = "alive"
        self.wire_version = p.version

    def latest(self) -> Optional[Pulse]:
        return self.pulses[-1] if self.pulses else None

    def window(self, n: int) -> List[Pulse]:
        if n <= 0:
            return list(self.pulses)
        return list(self.pulses)[-n:]


class ClusterAggregator:
    """Folds per-node pulse series into the cluster-level SLO view the
    dashboard, CLI, Prometheus federation and autoscaler all read."""

    def __init__(self, history: int = 300):
        self.history = max(2, int(history))
        self.series: Dict[str, NodeSeries] = {}

    def ingest(self, node_id: str, blob: bytes,
               rx_mono: Optional[float] = None) -> Optional[Pulse]:
        """Decode + store one pulse frame; returns the pulse, or None
        when the frame is malformed (dropped, counted nowhere — the next
        good pulse resets health anyway)."""
        try:
            p = decode(blob)
        except (ValueError, struct.error):
            return None
        s = self.series.get(node_id)
        if s is None:
            s = self.series[node_id] = NodeSeries(self.history)
        s.ingest(p, time.monotonic() if rx_mono is None else rx_mono)
        return p

    def forget(self, node_id: str) -> None:
        self.series.pop(node_id, None)

    def snapshot(self, window: int = 30) -> dict:
        """Cluster aggregate over the last `window` pulses per node:
        per-op p50/p99 + calls + bytes/s, per-node tail, and the
        resident totals."""
        ops: Dict[str, dict] = {}
        hists: Dict[str, Tuple[int, ...]] = {}
        span_s = 0.0
        nodes = {}
        tot = {"store_used": 0, "store_capacity": 0, "store_objects": 0,
               "queue_depth": 0, "num_workers": 0, "rss_bytes": 0,
               "shm_free_chunks": 0, "shm_arena_bytes": 0,
               "scope_dropped": 0, "events_dropped": 0}
        for node_id, s in self.series.items():
            w = s.window(window)
            last = s.latest()
            if last is not None:
                for k in tot:
                    tot[k] += getattr(last, k)
                nodes[node_id] = {
                    "health": s.health,
                    "seq": last.seq,
                    "missed_ticks": s.missed_ticks,
                    "age_s": max(0.0, time.monotonic() - s.last_rx_mono),
                    "store_used": last.store_used,
                    "store_capacity": last.store_capacity,
                    "store_objects": last.store_objects,
                    "queue_depth": last.queue_depth,
                    "num_workers": last.num_workers,
                    "rss_bytes": last.rss_bytes,
                    "shm_free_chunks": last.shm_free_chunks,
                    "shm_arena_bytes": last.shm_arena_bytes,
                    "prof_oncpu_permille": last.prof_oncpu_permille,
                    "prof_gil_permille": last.prof_gil_permille,
                    "wire_version": s.wire_version,
                }
                if s.wire_version != PULSE_VERSION:
                    # Old-format node: its kind deltas still fold (they
                    # are real data) but fields absent from its wire
                    # version read as zero — flag the row so status/
                    # dashboards don't misread zeros as idle.
                    nodes[node_id]["degraded"] = True
            if len(w) >= 2:
                span_s = max(span_s,
                             (w[-1].t_mono_ns - w[0].t_mono_ns) / 1e9)
            for p in w:
                for name, (calls, nbytes, ns, hist) in p.kinds.items():
                    o = ops.setdefault(name, {"calls": 0, "bytes": 0,
                                              "ns": 0})
                    o["calls"] += calls
                    o["bytes"] += nbytes
                    o["ns"] += ns
                    hists[name] = merge_hists(hists.get(name, ()), hist)
        for name, o in ops.items():
            h = hists.get(name, ())
            o["p50_ns"] = percentile_ns(h, 0.50)
            o["p99_ns"] = percentile_ns(h, 0.99)
            if span_s > 0:
                o["bytes_per_s"] = o["bytes"] / span_s
                o["calls_per_s"] = o["calls"] / span_s
            else:
                o["bytes_per_s"] = 0.0
                o["calls_per_s"] = 0.0
        return {"ops": ops, "nodes": nodes, "totals": tot,
                "window_s": span_s}

    def worst_p99_ns(self, window: int = 30,
                     kinds: Optional[Tuple[str, ...]] = None) -> float:
        """The slowest per-op p99 across the cluster — the autoscaler's
        latency signal. `kinds` restricts which ops count (default: all
        instrumented ops)."""
        snap = self.snapshot(window)
        worst = 0.0
        for name, o in snap["ops"].items():
            if kinds is not None and name not in kinds:
                continue
            worst = max(worst, float(o.get("p99_ns", 0.0)))
        return worst

    def total_queue_depth(self) -> int:
        depth = 0
        for s in self.series.values():
            p = s.latest()
            if p is not None:
                depth += p.queue_depth
        return depth
