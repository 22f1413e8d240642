"""graftlog: the crash-persistent cluster log plane.

Every worker (and the node agent) appends structured log records —
level, wall timestamp, and the emitting thread's task/actor context
from the graftprof registry — to a per-process ring that is a
``MAP_SHARED`` file ``logring-<pid>`` in the node's tmpfs store
directory. Unlike the graftscope/graftprof rings (anonymous process
memory), every record is on the filesystem the moment the emit
returns: a SIGKILL'd or OOM-killed worker leaves its last
``LOG_RING_SLOTS`` lines behind, and the node agent salvages the tail
post-mortem and attaches it to the task's grafttrail attempt record —
``get task`` on a dead task shows its final words, no ptrace, no core
dump.

Three producers feed the ring:

  * ``logging`` records from ``ray_tpu.*`` loggers, via
    :class:`GraftlogHandler` (attached by ``utils/logging.configure``);
  * raw stdout/stderr lines, via the :func:`install_stdio_tee` wrapper
    the worker installs at startup (the original stream still gets
    every byte, so the agent's pipe pump and driver echo are
    unchanged);
  * the node agent's own records (``LOG_SRC_AGENT``).

The emit path is csrc/log_core.cc when the native library is present
(a spinlock-serialized single-writer ring with a release-published
head) and a pure-Python ``mmap`` writer with the same file layout
otherwise. Records emitted before the ring opens (the worker learns
its store dir only after registering) buffer in a small pending deque
and flush on open.

The agent tails rings with :class:`RingReader` — the same acquire-head
/ copy / re-check-head lap discipline as the C drains, done on the
file — and ships coalesced batches fire-and-forget to the controller's
:class:`LogStore` (bounded, indexed by task/actor/node/level/time,
severity-aware eviction, error-storm dedup, per-worker rate caps).

Wire layout: lint pass 3h cross-checks the LOG_* constants below
against csrc/log_core.h (field order and width, struct format, record
size, source values, ring geometry).

Escape hatch: ``RAY_TPU_TORCH_GRAFTLOG=0`` or ``ray_tpu.init(graftlog=
False)`` turns the plane off; everything degrades to no-ops.
"""

from __future__ import annotations

import ctypes
import itertools
import logging
import mmap
import os
import struct
import sys
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Dict, List, NamedTuple, Optional, Tuple

# --- wire constants (lint-checked against csrc/log_core.h, pass 3h) -------

# Record sources.
LOG_SRC_LOGGER = 0  # a logging.Logger record (level preserved)
LOG_SRC_STDOUT = 1  # raw captured stdout line
LOG_SRC_STDERR = 2  # raw captured stderr line
LOG_SRC_AGENT = 3   # the node agent's own records
LOG_SRC_COUNT = 4

# Record layout: field name -> byte width, in wire order.
LOG_RECORD_FIELDS = (
    ("level", 1),
    ("source", 1),
    ("line_len", 2),
    ("seq", 4),
    ("t_ns", 8),
    ("task", 32),
    ("actor", 12),
    ("msg", 196),
)
LOG_RECORD = struct.Struct("<BBHIQ32s12s196s")
LOG_RECORD_SIZE = 256

# Ring geometry (kLog* in log_core.h). The file is
# LOG_HEADER_SIZE + LOG_RING_SLOTS * LOG_RECORD_SIZE bytes (~1 MiB).
LOG_RING_SLOTS = 4096
LOG_HEADER_SIZE = 64
LOG_TASK_CAP = 32   # full TaskID hex
LOG_ACTOR_CAP = 12  # ActorID hex prefix (graftprof convention)
LOG_MSG_CAP = 196
LOG_MAGIC = 0x474C4F31  # "GLO1"
LOG_RING_VERSION = 1

# File header: u32 magic|version|record_size|slots, u64 pid|head|
# dropped|start_ns, zero-pad to LOG_HEADER_SIZE.
LOG_HEADER = struct.Struct("<IIIIQQQQ")
_HEAD_OFF = 24  # byte offset of the u64 head counter

LOG_SRC_NAMES = {
    LOG_SRC_LOGGER: "logger",
    LOG_SRC_STDOUT: "stdout",
    LOG_SRC_STDERR: "stderr",
    LOG_SRC_AGENT: "agent",
}


class LogRec(NamedTuple):
    level: int
    source: int
    line_len: int
    seq: int
    t_ns: int
    task: str
    actor: str
    msg: str


def ring_path(store_dir: str, pid: int) -> str:
    return os.path.join(store_dir, "logring-%d" % pid)


# --- library access -------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
_lib_lock = threading.Lock()


def _get_lib() -> Optional[ctypes.CDLL]:
    """The shared library hosting the native emit path (log_core.cc is
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
    """Logging plane on? Uses the config flag (which RAY_TPU_TORCH_GRAFTLOG=0
    reaches through the normal env override path); the native side
    resolves the same env var independently."""
    try:
        from ray_tpu_torch.utils.config import GlobalConfig
        return bool(GlobalConfig.graftlog)
    except Exception:
        return True


# emit() sits under every print the stdio tee sees; the GlobalConfig
# attribute walk costs ~1.7us per call, so the flag is cached here and
# refreshed whenever the flag surface moves (set_enabled /
# configure_from_flags). None = not yet resolved.
_enabled_cache: Optional[bool] = None


def _enabled_fast() -> bool:
    global _enabled_cache
    if _enabled_cache is None:
        _enabled_cache = enabled()
    return _enabled_cache


def set_enabled(on: bool) -> None:
    global _enabled_cache
    _enabled_cache = bool(on)
    lib = _get_lib()
    if lib is not None:
        lib.log_set_enabled(1 if on else 0)


def configure_from_flags() -> None:
    try:
        from ray_tpu_torch.utils.config import GlobalConfig
        set_enabled(bool(GlobalConfig.graftlog))
    except Exception:
        pass


# --- the per-process ring writer ------------------------------------------

# One ring per process. _mode is "native" (log_core.cc owns the file)
# or "mmap" (pure-Python writer, same layout), None before open.
_mode: Optional[str] = None
_mm: Optional[mmap.mmap] = None
_mm_head = 0
_emit_lock = threading.Lock()
_ring_file: Optional[str] = None
# Records emitted before the ring opens (the worker only learns its
# store dir after registering with the agent) — replayed on open.
_pending: "deque[Tuple[int, int, str, str, str]]" = deque(maxlen=256)
_py_dropped = 0


def open_ring(store_dir: str, pid: Optional[int] = None) -> bool:
    """Create this process's ``logring-<pid>`` in ``store_dir`` and
    start appending to it; replays any pending pre-open records.
    Returns False (and stays pending) when the plane is disabled or
    the file cannot be created."""
    global _mode, _mm, _mm_head, _ring_file
    if not enabled():
        return False
    pid = os.getpid() if pid is None else pid
    lib = _get_lib()
    with _emit_lock:
        if lib is not None:
            if lib.log_ring_open(store_dir.encode("utf-8"), pid) != 0:
                return False
            _mode = "native"
        else:
            path = ring_path(store_dir, pid)
            total = LOG_HEADER_SIZE + LOG_RING_SLOTS * LOG_RECORD_SIZE
            try:
                fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC,
                             0o644)
                os.ftruncate(fd, total)
                _mm = mmap.mmap(fd, total, mmap.MAP_SHARED,
                                mmap.PROT_READ | mmap.PROT_WRITE)
                os.close(fd)
            except Exception:
                return False
            LOG_HEADER.pack_into(_mm, 0, LOG_MAGIC, LOG_RING_VERSION,
                                 LOG_RECORD_SIZE, LOG_RING_SLOTS, pid,
                                 0, 0, time.time_ns())
            _mm_head = 0
            _mode = "mmap"
        _ring_file = ring_path(store_dir, pid)
        pend = list(_pending)
        _pending.clear()
    for level, source, task, actor, msg in pend:
        _emit_now(level, source, task, actor, msg)
    return True


def close_ring() -> None:
    """Unmap the ring. The FILE stays — salvage reads it after death."""
    global _mode, _mm
    lib = _get_lib()
    with _emit_lock:
        if _mode == "native" and lib is not None:
            lib.log_ring_close()
        elif _mode == "mmap" and _mm is not None:
            try:
                _mm.close()
            except Exception:
                pass
            _mm = None
        _mode = None


def ring_file() -> Optional[str]:
    """Path of this process's ring file (None before open)."""
    return _ring_file if _mode is not None else None


def _emit_now(level: int, source: int, task: str, actor: str,
              msg: str) -> int:
    global _mm_head, _py_dropped
    lib = _get_lib()
    if _mode == "native" and lib is not None:
        raw = msg.encode("utf-8", "replace")
        return int(lib.log_emit(int(level), int(source),
                                task.encode("ascii", "replace"),
                                actor.encode("ascii", "replace"),
                                raw, len(raw)))
    if _mode == "mmap" and _mm is not None:
        raw = msg.encode("utf-8", "replace")
        with _emit_lock:
            h = _mm_head
            off = (LOG_HEADER_SIZE +
                   (h % LOG_RING_SLOTS) * LOG_RECORD_SIZE)
            LOG_RECORD.pack_into(
                _mm, off, min(255, max(0, int(level))), int(source) & 0xff,
                min(0xffff, len(raw)), (h + 1) & 0xffffffff,
                time.time_ns(), task.encode("ascii", "replace")[:LOG_TASK_CAP],
                actor.encode("ascii", "replace")[:LOG_ACTOR_CAP],
                raw[:LOG_MSG_CAP])
            _mm_head = h + 1
            # Publish after the record bytes: CPython writes the 8-byte
            # head in one aligned store, the best a pure-Python fallback
            # can do for the release discipline.
            struct.pack_into("<Q", _mm, _HEAD_OFF, h + 1)
        return h + 1
    _py_dropped += 1
    return 0


# The graftprof task registry (thread ident -> (task, actor, ...)) is
# resolved once and cached: an import statement inside the per-line hot
# path is a sys.modules probe per print.
_prof_registry: Optional[dict] = None


def _registry() -> Optional[dict]:
    global _prof_registry
    if _prof_registry is None:
        try:
            from ray_tpu_torch.core._native import graftprof
            _prof_registry = graftprof._task_registry
        except Exception:
            _prof_registry = {}
    return _prof_registry


def current_context() -> Tuple[str, str]:
    """The calling thread's (task, actor) from the graftprof registry
    ("", "") outside task execution."""
    try:
        ctx = _registry().get(threading.get_ident())
        return (ctx[0], ctx[1]) if ctx is not None else ("", "")
    except Exception:
        return ("", "")


def emit(level: int, source: int, msg: str, task: Optional[str] = None,
         actor: Optional[str] = None) -> int:
    """Append one record, attributing it to the calling thread's task
    context unless task/actor are given. Before the ring opens the
    record parks in the pending deque. Returns the record's seq, or 0
    when disabled / still pending.

    This is the per-line cost every tee'd print pays, so the common
    case (plane on, native ring open) is inlined: cached flag check,
    one registry probe, three encodes, one FFI call — no config walk,
    no import, no dispatch through _emit_now."""
    if not _enabled_fast():
        return 0
    if task is None and actor is None:
        ctx = _registry().get(threading.get_ident())
        if ctx is not None:
            task, actor = ctx[0], ctx[1]
        else:
            task = actor = ""
    task = task or ""
    actor = actor or ""
    if _mode == "native" and _lib is not None:
        raw = msg.encode("utf-8", "replace")
        return int(_lib.log_emit(int(level), int(source),
                                 task.encode("ascii", "replace"),
                                 actor.encode("ascii", "replace"),
                                 raw, len(raw)))
    if _mode is None:
        _pending.append((level, source, task, actor, msg))
        return 0
    return _emit_now(level, source, task, actor, msg)


def emit_batch(level: int, source: int, lines: List[str],
               task: str = "", actor: str = "") -> int:
    """Append a batch of same-context lines as consecutive records with
    ONE FFI crossing (log_emit_batch joins on newline and fills slots
    under a single lock acquisition / clock read). The stdio tee
    flushes its per-quantum buffer through this — the per-line cost of
    a print storm drops from one full emit() to a list append. Returns
    the seq of the last record, or 0 when disabled / empty / pending.
    Lines must not contain newlines (the tee's lines are split
    products; a stray one would just split into extra records)."""
    if not _enabled_fast() or not lines:
        return 0
    if _mode == "native" and _lib is not None:
        raw = "\n".join(lines).encode("utf-8", "replace")
        return int(_lib.log_emit_batch(int(level), int(source),
                                       task.encode("ascii", "replace"),
                                       actor.encode("ascii", "replace"),
                                       raw, len(raw)))
    if _mode is None:
        for line in lines:
            _pending.append((level, source, task, actor, line))
        return 0
    n = 0
    for line in lines:
        n = _emit_now(level, source, task, actor, line)
    return n


def emitted() -> int:
    lib = _get_lib()
    if _mode == "native" and lib is not None:
        return int(lib.log_emitted())
    return _mm_head if _mode == "mmap" else 0


def dropped() -> int:
    lib = _get_lib()
    n = _py_dropped
    if lib is not None:
        n += int(lib.log_dropped())
    return n


# --- decode + cross-process tailing ---------------------------------------

def decode_record(buf: bytes, off: int = 0) -> LogRec:
    (level, source, line_len, seq, t_ns, task, actor,
     msg) = LOG_RECORD.unpack_from(buf, off)
    return LogRec(level, source, line_len, seq, t_ns,
                  task.rstrip(b"\x00").decode("ascii", "replace"),
                  actor.rstrip(b"\x00").decode("ascii", "replace"),
                  msg[:min(line_len, LOG_MSG_CAP)].decode("utf-8",
                                                          "replace"))


def decode(buf: bytes) -> List[LogRec]:
    """Decode a blob of wire records; a trailing partial is ignored."""
    out = []
    end = len(buf) - len(buf) % LOG_RECORD_SIZE
    for off in range(0, end, LOG_RECORD_SIZE):
        out.append(decode_record(buf, off))
    return out


def drain_raw() -> bytes:
    """Drain this process's OWN ring via the native cursor (tests and
    parity checks; the agent tails files with RingReader instead)."""
    lib = _get_lib()
    if lib is None or _mode != "native":
        return b""
    cap = 256 * LOG_RECORD_SIZE
    buf = ctypes.create_string_buffer(cap)
    n = lib.log_drain(buf, cap)
    return buf.raw[:n] if n > 0 else b""


def _read_header(f) -> Optional[tuple]:
    f.seek(0)
    hdr = f.read(LOG_HEADER_SIZE)
    if len(hdr) < LOG_HEADER_SIZE:
        return None
    vals = LOG_HEADER.unpack_from(hdr, 0)
    if vals[0] != LOG_MAGIC or vals[1] != LOG_RING_VERSION:
        return None
    if vals[2] != LOG_RECORD_SIZE or vals[3] <= 0:
        return None
    return vals


class RingReader:
    """Tail another process's ring file with a persistent cursor.

    Same lap discipline as the C drains, applied to the file: load the
    published head, copy records, re-load the head, and discard
    anything the (possibly live) writer could have overwritten during
    the copy. Torn records additionally fail the embedded-seq check.
    Safe against the file not existing yet, being truncated and
    rewritten (ring re-open), or disappearing (salvage unlinked it)."""

    def __init__(self, path: str):
        self.path = path
        self.cursor = 0
        self.dropped = 0

    def poll(self, max_records: int = 1024) -> List[LogRec]:
        try:
            with open(self.path, "rb") as f:
                vals = _read_header(f)
                if vals is None:
                    return []
                slots, head = vals[3], vals[5]
                if head < self.cursor:
                    # The writer re-opened (truncate resets head):
                    # restart from the beginning of the new ring.
                    self.cursor = 0
                t = self.cursor
                if head - t > slots:
                    safe = head - slots
                    self.dropped += safe - t
                    t = safe
                out: List[LogRec] = []
                stop = min(head, t + max_records)
                while t < stop:
                    f.seek(LOG_HEADER_SIZE + (t % slots) * LOG_RECORD_SIZE)
                    raw = f.read(LOG_RECORD_SIZE)
                    if len(raw) < LOG_RECORD_SIZE:
                        break
                    rec = decode_record(raw)
                    # Re-check the head: if the writer lapped past t
                    # while we read, the slot contents are suspect.
                    vals2 = _read_header(f)
                    h2 = vals2[5] if vals2 is not None else head
                    if h2 - t > slots:
                        safe = h2 - slots
                        self.dropped += safe - t
                        t = safe
                        stop = min(h2, t + max_records)
                        continue
                    if rec.seq != ((t + 1) & 0xffffffff):
                        # Torn or stale slot; skip it.
                        self.dropped += 1
                        t += 1
                        continue
                    out.append(rec)
                    t += 1
                self.cursor = t
                return out
        except (OSError, struct.error):
            return []


def salvage_ring(path: str, tail: int = 200) -> Tuple[dict, List[LogRec]]:
    """Post-mortem decode of a dead process's ring file: the last
    ``tail`` records plus the header metadata. The writer is gone, so
    no lap discipline — only the embedded seq check filters never-
    written slots. Returns ({}, []) when the file is missing/garbage."""
    try:
        with open(path, "rb") as f:
            vals = _read_header(f)
            if vals is None:
                return {}, []
            slots, head = vals[3], vals[5]
            meta = {"pid": int(vals[4]), "emitted": int(head),
                    "dropped": int(vals[6]), "start_ns": int(vals[7])}
            n = min(head, slots, max(1, tail))
            out: List[LogRec] = []
            for t in range(head - n, head):
                f.seek(LOG_HEADER_SIZE + (t % slots) * LOG_RECORD_SIZE)
                raw = f.read(LOG_RECORD_SIZE)
                if len(raw) < LOG_RECORD_SIZE:
                    break
                rec = decode_record(raw)
                if rec.seq == ((t + 1) & 0xffffffff):
                    out.append(rec)
            return meta, out
    except (OSError, struct.error):
        return {}, []


# --- producers: logging handler + stdio tee -------------------------------

class GraftlogHandler(logging.Handler):
    """Routes ``ray_tpu.*`` logger records into the ring with the
    Python level preserved. The wire record carries level/time/task
    natively, so only the rendered message body is stored."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            globals()["emit"](record.levelno, LOG_SRC_LOGGER,
                              record.getMessage())
        except Exception:
            pass


class _TeeStream:
    """Wraps sys.stdout/sys.stderr: every byte still reaches the
    original stream (the agent's pipe pump and driver echo are
    untouched); complete lines are additionally emitted to the ring
    with the thread's task context.

    Ring emits are BATCHED per flush quantum: lines buffer as
    (task, actor) context runs and ship through emit_batch (one FFI
    crossing per run) when the buffer reaches _FLUSH_LINES, the oldest
    buffered line ages past _FLUSH_NS, or flush() is called — the
    worker flushes at task completion and on the telemetry tick, so a
    task's lines are ring-visible by the time its result is. WARNING+
    streams (stderr) bypass the buffer entirely: tracebacks and last
    words are the crash-forensics payload and must hit the
    MAP_SHARED ring the moment they are written, not a quantum later."""

    _MAX_PARTIAL = 8192
    _FLUSH_LINES = 64
    _FLUSH_NS = 50_000_000  # 50ms

    def __init__(self, stream, source: int, level: int):
        self._stream = stream
        self._source = source
        self._level = level
        self._partial = ""
        self._lock = threading.Lock()
        self._buf: List[tuple] = []  # (task, actor, [lines]) runs
        self._buf_n = 0
        self._buf_ns = 0

    def write(self, s) -> int:
        n = self._stream.write(s)
        try:
            batch = None
            with self._lock:
                self._partial += s
                if "\n" in self._partial or \
                        len(self._partial) > self._MAX_PARTIAL:
                    *lines, self._partial = self._partial.split("\n")
                    if len(self._partial) > self._MAX_PARTIAL:
                        lines.append(self._partial)
                        self._partial = ""
                    lines = [ln for ln in lines if ln]
                    if lines:
                        ctx = _registry().get(threading.get_ident())
                        task, actor = (ctx[0], ctx[1]) \
                            if ctx is not None else ("", "")
                        if self._buf and self._buf[-1][0] == task \
                                and self._buf[-1][1] == actor:
                            self._buf[-1][2].extend(lines)
                        else:
                            self._buf.append((task, actor, lines))
                        if self._buf_n == 0:
                            self._buf_ns = time.monotonic_ns()
                        self._buf_n += len(lines)
                        if (self._level >= logging.WARNING
                                or self._buf_n >= self._FLUSH_LINES
                                or time.monotonic_ns() - self._buf_ns
                                >= self._FLUSH_NS):
                            batch, self._buf, self._buf_n = \
                                self._buf, [], 0
            if batch:
                for task, actor, run in batch:
                    emit_batch(self._level, self._source, run,
                               task, actor)
        except Exception:
            pass
        return n

    def flush(self) -> None:
        self._stream.flush()
        self.flush_ring()

    def flush_ring(self) -> None:
        """Ship buffered lines to the ring without touching the
        underlying stream (loop-safe: no blocking stream I/O)."""
        try:
            with self._lock:
                batch, self._buf, self._buf_n = self._buf, [], 0
            for task, actor, run in batch:
                emit_batch(self._level, self._source, run, task, actor)
        except Exception:
            pass

    def __getattr__(self, name):
        return getattr(self._stream, name)


_tee_installed = False
_tees: List["_TeeStream"] = []


def install_stdio_tee() -> None:
    """Wrap sys.stdout/sys.stderr once (worker startup). Raw prints
    land in the ring as LOG_SRC_STDOUT/LOG_SRC_STDERR lines."""
    global _tee_installed
    if _tee_installed or not enabled():
        return
    sys.stdout = _TeeStream(sys.stdout, LOG_SRC_STDOUT, logging.INFO)
    sys.stderr = _TeeStream(sys.stderr, LOG_SRC_STDERR, logging.WARNING)
    _tees[:] = [sys.stdout, sys.stderr]
    _tee_installed = True


def flush_stdio_tee() -> None:
    """Ship any tee-buffered lines to the ring. Called at task
    completion and on the worker's telemetry tick so the batching
    quantum never delays a finished task's lines past its result."""
    for tee in _tees:
        tee.flush_ring()


# --- controller-side log store --------------------------------------------

class LogStore:
    """Bounded, indexed cluster log store (controller-owned).

    Ingests coalesced batches from node agents plus post-mortem
    salvage tails. Four secondary indexes (task, actor, node, level)
    over one id-ordered primary table; ids are monotonically
    increasing, so index sets sort back into time order for free.

    Bounding, in grafttrail's settled-first spirit: when over cap,
    evict the oldest sub-WARNING records first — routine chatter goes
    before errors, and salvaged last-words go last (they are the
    forensics payload).

    Storm control at ingest: (a) per-(node, pid) duplicate suppression
    — an identical message inside the dedup window bumps a ``repeats``
    counter instead of storing a new row; (b) a per-(node, pid) token
    bucket caps sustained ingest rate (suppressed counts are
    accounted, salvage bypasses both); (c) a per-(node, pid) seq
    high-water mark drops records the live tail already shipped when a
    salvage overlaps it."""

    def __init__(self, cap: int = 20000, rate_per_s: float = 200.0,
                 dedup_window_s: float = 5.0, id_alloc=None):
        self.cap = max(100, int(cap))
        self.rate_per_s = float(rate_per_s)
        self.dedup_window_s = float(dedup_window_s)
        self._recs: "OrderedDict[int, dict]" = OrderedDict()
        # Row ids must be globally monotonic even when several shard
        # stores share the table (ShardedLogStore injects one shared
        # counter; itertools.count.__next__ is atomic under the GIL, so
        # cross-shard allocation needs no extra lock).
        self._id_alloc = id_alloc if id_alloc is not None \
            else itertools.count(1).__next__
        self._by_task: Dict[str, set] = {}
        self._by_actor: Dict[str, set] = {}
        self._by_node: Dict[str, set] = {}
        self._by_level: Dict[int, set] = {}
        # (node, pid) -> [tokens, last_refill_monotonic]
        self._buckets: Dict[Tuple[str, int], List[float]] = {}
        # (node, pid, task, msg) -> (row id, ingest wall time)
        self._dedup: Dict[Tuple[str, int, str, str], Tuple[int, float]] = {}
        # (node, pid) -> highest live-tail seq ingested
        self._seq_hw: Dict[Tuple[str, int], int] = {}
        self._lock = threading.Lock()
        self.ingested = 0
        self.suppressed = 0
        self.deduped = 0
        self.evicted = 0

    # -- ingest ------------------------------------------------------------

    def _bucket_ok(self, node: str, pid: int, now: float) -> bool:
        b = self._buckets.get((node, pid))
        if b is None:
            b = self._buckets[(node, pid)] = [self.rate_per_s, now]
        tokens, last = b
        tokens = min(2.0 * self.rate_per_s,
                     tokens + (now - last) * self.rate_per_s)
        b[1] = now
        if tokens < 1.0:
            b[0] = tokens
            return False
        b[0] = tokens - 1.0
        return True

    def _evict_one(self) -> None:
        victim = None
        for rid, row in self._recs.items():
            if row["level"] < logging.WARNING and not row["salvaged"]:
                victim = rid
                break
        if victim is None and self._by_node:
            # Only WARNING+/salvaged rows left: cardinality fairness —
            # take the oldest non-salvaged row of the NOISIEST node, so
            # one node's warning storm reclaims its own space instead
            # of rolling every other node's errors out of the store.
            noisiest = max(self._by_node,
                           key=lambda k: len(self._by_node[k]))
            for rid in sorted(self._by_node[noisiest]):
                if not self._recs[rid]["salvaged"]:
                    victim = rid
                    break
        if victim is None:
            for rid, row in self._recs.items():
                if not row["salvaged"]:
                    victim = rid
                    break
        if victim is None:
            victim = next(iter(self._recs))
        self._unindex(self._recs.pop(victim))
        self.evicted += 1

    def _unindex(self, row: dict) -> None:
        for idx, key in ((self._by_task, row["task"]),
                         (self._by_actor, row["actor"]),
                         (self._by_node, row["node"]),
                         (self._by_level, row["level"])):
            s = idx.get(key)
            if s is not None:
                s.discard(row["id"])
                if not s:
                    del idx[key]

    def _insert(self, row: dict) -> None:
        rid = self._id_alloc()
        row["id"] = rid
        self._recs[rid] = row
        for idx, key in ((self._by_task, row["task"]),
                         (self._by_actor, row["actor"]),
                         (self._by_node, row["node"]),
                         (self._by_level, row["level"])):
            idx.setdefault(key, set()).add(rid)
        while len(self._recs) > self.cap:
            self._evict_one()

    def ingest_batch(self, node: str, records: List[dict],
                     salvaged: bool = False) -> int:
        """Ingest one agent batch; returns rows actually stored.
        Each record: {pid, level, source, seq, t_ns, task, actor, msg,
        line_len, repeats?}. Salvage bypasses dedup and rate caps but
        still honors the seq high-water (the live tail may have
        shipped the same slots already)."""
        now = time.time()
        stored = 0
        with self._lock:
            for rec in records or ():
                try:
                    pid = int(rec.get("pid") or 0)
                    level = int(rec.get("level") or 0)
                    seq = int(rec.get("seq") or 0)
                    msg = str(rec.get("msg") or "")
                    task = str(rec.get("task") or "")
                    actor = str(rec.get("actor") or "")
                except Exception:
                    continue
                key = (node, pid)
                if seq > 0:
                    if seq <= self._seq_hw.get(key, 0):
                        continue
                    self._seq_hw[key] = seq
                if not salvaged:
                    dkey = (node, pid, task, msg)
                    hit = self._dedup.get(dkey)
                    if hit is not None and \
                            now - hit[1] < self.dedup_window_s:
                        row = self._recs.get(hit[0])
                        if row is not None:
                            row["repeats"] += 1
                            row["t_ns"] = int(rec.get("t_ns") or 0) \
                                or row["t_ns"]
                            self._dedup[dkey] = (hit[0], now)
                            self.deduped += 1
                            continue
                    if not self._bucket_ok(node, pid, now):
                        self.suppressed += 1
                        continue
                row = {
                    "id": 0,
                    "t_ns": int(rec.get("t_ns") or 0),
                    "level": level,
                    "source": int(rec.get("source") or 0),
                    "pid": pid,
                    "node": node,
                    "task": task,
                    "actor": actor,
                    "msg": msg,
                    "line_len": int(rec.get("line_len") or len(msg)),
                    "repeats": int(rec.get("repeats") or 0),
                    "salvaged": bool(salvaged),
                }
                self._insert(row)
                if not salvaged:
                    self._dedup[(node, pid, task, msg)] = (row["id"], now)
                stored += 1
                self.ingested += 1
            if len(self._dedup) > 4 * self.cap:
                cutoff = now - self.dedup_window_s
                self._dedup = {k: v for k, v in self._dedup.items()
                               if v[1] >= cutoff}
        return stored

    # -- queries -----------------------------------------------------------

    def _candidates(self, task: str, actor: str, node: str,
                    level: int) -> Optional[set]:
        """The most selective index's id set (task > actor > node),
        or None for a full scan. Task/actor filters are prefix
        matches, mirroring the other planes' CLI surfaces."""
        if task:
            out: set = set()
            for key, ids in self._by_task.items():
                if key.startswith(task):
                    out |= ids
            return out
        if actor:
            out = set()
            for key, ids in self._by_actor.items():
                if key.startswith(actor):
                    out |= ids
            return out
        if node:
            return set(self._by_node.get(node, ()))
        if level > 0:
            out = set()
            for lv, ids in self._by_level.items():
                if lv >= level:
                    out |= ids
            return out
        return None

    def list(self, task: str = "", actor: str = "", node: str = "",
             level: int = 0, since_ns: int = 0, after_id: int = 0,
             limit: int = 100) -> List[dict]:
        """Matching rows in time (id) order — the last ``limit`` of
        them, so the default reads as a tail. ``after_id`` turns it
        into a follow cursor: only rows newer than the given id, the
        `logs -f` / `state.list_logs` incremental path."""
        limit = max(1, int(limit))
        with self._lock:
            cand = self._candidates(task, actor, node, level)
            ids = sorted(cand) if cand is not None else list(self._recs)
            out: List[dict] = []
            for rid in reversed(ids):
                row = self._recs.get(rid)
                if row is None:
                    continue
                if rid <= after_id:
                    break
                if task and not row["task"].startswith(task):
                    continue
                if actor and not row["actor"].startswith(actor):
                    continue
                if node and row["node"] != node:
                    continue
                if level > 0 and row["level"] < level:
                    continue
                if since_ns > 0 and row["t_ns"] < since_ns:
                    continue
                out.append(dict(row))
                if len(out) >= limit:
                    break
            out.reverse()
            return out

    def task_tail(self, task: str, limit: int = 20) -> List[dict]:
        """The task's last rows — the grafttrail `get task` join."""
        return self.list(task=task, limit=limit)

    def stats(self) -> dict:
        with self._lock:
            by_level: Dict[str, int] = {}
            salvaged = 0
            for row in self._recs.values():
                name = logging.getLevelName(
                    row["level"] // 10 * 10) if row["level"] else "NOTSET"
                by_level[name] = by_level.get(name, 0) + 1
                if row["salvaged"]:
                    salvaged += 1
            return {"records": len(self._recs),
                    "cap": self.cap,
                    "ingested": self.ingested,
                    "suppressed": self.suppressed,
                    "deduped": self.deduped,
                    "evicted": self.evicted,
                    "salvaged": salvaged,
                    "tasks": len(self._by_task),
                    "nodes": len(self._by_node),
                    "by_level": by_level}


class ShardedLogStore:
    """Node-hash partitioned LogStore: N independent stores, each with
    its own lock, indexes, eviction and cap slice, routed by
    ``crc32(node) % N``.

    What the scale harness showed at 256+ nodes is the classic
    singleton-store shape: every agent batch serialized through one
    lock, and one node's eviction pressure scanning (and evicting)
    every other node's rows. Sharding makes both per-partition —
    ingest for node A never contends with node B's, and a noisy
    shard's eviction churn is bounded by its own cap slice.

    Row ids stay *globally* monotonic (one shared allocator injected
    into every shard), which is the invariant the merged ``list()``
    and its ``after_id`` follow-cursor semantics ride on: per-shard
    tails merge-sort by id straight back into cluster time order."""

    def __init__(self, shards: int = 8, cap: int = 20000,
                 rate_per_s: float = 200.0, dedup_window_s: float = 5.0):
        n = max(1, int(shards))
        self.cap = max(100, int(cap))
        alloc = itertools.count(1).__next__
        self.shards = [LogStore(cap=max(100, self.cap // n),
                                rate_per_s=rate_per_s,
                                dedup_window_s=dedup_window_s,
                                id_alloc=alloc)
                       for _ in range(n)]

    def _shard(self, node: str) -> LogStore:
        return self.shards[zlib.crc32(node.encode()) % len(self.shards)]

    def ingest_batch(self, node: str, records: List[dict],
                     salvaged: bool = False) -> int:
        return self._shard(node).ingest_batch(node, records,
                                              salvaged=salvaged)

    def list(self, task: str = "", actor: str = "", node: str = "",
             level: int = 0, since_ns: int = 0, after_id: int = 0,
             limit: int = 100) -> List[dict]:
        if node:  # node filter pins the shard — no fan-out
            return self._shard(node).list(task=task, actor=actor,
                                          node=node, level=level,
                                          since_ns=since_ns,
                                          after_id=after_id, limit=limit)
        limit = max(1, int(limit))
        rows: List[dict] = []
        for s in self.shards:
            rows.extend(s.list(task=task, actor=actor, level=level,
                               since_ns=since_ns, after_id=after_id,
                               limit=limit))
        rows.sort(key=lambda r: r["id"])
        return rows[-limit:]

    def task_tail(self, task: str, limit: int = 20) -> List[dict]:
        return self.list(task=task, limit=limit)

    def stats(self) -> dict:
        out = {"records": 0, "cap": self.cap, "ingested": 0,
               "suppressed": 0, "deduped": 0, "evicted": 0,
               "salvaged": 0, "tasks": 0, "nodes": 0,
               "by_level": {}, "shards": len(self.shards),
               "shard_records": []}
        for s in self.shards:
            st = s.stats()
            for k in ("records", "ingested", "suppressed", "deduped",
                      "evicted", "salvaged", "tasks", "nodes"):
                out[k] += st[k]
            for name, cnt in st["by_level"].items():
                out["by_level"][name] = out["by_level"].get(name, 0) + cnt
            out["shard_records"].append(st["records"])
        return out
