"""graftprof: the always-on continuous profiling plane.

Two samplers cooperate in every worker (and the node agent):

  * csrc/prof_core.cc runs one native thread per process at
    ``prof_hz`` (default 67 Hz — off-round so the tick train can't
    alias with the 2 s flush or the 1 s pulse). Each tick it snapshots
    every registered thread's ``CLOCK_THREAD_CPUTIME_ID`` (the native
    sidecar threads — graftrpc reactor, store conn/accept loops,
    graftcopy workers, the reaper — register themselves at birth, and
    Python exec threads register through ``register_current_thread``)
    and times one GIL acquire from outside the interpreter via the
    ``PyGILState_Ensure``/``Release`` pointers handed over at start.
  * this module runs a Python wall-stack sampler at the same rate:
    each tick pairs ``sys._current_frames()`` with the thread→task
    registry that the core worker maintains at task entry/exit, interns
    frames into a per-worker frame table, and folds the samples into
    compact per-(task, actor) folded-stack profiles.

Profiles ride the existing worker→agent 2 s flush tick
(``collect_flush`` returns the since-last-flush *delta* and resets, so
controller-side merges only ever add — a dead worker just stops
contributing, never subtracts) and the agent→controller fire-and-forget
path (the graftpulse/grafttrail transport shape; no new RPC
round-trips). The controller keeps a bounded per-node/per-task
``ProfStore`` with merge-on-fold.

Known limitation (by design): the wall-stack sampler is a Python
thread, so it cannot sample *during* a C-extension GIL hold — but the
native GIL probe times exactly those windows, which is why the two
samplers ship as one plane.

Wire layout: lint pass 3g cross-checks the PROF_* constants below
against csrc/prof_core.h (field order and width, struct format, record
size, kind values, ring geometry).

Escape hatch: ``RAY_TPU_TORCH_GRAFTPROF=0`` or ``ray_tpu.init(graftprof=
False)`` turns both samplers off; everything here degrades to no-ops
when the native library is absent.
"""

from __future__ import annotations

import atexit
import ctypes
import os
import struct
import sys
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Dict, List, NamedTuple, Optional, Tuple

# --- wire constants (lint-checked against csrc/prof_core.h, pass 3g) ------

# Record kinds.
PROF_TICK = 1        # sampler tick marker (val_us = measured period)
PROF_THREAD_CPU = 2  # one registered thread's CPU delta this tick
PROF_GIL_WAIT = 3    # one GIL probe's acquire latency
PROF_KIND_COUNT = 4

# Record layout: field name -> byte width, in wire order.
PROF_RECORD_FIELDS = (
    ("kind", 1),
    ("slot", 1),
    ("flags", 2),
    ("val_us", 4),
    ("tick", 8),
    ("t_ns", 8),
)
PROF_RECORD = struct.Struct("<BBHIQQ")
PROF_RECORD_SIZE = 24

# Sampler geometry (kProf* in prof_core.h).
PROF_DEFAULT_HZ = 67
PROF_MAX_THREADS = 64
PROF_RING_CAP = 4096
PROF_NAME_CAP = 32

PROF_KIND_NAMES = {
    PROF_TICK: "tick",
    PROF_THREAD_CPU: "thread_cpu",
    PROF_GIL_WAIT: "gil_wait",
}

_MAX_STACK_DEPTH = 64


class ProfRec(NamedTuple):
    kind: int
    slot: int
    flags: int
    val_us: int
    tick: int
    t_ns: int


# --- library access -------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
_lib_lock = threading.Lock()


def _get_lib() -> Optional[ctypes.CDLL]:
    """The shared library hosting the native sampler (prof_core.cc is
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
    """Profiling on? Uses the config flag (which RAY_TPU_TORCH_GRAFTPROF=0
    reaches through the normal env override path); the native side
    resolves the same env var independently for pure-C processes."""
    try:
        from ray_tpu_torch.utils.config import GlobalConfig
        return bool(GlobalConfig.graftprof)
    except Exception:
        return True


def set_enabled(on: bool) -> None:
    lib = _get_lib()
    if lib is not None:
        lib.prof_set_enabled(1 if on else 0)


def configure_from_flags() -> None:
    try:
        from ray_tpu_torch.utils.config import GlobalConfig
        set_enabled(bool(GlobalConfig.graftprof))
    except Exception:
        pass


def prof_hz() -> int:
    try:
        from ray_tpu_torch.utils.config import GlobalConfig
        hz = int(GlobalConfig.prof_hz)
        return hz if hz > 0 else PROF_DEFAULT_HZ
    except Exception:
        return PROF_DEFAULT_HZ


def decode(buf: bytes) -> List[ProfRec]:
    """Decode a blob of wire records; a trailing partial is ignored."""
    out = []
    end = len(buf) - len(buf) % PROF_RECORD_SIZE
    for off in range(0, end, PROF_RECORD_SIZE):
        out.append(ProfRec(*PROF_RECORD.unpack_from(buf, off)))
    return out


_DRAIN_BUF_SIZE = 96 << 10  # whole multiple of the record size


def drain_raw() -> bytes:
    lib = _get_lib()
    if lib is None:
        return b""
    buf = ctypes.create_string_buffer(_DRAIN_BUF_SIZE)
    n = lib.prof_drain(buf, _DRAIN_BUF_SIZE)
    return buf.raw[:n] if n > 0 else b""


def drain_records(max_passes: int = 16) -> List[ProfRec]:
    out: List[ProfRec] = []
    for _ in range(max_passes):
        raw = drain_raw()
        if not raw:
            break
        out.extend(decode(raw))
    return out


def dropped() -> int:
    lib = _get_lib()
    return int(lib.prof_dropped()) if lib is not None else 0


def ticks() -> int:
    lib = _get_lib()
    return int(lib.prof_ticks()) if lib is not None else 0


def gil_wait_ns() -> int:
    lib = _get_lib()
    return int(lib.prof_gil_wait_ns()) if lib is not None else 0


def gil_probes() -> int:
    lib = _get_lib()
    return int(lib.prof_gil_probes()) if lib is not None else 0


def thread_cpu_ns() -> List[int]:
    """Per-slot cumulative CPU ns the native sampler has observed
    (dead threads keep their frozen total)."""
    lib = _get_lib()
    if lib is None:
        return []
    arr = (ctypes.c_uint64 * PROF_MAX_THREADS)()
    k = lib.prof_thread_cpu_ns(arr, PROF_MAX_THREADS)
    return [int(arr[s]) for s in range(max(0, min(k, PROF_MAX_THREADS)))]


def thread_names() -> List[str]:
    """Per-slot registered names, index-aligned with thread_cpu_ns()."""
    lib = _get_lib()
    if lib is None:
        return []
    n = int(lib.prof_thread_count())
    out = []
    buf = ctypes.create_string_buffer(PROF_NAME_CAP)
    for s in range(max(0, min(n, PROF_MAX_THREADS))):
        k = lib.prof_thread_name(s, buf, PROF_NAME_CAP)
        out.append(buf.value.decode("utf-8", "replace") if k >= 0 else "")
    return out


# --- thread -> task registry ----------------------------------------------

# The wall-stack sampler runs on its own thread, so the exec paths
# can't hand it context through threading.local — they publish
# {thread ident: (task_id, actor, name)} here instead. Plain dict ops
# are GIL-atomic; the lock only serializes writers.
_task_registry: Dict[int, Tuple[str, str, str]] = {}
_registry_lock = threading.Lock()

# thread ident -> native slot for threads registered from Python, so
# collect_flush can attribute C-side CPU deltas to tasks.
_slot_by_ident: Dict[int, int] = {}


def set_task_context(task_id: str, actor: str = "", name: str = "",
                     ident: Optional[int] = None) -> None:
    """Tag the calling (or given) thread's samples with a task/actor
    until clear_task_context. Called at task-execution entry."""
    key = ident if ident is not None else threading.get_ident()
    with _registry_lock:
        _task_registry[key] = (task_id or "", actor or "", name or "")


def clear_task_context(ident: Optional[int] = None) -> None:
    key = ident if ident is not None else threading.get_ident()
    with _registry_lock:
        _task_registry.pop(key, None)


def register_current_thread(name: str) -> int:
    """Register the calling thread for native CPU-time sampling and
    remember its slot for task attribution. Idempotent.

    Called on every task-execution entry, so already-registered
    threads take a dict-lookup fast path instead of crossing the FFI
    (the C side keys on gettid and would return the same slot)."""
    cached = _slot_by_ident.get(threading.get_ident())
    if cached is not None:
        return cached
    lib = _get_lib()
    if lib is None:
        return -1
    slot = int(lib.prof_register_thread(name.encode("utf-8", "replace")))
    if slot >= 0:
        _slot_by_ident[threading.get_ident()] = slot
    return slot


# --- folded-stack accumulation --------------------------------------------

class _Accum:
    """One accumulation window: interned frame table plus folded
    per-(task, actor) stack counts. Reset on every flush — only deltas
    ever leave the process."""

    def __init__(self) -> None:
        self.frame_ids: Dict[str, int] = {}
        self.frames: List[str] = []
        # (task, actor, name, stack idx tuple) -> samples
        self.stacks: Dict[Tuple[str, str, str, Tuple[int, ...]], int] = {}
        # (ident, (task, actor, name)) -> samples, for CPU apportionment
        self.thread_task: Dict[Tuple[int, Tuple[str, str, str]], int] = {}
        self.samples = 0

    def intern(self, label: str) -> int:
        fid = self.frame_ids.get(label)
        if fid is None:
            fid = len(self.frames)
            self.frame_ids[label] = fid
            self.frames.append(label)
        return fid

    def add(self, ctx: Tuple[str, str, str], ident: int,
            stack: Tuple[int, ...]) -> None:
        key = ctx + (stack,)
        self.stacks[key] = self.stacks.get(key, 0) + 1
        tkey = (ident, ctx)
        self.thread_task[tkey] = self.thread_task.get(tkey, 0) + 1
        self.samples += 1


def _frame_label(frame) -> str:
    code = frame.f_code
    return "%s:%s" % (os.path.basename(code.co_filename), code.co_name)


def _fold_frame(frame, accum: _Accum) -> Tuple[int, ...]:
    """Walk a frame to the root and return the interned stack,
    root-first (flamegraph order)."""
    labels: List[int] = []
    f = frame
    depth = 0
    while f is not None and depth < _MAX_STACK_DEPTH:
        labels.append(accum.intern(_frame_label(f)))
        f = f.f_back
        depth += 1
    labels.reverse()
    return tuple(labels)


# --- the wall-stack sampler -----------------------------------------------

class _PySampler(threading.Thread):
    """Daemon thread pairing native ticks with Python wall stacks.
    ``extra`` accumulators let an RPC handler capture a bounded window
    (``capture_stacks``) without disturbing the flush accumulator."""

    def __init__(self, hz: int):
        super().__init__(name="graftprof-py-sampler", daemon=True)
        self.period = 1.0 / max(1, hz)
        # The CPU-share budget is pinned at _BUDGET_FRACTION for the
        # default always-on rate and scales linearly for explicitly
        # higher rates: asking for 3x the default rate is an explicit
        # opt-in to 3x the sampling cost (e.g. a bounded
        # `stack --profile` capture window), not a reason for the
        # governor to quietly clamp the capture back to the default.
        self._budget = self._BUDGET_FRACTION * max(
            1.0, float(hz) / PROF_DEFAULT_HZ)
        self.accum = _Accum()
        self.extra: List[_Accum] = []
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._names: Dict[int, str] = {}
        self._name_refresh = 0

    def stop(self) -> None:
        self._stop.set()

    def _thread_name(self, ident: int) -> str:
        if self._name_refresh <= 0:
            self._names = {t.ident: t.name for t in threading.enumerate()
                           if t.ident is not None}
            self._name_refresh = 64
        self._name_refresh -= 1
        return self._names.get(ident, "?")

    def sample_once(self) -> bool:
        """One wall-stack sweep. Returns False on an idle tick.

        Sampling is gated on having something to attribute: with no
        task context registered and no capture window open, the tick
        is a dict check and nothing else. This is what keeps an
        always-on profiler honest on its overhead budget — a parked
        worker (or the driver) costs ~nothing, and cost scales with
        actual task execution, not with process count. The flush
        accumulator only folds context-tagged threads for the same
        reason; anonymous threads are folded for capture windows
        (`stack --profile`), which want the whole process."""
        if not enabled():
            return False
        extra = self.extra  # snapshot; swapped under self.lock
        if not _task_registry and not extra:
            return False
        frames = sys._current_frames()
        me = threading.get_ident()
        sampled = False
        with self.lock:
            extra = list(self.extra)
            for ident, frame in frames.items():
                if ident == me:
                    continue
                ctx = _task_registry.get(ident)
                if ctx is not None:
                    stack = _fold_frame(frame, self.accum)
                    self.accum.add(ctx, ident, stack)
                    sampled = True
                for acc in extra:
                    stack = _fold_frame(frame, acc)
                    if ctx is None:
                        # Anonymous thread: root the stack under the
                        # thread's name so `stack --profile` stays
                        # readable.
                        root = acc.intern(
                            "thread:%s" % self._thread_name(ident))
                        acc.add(("", "", ""), ident, (root,) + stack)
                    else:
                        acc.add(ctx, ident, stack)
                    sampled = True
        return sampled

    # Idle ticks stretch the next sleep exponentially (1, 2, 4, ...
    # periods) up to this many periods, so a parked process reaches its
    # floor wake rate after 5 idle ticks (~75ms at the default 67 Hz)
    # instead of ramping linearly through 8; one busy tick snaps back.
    # On a core-starved host the wakeups themselves are the overhead —
    # every sampler tick is a context switch stolen from the workload —
    # so how FAST the backoff engages matters as much as its ceiling.
    _IDLE_BACKOFF_MAX = 16

    # Overhead governor: the sampler may spend at most this fraction
    # of the process's own CPU time, measured as an EWMA of
    # (sampler thread CPU) / (process CPU) between productive ticks.
    # When the ratio runs hot the period stretches (down-clocking the
    # sampler); when it runs cool the period relaxes back toward the
    # configured rate. On an oversubscribed host each process earns
    # CPU slowly, so the governor self-clocks the aggregate sampling
    # tax across N co-located workers to ~the same fraction of the
    # machine — which is what keeps "always-on" inside its budget
    # regardless of core count or process count.
    _BUDGET_FRACTION = 0.01
    _THROTTLE_MAX = 64.0
    # Fresh processes start down-clocked and earn their way to the
    # configured rate: the governor has no cost data yet, and a
    # short-lived worker should not pay full sampling freight during
    # its first moments. On an uncontended host the ramp to full rate
    # takes well under a second of productive ticks.
    _THROTTLE_WARMUP = 8.0

    def run(self) -> None:
        idle = 0
        throttle = self._THROTTLE_WARMUP
        last_proc = time.process_time_ns()
        last_self = time.thread_time_ns()
        while not self._stop.wait(
                self.period
                * min(self._IDLE_BACKOFF_MAX, 1 << min(idle, 4))
                * throttle):
            try:
                sampled = self.sample_once()
                idle = 0 if sampled else idle + 1
                now_proc = time.process_time_ns()
                now_self = time.thread_time_ns()
                dproc = now_proc - last_proc
                dself = now_self - last_self
                last_proc, last_self = now_proc, now_self
                if sampled and dproc > 0:
                    # Track share/budget multiplicatively in BOTH
                    # directions (bounded per step): a one-sided ramp
                    # with a slow linear decay overshoots to the cap
                    # on a contended burst and then starves sampling
                    # for seconds after the pressure is gone.
                    ratio = (dself / dproc) / self._budget
                    throttle = min(
                        self._THROTTLE_MAX,
                        max(1.0, throttle * min(4.0, max(0.5, ratio))))
            except Exception:
                # Never let the profiler kill a worker; skip the tick.
                pass


_sampler: Optional[_PySampler] = None
_sampler_lock = threading.Lock()
_last_flush: Dict[str, int] = {}
_atexit_registered = False


def start(hz: Optional[int] = None) -> bool:
    """Start both samplers (native + wall-stack) for this process.
    Idempotent; returns True when profiling is running."""
    global _sampler, _atexit_registered
    if not enabled():
        return False
    rate = hz if hz and hz > 0 else prof_hz()
    lib = _get_lib()
    with _sampler_lock:
        if lib is not None:
            try:
                # Hand the GIL probe its entry points, then launch the
                # native sampler. prof_stop() runs from atexit *before*
                # interpreter finalization, so the probe can never
                # touch a dying interpreter.
                lib.prof_set_gil_fns(
                    ctypes.cast(ctypes.pythonapi.PyGILState_Ensure,
                                ctypes.c_void_p),
                    ctypes.cast(ctypes.pythonapi.PyGILState_Release,
                                ctypes.c_void_p))
                lib.prof_start(rate)
            except Exception:
                pass
        if _sampler is None or not _sampler.is_alive():
            _sampler = _PySampler(rate)
            _sampler.start()
        if not _atexit_registered:
            atexit.register(stop)
            _atexit_registered = True
    register_current_thread("py-main")
    return True


def stop() -> None:
    """Join the native sampler (kills the GIL probe) and stop the
    wall-stack thread. Safe to call repeatedly."""
    global _sampler
    lib = _get_lib()
    if lib is not None:
        try:
            lib.prof_set_gil_fns(None, None)
            lib.prof_stop()
        except Exception:
            pass
    with _sampler_lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None


def running() -> bool:
    return _sampler is not None and _sampler.is_alive()


def capture_stacks(seconds: float, hz: Optional[int] = None) -> dict:
    """Fold `seconds` of fresh samples into one folded-stack dict —
    the `ray_tpu stack --profile N` path. Uses a throwaway accumulator
    fed by the running sampler (or a temporary one when profiling is
    off), so the flush accumulator is undisturbed."""
    acc = _Accum()
    s = _sampler
    if s is not None and s.is_alive():
        with s.lock:
            s.extra.append(acc)
        time.sleep(max(0.0, seconds))
        with s.lock:
            s.extra.remove(acc)
    else:
        rate = hz if hz and hz > 0 else prof_hz()
        tmp = _PySampler(rate)
        deadline = time.monotonic() + max(0.0, seconds)
        while time.monotonic() < deadline:
            frames = sys._current_frames()
            me = threading.get_ident()
            for ident, frame in frames.items():
                if ident == me:
                    continue
                ctx = _task_registry.get(ident)
                stack = _fold_frame(frame, acc)
                if ctx is None:
                    root = acc.intern(
                        "thread:%s" % tmp._thread_name(ident))
                    acc.add(("", "", ""), ident, (root,) + stack)
                else:
                    acc.add(ctx, ident, stack)
            time.sleep(1.0 / rate)
    return {
        "frames": list(acc.frames),
        "stacks": [[t, a, nm, list(st), n]
                   for (t, a, nm, st), n in acc.stacks.items()],
        "samples": acc.samples,
    }


def collect_flush() -> Optional[dict]:
    """The 2 s flush hook: return this window's profile *delta* and
    reset the accumulator. None when there is nothing to ship.

    CPU attribution: the native sampler's cumulative per-slot totals
    are delta'd against the previous flush; exec-thread deltas are
    apportioned across the tasks sampled on that thread (by sample
    share), GIL-wait deltas across all tasks the same way. Shipping
    deltas (never cumulative totals) is what makes controller merges
    add-only — a dead worker can't drive a fold negative."""
    s = _sampler
    if s is None:
        return None
    with s.lock:
        acc, s.accum = s.accum, _Accum()

    now = time.monotonic_ns()
    wall_ns = now - _last_flush.get("t", now)
    _last_flush["t"] = now

    cpu = thread_cpu_ns()
    names = thread_names()
    cpu_delta: List[int] = []
    for slot, total in enumerate(cpu):
        prev = _last_flush.get("cpu%d" % slot, 0)
        cpu_delta.append(max(0, total - prev))
        _last_flush["cpu%d" % slot] = total
    gil_total = gil_wait_ns()
    gil_delta = max(0, gil_total - _last_flush.get("gil", 0))
    _last_flush["gil"] = gil_total

    # Apportion per-thread CPU deltas over the tasks sampled on that
    # thread this window.
    task_rows: Dict[Tuple[str, str, str], List[int]] = {}
    by_thread: Dict[int, Dict[Tuple[str, str, str], int]] = {}
    for (ident, tkey), n in acc.thread_task.items():
        by_thread.setdefault(ident, {})[tkey] = n
        row = task_rows.setdefault(tkey, [0, 0, 0])
        row[0] += n
    for ident, tasks in by_thread.items():
        slot = _slot_by_ident.get(ident)
        if slot is None or slot >= len(cpu_delta):
            continue
        total = sum(tasks.values())
        if total <= 0:
            continue
        for tkey, n in tasks.items():
            task_rows[tkey][1] += cpu_delta[slot] * n // total
    if acc.samples > 0 and gil_delta > 0:
        for tkey, row in task_rows.items():
            row[2] += gil_delta * row[0] // acc.samples

    if not acc.stacks and not any(cpu_delta) and gil_delta == 0:
        return None
    return {
        "pid": os.getpid(),
        "wall_ns": wall_ns,
        "hz": prof_hz(),
        "samples": acc.samples,
        "frames": list(acc.frames),
        "stacks": [[t, a, nm, list(st), n]
                   for (t, a, nm, st), n in acc.stacks.items()],
        "tasks": [[t, a, nm, row[0], row[1], row[2]]
                  for (t, a, nm), row in task_rows.items()],
        "threads": [[names[s_] if s_ < len(names) else "", d]
                    for s_, d in enumerate(cpu_delta) if d > 0],
        "oncpu_ns": sum(cpu_delta),
        "gil_ns": gil_delta,
        "dropped": dropped(),
    }


# --- controller-side profile store ----------------------------------------

def _merge_folded(dst: Dict[str, int], src: Dict[str, int],
                  cap: int) -> None:
    """Merge-on-fold: add counts stack-by-stack; beyond `cap` distinct
    stacks, evict the coldest so one noisy task can't eat the store."""
    for stack, n in src.items():
        dst[stack] = dst.get(stack, 0) + n
    if len(dst) > cap:
        for stack, _ in sorted(dst.items(), key=lambda kv: kv[1])[
                :len(dst) - cap]:
            del dst[stack]


# Renderers over a folded {stack: count} dict, shared by ProfStore and
# ShardedProfStore (the sharded store merges per-shard folds first and
# renders once — selection is per-partition, presentation is global).

def _top_from_folded(folded: Dict[str, int], native: Dict[str, int],
                     limit: int = 30) -> dict:
    total = sum(folded.values())
    self_n: Dict[str, int] = {}
    cum_n: Dict[str, int] = {}
    for stack, n in folded.items():
        parts = stack.split(";")
        if not parts:
            continue
        leaf = parts[-1]
        self_n[leaf] = self_n.get(leaf, 0) + n
        for fr in set(parts):
            cum_n[fr] = cum_n.get(fr, 0) + n
    rows = []
    for fr in sorted(self_n, key=lambda f: (-self_n[f], f)):
        rows.append({"func": fr, "self": self_n[fr],
                     "cum": cum_n.get(fr, 0),
                     "self_pct": 100.0 * self_n[fr] / total
                     if total else 0.0,
                     "cum_pct": 100.0 * cum_n.get(fr, 0) / total
                     if total else 0.0})
        if len(rows) >= max(1, limit):
            break
    return {"total_samples": total, "rows": rows,
            "native_threads": sorted(native.items(),
                                     key=lambda kv: -kv[1])}


def _flame_from_folded(folded: Dict[str, int]) -> dict:
    root = {"name": "all", "value": 0, "children": {}}
    for stack, n in folded.items():
        root["value"] += n
        cur = root
        for fr in stack.split(";"):
            child = cur["children"].get(fr)
            if child is None:
                child = cur["children"][fr] = {
                    "name": fr, "value": 0, "children": {}}
            child["value"] += n
            cur = child

    def _materialize(node_: dict) -> dict:
        kids = [_materialize(c) for c in node_["children"].values()]
        kids.sort(key=lambda c: -c["value"])
        out = {"name": node_["name"], "value": node_["value"]}
        if kids:
            out["children"] = kids
        return out

    return _materialize(root)


def _collapsed_from_folded(folded: Dict[str, int]) -> List[str]:
    return ["%s %d" % (stack, n)
            for stack, n in sorted(folded.items(),
                                   key=lambda kv: -kv[1])]


class ProfStore:
    """Bounded per-node / per-task profile store (controller-owned).

    Two indexes over the same ingested deltas:
      * a per-node ring of (wall_s, rows) flush windows — the
        ``--seconds`` query path;
      * a per-(task, actor) merged profile with sample/on-CPU/GIL
        totals — the task/actor query path and the grafttrail join.
    Both are bounded; eviction is LRU on the task table and ring-age on
    the node windows."""

    def __init__(self, history: int = 120, task_cap: int = 512,
                 stack_cap: int = 256):
        self.history = max(2, int(history))
        self.task_cap = max(8, int(task_cap))
        self.stack_cap = max(16, int(stack_cap))
        self._nodes: Dict[str, deque] = {}
        # node -> {thread name: cumulative CPU ns} — the native sidecar
        # threads (reactor, store loops, copy workers, reaper), so
        # C-plane time shows up in `prof top` instead of vanishing.
        self._threads: Dict[str, Dict[str, int]] = {}
        # (task, actor) -> {"samples", "oncpu_ns", "gil_ns", "stacks"}
        self._tasks: "OrderedDict[Tuple[str, str], dict]" = OrderedDict()
        self._lock = threading.Lock()
        self.ingested = 0

    def ingest(self, node_id: str, payload: dict,
               wall_s: Optional[float] = None) -> None:
        if not isinstance(payload, dict):
            return
        frames = payload.get("frames") or []
        rows = []
        for row in payload.get("stacks") or []:
            try:
                task, actor, name, idxs, n = row
                stack = ";".join(frames[i] for i in idxs)
            except Exception:
                continue
            rows.append((str(task), str(actor), str(name), stack, int(n)))
        ts = time.time() if wall_s is None else wall_s
        with self._lock:
            ring = self._nodes.get(node_id)
            if ring is None:
                ring = self._nodes[node_id] = deque(maxlen=self.history)
            ring.append((ts, rows))
            for task, actor, name, stack, n in rows:
                rec = self._task_rec(task, actor, name)
                rec["samples"] += n
                _merge_folded(rec["stacks"], {stack: n}, self.stack_cap)
            hz = max(1, int(payload.get("hz") or PROF_DEFAULT_HZ))
            for row in payload.get("tasks") or []:
                try:
                    task, actor, name, samples, oncpu_ns, gil_ns = row
                except Exception:
                    continue
                rec = self._task_rec(str(task), str(actor), str(name))
                rec["oncpu_ns"] += int(oncpu_ns)
                rec["gil_ns"] += int(gil_ns)
                # Sampled wall estimate: each sample covers one sampler
                # period on one thread — the on-CPU%/GIL% denominator.
                rec["wall_ns"] += int(samples) * 1_000_000_000 // hz
            tn = self._threads.setdefault(node_id, {})
            for row in payload.get("threads") or []:
                try:
                    name, d = row
                    tn[str(name)] = tn.get(str(name), 0) + int(d)
                except Exception:
                    continue
            self.ingested += 1

    def _task_rec(self, task: str, actor: str, name: str = "") -> dict:
        key = (task, actor)
        rec = self._tasks.get(key)
        if rec is None:
            rec = self._tasks[key] = {"samples": 0, "oncpu_ns": 0,
                                      "gil_ns": 0, "wall_ns": 0,
                                      "name": name, "stacks": {}}
            while len(self._tasks) > self.task_cap:
                self._tasks.popitem(last=False)
        else:
            self._tasks.move_to_end(key)
            if name and not rec["name"]:
                rec["name"] = name
        return rec

    @staticmethod
    def _match(filt: str, task: str, name: str) -> bool:
        """A --task filter matches a task id (prefix) or a task name."""
        return bool(filt) and (task.startswith(filt) or name == filt)

    def forget_node(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)
            self._threads.pop(node_id, None)

    # -- queries -----------------------------------------------------------

    def _select(self, task: str = "", actor: str = "", node: str = "",
                seconds: float = 0.0) -> Dict[str, int]:
        """Folded stacks matching the filters. A time window forces the
        node-ring path; otherwise task/actor filters use the merged
        task table (complete history, bounded stacks)."""
        out: Dict[str, int] = {}
        with self._lock:
            if seconds > 0 or node:
                cutoff = time.time() - seconds if seconds > 0 else 0.0
                nodes = [node] if node else list(self._nodes)
                for nid in nodes:
                    for ts, rows in self._nodes.get(nid, ()):
                        if ts < cutoff:
                            continue
                        for t, a, nm, stack, n in rows:
                            if task and not self._match(task, t, nm):
                                continue
                            if actor and not a.startswith(actor):
                                continue
                            out[stack] = out.get(stack, 0) + n
            else:
                for (t, a), rec in self._tasks.items():
                    if task and not self._match(task, t, rec["name"]):
                        continue
                    if actor and not a.startswith(actor):
                        continue
                    for stack, n in rec["stacks"].items():
                        out[stack] = out.get(stack, 0) + n
        return out

    def _native_threads(self, node: str = "") -> Dict[str, int]:
        """Native thread CPU is process-wide, not task-attributable —
        reported alongside so C-plane time is visible, not lost."""
        native: Dict[str, int] = {}
        with self._lock:
            for nid in ([node] if node else list(self._threads)):
                for name, ns in self._threads.get(nid, {}).items():
                    native[name] = native.get(name, 0) + ns
        return native

    def top(self, task: str = "", actor: str = "", node: str = "",
            seconds: float = 0.0, limit: int = 30) -> dict:
        """Per-function self/cumulative sample counts: the leaf frame
        of a stack earns self time, every distinct frame on it earns
        cumulative time."""
        return _top_from_folded(self._select(task, actor, node, seconds),
                                self._native_threads(node), limit)

    def flame(self, task: str = "", actor: str = "", node: str = "",
              seconds: float = 0.0) -> dict:
        """d3-flamegraph JSON: nested {name, value, children}."""
        return _flame_from_folded(
            self._select(task, actor, node, seconds))

    def collapsed(self, task: str = "", actor: str = "", node: str = "",
                  seconds: float = 0.0) -> List[str]:
        """Brendan-Gregg collapsed format: one "a;b;c N" line per
        distinct stack (flamegraph.pl / speedscope input)."""
        return _collapsed_from_folded(
            self._select(task, actor, node, seconds))

    def task_stats(self, task: str = "", actor: str = "") -> dict:
        """Per-task totals for the grafttrail join (`get task`)."""
        with self._lock:
            for (t, a), rec in self._tasks.items():
                if (task and self._match(task, t, rec["name"])) or \
                        (actor and a.startswith(actor)):
                    return {"samples": rec["samples"],
                            "oncpu_ns": rec["oncpu_ns"],
                            "gil_ns": rec["gil_ns"],
                            "wall_ns": rec["wall_ns"],
                            "name": rec["name"]}
        return {}

    def stats(self) -> dict:
        with self._lock:
            return {"tasks": len(self._tasks),
                    "nodes": len(self._nodes),
                    "windows": sum(len(r) for r in self._nodes.values()),
                    "ingested": self.ingested}


class ShardedProfStore:
    """Node-hash partitioned ProfStore: ingest and forget route by
    ``crc32(node) % N`` into N independent stores (own lock, own node
    ring, own task LRU slice); queries merge per-shard folds and render
    once through the shared ``_*_from_folded`` helpers.

    Payload merge is the ProfStore hot path at cardinality — every
    flush window walks its stacks under the store lock, so a singleton
    store serializes all nodes' merges. A task that ran attempts on
    several nodes has partial profiles in several shards;
    ``task_stats`` sums them back together."""

    def __init__(self, shards: int = 8, history: int = 120,
                 task_cap: int = 512, stack_cap: int = 256):
        n = max(1, int(shards))
        self.shards = [ProfStore(history=history,
                                 task_cap=max(8, int(task_cap) // n),
                                 stack_cap=stack_cap)
                       for _ in range(n)]

    def _shard(self, node_id: str) -> ProfStore:
        return self.shards[zlib.crc32(node_id.encode())
                           % len(self.shards)]

    def ingest(self, node_id: str, payload: dict,
               wall_s: Optional[float] = None) -> None:
        self._shard(node_id).ingest(node_id, payload, wall_s)

    def forget_node(self, node_id: str) -> None:
        self._shard(node_id).forget_node(node_id)

    def _merged(self, task: str, actor: str, node: str,
                seconds: float) -> Dict[str, int]:
        shards = [self._shard(node)] if node else self.shards
        out: Dict[str, int] = {}
        for s in shards:
            for stack, n in s._select(task, actor, node,
                                      seconds).items():
                out[stack] = out.get(stack, 0) + n
        return out

    def top(self, task: str = "", actor: str = "", node: str = "",
            seconds: float = 0.0, limit: int = 30) -> dict:
        shards = [self._shard(node)] if node else self.shards
        native: Dict[str, int] = {}
        for s in shards:
            for name, ns in s._native_threads(node).items():
                native[name] = native.get(name, 0) + ns
        return _top_from_folded(self._merged(task, actor, node, seconds),
                                native, limit)

    def flame(self, task: str = "", actor: str = "", node: str = "",
              seconds: float = 0.0) -> dict:
        return _flame_from_folded(
            self._merged(task, actor, node, seconds))

    def collapsed(self, task: str = "", actor: str = "", node: str = "",
                  seconds: float = 0.0) -> List[str]:
        return _collapsed_from_folded(
            self._merged(task, actor, node, seconds))

    def task_stats(self, task: str = "", actor: str = "") -> dict:
        out: dict = {}
        for s in self.shards:
            st = s.task_stats(task, actor)
            if not st:
                continue
            if not out:
                out = dict(st)
            else:
                for k in ("samples", "oncpu_ns", "gil_ns", "wall_ns"):
                    out[k] += st[k]
                if not out.get("name"):
                    out["name"] = st.get("name", "")
        return out

    def stats(self) -> dict:
        out = {"tasks": 0, "nodes": 0, "windows": 0, "ingested": 0,
               "shards": len(self.shards)}
        for s in self.shards:
            st = s.stats()
            for k in ("tasks", "nodes", "windows", "ingested"):
                out[k] += st[k]
        return out
