"""CoreWorker — the per-process runtime library (driver and workers alike).

Analogue of the reference's core worker (reference:
src/ray/core_worker/core_worker.cc, with task_submission/normal_task_submitter.cc
lease+push, task_manager.cc owner ledger + lineage, reference_count.cc
distributed refcounting, store_provider/ memory+plasma providers, and
task_execution/task_receiver.cc ordered actor queues; Python surface mirrored
from python/ray/_private/worker.py and python/ray/_raylet.pyx).

One instance per process. Owns:
  * a background asyncio IO thread running an RPC server (the core-worker
    service: push_task, object status/location, borrow accounting)
  * the ownership ledger: every object this process created (task returns and
    puts) with state, inline value or store locations, refcounts, and the
    creating TaskSpec for lineage reconstruction
  * task submission: lease a worker from the local node agent (spillback
    handled agent-side), push the spec directly to the leased worker, retry on
    worker failure
  * task execution (worker mode): ordered actor queues, function cache backed
    by the controller KV function table
  * get/put/wait against the in-process memory store + shared-memory store
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import hashlib
import os
import pickle
import threading
import time
import traceback
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.common import (ActorState, Address, GetTimeoutError,
                                       ObjectLostError, TaskError, TaskSpec,
                                       WorkerCrashedError)
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_store import MappedObject
from ray_tpu_torch.core.ref import ActorHandle, ObjectRef, set_core_worker
from ray_tpu_torch.core.rpc import (RpcApplicationError, RpcClient,
                                    RpcConnectionLost, RpcServer, long_poll)
from ray_tpu_torch.utils import get_logger
from ray_tpu_torch.utils.aio import spawn
from ray_tpu_torch.utils.config import GlobalConfig

logger = get_logger("core_worker")

# Ambient trace context: (trace_id, current_span). Exec THREADS use the
# threading.local (run_in_executor does not propagate contextvars); async
# actor methods use the ContextVar (isolated per asyncio task).
import contextvars as _contextvars  # noqa: E402

_trace_local = threading.local()
_trace_ctxvar: "_contextvars.ContextVar" = _contextvars.ContextVar(
    "ray_tpu_torch_trace", default=None)

# Device objects, the device transfer plane and collectives (the DAG's
# device edges and allreduce) wait for their own port.
_DEVICE_PLANE_MISSING = (
    "device objects and the device transfer plane are not ported to "
    "ray_tpu_torch yet (ROADMAP Queue 1 item 5: device objects and "
    "collectives); DAG edges without with_tensor_transport() and "
    "without allreduce() work")

PENDING, READY, ERROR = "PENDING", "READY", "ERROR"


class ObjectEntry:
    __slots__ = ("state", "inline", "locations", "size", "local_refs",
                 "borrow_refs", "creating_task", "event", "error", "contained")

    def __init__(self):
        self.state = PENDING
        self.inline: Optional[Tuple[bytes, bytes]] = None
        self.locations: set = set()  # {(node_id, (host, port))}
        self.size = 0
        self.local_refs = 0
        self.borrow_refs = 0
        self.creating_task: Optional[TaskSpec] = None
        self.event: Optional[asyncio.Event] = None
        self.error: Optional[BaseException] = None
        # Refs contained inside this object's value (borrowed on put, so the
        # nested objects outlive this one; dropped when this object is freed).
        self.contained: list = []


class _StreamState:
    """Owner-side ledger for one streaming task (reference:
    task_manager.cc ObjectRefStream)."""

    __slots__ = ("refs", "produced", "consumed", "total", "error", "event",
                 "bp_event", "released")

    def __init__(self):
        self.refs: Dict[int, "ObjectRef"] = {}
        self.produced = 0          # highest index+1 reported
        self.consumed = 0          # highest index+1 handed to the consumer
        self.total: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.event: Optional[asyncio.Event] = None   # consumer waiting
        self.bp_event: Optional[asyncio.Event] = None  # producer parked
        self.released = False


def _spec_has_ref_args(spec: "TaskSpec") -> bool:
    """True if any wire arg is an ObjectRef (kind 'r')."""
    for a in spec.args:
        kind = a[1] if a[0] == "p" else a[2]
        if kind == "r":
            return True
    return False


def _ref_descs(sv) -> list:
    """Wire descriptors for the ObjectRefs contained in a serialized
    value: what the receiver needs to adopt borrows (adopt/ack
    protocol)."""
    return [(r.binary(), tuple(r.owner_addr) if r.owner_addr else None)
            for r in sv.contained_refs]


class CoreWorker:
    def __init__(self, mode: str, agent_addr: Address,
                 controller_addr: Address, session_dir: str = "/tmp"):
        self.mode = mode  # "driver" | "worker"
        self.worker_id = WorkerID.random()
        self.agent_addr = agent_addr
        self.controller_addr = controller_addr
        self.session_dir = session_dir
        self.node_id: Optional[bytes] = None
        self.store_dir: Optional[str] = None
        self.port: int = 0

        # NOTE: no eager task factory anywhere — measured: eager startup
        # reorders the lease pump's submit/grant interleaving and the
        # driver client's send/recv pattern badly (up to 20x slower burst
        # submission on the 1-core host).
        self._loop = asyncio.new_event_loop()
        self._io_thread = threading.Thread(
            target=self._loop.run_forever, daemon=True, name="cw-io")
        self._io_thread.start()

        self.objects: Dict[bytes, ObjectEntry] = {}
        self._local_ref_counts: Dict[bytes, int] = {}
        self._func_cache: Dict[bytes, Any] = {}
        self._exported_funcs: set = set()
        # Exports whose background kv_put is still in flight: every
        # submission during the window must flag async_export=True so
        # the executor's _load_function keeps its retry window open
        # (r5 advisor: only the FIRST submission did, and a fast cached
        # re-submission could fail a single no-retry kv_get).
        self._pending_exports: set = set()
        self._actor_instance: Any = None
        self._actor_id: Optional[bytes] = None
        # actor-task ordering: caller_id -> next expected seqno, plus one
        # event per out-of-order waiter (a CV broadcast is O(waiters) wakeups
        # per completion — O(n^2) for a deep pipeline; reference:
        # task_execution/actor_scheduling_queue.cc keys waiters by seqno).
        self._actor_seqno: Dict[bytes, int] = {}
        self._actor_waiters: Dict[bytes, Dict[int, asyncio.Event]] = {}
        self._is_actor_worker = False
        self._exec_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="task-exec")
        self._worker_clients: Dict[Address, RpcClient] = {}
        # actor_id -> (addr, client, incarnation)
        self._actor_clients: Dict[bytes, Tuple[Address, RpcClient, int]] = {}
        # Send-side seqnos are assigned per (actor, incarnation) at push time
        # so a restarted actor (which expects 0 again) stays in sync. The
        # last-known incarnation lives in its own map (not the client cache,
        # which is dropped on transient connection errors) so a reconnect to
        # the SAME incarnation never resets the seqno stream.
        self._actor_seq_out: Dict[bytes, int] = {}
        # Per-actor push coalescing (one in-flight batch RPC per actor).
        self._actor_push_buf: Dict[bytes, list] = {}
        self._actor_flushing: set = set()
        self._actor_push_sem: Dict[bytes, asyncio.Semaphore] = {}
        self._actor_task_ms: Dict[bytes, float] = {}  # exec-time EMA
        self._actor_incarnation: Dict[bytes, int] = {}
        # Actor-state pubsub: terminal deaths observed on the controller's
        # actor_events channel (fail-fast without a wait_actor_ready RPC).
        self._actor_deaths: Dict[bytes, str] = {}
        self._actor_sub = None
        # task_id -> ObjectRefs held for that task's args (incl. refs
        # contained inside inline values and promoted big args).
        self._task_arg_refs: Dict[bytes, List[ObjectRef]] = {}
        # actor_id -> ObjectRefs held for the actor's constructor args;
        # pinned for the actor's lifetime (restarts re-resolve them),
        # released when the actor is killed or observed dead.
        self._actor_arg_refs: Dict[bytes, List[ObjectRef]] = {}
        # Streaming-generator task state (owner side), keyed by task_id.
        self._streams: Dict[bytes, _StreamState] = {}
        # Proxy borrows on refs forwarded inside replies, held until the
        # receiver acks (ack_reply_refs) or the grace fallback fires.
        self._reply_holds: Dict[Any, list] = {}
        self._reply_hold_timers: Dict[Any, Any] = {}
        from collections import OrderedDict
        self._map_cache: "OrderedDict[bytes, Any]" = OrderedDict()
        self._map_cache_bytes = 0
        # Cancellation: task_ids cancelled by the user; where tasks execute.
        self._cancelled: set = set()
        self._task_exec_addr: Dict[bytes, Address] = {}
        # Worker-side cancellation: task_ids to skip/interrupt, plus the
        # thread currently executing each task (async actors run several
        # tasks on different threads concurrently — cancel must target
        # the RIGHT thread).
        self._exec_cancelled: set = set()
        self._exec_threads: Dict[bytes, int] = {}
        # Device-resident objects (RDT): key -> jax array kept in HBM.
        self._device_objects: Dict[bytes, Any] = {}
        self._device_consumers: Dict[bytes, int] = {}
        self._device_tokens: Dict[bytes, Any] = {}  # re-registration guard
        # Device channels: reader inboxes + writer-side release tracking.
        self._channel_inbox: Dict[bytes, Any] = {}
        self._channel_acks: Dict[bytes, Dict] = {}
        self._channel_ack_events: Dict[bytes, Any] = {}
        # Task-event buffer, flushed to the controller in batches
        # (reference: task_event_buffer.cc -> gcs_task_manager.cc).
        # Guarded: submit runs on user threads, completion on the io loop.
        self._task_events: List[tuple] = []
        self._task_events_lock = threading.Lock()
        self._task_events_cap: Optional[int] = None  # lazy config read
        # Lease-cached dispatch state, per scheduling class.
        self._class_queues: Dict[tuple, list] = {}
        self._class_pumps: Dict[tuple, asyncio.Task] = {}
        self._class_runners: Dict[tuple, set] = {}
        self._class_lease_cap: Dict[tuple, int] = {}
        self._class_events: Dict[tuple, asyncio.Event] = {}
        self._next_put_index = 0
        # Direct-write put path: the local store dir (fetched once) and a
        # per-process ingest-file counter.
        self._store_dir_cache: Optional[str] = None
        # Native fast path to the agent's store sidecar (C unix socket,
        # blocking, no event loop — csrc/store_server.cc). Probed
        # lazily alongside the store dir; None = unavailable.
        self._fastpath = None
        self._fastpath_probed = False
        self._fastpath_lock = threading.Lock()  # probe + ingest naming
        self._map_cache_lock = threading.Lock()
        self._ingest_seq = 0
        # graftcopy put plane: fused OP_PUT with O_TMPFILE+linkat staging
        # (csrc/copy_core.cc). None = unresolved; resolves to False when
        # the flag is off or the native library is unavailable.
        self._graftcopy_put: Optional[bool] = None
        self._o_tmpfile_ok: Optional[bool] = None  # probed per process
        # graftshm put plane: store-owned slabs mapped over SCM_RIGHTS
        # fds, serialized in place (csrc/shm_core.cc). None = unresolved;
        # False when the flag is off or the native library is missing.
        # The map cache reuses writable slab mappings by inode so a
        # steady-state put loop skips the mmap/munmap pair entirely.
        self._graftshm_put: Optional[bool] = None
        self._shm_map_cache = None
        # Staging-inode recycling: one private hardlink ("scratch-*")
        # keeps the last staging file's tmpfs pages alive across the
        # store's delete, so the next put rewrites hot pages instead of
        # cold-allocating (cold allocation halves tmpfs write
        # bandwidth). _scratch_oid is the live object sharing the
        # inode; _scratch_freed collects oids whose store-side erase
        # was confirmed (drop settled rc 0), flipping the scratch free
        # again; _scratch_stale collects oids whose erase was deferred
        # or lost, making the scratch leg abandon the inode.
        self._scratch_lock = threading.Lock()
        self._scratch_fd = -1
        self._scratch_name: Optional[str] = None
        self._scratch_size = 0
        self._scratch_oid: Optional[bytes] = None
        self._scratch_free = False
        self._scratch_freed: set = set()
        self._scratch_stale: set = set()
        # Put-phase breakdown counters (ns + put count), read by
        # bench_core.py so put regressions localize to a phase.
        self._put_phase = {"serialize": 0, "copy": 0, "inplace": 0,
                           "ingest": 0, "puts": 0}
        # Per-peer batched store frees (flushed on the next loop tick).
        self._free_buf: Dict[tuple, list] = {}
        self._free_flush_scheduled = False
        # Deferred-ack puts: oid -> (sv, staged_path) until the sidecar's
        # OP_PUT reply confirms adoption; failed acks queue here for
        # loop-side repair through the spill-capable agent path.
        self._put_unacked: Dict[bytes, tuple] = {}
        self._put_ack_err: deque = deque()
        self._put_drain_scheduled = False
        # Per-scheduling-class task-duration EMA: steers normal-task push
        # coalescing (slow tasks ship alone — a batch reply lands only
        # after every member executed).
        self._class_task_ms: Dict[tuple, float] = {}
        # Coalesced fire-and-forget scheduling: submissions buffered here
        # wake the io loop ONCE per burst instead of once per call.
        self._spawn_buf: deque = deque()
        self._spawn_scheduled = False
        # graftrpc dispatch plane (csrc/rpc_core.cc): native transport for
        # push_task_batch between co-located workers. The asyncio RpcServer
        # stays the control plane. None = off / native lib unavailable.
        self._graft = None
        self._graft_path = ""
        self._graft_channels: Dict[Any, Any] = {}    # peer addr -> channel
        self._graft_chan_by_conn: Dict[int, Any] = {}
        self._graft_interns: Dict[int, dict] = {}    # serve side, per conn
        self._graft_no: set = set()  # peers with no graft listener
        self._graft_dialing: Dict[Any, Any] = {}  # single-flight discovery
        # graftscope stitching (csrc/scope_core.cc): trace-tag assembler
        # + spans buffered from user threads (list.append is GIL-atomic),
        # flushed to the controller on the task-event flusher tick.
        self._scope = None
        self._scope_spans: list = []
        # graftpulse pre-aggregation: the cumulative scope block as of
        # the last report_scope_delta flush (counters, hists).
        self._scope_sent: tuple = ({}, {})
        # task-phase breakdown (ns accumulators + task count), read by
        # bench_core.py so a dispatch regression localizes to submit /
        # lease / run / reply.
        self._task_phase = {"submit": 0, "lease": 0, "run": 0,
                            "reply": 0, "tasks": 0}
        # graftsched inline provenance: owner-attested trail events for
        # inline objects at/under graftsched_inline_bytes. A sealed
        # event DEBOUNCES one full flush window before shipping: an
        # object freed while still pending cancels locally and the
        # trail never hears of it (hot-loop results/puts are invisible
        # by design, like the store's scratch inodes), while anything
        # that survives a window is attested and its eventual free
        # ships as the matching inline-plane event.
        self._inline_pending: Dict[str, tuple] = {}  # hx -> sealed event
        self._inline_shipped: set = set()  # oids with sealed shipped
        self._inline_freed_buf: list = []
        self._inline_cap = None  # cached graftsched_inline_bytes
        # Actor-dispatch wakeup coalescing: user threads append specs to
        # _actor_push_buf directly (GIL-atomic) and poke the drainer once
        # per burst — no per-call coroutine/Task/Future on the hot path.
        self._dispatch_dirty: deque = deque()
        self._dispatch_scheduled = False
        self._owned_drop_buf: deque = deque()
        self._owned_drop_scheduled = False
        # func -> exported func_id (pickle a function once per process,
        # like the reference's RemoteFunction._remote; reference:
        # python/ray/remote_function.py:314).
        self._func_id_cache: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()

        self._run(self._async_init()).result()
        set_core_worker(self)

    # ------------------------------------------------------------------
    # io-thread plumbing
    # ------------------------------------------------------------------
    def _run(self, coro) -> concurrent.futures.Future:
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    def _spawn(self, coro) -> None:
        """Fire-and-forget a coroutine on the io loop with a STRONG
        reference (see utils/aio.py: weakly-referenced tasks can be GC'd
        mid-flight, killing the coroutine with GeneratorExit).

        Wakeups are COALESCED: a burst of submissions from a caller
        thread enqueues into _spawn_buf and pays one
        call_soon_threadsafe (one self-pipe write) per burst, not one
        per call — the async-dispatch hot path."""
        try:
            if self._loop.is_closed():
                coro.close()
                return
            self._spawn_buf.append(coro)
            if not self._spawn_scheduled:
                self._spawn_scheduled = True
                self._loop.call_soon_threadsafe(self._drain_spawns)
        except RuntimeError:  # loop shut down mid-call
            # Reset the flag and close EVERYTHING buffered (including
            # this coro) — a stuck True flag would silently drop every
            # later fire-and-forget coroutine un-closed.
            self._spawn_scheduled = False
            while self._spawn_buf:
                self._spawn_buf.popleft().close()

    def _drain_spawns(self) -> None:
        # Clear the flag BEFORE draining: a concurrent producer either
        # lands in this drain or schedules the next one — never dropped.
        self._spawn_scheduled = False
        while self._spawn_buf:
            spawn(self._spawn_buf.popleft())

    def _poke_dispatch(self, actor_id: bytes) -> None:
        """Ensure a flusher will run for this actor's push buffer. Same
        lost-wakeup-free shape as _spawn: append BEFORE the flag check,
        drain clears the flag BEFORE draining."""
        self._dispatch_dirty.append(actor_id)
        if not self._dispatch_scheduled:
            self._dispatch_scheduled = True
            try:
                self._loop.call_soon_threadsafe(self._drain_dispatch)
            except RuntimeError:  # loop shut down mid-call
                self._dispatch_scheduled = False

    def _drain_dispatch(self) -> None:
        self._dispatch_scheduled = False
        while self._dispatch_dirty:
            actor_id = self._dispatch_dirty.popleft()
            if actor_id not in self._actor_flushing:
                self._actor_flushing.add(actor_id)
                spawn(self._flush_actor_pushes(actor_id))

    async def _async_init(self) -> None:
        # Same-host agent RPC rides a unix socket when one is available
        # (spawned workers get it via env; the driver probes below).
        sock = os.environ.get("RAY_TPU_TORCH_AGENT_SOCK", "")
        if sock and os.path.exists(sock):
            self.agent = RpcClient(sock)
        else:
            self.agent = RpcClient(self.agent_addr)
            try:
                sock = await self.agent.call("sock_path")
                if sock and os.path.exists(sock):
                    await self.agent.close()  # drop the TCP probe conn
                    self.agent = RpcClient(sock)
            except Exception:
                pass  # older agent or cross-host: stay on TCP
        self.controller = RpcClient(self.controller_addr)
        server = RpcServer("core_worker")
        server.register_object(self, prefix="")
        self.port = await server.start_tcp("127.0.0.1", 0)
        self._server = server
        reply = await self.agent.call("register_worker",
                                      self.worker_id.binary(), os.getpid(),
                                      self.port)
        self.node_id = reply["node_id"]
        self.store_dir = reply["store_dir"]
        if GlobalConfig.graftrpc:
            try:
                from ray_tpu_torch.core._native import graftrpc
                if graftrpc.available():
                    path = os.path.join(
                        self.session_dir,
                        f"graft-{self.worker_id.binary().hex()[:12]}.sock")
                    ep = graftrpc.GraftEndpoint(
                        asyncio.get_running_loop(), path)
                    ep.on_frame = self._on_graft_frame
                    ep.on_close = self._on_graft_close
                    self._graft = ep
                    self._graft_path = path
            except Exception as e:
                logger.debug("graftrpc dispatch plane unavailable: %r", e)
                self._graft = None
        # Apply the graftscope config flag to the native recorder. The
        # flag resolves override > RAY_TPU_TORCH_GRAFTSCOPE env > default(on),
        # mirroring the C side's lazy getenv — this call only matters
        # for programmatic initialize() overrides.
        from ray_tpu_torch.core._native import graftprof, graftscope
        graftscope.configure_from_flags()
        # Continuous profiling: both graftprof samplers (native CPU/GIL
        # + Python wall-stack) run for the life of the process; profile
        # deltas ride the same 2 s flush tick below.
        graftprof.configure_from_flags()
        if graftprof.enabled():
            graftprof.start()
        # Crash-persistent log ring: open logring-<pid> in the node's
        # store dir (learned from the registration reply) and replay
        # any records the logger parked before the dir was known. In
        # worker mode, raw stdout/stderr lines tee into the ring too —
        # the agent still gets every byte through the pipe, but the
        # ring copy carries task attribution and survives a SIGKILL
        # for postmortem salvage.
        from ray_tpu_torch.core._native import graftlog
        graftlog.configure_from_flags()
        if graftlog.enabled() and self.store_dir:
            try:
                graftlog.open_ring(self.store_dir)
                if self.mode == "worker":
                    graftlog.install_stdio_tee()
            except Exception as e:
                logger.debug("graftlog ring unavailable: %r", e)
        spawn(self._task_event_flusher())
        if self.mode == "driver" and GlobalConfig.log_to_driver:
            # Worker prints stream to this driver (reference:
            # worker.py:2261 print_worker_logs).
            from ray_tpu_torch.core.pubsub import Subscription

            def _print_log(ev: dict) -> None:
                print(f"(pid={ev['pid']}, node={ev['node']}) {ev['line']}",
                      flush=True)

            self._log_sub = Subscription(
                self.controller, "log_events", _print_log,
                from_latest=True).start()

    async def worker_stacks(self, profile_s: float = 0.0) -> Dict:
        """Python stacks of every thread in this process (the `ray stack`
        analogue's fast path, reference: scripts.py:2706 — py-spy dump).
        Served from the IO loop, so a task wedged on its EXEC thread
        still answers; a wedged io loop falls back to the agent's
        SIGUSR1/faulthandler path.

        With profile_s > 0 (`ray_tpu stack --profile N`), returns N
        seconds of graftprof folded samples instead of one snapshot —
        ``capture_stacks`` runs in the exec pool so the io loop keeps
        serving — plus the native sidecar-thread CPU table."""
        import sys
        import threading
        import traceback
        if profile_s and profile_s > 0:
            from ray_tpu_torch.core._native import graftprof
            loop = asyncio.get_running_loop()
            folded = await loop.run_in_executor(
                None, graftprof.capture_stacks, min(float(profile_s), 30.0))
            folded["thread_cpu_ns"] = list(zip(
                graftprof.thread_names(), graftprof.thread_cpu_ns()))
            return folded
        names = {t.ident: t.name for t in threading.enumerate()}
        out = {}
        for tid, frame in sys._current_frames().items():
            label = f"{names.get(tid, 'thread')}-{tid}"
            out[label] = "".join(traceback.format_stack(frame))
        return out

    async def retarget_controller(self, addr) -> bool:
        """Follow a controller head failover: swap the controller client
        to the replacement's address (the durable-store restart path).
        Worker->worker data paths are unaffected; controller-fed
        subscriptions (driver logs, actor state events) repoint to the
        new head and resync via the pubsub epoch-restart detection.
        Exposed over RPC so the node agent can propagate a failover to
        its hosted workers."""
        addr = (addr[0], int(addr[1]))
        old = self.controller
        self.controller_addr = addr
        self.controller = RpcClient(addr)
        try:
            await old.close()
        except Exception:
            pass
        for sub in (getattr(self, "_log_sub", None), self._actor_sub):
            if sub is not None:
                sub.retarget(self.controller)
        return True

    @property
    def address(self) -> Address:
        return ("127.0.0.1", self.port)

    def _client_for_worker(self, addr: Address) -> RpcClient:
        """Client to a peer worker/agent. Retries are safe: every retried
        request carries a stable request id and the server replays the
        cached first response instead of re-executing (rpc.py dedup), so
        borrow accounting, stream reports, and task pushes stay
        exactly-once per server process."""
        addr = tuple(addr)
        c = self._worker_clients.get(addr)
        if c is None:
            c = RpcClient(addr, max_retries=3)
            self._worker_clients[addr] = c
        return c

    # ------------------------------------------------------------------
    # task events (owner-side; reference: task_event_buffer.cc).
    # States walk the grafttrail per-attempt FSM (SUBMITTED -> LEASED ->
    # RUNNING -> FINISHED|FAILED|CANCELLED); with the trail disabled the
    # flush degrades to the legacy submitted/finished/failed stream.
    # ------------------------------------------------------------------
    _trail_enabled = None  # cached per-process (env/config is fixed)

    def _trail_on(self) -> bool:
        on = self._trail_enabled
        if on is None:
            from ray_tpu_torch.core._native import grafttrail
            on = CoreWorker._trail_enabled = grafttrail.enabled()
        return on

    # graftsched fast path (batched lease waves + lease keep-alive +
    # inline-result provenance); cached per-process like the trail flag.
    _sched_enabled = None

    def _sched_on(self) -> bool:
        on = CoreWorker._sched_enabled
        if on is None:
            on = CoreWorker._sched_enabled = bool(GlobalConfig.graftsched)
        return on

    def _record_task_event(self, task_id: bytes, name: str,
                           state: str, trace_id: bytes = b"",
                           parent_span: bytes = b"", *, attempt: int = 0,
                           node: str = "", worker: str = "",
                           err: str = "", actor: bytes = b"") -> None:
        # Submission hot path (a few events per task): append the raw
        # tuple; shaping + hex conversion happen at flush time.
        cap = self._task_events_cap
        if cap is None:
            cap = self._task_events_cap = \
                GlobalConfig.task_events_batch_size
        with self._task_events_lock:
            self._task_events.append(
                (task_id, name, state, time.time(), trace_id, parent_span,
                 attempt, node, worker, err, actor))
            full = len(self._task_events) >= cap
        if full:
            self._flush_task_events()

    def _trace_for_new_task(self, task_id: bytes) -> tuple:
        """(trace_id, parent_span) for a task being submitted NOW: the
        ambient trace context if this code runs inside a task (sync exec
        thread or async actor method), else a fresh root whose trace_id
        is the new task's own id."""
        ctx = getattr(_trace_local, "ctx", None)
        if ctx is None:
            ctx = _trace_ctxvar.get()
        if ctx is None:
            return task_id, b""
        return ctx[0], ctx[1]

    def _flush_task_events(self) -> None:
        with self._task_events_lock:
            batch, self._task_events = self._task_events, []
            objs = None
            if self._inline_pending or self._inline_freed_buf:
                # Attest only sealed events at least one full flush
                # quantum old (freed while pending cancelled silently),
                # plus the freed events of previously-attested objects.
                # Aging is by wall time, not flush count: batch-cap
                # flushes mid-burst must not prematurely age a burst's
                # own short-lived results.
                cutoff = time.time() - 2.0
                ship = [hx for hx, ev in self._inline_pending.items()
                        if ev[2] <= cutoff]
                objs = [self._inline_pending.pop(hx) for hx in ship]
                for hx in ship:
                    self._inline_shipped.add(bytes.fromhex(hx))
                objs.extend(self._inline_freed_buf)
                self._inline_freed_buf = []
                objs = objs or None
        if not batch and not objs:
            return
        from ray_tpu_torch.core._native import grafttrail
        owner = self.worker_id.hex()[:8]
        if not self._trail_on():
            # Legacy stream, straight to the controller: the pre-trail
            # vocabulary had no LEASED/RUNNING and reported a cancel as
            # a plain failure.
            legacy = {"SUBMITTED": "submitted", "FINISHED": "finished",
                      "FAILED": "failed", "CANCELLED": "failed"}
            out = []
            for (task_id, name, state, ts, trace_id, parent_span,
                 _attempt, _node, _worker, _err, _actor) in batch:
                event = legacy.get(state)
                if event is None:
                    continue
                rec = {"task_id": task_id.hex(), "name": name,
                       "event": event, "ts": ts, "owner": owner}
                if trace_id:
                    # Span model: span id == task id; these two fields
                    # make the cross-process task TREE reconstructable
                    # from the event stream (reference:
                    # tracing_helper.py spans).
                    rec["trace_id"] = trace_id.hex()
                    rec["parent_span"] = parent_span.hex() \
                        if parent_span else ""
                out.append(rec)
            if out:
                self._spawn(self._send_task_events(out))
            return
        events = []
        for (task_id, name, state, ts, trace_id, parent_span,
             attempt, node, wkr, err, actor) in batch:
            # parent == parent_span because a span id IS a task id in
            # the trace model — the trail gets the task tree for free.
            pspan = parent_span.hex() if parent_span else ""
            events.append(grafttrail.task_event(
                task_id.hex(), attempt, state, ts,
                name=name, owner=owner,
                trace=trace_id.hex() if trace_id else "",
                pspan=pspan, parent=pspan,
                actor=actor.hex()[:12] if actor else "",
                node=node, worker=wkr, err=err))
        self._spawn(self._send_trail_events(events, objs))

    async def _send_task_events(self, batch: list) -> None:
        try:
            await self.controller.call("report_task_events", batch)
        except Exception:
            pass  # observability is best-effort

    async def _send_trail_events(self, events: list,
                                 objects: Optional[list] = None) -> None:
        """Ship trail transitions one hop to the node agent, which folds
        every hosted worker's batch into its flush tick (graftpulse's
        transport shape). `objects` carries owner-attested inline-plane
        object events (graftsched) in the same frame. A process with no
        agent registration yet falls back to reporting straight to the
        controller."""
        try:
            agent = getattr(self, "agent", None)
            if agent is not None:
                await agent.call("report_trail",
                                 self.worker_id.binary(), events,
                                 objects or None)
            else:
                await self.controller.call("report_trail_batch", b"",
                                           events, objects or [])
        except Exception:
            pass  # observability is best-effort

    async def _task_event_flusher(self) -> None:
        from ray_tpu_torch.core._native import graftlog
        while True:
            await asyncio.sleep(2.0)
            if self._put_unacked:
                self._drain_put_reply()  # settle a burst-final put ack
            graftlog.flush_stdio_tee()  # tee quantum backstop
            self._flush_task_events()
            self._flush_native_spans()
            self._flush_prof()

    def _flush_prof(self) -> None:
        """Ship this window's graftprof delta one hop to the node agent
        (which batches every hosted worker's profile into its
        fire-and-forget controller forward — the grafttrail transport
        shape). Agent-less processes report straight to the
        controller."""
        from ray_tpu_torch.core._native import graftprof
        if not graftprof.enabled():
            return
        try:
            payload = graftprof.collect_flush()
        except Exception:
            return
        if payload is None:
            return
        self._spawn(self._send_prof(payload))

    async def _send_prof(self, payload: dict) -> None:
        try:
            agent = getattr(self, "agent", None)
            if agent is not None:
                await agent.call("report_prof",
                                 self.worker_id.binary(), payload)
            else:
                await self.controller.call("report_prof_batch", "",
                                           [payload])
        except Exception:
            pass  # observability is best-effort

    # ------------------------------------------------------------------
    # graftscope stitching (owner-side; the native recorder's records
    # become timeline spans here — see _native/graftscope.py)
    # ------------------------------------------------------------------
    def _scope_asm(self):
        """This worker's SpanAssembler, or None while the recorder is
        unavailable/disabled (checked per call: set_enabled can flip at
        runtime; the check is one cached-ctypes C call)."""
        from ray_tpu_torch.core._native import graftscope
        if not (graftscope.available() and graftscope.enabled()):
            return None
        if self._scope is None:
            self._scope = graftscope.SpanAssembler(
                "worker:" + self.worker_id.hex()[:8])
        return self._scope

    def _flush_native_spans(self) -> None:
        """Drain this process's recorder rings, assemble spans, and ship
        them (plus Python-timed put spans buffered by user threads) to
        the controller. Rides the 2s task-event flusher tick so the hot
        paths never touch span assembly."""
        from ray_tpu_torch.core._native import graftscope
        asm = self._scope_asm()
        if asm is None:
            return
        spans = asm.feed(graftscope.drain_records())
        if self._scope_spans:
            buf, self._scope_spans = self._scope_spans, []
            spans.extend(buf)
        # Worker-process counters (rpc send/flush, copy) fold into this
        # process's metrics registry on the same tick. The node pulse
        # needs the client-side op deltas too, but the agent's tick must
        # not pay a per-source cumulative-block fold while it is also
        # dispatching — so THIS process diffs its own cumulative blocks
        # against what it last shipped and forwards only the sparse
        # non-zero delta rows (report_scope_delta); the agent's fold
        # degenerates to one dict merge.
        graftscope.publish_counters()
        counters = graftscope.counters()
        if counters and getattr(self, "agent", None) is not None:
            deltas = self._diff_scope_blocks(counters,
                                             graftscope.histograms())
            if deltas:
                self._spawn(self._send_scope_delta(deltas))
        if spans:
            # Bound the batch: a controller outage must not turn the
            # span buffer into a leak.
            self._spawn(self._send_native_spans(spans[-5000:]))

    async def _send_native_spans(self, spans: list) -> None:
        try:
            await self.controller.call("report_native_spans", spans)
        except Exception:
            pass  # observability is best-effort

    def _diff_scope_blocks(self, counters: dict, hists: dict) -> dict:
        """Sparse per-kind delta of this process's cumulative scope
        blocks since the last flush: {kind: (dcalls, dbytes, dns,
        dhist)} with all-zero rows dropped. The counters only ever grow
        within one process, so a plain subtraction is exact — the
        restart-detection the agent-side fold needed disappears with
        the cumulative transport."""
        prev_c, prev_h = self._scope_sent
        deltas = {}
        for name, cb in counters.items():
            calls, nbytes, ns = (int(x) for x in cb)
            ch = tuple(int(x) for x in hists.get(name, ()))
            pc = prev_c.get(name, (0, 0, 0))
            ph = prev_h.get(name, (0,) * len(ch))
            dh = tuple(max(0, a - b) for a, b in zip(ch, ph))
            dc = max(0, calls - pc[0])
            db = max(0, nbytes - pc[1])
            dn = max(0, ns - pc[2])
            if dc or db or dn or any(dh):
                deltas[name] = (dc, db, dn, dh)
            prev_c[name] = (calls, nbytes, ns)
            prev_h[name] = ch
        return deltas

    async def _send_scope_delta(self, deltas: dict) -> None:
        try:
            await self.agent.call("report_scope_delta",
                                  self.worker_id.binary(), deltas)
        except Exception:
            pass  # observability is best-effort

    # ------------------------------------------------------------------
    # ownership ledger helpers
    # ------------------------------------------------------------------
    def _entry(self, oid: bytes, create: bool = False) -> Optional[ObjectEntry]:
        e = self.objects.get(oid)
        if e is None and create:
            e = ObjectEntry()
            self.objects[oid] = e
        return e

    def _mark_ready_inline(self, oid: bytes, data: bytes, meta: bytes) -> None:
        e = self._entry(oid, create=True)
        e.state = READY
        e.inline = (data, meta)
        e.size = len(data)
        if e.event:
            e.event.set()
        self._note_inline_sealed(oid, len(data))

    def _note_inline_sealed(self, oid: bytes, size: int) -> None:
        """graftsched inline provenance (owner-attested): a small inline
        object never touches the store, so the OWNER is the only process
        that can witness its lifecycle. Objects at/under
        graftsched_inline_bytes get a sealed event on the dedicated
        'inline' plane, debounced one flush window (see __init__ note);
        the paired freed event ships from the pop sites in
        _try_sync_drop / _drain_owned_drops / _maybe_free. Every
        _mark_ready_inline call site runs owner-side (put_inline_marker,
        _do_put, task-reply returns, streamed returns), so hooking here
        covers them all. Larger inline objects stay untracked, as
        before."""
        cap = self._inline_cap
        if cap is None:
            cap = self._inline_cap = (
                GlobalConfig.graftsched_inline_bytes
                if (self._sched_on() and self._trail_on()) else 0)
        if not cap or size > cap:
            return
        from ray_tpu_torch.core._native import grafttrail
        node = self.node_id.hex()[:12] if self.node_id else ""
        hx = oid.hex()
        with self._task_events_lock:
            if hx in self._inline_pending or oid in self._inline_shipped:
                return  # a task retry re-marked an attested return
            self._inline_pending[hx] = grafttrail.object_event(
                hx, "sealed", time.time(), size=size, plane="inline",
                node=node, owner=self.worker_id.hex()[:8])

    def _note_inline_freed(self, oid: bytes) -> None:
        if not self._inline_pending and not self._inline_shipped:
            return
        from ray_tpu_torch.core._native import grafttrail
        node = self.node_id.hex()[:12] if self.node_id else ""
        hx = oid.hex()
        with self._task_events_lock:
            if self._inline_pending.pop(hx, None) is not None:
                return  # freed before attestation: cancel the pair
            if oid not in self._inline_shipped:
                return
            self._inline_shipped.discard(oid)
            self._inline_freed_buf.append(grafttrail.object_event(
                hx, "freed", time.time(), plane="inline", node=node,
                owner=self.worker_id.hex()[:8]))

    def _mark_ready_stored(self, oid: bytes, node_id: bytes, addr: Address,
                           size: int) -> None:
        e = self._entry(oid, create=True)
        e.state = READY
        e.locations.add((node_id, tuple(addr)))
        e.size = size
        if e.event:
            e.event.set()

    def _mark_error(self, oid: bytes, err: BaseException) -> None:
        e = self._entry(oid, create=True)
        e.state = ERROR
        e.error = err
        if e.event:
            e.event.set()

    async def _wait_entry_ready(self, oid: bytes, timeout: Optional[float]
                                ) -> ObjectEntry:
        e = self._entry(oid, create=True)
        if e.state == PENDING:
            if e.event is None:
                e.event = asyncio.Event()
            if timeout is None:
                await e.event.wait()
            else:
                await asyncio.wait_for(e.event.wait(), timeout)
        return e

    # ------------------------------------------------------------------
    # ref counting (core-worker service + local hooks)
    # ------------------------------------------------------------------
    def add_local_ref(self, ref: ObjectRef) -> None:
        k = ref.binary()
        self._local_ref_counts[k] = self._local_ref_counts.get(k, 0) + 1

    def remove_local_ref(self, ref: ObjectRef) -> None:
        k = ref.binary()
        n = self._local_ref_counts.get(k)
        if n is None:
            return
        if n <= 1:
            self._local_ref_counts.pop(k, None)
            owner = ref.owner_addr
            try:
                if owner is None or tuple(owner) == self.address:
                    # Common case first: a READY self-owned object with
                    # one local store copy frees with one C sidecar call
                    # RIGHT HERE — a loop wakeup (self-pipe write + loop
                    # dispatch, ~70us on this VM class) costs more than
                    # the free itself.
                    if self._try_sync_drop(k):
                        return
                    # Everything else is BATCHED onto the loop: a burst
                    # of GC'd refs pays one wakeup and zero Tasks for
                    # the no-contained-refs case (same shape as _spawn).
                    self._owned_drop_buf.append(k)
                    if not self._owned_drop_scheduled:
                        self._owned_drop_scheduled = True
                        self._loop.call_soon_threadsafe(
                            self._drain_owned_drops)
                else:
                    self._spawn(self._notify_remove_borrow(tuple(owner), k))
            except RuntimeError:
                self._owned_drop_scheduled = False  # loop shut down
        else:
            self._local_ref_counts[k] = n - 1

    def _try_sync_drop(self, k: bytes) -> bool:
        """Free a just-dropped SELF-OWNED object synchronously on the
        calling thread when the cheap common case holds: entry READY
        with no contained refs, no borrows, no device twin, and either
        inline-only or exactly one LOCAL store copy reachable over the
        sidecar. Anything unusual (pending, borrowed, remote copies, io
        thread, no sidecar) returns False and takes the batched loop
        path. Safe from user threads for the same reason fast-put is:
        the ref count is already zero, so no new waiter can appear."""
        if threading.get_ident() == getattr(self._io_thread, "ident",
                                            None):
            return False  # never block the loop on sidecar i/o
        e = self.objects.get(k)
        if e is None:
            return True  # nothing tracked: the drop is complete
        if (e.state != READY or e.contained or e.borrow_refs > 0
                or k in self._device_objects or k in self._device_tokens):
            return False
        if not e.locations:
            if e.inline is None:
                return False  # odd state: let the loop path reason
            self.objects.pop(k, None)
            self._drop_map_cache(k)
            self._note_inline_freed(k)
            return True
        if len(e.locations) != 1 or self.agent_addr is None:
            return False
        (_nid, addr), = e.locations
        if tuple(addr) != tuple(self.agent_addr):
            return False
        fp = self._fastpath if self._fastpath_probed else None
        if fp is None:
            return False
        self.objects.pop(k, None)
        self._drop_map_cache(k)
        self._note_inline_freed(k)
        try:
            # Fire-and-forget: the sidecar erases without replying; the
            # outcome (rc 0 = name gone now) rides the next put/contains
            # reply and feeds the staging-inode recycler.
            fp.drop_async(k, self._scratch_note_delete)
        except OSError:
            # Connection lost mid-free: hand the store free to the
            # batched RPC path (entry already dropped).
            try:
                self._loop.call_soon_threadsafe(self._queue_free, addr, k)
            except RuntimeError:
                pass
        return True

    def _queue_free(self, addr, oid: bytes) -> None:
        """Loop-side: enqueue a store free for the batched flusher."""
        self._free_buf.setdefault(tuple(addr), []).append(oid)
        if not self._free_flush_scheduled:
            self._free_flush_scheduled = True
            self._loop.call_soon(self._flush_frees)

    def _drain_owned_drops(self) -> None:
        self._owned_drop_scheduled = False
        while self._owned_drop_buf:
            oid = self._owned_drop_buf.popleft()
            e = self.objects.get(oid)
            if e is None or oid in self._local_ref_counts \
                    or e.borrow_refs > 0:
                continue
            if e.contained:
                # Contained-ref borrows need awaits; rare path.
                spawn(self._maybe_free(oid))
                continue
            self.objects.pop(oid, None)
            self.free_device_object(oid)
            self._drop_map_cache(oid)
            self._note_inline_freed(oid)
            if e.locations:
                for node_id, addr in e.locations:
                    self._free_buf.setdefault(tuple(addr), []).append(oid)
                if not self._free_flush_scheduled:
                    self._free_flush_scheduled = True
                    self._loop.call_soon(self._flush_frees)

    def on_ref_deserialized(self, ref: ObjectRef) -> None:
        k = ref.binary()
        first = k not in self._local_ref_counts
        self.add_local_ref(ref)
        owner = ref.owner_addr
        if first and owner is not None and tuple(owner) != self.address:
            try:
                self._spawn(self._notify_add_borrow(tuple(owner), k))
            except RuntimeError:
                pass

    async def _notify_add_borrow(self, owner: Address, oid: bytes) -> None:
        try:
            await self._client_for_worker(owner).call("add_borrow", oid)
        except Exception:
            pass

    async def _notify_remove_borrow(self, owner: Address, oid: bytes) -> None:
        try:
            await self._client_for_worker(owner).call("remove_borrow", oid)
        except Exception:
            pass

    async def add_borrow(self, oid: bytes) -> None:
        e = self._entry(oid, create=True)
        e.borrow_refs += 1

    async def remove_borrow(self, oid: bytes) -> None:
        e = self._entry(oid)
        if e is None:
            return
        e.borrow_refs -= 1
        await self._maybe_free(oid)

    async def _on_owned_ref_dropped(self, oid: bytes) -> None:
        e = self._entry(oid)
        if e is None:
            return
        await self._maybe_free(oid)

    async def _maybe_free(self, oid: bytes) -> None:
        e = self._entry(oid)
        if e is None:
            return
        if oid in self._local_ref_counts:
            return
        if e.borrow_refs > 0:
            return
        # Free: drop store copies everywhere, forget the entry. A
        # device-resident twin (DeviceRef) shares the oid — its HBM
        # array frees with the ledger entry (ownership integration;
        # reference: gpu_object_manager.py hangs GPU objects off the
        # ObjectRef protocol). Store frees are BATCHED per peer: a burst
        # of dropped refs pays one free_objects RPC per node, not one
        # per object.
        self.objects.pop(oid, None)
        self.free_device_object(oid)
        self._drop_map_cache(oid)
        self._note_inline_freed(oid)
        for node_id, addr in list(e.locations):
            self._free_buf.setdefault(tuple(addr), []).append(oid)
        if e.locations and not self._free_flush_scheduled:
            self._free_flush_scheduled = True
            self._loop.call_soon(self._flush_frees)
        # Drop the borrows this object held on its contained refs.
        for r in e.contained:
            try:
                await self._release_borrow(r)
            except Exception:
                pass

    def _flush_frees(self) -> None:
        self._free_flush_scheduled = False
        buf, self._free_buf = self._free_buf, {}
        local = tuple(self.agent_addr) if self.agent_addr else None
        for addr, oids in buf.items():
            # Local frees ride the C sidecar as fire-and-forget OP_DROP
            # sends (journaled like OP_DELETE; the agent's ledger stays
            # authoritative) — a replied delete would park THIS event
            # loop for a scheduler wake cycle per oid. The drops settle
            # via the cumulative counters on later counter-carrying
            # replies; the scratch callback keeps put-scratch recycling
            # honest about each tenant's fate. Remote frees stay RPC.
            if addr == local:
                fp = self._fastpath if self._fastpath_probed else None
                if fp is not None:
                    try:
                        for oid in oids:
                            fp.drop_async(oid, self._scratch_note_delete)
                        continue
                    except OSError:
                        pass  # connection lost: fall through to RPC
            try:
                peer = self._client_for_worker(addr)
                # lint: allow(rpc-in-loop: one batched free_objects RPC per distinct peer node)
                spawn(self._call_ignore_errors(peer, "free_objects", oids))
            except Exception:
                pass

    async def _call_ignore_errors(self, client, method, *args) -> None:
        try:
            await client.call(method, *args)
        except Exception:
            pass

    # ------------------------------------------------------------------
    # core-worker RPC service (called by agents/other workers)
    # ------------------------------------------------------------------
    async def add_location(self, oid: bytes, node_id: bytes, addr,
                           size: int) -> None:
        self._mark_ready_stored(oid, node_id, tuple(addr), size)

    @long_poll
    async def get_object_status(self, oid: bytes,
                                timeout: float = 60.0) -> dict:
        try:
            e = await self._wait_entry_ready(oid, timeout)
        except asyncio.TimeoutError:
            return {"status": "pending"}
        if e.state == ERROR:
            sv = serialization.serialize(e.error)
            return {"status": "error", "error": sv.to_bytes(),
                    "error_meta": sv.meta()}
        if e.inline is not None:
            return {"status": "inline", "data": e.inline[0],
                    "meta": e.inline[1]}
        return {"status": "stored", "locations": list(e.locations),
                "size": e.size}

    async def ping(self) -> str:
        return "pong"

    # ------------------------------------------------------------------
    # device-resident objects (reference: experimental/gpu_object_manager/
    # gpu_object_manager.py:61 — ObjectRef metadata travels the control
    # plane while the tensor stays in device memory; transfer happens
    # out-of-band on fetch)
    # ------------------------------------------------------------------
    def put_device_object(self, key: bytes, array: Any,
                          consumers: int = 0,
                          ttl_s: float = 600.0) -> None:
        """Hold an array in device memory under `key`. consumers>0 makes
        the entry self-freeing after that many staged pulls (collective
        rendezvous points), with a TTL backstop so a dead participant
        cannot pin the array forever. Callable from any thread (dict ops
        are GIL-atomic; waiters poll on the io loop)."""
        token = object()
        self._device_objects[key] = array
        self._device_tokens[key] = token
        if consumers > 0:
            self._device_consumers[key] = consumers

            async def _ttl_free():
                await asyncio.sleep(ttl_s)
                if self._device_tokens.get(key) is token:
                    self.free_device_object(key)

            self._spawn(_ttl_free())

    def get_device_object_local(self, key: bytes) -> Any:
        return self._device_objects.get(key)

    def free_device_object(self, key: bytes) -> None:
        self._device_objects.pop(key, None)
        self._device_consumers.pop(key, None)
        self._device_tokens.pop(key, None)

    @long_poll
    async def device_pull_info(self, key: bytes,
                               wait_s: float = 0.0) -> Optional[tuple]:
        """Stage the device object for ONE pull by the calling peer and
        return the tiny control tuple (transfer_addr, uuid, aval_descs).
        The tensor itself never touches this RPC — the peer pulls it
        device-to-device through the transfer plane. wait_s>0 parks until
        the key is registered (collective rendezvous; a poll loop — the
        producer may register from an exec thread, so no cross-thread
        asyncio primitives)."""
        arr = self._device_objects.get(key)
        if arr is None and wait_s > 0:
            deadline = asyncio.get_running_loop().time() + wait_s
            while (arr is None
                   and asyncio.get_running_loop().time() < deadline):
                await asyncio.sleep(0.02)
                arr = self._device_objects.get(key)
        if arr is None:
            return None
        # Staging for a device-to-device pull needs the transfer plane.
        raise NotImplementedError(_DEVICE_PLANE_MISSING)

    async def fetch_device_object(self, key: bytes) -> Optional[tuple]:
        """Host-bytes fallback endpoint (cross-backend transfers, or when
        the transfer plane is unavailable): device -> host array -> wire
        (pickle-5 ships the buffer without an extra copy). The D2H copy
        runs OFF the io loop — a multi-GB transfer must not stall this
        worker's RPC service."""
        arr = self._device_objects.get(key)
        if arr is None:
            return None
        import numpy as np
        host = await asyncio.get_running_loop().run_in_executor(
            None, np.asarray, arr)
        return (host, str(host.dtype), host.shape)

    async def free_device_object_remote(self, key: bytes) -> None:
        self.free_device_object(key)

    # ------------------------------------------------------------------
    # device channels (reference: experimental mutable-object channels,
    # src/ray/core_worker/experimental_mutable_object_manager.h:44 —
    # acquire/release slots; ours signals over RPC, moves data over the
    # transfer plane)
    # ------------------------------------------------------------------
    async def channel_notify(self, channel_id: bytes, seq: int,
                             writer_addr, addr: str, uuid: int,
                             descs: list) -> None:
        """A writer published item `seq`: enqueue the pull ticket for the
        local reader."""
        q = self._channel_inbox.get(channel_id)
        if q is None:
            q = self._channel_inbox[channel_id] = asyncio.Queue()
        q.put_nowait((seq, tuple(writer_addr), addr, uuid, descs))

    async def channel_release(self, channel_id: bytes, reader_addr,
                              seq: int) -> None:
        """A reader finished with item `seq` (writer-side handler)."""
        st = self._channel_acks.get(channel_id)
        if st is None:
            st = self._channel_acks[channel_id] = {}
        key = tuple(reader_addr)
        st[key] = max(st.get(key, 0), seq)
        ev = self._channel_ack_events.get(channel_id)
        if ev is not None:
            ev.set()

    async def channel_next(self, channel_id: bytes,
                           timeout: Optional[float]) -> tuple:
        """Reader-side: wait for the next published item ticket."""
        q = self._channel_inbox.get(channel_id)
        if q is None:
            q = self._channel_inbox[channel_id] = asyncio.Queue()
        return await asyncio.wait_for(q.get(), timeout)

    async def channel_wait_acks(self, channel_id: bytes, min_seq: int,
                                n_readers: int,
                                timeout: Optional[float]) -> None:
        """Writer-side backpressure: park until every reader has released
        item `min_seq` (or further)."""
        deadline = (None if timeout is None
                    else asyncio.get_running_loop().time() + timeout)
        while True:
            st = self._channel_acks.get(channel_id, {})
            if (len(st) >= n_readers
                    and all(v >= min_seq for v in st.values())):
                return
            ev = self._channel_ack_events.get(channel_id)
            if ev is None or ev.is_set():
                ev = self._channel_ack_events[channel_id] = asyncio.Event()
            t = (None if deadline is None
                 else deadline - asyncio.get_running_loop().time())
            if t is not None and t <= 0:
                raise asyncio.TimeoutError(
                    f"channel {channel_id.hex()[:8]} backpressure: readers "
                    f"did not release item {min_seq}")
            await asyncio.wait_for(ev.wait(), t)

    def drop_channel(self, channel_id: bytes) -> None:
        self._channel_inbox.pop(channel_id, None)
        self._channel_acks.pop(channel_id, None)
        self._channel_ack_events.pop(channel_id, None)

    # ------------------------------------------------------------------
    # compiled-DAG builtins (executed like actor methods, provided by the
    # worker; reference: python/ray/dag/compiled_dag_node.py actor loops
    # + collective_node.py:252 CollectiveOutputNode)
    # ------------------------------------------------------------------
    def _builtin_dag_call(self, method_name: str, out_mode: str,
                          *args, **kwargs):
        """Run an actor method for a compiled DAG with device-plane IO
        (DeviceRef args pulled device-to-device; out_mode='device' keeps
        the result on the card). The device plane is not ported yet."""
        raise NotImplementedError(_DEVICE_PLANE_MISSING)

    def _builtin_dag_allreduce(self, op_key: bytes, rank: int, world: int,
                               op: str, inputs: list,
                               timeout: float = 120.0):
        """In-DAG allreduce across the participating actors' device
        tensors (hub reduce over the transfer plane). The device plane is
        not ported yet."""
        raise NotImplementedError(_DEVICE_PLANE_MISSING)

    # ------------------------------------------------------------------
    # streaming generators (owner side; reference: task_manager.cc
    # HandleReportGeneratorItemReturns + ObjectRefStream)
    # ------------------------------------------------------------------
    @long_poll
    async def report_streamed_return(self, task_id: bytes, index: int,
                                     kind: str, data, meta, node_id,
                                     addr, size: int,
                                     ref_descs=()) -> dict:
        st = self._streams.get(task_id)
        if st is None or st.released:
            # Consumer gone: tell the producer to stop.
            return {"accepted": False}
        oid = ObjectID.for_task_return(TaskID(task_id), index).binary()
        # Accept an index unless it is already recorded (in st.refs) or was
        # already handed to the consumer (< st.consumed) — reports can
        # arrive out of order (a big item's store-put overlaps the next
        # item's inline report), and a retried worker re-emits from 0.
        if index >= st.consumed and index not in st.refs:
            ref = ObjectRef(ObjectID(oid), self.address)
            self.add_local_ref(ref)  # held for the consumer until handed out
            st.refs[index] = ref
            if kind == "inline":
                self._mark_ready_inline(oid, data, meta)
            else:
                self._mark_ready_stored(oid, node_id, tuple(addr), size)
            if ref_descs:
                # Adopt forwarded refs BEFORE replying: the producer drops
                # its proxy borrow as soon as this RPC returns.
                await self._adopt_reply_refs(task_id,
                                             [(oid, ref_descs)], None)
            st.produced = max(st.produced, index + 1)
            if st.event is not None:
                st.event.set()
        # Backpressure: park this report's reply while the consumer lags
        # more than the window (the producer's send window stalls on it).
        window = GlobalConfig.streaming_generator_backpressure_items
        while (not st.released and st.error is None
               and index + 1 - st.consumed > window):
            if st.bp_event is None or st.bp_event.is_set():
                st.bp_event = asyncio.Event()
            await st.bp_event.wait()
        return {"accepted": not st.released}

    async def _next_stream_item_async(self, task_id: bytes, index: int,
                                      timeout: Optional[float] = None):
        st = self._streams.get(task_id)
        if st is None:
            return None  # exhausted or released: iterator semantics
        deadline = None if timeout is None else \
            asyncio.get_running_loop().time() + timeout
        while True:
            if index < st.produced and index in st.refs:
                st.consumed = max(st.consumed, index + 1)
                if st.bp_event is not None:
                    st.bp_event.set()
                return st.refs.pop(index)
            if st.error is not None:
                raise st.error
            if st.total is not None and index >= st.total:
                self._streams.pop(task_id, None)
                return None
            if st.event is None or st.event.is_set():
                st.event = asyncio.Event()
            if deadline is None:
                await st.event.wait()
            else:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    raise GetTimeoutError("stream item timed out")
                try:
                    await asyncio.wait_for(st.event.wait(), remaining)
                except asyncio.TimeoutError:
                    raise GetTimeoutError("stream item timed out") from None

    def next_stream_item(self, task_id: bytes, index: int,
                         timeout: Optional[float] = None):
        return self._run(
            self._next_stream_item_async(task_id, index, timeout)).result()

    async def _wait_stream_item_async(self, task_id: bytes, index: int,
                                      timeout: float) -> None:
        """Peek-wait: block until stream item `index` is ready (or the
        stream errors/ends) WITHOUT consuming it — pollers (the Data
        executor) park here instead of spinning on timeout=0 probes."""
        st = self._streams.get(task_id)
        deadline = asyncio.get_running_loop().time() + timeout
        while st is not None:
            if index < st.produced and index in st.refs:
                return
            if st.error is not None or st.released:
                return
            if st.total is not None and index >= st.total:
                return
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                return
            if st.event is None or st.event.is_set():
                st.event = asyncio.Event()
            try:
                await asyncio.wait_for(st.event.wait(), remaining)
            except asyncio.TimeoutError:
                return

    def wait_stream_item(self, task_id: bytes, index: int,
                         timeout: float) -> None:
        self._run(self._wait_stream_item_async(task_id, index,
                                               timeout)).result()

    async def next_stream_item_async(self, task_id: bytes, index: int):
        """Variant for async consumers on THEIR OWN event loop (Serve
        replicas): the wait still runs on the core-worker io loop (stream
        events are not thread-safe across loops); the caller's loop awaits
        the bridged future."""
        return await asyncio.wrap_future(
            self._run(self._next_stream_item_async(task_id, index)))

    def release_stream(self, task_id: bytes) -> None:
        st = self._streams.pop(task_id, None)
        if st is None:
            return
        st.released = True

        def _drop():
            if st.bp_event is not None:
                st.bp_event.set()
            if st.event is not None:
                st.event.set()  # wake parked peek-waiters immediately
            for ref in st.refs.values():
                self.remove_local_ref(ref)
            st.refs.clear()

        try:
            self._loop.call_soon_threadsafe(_drop)
        except RuntimeError:
            pass  # loop shut down

    # ------------------------------------------------------------------
    # put / get / wait
    # ------------------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        t0 = time.perf_counter_ns()
        oid = ObjectID.from_put()
        sv = serialization.serialize(value)
        self._put_phase["serialize"] += time.perf_counter_ns() - t0
        ref = ObjectRef(oid, self.address)
        self.add_local_ref(ref)
        # Fast path: a FRESH oid with no contained refs needs no loop
        # coordination (nobody can be waiting on it yet — the same
        # argument as put_inline_marker), so serialize + write + one C
        # sidecar round-trip happens synchronously on this thread.
        if not sv.contained_refs and self._try_fast_put(oid.binary(), sv):
            self._put_phase["puts"] += 1
            return ref
        self._run(self._do_put(oid.binary(), sv)).result()
        self._put_phase["puts"] += 1
        return ref

    def put_phase_snapshot(self) -> Dict[str, int]:
        """Copy of the put-phase breakdown counters (ns per phase +
        total puts); consumed by bench_core.py so a put regression
        localizes to serialize vs copy vs ingest-RPC."""
        return dict(self._put_phase)

    def _use_graftcopy(self) -> bool:
        """Resolve (once per process) whether the fused graftcopy put
        plane is on: flag set AND the native library loads."""
        g = self._graftcopy_put
        if g is None:
            try:
                from ray_tpu_torch.core._native import graftcopy
                g = graftcopy.available()
            except Exception:
                g = False
            self._graftcopy_put = g
        return g

    def _use_graftshm(self) -> bool:
        """Resolve (once per process) whether the shared-memory put
        plane is on: flag set AND the native library loads."""
        g = self._graftshm_put
        if g is None:
            try:
                from ray_tpu_torch.core._native import graftshm
                g = graftshm.available()
            except Exception:
                g = False
            self._graftshm_put = g
        return g

    def _try_fast_put(self, oid: bytes, sv) -> bool:
        meta = sv.meta()
        total = sv.total_size + len(meta)
        if sv.total_size <= GlobalConfig.max_direct_call_object_size:
            self.put_inline_marker(oid, sv)
            return True
        fp = self._get_fastpath()
        if fp is None:
            return False
        # graftshm plane: serialize straight into a store-owned slab —
        # the two round-trips (CREATE with its SCM_RIGHTS fd, then SEAL)
        # only pay off once the saved memcpy dominates, hence the size
        # gate. Any failure falls through to graftcopy below.
        if (total >= GlobalConfig.graftshm_min_bytes
                and self._use_graftshm()
                and self._put_shm(oid, sv, meta, fp)):
            return True
        if self._use_graftcopy():
            # graftcopy plane: ALL sizes stay synchronous on the user
            # thread (it blocks on the put anyway, and both pwritev and
            # the ctypes scatter call drop the GIL for the copy), so a
            # GiB put pays zero loop hops: stage + one fused OP_PUT.
            return self._put_direct(oid, sv, meta, fp)
        # Legacy plane: big payloads keep the executor-offloaded loop
        # path (same knob that gates the loop path's executor hop).
        if total > GlobalConfig.put_executor_offload_bytes:
            return False
        sdir = self._store_dir_cache
        name = self._next_ingest_name()
        path = os.path.join(sdir, name)
        try:
            fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            try:
                sv.write_to_fd(fd, meta)
            finally:
                os.close(fd)
            rc = fp.ingest(oid, name, sv.total_size, len(meta))
        except OSError:
            try:
                os.unlink(path)
            except OSError:
                pass
            return False
        if rc != 0:
            # Full (-2) or raced: clean up; the RPC path can spill.
            try:
                os.unlink(path)
            except OSError:
                pass
            return False
        e = self._entry(oid, create=True)
        e.creating_task = None
        e.contained = []
        self._mark_ready_stored(oid, self.node_id, self.agent_addr,
                                sv.total_size)
        return True

    def _put_direct(self, oid: bytes, sv, meta: bytes, fp) -> bool:
        """Fused put: stage the payload (O_TMPFILE+linkat where the fs
        supports it, else a named O_EXCL file), then ONE sidecar OP_PUT
        round-trip that accounts + renames in + pins + journals. The
        staging name derives from the oid — unique by construction, so
        none of the ingest-name collision machinery applies here. Any
        failure returns False and the loop path (whose create+seal leg
        can evict/spill before bytes land) takes over."""
        phase = self._put_phase
        sdir = self._store_dir_cache
        asm = self._scope_asm()
        w0 = time.time_ns() if asm is not None else 0
        t0 = time.perf_counter_ns()
        try:
            name = self._write_put_file(sdir, oid, sv, meta)
        except FileExistsError:
            # oid-derived name taken: THIS object is already being (or
            # has been) put — let the loop path resolve it idempotently.
            return False
        except OSError:
            # ENOSPC before the store could account/evict, or linkat
            # unsupported mid-flight: fall back (create+seal admission
            # evicts/spills BEFORE any bytes land).
            return False
        w1 = time.time_ns() if asm is not None else 0
        t1 = time.perf_counter_ns()
        phase["copy"] += t1 - t0
        path = os.path.join(sdir, name)
        total = sv.total_size + len(meta)
        if (GlobalConfig.graftcopy_deferred_ack
                and total < GlobalConfig.graftshm_min_bytes):
            # Deferred ack: send the OP_PUT and move on — the sidecar
            # processes requests in order, so the object is visible to
            # every later op on this connection before the reply is
            # even read. The ack rides the next client op (depth-1
            # pipeline); a rejected adoption is repaired off-thread
            # through the spill-capable agent path (_note_put_ack).
            # Large puts keep the synchronous ack: their copy time
            # dwarfs the round-trip, and a failed GiB adoption should
            # not sit unacked in staging.
            self._put_unacked[oid] = (sv, path)
            try:
                fp.put_deferred(oid, name, sv.total_size, len(meta),
                                self._note_put_ack)
            except OSError:
                self._put_unacked.pop(oid, None)
                self._drop_staged(path, oid)
                return False
            phase["ingest"] += time.perf_counter_ns() - t1
            # No per-put drain wakeup: a burst's intermediate acks ride
            # the next op's drain-before-send, the final one settles on
            # the 2s task-event tick (or a getter's settle poke) — a
            # call_soon_threadsafe here costs more in loop wakeups than
            # the deferred reply saves.
        else:
            try:
                rc = fp.put(oid, name, sv.total_size, len(meta))
            except OSError:
                # Sidecar died mid-put: orphaned staging file is swept
                # by the agent; the loop path reconnects or RPCs.
                self._drop_staged(path, oid)
                return False
            phase["ingest"] += time.perf_counter_ns() - t1
            if rc == -1:
                # Already stored: puts are idempotent — success, drop
                # ours.
                self._drop_staged(path, oid)
            elif rc != 0:
                # Full (-2) or rename failure: the RPC path can spill.
                self._drop_staged(path, oid)
                return False
        if asm is not None:
            # Put-plane spans carry the oid64 key AND the ambient trace
            # context: the controller learns oid64 -> context here and
            # uses it to parent the sidecar-side service spans for the
            # same object (which arrive from the agent context-free).
            ctx = getattr(_trace_local, "ctx", None)
            if ctx is None:
                ctx = _trace_ctxvar.get()
            tid = ctx[0].hex() if ctx else ""
            par = ctx[1].hex() if ctx and ctx[1] else \
                (ctx[0].hex() if ctx else "")
            w2 = time.time_ns()
            self._scope_spans.append(asm.put_span(
                "put.copy", w0, w1, oid, tid, par, sv.total_size))
            self._scope_spans.append(asm.put_span(
                "put.ingest", w1, w2, oid, tid, par, sv.total_size))
        e = self._entry(oid, create=True)
        e.creating_task = None
        e.contained = []
        self._mark_ready_stored(oid, self.node_id, self.agent_addr,
                                sv.total_size)
        return True

    def _put_shm(self, oid: bytes, sv, meta: bytes, fp) -> bool:
        """graftshm put: CREATE hands back a store-owned slab fd over
        SCM_RIGHTS; the payload is serialized IN PLACE through a cached
        writable mapping of that slab (the bytes are written exactly
        once, into the pages the store serves them from — there is no
        staging file and no bulk-copy phase); SEAL publishes. Any
        failure returns False and the graftcopy/loop paths take over;
        a staged entry left by a mid-flight failure is deleted here (or
        reclaimed by the sidecar on disconnect)."""
        phase = self._put_phase
        asm = self._scope_asm()
        w0 = time.time_ns() if asm is not None else 0
        t0 = time.perf_counter_ns()
        total = sv.total_size + len(meta)
        try:
            rc, _spath, slab_fd, _reused = fp.create(
                oid, sv.total_size, len(meta))
        except OSError:
            return False
        if rc == -1:
            # Already stored: puts are idempotent — success.
            e = self._entry(oid, create=True)
            e.creating_task = None
            e.contained = []
            self._mark_ready_stored(oid, self.node_id, self.agent_addr,
                                    sv.total_size)
            return True
        if rc != 0:
            # Full (-2: fall back to a path whose admission can spill)
            # or io error (-3).
            return False
        try:
            cache = self._shm_map_cache
            if cache is None:
                from ray_tpu_torch.core._native.graftshm import SlabMapCache
                cache = self._shm_map_cache = SlabMapCache()
            m = cache.map_fd(slab_fd, total)
            sv.write_into_mapped(memoryview(m)[:total], meta)
        except (OSError, ValueError, BufferError):
            # Mapping or in-place write failed: un-stage so the oid is
            # not stuck invisible, then fall back.
            try:
                fp.delete(oid)
            except OSError:
                pass
            return False
        w1 = time.time_ns() if asm is not None else 0
        t1 = time.perf_counter_ns()
        phase["inplace"] += t1 - t0
        try:
            rc = fp.seal(oid)
        except OSError:
            # Seal failed mid-wire. The old connection's disconnect
            # sweep reclaims the staged entry eventually, but the
            # graftcopy fallback below RECONNECTS and its OP_PUT could
            # race that sweep: hitting the still-staged entry reads as
            # rc -1 "already stored" for an object the sweep then
            # deletes. A best-effort delete on the (reconnected) client
            # serializes ahead of the fallback put on the same
            # connection, so the race cannot happen; if the reply was
            # lost AFTER the seal committed, the delete defers behind
            # the primary pin and the fallback's put sees a real
            # sealed copy (idempotent success either way).
            try:
                fp.delete(oid)
            except OSError:
                pass
            return False
        phase["ingest"] += time.perf_counter_ns() - t1
        if rc != 0:
            try:
                fp.delete(oid)
            except OSError:
                pass
            return False
        if asm is not None:
            ctx = getattr(_trace_local, "ctx", None)
            if ctx is None:
                ctx = _trace_ctxvar.get()
            tid = ctx[0].hex() if ctx else ""
            par = ctx[1].hex() if ctx and ctx[1] else \
                (ctx[0].hex() if ctx else "")
            w2 = time.time_ns()
            self._scope_spans.append(asm.put_span(
                "put.inplace", w0, w1, oid, tid, par, sv.total_size))
            self._scope_spans.append(asm.put_span(
                "put.seal", w1, w2, oid, tid, par, sv.total_size))
        e = self._entry(oid, create=True)
        e.creating_task = None
        e.contained = []
        self._mark_ready_stored(oid, self.node_id, self.agent_addr,
                                sv.total_size)
        return True

    def _drop_staged(self, path: str, oid: bytes) -> None:
        """Remove a staged put- name the store did not adopt. When the
        unlink itself succeeds the rename provably never happened, so a
        scratch inode staged for this oid is sole-owned again and may
        be recycled; when it fails (ENOENT — the sidecar may have
        renamed before the connection died) the scratch stays
        conservatively busy until abandoned."""
        try:
            os.unlink(path)
        except OSError:
            return
        self._scratch_note_delete(oid, 0)

    def _scratch_note_delete(self, oid: bytes, rc: int) -> None:
        """Record the settled fate of the object sharing the scratch
        inode: rc 0 (name erased now) feeds the freed-set; anything
        else (deferred behind live readers, connection lost) feeds the
        stale-set, which makes the scratch leg abandon the inode rather
        than guess. Runs under the fastpath client lock from drop
        settlement, so it only touches the sets; the scratch leg folds
        them in under the scratch lock."""
        if oid != self._scratch_oid:
            return
        if rc == 0:
            self._scratch_freed.add(oid)
        else:
            self._scratch_stale.add(oid)

    def _note_put_ack(self, oid: bytes, rc: int) -> None:
        """Deferred put settled (runs under the fastpath client lock —
        stays trivial). rc 0: adopted, done. Anything else queues for
        loop-side repair: -1 already stored (drop our staging file),
        -2/-3 full / io error (re-put through the agent, whose
        admission can spill), -4 connection lost before the ack
        (re-put; puts are idempotent either way)."""
        if rc == 0:
            self._put_unacked.pop(oid, None)
            return
        self._put_ack_err.append((oid, rc))
        try:
            self._loop.call_soon_threadsafe(self._process_put_acks)
        except RuntimeError:
            pass  # loop closed mid-shutdown

    def _process_put_acks(self) -> None:
        while self._put_ack_err:
            oid, rc = self._put_ack_err.popleft()
            staged = self._put_unacked.get(oid)
            if staged is None:
                continue
            sv, path = staged
            # Un-stage first in every case: for -1 the store kept its
            # own copy; for the failures the un-adopted name would
            # collide with the repair's restage (and if -4 actually
            # adopted, the unlink fails harmlessly — the store's hex
            # link holds the inode).
            self._drop_staged(path, oid)
            if rc == -1:
                self._put_unacked.pop(oid, None)  # idempotent success
                continue
            spawn(self._repair_put(oid, sv))

    async def _repair_put(self, oid: bytes, sv) -> None:
        """Re-drive a deferred put whose ack reported failure. The
        object was already READY to waiters — which stays true: the
        repair re-stores the same immutable bytes, and local gets
        issued meanwhile order behind the failed put on the shared
        connection (they miss and land in _get_from_store, which waits
        for this repair before declaring loss)."""
        try:
            await self._do_put(oid, sv)
        except Exception as e:
            self._mark_error(oid, WorkerCrashedError(
                f"deferred put repair failed: {e!r}"))
        finally:
            self._put_unacked.pop(oid, None)

    def _poke_put_drain(self) -> None:
        """Make sure a put burst's LAST deferred ack is eventually
        read even if no further client op comes along to drain it:
        one coalesced loop callback per burst collects whatever reply
        is still pending (by the time the loop runs it, the sidecar
        answered long ago)."""
        if self._put_drain_scheduled:
            return
        self._put_drain_scheduled = True
        try:
            self._loop.call_soon_threadsafe(self._drain_put_reply)
        except RuntimeError:
            self._put_drain_scheduled = False

    def _drain_put_reply(self) -> None:
        self._put_drain_scheduled = False
        fp = self._fastpath if self._fastpath_probed else None
        if fp is not None:
            try:
                fp.poll_pending()
            except OSError:
                pass  # connection lost: pending settled as -4

    def _scratch_try_write(self, sdir: str, path: str, oid: bytes,
                           total: int, sv, meta: bytes, fp) -> bool:
        """Stage via the recycled scratch inode when it is provably
        unshared. Returns False (caller takes the fresh-inode leg) when
        recycling is off, the payload exceeds the cap, another thread
        holds the scratch, or the tenant's erase is still unconfirmed;
        raises like _write_put_file on write or link failure.

        Confirmation policy: the tenant's fire-and-forget drop settles
        on the NEXT counter-carrying sidecar reply, so small payloads
        whose tenant is still unsettled just take the fresh-inode leg
        this round (the scratch stays parked; by the next put the
        previous put's own reply has settled it) — at 200KiB the cold
        pages cost less than any extra round-trip. Large payloads
        (>= graftcopy_min_bytes) spend one CONTAINS round-trip: the
        server answers requests in order on the shared connection, so
        the queued drop has provably been processed by reply time and
        ABSENT means the inode is unshared — ~85us buying back a 2x
        bandwidth difference on the GiB-scale write."""
        cap = GlobalConfig.graftcopy_scratch_max_bytes
        if cap <= 0 or total > cap:
            return False
        if not self._scratch_lock.acquire(blocking=False):
            return False
        try:
            if self._scratch_fd >= 0 and not self._scratch_free:
                tenant = self._scratch_oid
                if (tenant not in self._scratch_freed
                        and tenant not in self._scratch_stale
                        and fp is not None
                        and total >= GlobalConfig.graftcopy_min_bytes):
                    try:
                        if fp.contains(tenant) == 0:
                            self._scratch_freed.add(tenant)
                        else:
                            self._scratch_stale.add(tenant)
                    except OSError:
                        pass  # conn lost: fate unknown this round
                if tenant in self._scratch_freed:
                    self._scratch_freed.discard(tenant)
                    self._scratch_oid = None
                    self._scratch_free = True
                elif tenant in self._scratch_stale:
                    # Tenant provably alive (delete deferred behind
                    # readers) or its fate unknowable: drop OUR link —
                    # the store's copy is untouched — and start over.
                    self._scratch_stale.discard(tenant)
                    self._scratch_close()
                else:
                    return False  # drop unsettled: park the scratch
            if self._scratch_fd < 0:
                sname = (f"scratch-{self.worker_id.hex()[:16]}-"
                         f"{os.getpid()}")
                spath = os.path.join(sdir, sname)
                try:
                    self._scratch_fd = os.open(
                        spath, os.O_CREAT | os.O_RDWR, 0o600)
                except OSError:
                    return False
                self._scratch_name = sname
                self._scratch_size = 0
                self._scratch_oid = None
                self._scratch_free = True
            fd = self._scratch_fd
            spath = os.path.join(sdir, self._scratch_name)
            if self._scratch_size != total:
                os.ftruncate(fd, total)
                self._scratch_size = total
            serialization.write_payload(fd, sv, meta)
            try:
                # Publish: the put- name and the scratch share the
                # inode until the store's delete drops its side.
                os.link(spath, path)
            except FileNotFoundError:
                # The agent swept our idle scratch name: the cached fd
                # points at a dead inode. Recover on the fresh leg.
                self._scratch_close(unlink=False)
                return False
            self._scratch_freed.discard(oid)
            self._scratch_oid = oid
            self._scratch_free = False
            return True
        finally:
            self._scratch_lock.release()

    def _scratch_close(self, unlink: bool = True) -> None:
        """Drop the scratch fd and (optionally) its name; pages of a
        live tenant survive via the store's own hex link."""
        if self._scratch_fd >= 0:
            try:
                os.close(self._scratch_fd)
            except OSError:
                pass
            self._scratch_fd = -1
        if unlink and self._scratch_name and self._store_dir_cache:
            try:
                os.unlink(os.path.join(self._store_dir_cache,
                                       self._scratch_name))
            except OSError:
                pass
        self._scratch_name = None
        self._scratch_oid = None
        self._scratch_free = False
        self._scratch_freed.clear()
        self._scratch_stale.clear()

    def _open_put_file(self, sdir: str, path: str) -> Tuple[int, bool]:
        """-> (fd, named). Prefers an anonymous O_TMPFILE in the store
        dir (a crash mid-write leaves NOTHING to sweep; linkat publishes
        it atomically once the bytes are down); the named-O_EXCL
        fallback covers filesystems without O_TMPFILE. The probe result
        is cached per process."""
        if self._o_tmpfile_ok is not False:
            tmp = getattr(os, "O_TMPFILE", 0)
            if tmp:
                try:
                    fd = os.open(sdir, tmp | os.O_RDWR, 0o600)
                    self._o_tmpfile_ok = True
                    return fd, False
                except OSError:
                    self._o_tmpfile_ok = False
            else:
                self._o_tmpfile_ok = False
        return os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600), True

    def _write_put_file(self, sdir: str, oid: bytes, sv, meta: bytes) -> str:
        """Stage a put payload under its oid-derived name and return the
        name. Shared by the sync fast path and the loop path, so both
        use the same O_TMPFILE+linkat staging and the same
        serialization.write_payload seam (pwritev or the native scatter
        engine). Raises FileExistsError when the name is taken (the
        object is already being put) and OSError on write failure; in
        both cases nothing is left published at the name."""
        name = "put-" + oid.hex()
        path = os.path.join(sdir, name)
        fp = self._fastpath if self._fastpath_probed else None
        if self._scratch_try_write(sdir, path, oid,
                                   sv.total_size + len(meta), sv, meta,
                                   fp):
            return name
        fd, named = self._open_put_file(sdir, path)
        try:
            try:
                serialization.write_payload(fd, sv, meta)
                if not named:
                    from ray_tpu_torch.core._native import graftcopy
                    graftcopy.linkat(fd, path)
            except BaseException:
                if named:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                raise
        finally:
            os.close(fd)
        return name

    def _next_ingest_name(self) -> str:
        """Ingest-file name unique ACROSS pid namespaces: containerized
        workers share the store dir while each believes it is pid 1, so
        the pid alone collides — the random worker_id disambiguates
        (r5 advisor finding). Seq is lock-guarded: puts run on arbitrary
        user threads and the io loop concurrently."""
        with self._fastpath_lock:
            self._ingest_seq += 1
            seq = self._ingest_seq
        return f"ingest-{self.worker_id.hex()[:16]}-{os.getpid()}-{seq}"

    def _get_fastpath(self):
        """Connect the C sidecar client once (probing store_info on the
        loop if the dir cache is cold). Lock-guarded: concurrent first
        puts from user threads must not double-connect."""
        if self._fastpath_probed:
            return self._fastpath
        # Probe OUTSIDE the lock: _run().result() waits on the event
        # loop, and the loop thread itself takes _fastpath_lock briefly
        # in _store_put — holding it across the wait could deadlock.
        if self._store_dir_cache is None:
            try:
                info = self._run(self.agent.call("store_info")).result(10)
                self._store_dir_cache = (info["dir"]
                                         if os.path.isdir(info["dir"])
                                         else "")
                self._fp_sock = info.get("fastpath_sock", "")
            except Exception:
                return None
        with self._fastpath_lock:
            if self._fastpath_probed:
                return self._fastpath
            sock = getattr(self, "_fp_sock", "")
            if self._store_dir_cache and sock and os.path.exists(sock):
                try:
                    from ray_tpu_torch.core.object_store import FastStoreClient
                    self._fastpath = FastStoreClient(sock)
                except Exception as e:
                    logger.debug("store fast path unavailable: %r", e)
                    self._fastpath = None
            self._fastpath_probed = True
        return self._fastpath

    def put_inline_marker(self, oid: bytes, sv) -> None:
        """Synchronously register a small ref-free owned object (e.g. a
        DeviceRef's ledger marker). Safe from ANY thread for a FRESH oid:
        nobody can be waiting on it yet, so no cross-thread event fires —
        which also makes it safe on the io loop itself, where blocking on
        _run(_do_put) would deadlock."""
        assert not sv.contained_refs and \
            sv.total_size <= GlobalConfig.max_direct_call_object_size
        e = self._entry(oid, create=True)
        e.creating_task = None
        e.contained = []
        self._mark_ready_inline(oid, sv.to_bytes(), sv.meta())

    async def _do_put(self, oid: bytes, sv) -> None:
        e = self._entry(oid, create=True)
        e.creating_task = None
        e.contained = list(sv.contained_refs)
        for r in sv.contained_refs:
            await self.add_borrow(r.binary()) if self._is_self_owned(r) else \
                await self._notify_add_borrow(tuple(r.owner_addr), r.binary())
        if sv.total_size <= GlobalConfig.max_direct_call_object_size:
            self._mark_ready_inline(oid, sv.to_bytes(), sv.meta())
            return
        await self._store_put(oid, sv)
        self._mark_ready_stored(oid, self.node_id, self.agent_addr,
                                sv.total_size)

    def _is_self_owned(self, ref: ObjectRef) -> bool:
        return ref.owner_addr is None or tuple(ref.owner_addr) == self.address

    async def _store_put(self, oid: bytes, sv) -> None:
        meta = sv.meta()
        total = sv.total_size + len(meta)
        # Direct-write put (one RPC): write the payload into the store
        # dir ourselves, then store_ingest accounts + renames it in as a
        # sealed primary. Falls back to create+seal when the store dir
        # isn't reachable from this process (non-local agent setups).
        sdir = self._store_dir_cache
        if sdir is None:
            try:
                info = await self.agent.call("store_info")
            except Exception:
                # Transient failure: leave the cache unset so the fast
                # path gets re-probed (a permanent "" would demote every
                # future put in this process to the 3-RPC path).
                info = None
            if info is not None:
                sdir = info["dir"] if os.path.isdir(info["dir"]) else ""
                self._store_dir_cache = sdir
                self._fp_sock = info.get("fastpath_sock", "")
            else:
                sdir = ""

        offload = GlobalConfig.put_executor_offload_bytes

        def _write_at(path, flags):
            # pwrite-family, not mmap+populate: kernel-side bulk copies
            # run ~2x faster than the per-page fault+PTE path on this VM
            # class (3.1 vs 1.6 GiB/s raw for a 1 GiB tmpfs write).
            # write_payload routes GiB-scale copies through the native
            # scatter engine when available.
            fd = os.open(path, flags, 0o600)
            try:
                serialization.write_payload(fd, sv, meta)
            finally:
                os.close(fd)

        loop = asyncio.get_running_loop()
        if sdir:
            name = None
            if self._use_graftcopy():
                # Unified staging: same O_TMPFILE+linkat + write_payload
                # helper as the sync fast path, with the oid-derived
                # name (no collision machinery). Only the ingest RPC
                # differs — this coroutine runs on the io loop, where
                # the blocking sidecar socket is off-limits.
                try:
                    if total > offload:
                        # Big copies run OFF the io loop (a 1 GiB put
                        # must not stall RPC).
                        name = await loop.run_in_executor(
                            None, self._write_put_file, sdir, oid, sv,
                            meta)
                    else:
                        # lint: allow-blocking(small tmpfs write; executor hop costs more than the copy)
                        name = self._write_put_file(sdir, oid, sv, meta)
                except FileExistsError:
                    # oid-derived name taken: this object is already
                    # being put; create+seal resolves idempotently.
                    logger.warning("put staging name for %s already "
                                   "exists; using the create+seal path",
                                   oid.hex())
                except OSError:
                    pass  # e.g. ENOSPC: create+seal admission spills
            else:
                legacy = self._next_ingest_name()
                path = os.path.join(sdir, legacy)
                flags = os.O_CREAT | os.O_RDWR | os.O_EXCL
                try:
                    if total > offload:
                        await loop.run_in_executor(None, _write_at, path,
                                                   flags)
                    else:
                        # lint: allow-blocking(small tmpfs write; executor hop costs more than the copy)
                        _write_at(path, flags)
                    name = legacy
                except FileExistsError:
                    # O_EXCL lost a NAME collision: that file is another
                    # writer's in-flight payload — never unlink it,
                    # never claim success (r5 advisor: the old
                    # treat-as-success here silently lost objects).
                    # Names embed worker_id so this is near-impossible;
                    # fall through to create+seal.
                    logger.warning("ingest name collision on %s; using "
                                   "the create+seal path", legacy)
                except OSError:
                    # Write failed (e.g. tmpfs ENOSPC before the store
                    # could account/evict): clean up and fall through to
                    # the create-first path, whose admission
                    # evicts/spills BEFORE any bytes land.
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                except BaseException:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    raise
            if name is not None:
                path = os.path.join(sdir, name)
                try:
                    await self.agent.call("store_ingest", oid, name,
                                          sv.total_size, len(meta))
                    return
                except RpcApplicationError as e:
                    # FileExistsError FROM THE AGENT means the object is
                    # already stored (a prior ingest committed but its
                    # response was lost and the dedup entry aged out):
                    # puts are idempotent — success. The agent already
                    # unlinked our source file on its error path.
                    if isinstance(e.remote_exc, FileExistsError):
                        try:
                            os.unlink(path)
                        except OSError:
                            pass
                        return
                    raise
                except BaseException:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    raise
        path = await self.agent.call("store_create", oid, sv.total_size,
                                     len(meta))
        if total > offload:
            await loop.run_in_executor(None, _write_at, path, os.O_RDWR)
        else:
            _write_at(path, os.O_RDWR)
        await self.agent.call("store_seal", oid, None, total)

    _FAST_MISS = object()  # sentinel: fast get not applicable

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None
            ) -> List[Any]:
        # Per-ref sync fast path: only the misses pay the event-loop
        # round-trip (a multi-ref get over READY local objects costs no
        # loop hop at all).
        out = [self._try_fast_get(r) for r in refs]
        miss = [i for i, v in enumerate(out) if v is self._FAST_MISS]
        if not miss:
            return out

        try:
            got = self._run(self._bulk_get(refs, miss, timeout)).result()
        except asyncio.TimeoutError:
            raise GetTimeoutError(f"get timed out after {timeout}s")
        for i, v in zip(miss, got):
            out[i] = v
        return out

    async def _bulk_get(self, refs: Sequence[ObjectRef], miss: List[int],
                        timeout: Optional[float]) -> List[Any]:
        """Resolve the fast-path misses of a bulk get.

        Self-owned refs resolve via local entry events, so one coroutine
        awaits them in sequence (a Task per ref costs more than the waits
        themselves on a big batch); work that does real I/O — borrowed
        refs and store fetches — still runs concurrently. All waits share
        one deadline, matching the old gather's per-call timeout start.
        """
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + timeout
        borrowed = [i for i in miss if not self._is_self_owned(refs[i])]
        btask = asyncio.gather(
            *[self.get_async(refs[i], timeout) for i in borrowed]) \
            if borrowed else None
        results: Dict[int, Any] = {}
        fetch: List[tuple] = []  # (index, store-fetch coroutine)
        try:
            for i in miss:
                ref = refs[i]
                if not self._is_self_owned(ref):
                    continue
                rem = None if deadline is None else \
                    max(0.0, deadline - loop.time())
                oid = ref.binary()
                e = await self._wait_entry_ready(oid, rem)
                if e.state == ERROR:
                    raise e.error
                if e.inline is not None:
                    results[i] = serialization.deserialize(
                        e.inline[0], e.inline[1])
                else:
                    fetch.append((i, self._get_from_store(oid, e)))
            if fetch:
                idxs = [i for i, _ in fetch]
                got = await asyncio.gather(*[c for _, c in fetch])
                fetch = []
                for i, v in zip(idxs, got):
                    results[i] = v
        except BaseException:
            if btask is not None:
                btask.cancel()
            for _, c in fetch:
                c.close()
            raise
        if btask is not None:
            for i, v in zip(borrowed, await btask):
                results[i] = v
        return [results[i] for i in miss]

    def _try_fast_get(self, ref: ObjectRef):
        """Synchronous get for the common local case — a READY
        self-owned object that is inline, map-cached, or resident in the
        local store — without an event-loop round-trip (READY is a
        terminal state, so reading the entry off-loop is safe; the C
        sidecar does the pin/release)."""
        if not self._is_self_owned(ref):
            return self._FAST_MISS
        e = self.objects.get(ref.binary())
        if e is None or e.state != READY:
            return self._FAST_MISS
        oid = ref.binary()
        if e.inline is not None:
            return serialization.deserialize(e.inline[0], e.inline[1])
        with self._map_cache_lock:
            mo = self._map_cache.get(oid)
            if mo is not None:
                self._map_cache.move_to_end(oid)
        if mo is not None:
            return serialization.deserialize(mo.data, bytes(mo.meta))
        fp = self._fastpath if self._fastpath_probed else \
            self._get_fastpath()
        if fp is None or (self.node_id, tuple(self.agent_addr)) not in \
                e.locations:
            return self._FAST_MISS
        try:
            got = fp.get(oid)
        except OSError:
            return self._FAST_MISS
        if got is None:  # evicted/spilled locally: loop path restores
            return self._FAST_MISS
        path, ds, ms = got
        try:
            mo = MappedObject(path, ds, ms)
        except OSError:
            self._fp_release_quiet(fp, oid)
            return self._FAST_MISS
        try:
            self._map_cache_put(oid, mo, ds, ms)
            return serialization.deserialize(mo.data, bytes(mo.meta))
        finally:
            # A lost sidecar connection must not fail a get that already
            # read its data (the server releases a dead client's pins).
            self._fp_release_quiet(fp, oid)

    @staticmethod
    def _fp_release_quiet(fp, oid: bytes) -> None:
        try:
            fp.release(oid)
        except OSError:
            pass

    def _map_cache_put(self, oid: bytes, mo, ds: int, ms: int) -> None:
        """Insert into the byte-bounded mapping cache (lock-guarded: the
        sync fast path and the loop path both mutate it). Subtracts any
        replaced entry so concurrent misses for one oid can't drift the
        accounting upward."""
        if ds + ms > self._MAP_CACHE_ENTRY_MAX:
            return
        with self._map_cache_lock:
            prev = self._map_cache.get(oid)
            if prev is not None:
                self._map_cache_bytes -= len(prev.data) + len(prev.meta)
            self._map_cache[oid] = mo
            self._map_cache_bytes += ds + ms
            while (self._map_cache
                   and self._map_cache_bytes > self._MAP_CACHE_MAX_BYTES):
                _, old = self._map_cache.popitem(last=False)
                self._map_cache_bytes -= len(old.data) + len(old.meta)

    def get_future(self, ref: ObjectRef) -> concurrent.futures.Future:
        return self._run(self.get_async(ref))

    async def get_async(self, ref: ObjectRef,
                        timeout: Optional[float] = None,
                        _priority: int = 0) -> Any:
        oid = ref.binary()
        if self._is_self_owned(ref):
            e = await self._wait_entry_ready(oid, timeout)
            if e.state == ERROR:
                raise e.error
            if e.inline is not None:
                return serialization.deserialize(e.inline[0], e.inline[1])
            return await self._get_from_store(oid, e, _priority)
        # Borrowed ref: ask the owner.
        owner = self._client_for_worker(tuple(ref.owner_addr))
        deadline = None if timeout is None else \
            asyncio.get_running_loop().time() + timeout
        while True:
            remaining = 9.0 if deadline is None else \
                min(9.0, deadline - asyncio.get_running_loop().time())
            if remaining <= 0:
                raise asyncio.TimeoutError()
            try:
                status = await owner.call("get_object_status", oid,
                                          timeout=remaining)
            except RpcConnectionLost:
                raise ObjectLostError(
                    f"owner of {ref} is unreachable") from None
            if status["status"] != "pending":
                break
        if status["status"] == "error":
            raise serialization.deserialize(status["error"],
                                            status["error_meta"])
        if status["status"] == "inline":
            return serialization.deserialize(status["data"], status["meta"])
        return await self._fetch_stored(oid, status["locations"],
                                        ref.owner_addr, _priority)

    async def _get_from_store(self, oid: bytes, e: ObjectEntry,
                              priority: int = 0) -> Any:
        ok = await self._ensure_local(oid, list(e.locations), priority)
        if not ok and oid in self._put_unacked:
            # A deferred-ack put of this object hasn't settled — its
            # OP_PUT may have failed (store full) with the repair
            # still in flight. Wait for settlement, then look again
            # before declaring the object lost.
            self._poke_put_drain()
            while oid in self._put_unacked:
                await asyncio.sleep(0.002)
            ok = await self._ensure_local(oid, list(e.locations),
                                          priority)
        if not ok:
            # All copies lost: try lineage reconstruction.
            if e.creating_task is not None:
                await self._resubmit_task(e)
                e2 = await self._wait_entry_ready(oid, None)
                if e2.state == ERROR:
                    raise e2.error
                if e2.inline is not None:
                    return serialization.deserialize(*e2.inline)
                ok = await self._ensure_local(oid, list(e2.locations))
            if not ok:
                raise ObjectLostError(
                    f"object {ObjectID(oid)} lost (all copies gone)")
        return await self._map_local(oid)

    async def _fetch_stored(self, oid: bytes, locations, owner_addr,
                            priority: int = 0) -> Any:
        ok = await self._ensure_local(oid, locations, priority)
        if not ok:
            raise ObjectLostError(f"object {ObjectID(oid)} lost")
        return await self._map_local(oid)

    async def _ensure_local(self, oid: bytes, locations,
                            priority: int = 0) -> bool:
        if await self.agent.call("store_contains", oid) == 1:
            return True
        for node_id, addr in locations:
            if node_id == self.node_id:
                continue  # local agent lost it; try others
            try:
                await self.agent.call("pull_object", oid, tuple(addr),
                                      priority)
                return True
            except Exception as e:
                logger.debug("pull of %s from %s failed: %r",
                             ObjectID(oid), addr, e)
        return await self.agent.call("store_contains", oid) == 1

    # Mapping cache: repeat gets of a sealed object skip the store RPC and
    # re-mapping entirely (sealed objects are immutable; ObjectIDs are
    # never reused, so a cached mapping can only ever serve live data —
    # tmpfs pages stay valid until munmap even after an unlink). Byte-
    # bounded: these mappings pin tmpfs pages OUTSIDE the store's
    # capacity accounting, so the budget stays small.
    _MAP_CACHE_MAX_BYTES = 32 * 1024 * 1024
    _MAP_CACHE_ENTRY_MAX = 4 * 1024 * 1024

    async def _map_local(self, oid: bytes) -> Any:
        with self._map_cache_lock:
            mo = self._map_cache.get(oid)
            if mo is not None:
                self._map_cache.move_to_end(oid)
        if mo is not None:
            return serialization.deserialize(mo.data, bytes(mo.meta))
        got = await self.agent.call("store_get", oid)
        if got is None:
            raise ObjectLostError(f"object {ObjectID(oid)} vanished locally")
        path, ds, ms = got
        try:
            mo = MappedObject(path, ds, ms)
            self._map_cache_put(oid, mo, ds, ms)
            # Deserialized arrays keep views into the mapping alive; the pin
            # can be dropped immediately (tmpfs pages live until munmap).
            return serialization.deserialize(mo.data, bytes(mo.meta))
        finally:
            await self.agent.call("store_release", oid)

    def _drop_map_cache(self, oid: bytes) -> None:
        with self._map_cache_lock:
            mo = self._map_cache.pop(oid, None)
            if mo is not None:
                self._map_cache_bytes -= len(mo.data) + len(mo.meta)

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None) -> Tuple[list, list]:
        return self._run(self._wait_async(list(refs), num_returns,
                                          timeout)).result()

    async def _wait_async(self, refs, num_returns, timeout):
        tasks = {asyncio.ensure_future(self._ready_probe(r)): r for r in refs}
        done_refs: list = []
        pending = set(tasks)
        deadline = None if timeout is None else \
            asyncio.get_running_loop().time() + timeout
        while pending and len(done_refs) < num_returns:
            wait_timeout = None if deadline is None else \
                max(0.0, deadline - asyncio.get_running_loop().time())
            done, pending = await asyncio.wait(
                pending, timeout=wait_timeout,
                return_when=asyncio.FIRST_COMPLETED)
            if not done:
                break
            for d in done:
                done_refs.append(tasks[d])
        for p in pending:
            p.cancel()
        ready = [r for r in refs if r in done_refs][:num_returns]
        not_ready = [r for r in refs if r not in ready]
        return ready, not_ready

    async def _ready_probe(self, ref: ObjectRef) -> None:
        oid = ref.binary()
        if self._is_self_owned(ref):
            await self._wait_entry_ready(oid, None)
            return
        owner = self._client_for_worker(tuple(ref.owner_addr))
        while True:
            status = await owner.call("get_object_status", oid, timeout=9.0)
            if status["status"] != "pending":
                return

    # ------------------------------------------------------------------
    # function table
    # ------------------------------------------------------------------
    def _export_function(self, func: Any) -> tuple:
        # Pickle once per function OBJECT (the reference pickles in
        # RemoteFunction once, not per submit) — re-pickling on the hot
        # path costs ~15% of async task dispatch. A mutated closure on
        # the same function object keeps its first export, same as the
        # reference's semantics.
        try:
            cached = self._func_id_cache.get(func)
        except TypeError:
            cached = None
        if cached is not None:
            return cached, cached in self._pending_exports
        blob = cloudpickle.dumps(func)
        func_id = hashlib.sha1(blob).digest()
        if func_id not in self._exported_funcs:
            put = self.controller.call("kv_put", "fn", func_id.hex(),
                                       blob, False)
            async_export = threading.get_ident() == getattr(
                self._io_thread, "ident", None)
            if async_export:
                # Submitting from the io loop itself (an async actor
                # method calling fn.remote): blocking _run().result()
                # here would deadlock the loop. Export asynchronously —
                # the EXECUTING worker's _load_function retries while
                # the export is in flight (spec.fn_async_export).
                self._pending_exports.add(func_id)
                self._spawn(self._export_bg(func_id, put))
            else:
                self._run(put).result()
            self._exported_funcs.add(func_id)
        else:
            # Re-submission while a background export is still in
            # flight must keep the executor-side retry window open.
            async_export = func_id in self._pending_exports
        try:
            self._func_id_cache[func] = func_id
        except TypeError:
            pass
        return func_id, async_export

    async def _load_function(self, func_id: bytes,
                             retry: bool = False) -> Any:
        fn = self._func_cache.get(func_id)
        if fn is None:
            # Retry window ONLY when the owner flagged an async export
            # (io-loop submission): a fast push can beat the kv_put. A
            # genuinely missing function stays a one-RPC failure.
            blob = None
            delay = 0.05
            deadline = asyncio.get_running_loop().time() + \
                (3.0 if retry else 0.0)
            while True:
                blob = await self.controller.call("kv_get", "fn",
                                                  func_id.hex())
                if blob is not None \
                        or asyncio.get_running_loop().time() > deadline:
                    break
                await asyncio.sleep(delay)
                delay = min(delay * 2, 0.4)
            if blob is None:
                raise RuntimeError(f"function {func_id.hex()} not found")
            fn = cloudpickle.loads(blob)
            self._func_cache[func_id] = fn
        return fn

    async def _export_bg(self, func_id: bytes, put_coro) -> None:
        """Background function-table export (io-loop submissions): on
        failure, un-mark the export so the NEXT submission retries it
        instead of every executor timing out on a key that will never
        arrive."""
        try:
            await put_coro
        except Exception as e:
            self._exported_funcs.discard(func_id)
            logger.warning("function export %s failed: %r (will retry "
                           "on next submission)", func_id.hex()[:12], e)
        finally:
            self._pending_exports.discard(func_id)

    # ------------------------------------------------------------------
    # task submission (owner side)
    # ------------------------------------------------------------------
    def _serialize_args(self, args: tuple, kwargs: dict,
                        held: Optional[List[ObjectRef]] = None) -> list:
        # args encoded positionally; kwargs appended as ("k", name, *wire).
        # Every ref pinned on behalf of the args (top-level, contained in
        # inline values, or promoted big args) is appended to `held` so the
        # submit path can release them all when the task completes.
        if held is None:
            held = []
        out = []
        for a in args:
            out.append(("p",) + self._wire_value(a, held))
        for k, v in kwargs.items():
            out.append(("k", k) + self._wire_value(v, held))
        return out

    def _wire_value(self, v: Any, held: List[ObjectRef]) -> tuple:
        if isinstance(v, ObjectRef):
            self.add_local_ref(v)  # held until task completes
            held.append(v)
            return ("r", v.binary(), v.owner_addr or self.address)
        sv = serialization.serialize(v)
        for r in sv.contained_refs:
            self.add_local_ref(r)
            held.append(r)
        if sv.total_size > GlobalConfig.max_direct_call_object_size:
            # Promote big args to the store under a fresh put id.
            oid = ObjectID.from_put()
            ref = ObjectRef(oid, self.address)
            self.add_local_ref(ref)
            held.append(ref)
            if threading.get_ident() == getattr(self._io_thread, "ident",
                                                None):
                # Submitting from the io loop (async actor method):
                # blocking here would deadlock it. The put completes in
                # the background; the executing side's arg resolution
                # waits on the entry's READY state, not on this call.
                self._spawn(self._do_put(oid.binary(), sv))
            else:
                self._run(self._do_put(oid.binary(), sv)).result()
            return ("r", oid.binary(), self.address)
        return ("v", sv.to_bytes(), sv.meta())

    def submit_task(self, func, args, kwargs, *, num_returns=1,
                    resources: Optional[dict] = None, max_retries: int = 0,
                    placement_group=None, pg_bundle_index: int = -1,
                    scheduling_strategy=None, label_selector=None,
                    name: str = ""):
        streaming = num_returns == "streaming"
        func_id, async_export = self._export_function(func)
        task_id = TaskID.random()
        held: List[ObjectRef] = []
        spec = TaskSpec(
            task_id=task_id.binary(),
            name=name or getattr(func, "__name__", "task"),
            func_id=func_id,
            args=self._serialize_args(args, kwargs, held),
            num_returns=1 if streaming else num_returns,
            streaming=streaming,
            resources=resources or {"CPU": 1.0},
            owner_addr=self.address,
            owner_worker_id=self.worker_id.binary(),
            max_retries=max_retries,
            placement_group=placement_group,
            pg_bundle_index=pg_bundle_index,
            scheduling_strategy=scheduling_strategy,
            label_selector=label_selector,
        )
        spec.fn_async_export = async_export
        spec._ph0 = time.perf_counter_ns()  # task_phase_us: submit stamp
        spec.trace_id, spec.parent_span = \
            self._trace_for_new_task(task_id.binary())
        self._task_arg_refs[task_id.binary()] = held
        self._record_task_event(task_id.binary(), spec.name, "SUBMITTED",
                                spec.trace_id, spec.parent_span)
        if streaming:
            from ray_tpu_torch.core.ref import ObjectRefGenerator
            self._streams[task_id.binary()] = _StreamState()
            self._spawn(self._submit_and_track(spec))
            return ObjectRefGenerator(task_id.binary())
        refs = []
        for i in range(num_returns):
            oid = ObjectID.for_task_return(task_id, i)
            ref = ObjectRef(oid, self.address)
            self.add_local_ref(ref)
            e = self._entry(oid.binary(), create=True)
            if GlobalConfig.lineage_pinning_enabled:
                e.creating_task = spec  # lineage for reconstruction
            refs.append(ref)
        self._spawn(self._submit_and_track(spec))
        return refs

    async def _submit_and_track(self, spec: TaskSpec) -> None:
        try:
            await self._submit_with_retries(spec)
        except BaseException as e:  # mark all returns failed
            from ray_tpu_torch.core.common import TaskCancelledError
            self._record_task_event(
                spec.task_id, spec.name,
                "CANCELLED" if isinstance(e, TaskCancelledError)
                else "FAILED",
                spec.trace_id, spec.parent_span,
                attempt=spec.retry_count, err=repr(e)[:256])
            err = e if isinstance(e, Exception) else WorkerCrashedError(repr(e))
            if spec.streaming:
                self._fail_stream(spec.task_id, err)
            else:
                for i in range(spec.num_returns):
                    oid = ObjectID.for_task_return(TaskID(spec.task_id), i)
                    self._mark_error(oid.binary(), err)
            self._release_arg_refs(spec)

    def _fail_stream(self, task_id: bytes, err: BaseException) -> None:
        st = self._streams.get(task_id)
        if st is not None:
            st.error = err
            if st.event is not None:
                st.event.set()
            if st.bp_event is not None:
                st.bp_event.set()

    async def _submit_with_retries(self, spec: TaskSpec) -> None:
        from ray_tpu_torch.core.common import TaskCancelledError
        attempts = spec.max_retries + 1
        last_exc: Optional[BaseException] = None
        for attempt in range(attempts):
            if spec.task_id in self._cancelled:
                raise TaskCancelledError(f"task {spec.name} cancelled")
            try:
                await self._submit_once(spec)
                return
            except (RpcConnectionLost, WorkerCrashedError, OSError) as e:
                if spec.task_id in self._cancelled:
                    raise TaskCancelledError(
                        f"task {spec.name} cancelled") from None
                last_exc = e
                spec.retry_count += 1
                await asyncio.sleep(GlobalConfig.task_retry_delay_ms / 1000)
        raise WorkerCrashedError(
            f"task {spec.name} failed after {attempts} attempts: {last_exc!r}")

    # -- lease-cached dispatch (reference: normal_task_submitter.cc lease
    # caching per scheduling class + backlog pipelining) ------------------
    def _sched_class(self, spec: TaskSpec) -> tuple:
        strat = spec.scheduling_strategy
        strat_key = tuple(sorted(strat.items())) if isinstance(strat, dict) \
            else strat
        sel = spec.label_selector
        sel_key = tuple(sorted(sel.items())) if sel else None
        return (tuple(sorted(spec.resources.items())), spec.placement_group,
                spec.pg_bundle_index, strat_key, sel_key)

    async def _submit_once(self, spec: TaskSpec) -> None:
        """Enqueue on the scheduling class; a per-class lease pump feeds
        queued tasks through cached worker leases (one RPC stream per
        leased worker, tasks pipelined sequentially)."""
        key = self._sched_class(spec)
        q = self._class_queues.get(key)
        if q is None:
            q = self._class_queues[key] = []
        fut = asyncio.get_running_loop().create_future()
        spec._ph1 = time.perf_counter_ns()  # task_phase_us: queued stamp
        q.append((spec, fut))
        self._class_event(key).set()
        self._ensure_pump(key)
        await fut

    def _class_event(self, key: tuple) -> asyncio.Event:
        ev = self._class_events.get(key)
        if ev is None:
            ev = self._class_events[key] = asyncio.Event()
        return ev

    def _ensure_pump(self, key: tuple) -> None:
        if key not in self._class_pumps:
            self._class_pumps[key] = asyncio.ensure_future(self._pump(key))

    def _preferred_agent_for(self, spec: TaskSpec) -> Optional[Address]:
        """Locality-aware lease target: the node already holding the most
        stored-arg bytes (reference: src/ray/core_worker/lease_policy.cc
        — the best node by object bytes local). Only self-owned stored
        args count (the ledger knows their locations and sizes); inline
        args travel with the spec and have no locality."""
        threshold = GlobalConfig.locality_min_bytes
        by_addr: Dict[Address, int] = {}
        for a in spec.args:
            kind, rest = (a[1], a[2:]) if a[0] == "p" else (a[2], a[3:])
            if kind != "r":
                continue
            e = self.objects.get(rest[0])
            if e is None or not e.locations or not e.size:
                continue
            for _node_id, addr in e.locations:
                t = tuple(addr)
                by_addr[t] = by_addr.get(t, 0) + e.size
        if not by_addr:
            return None
        best = max(by_addr, key=lambda k: by_addr[k])
        return best if by_addr[best] >= threshold else None

    async def _pump(self, key: tuple) -> None:
        """Acquire leases while the class has backlog; one denied-lease
        poller per CLASS (not per task)."""
        try:
            q = self._class_queues[key]
            runners = self._class_runners.setdefault(key, set())
            ev = self._class_event(key)
            max_leases = GlobalConfig.max_pending_lease_requests_per_class
            fail_streak = 0
            while q:
                # Adaptive wave size (AIMD-ish): a denial means the node
                # is saturated at the current concurrency — over-asking
                # parks requests server-side AND spawns surplus workers
                # when those parks are granted after the burst already
                # drained (measured 3x burst slowdown from the churn).
                cap = self._class_lease_cap.get(key, 4)
                want = max(1, min(cap, len(q))) - len(runners)
                if want <= 0:
                    # Enough leased workers for the backlog; sleep until a
                    # runner finishes or a new task arrives (no polling).
                    ev.clear()
                    try:
                        await asyncio.wait_for(ev.wait(), 0.5)
                    except asyncio.TimeoutError:
                        pass
                    continue
                spec0 = q[0][0]

                # Locality: tasks whose stored args live on a remote node
                # lease THERE first, so data-heavy args never cross nodes.
                preferred = None
                if spec0.placement_group is None \
                        and spec0.scheduling_strategy is None:
                    preferred = self._preferred_agent_for(spec0)
                    if preferred is not None and \
                            tuple(preferred) == tuple(self.agent_addr):
                        preferred = None

                def _start_runner(r):
                    runner = asyncio.ensure_future(
                        self._lease_runner(key, r))
                    runners.add(runner)
                    runner.add_done_callback(
                        lambda t, _r=runners, _e=ev: (_r.discard(t),
                                                      _e.set()))

                async def _probe_preferred():
                    # Short queue-wait probe: a busy preferred node must
                    # not stall the local fallback.
                    try:
                        r = await self._client_for_worker(
                            tuple(preferred)).call(
                            "request_lease", spec0.resources,
                            None, -1, None, spec0.label_selector,
                            _no_spill=True, queue_wait_ms=50)
                    except Exception:
                        return None
                    if r and r.get("granted"):
                        r["spilled_to"] = tuple(preferred)
                        return r
                    return None  # preferred busy: go local

                async def _request_one():
                    # Legacy per-lease path (RAY_TPU_TORCH_GRAFTSCHED=0).
                    # Start the runner THE MOMENT a grant lands: siblings
                    # of this wave park server-side for the queue-wait
                    # budget, and a gather-then-start would leave granted
                    # workers idle exactly that long (measured 10x burst
                    # slowdown when a wave mixes grants and parks).
                    r = None
                    if preferred is not None:
                        r = await _probe_preferred()
                    if r is None:
                        r = await self.agent.call(
                            "request_lease", spec0.resources,
                            spec0.placement_group, spec0.pg_bundle_index,
                            spec0.scheduling_strategy,
                            spec0.label_selector)
                    if r.get("granted"):
                        _start_runner(r)
                    return r

                errors: list = []
                granted_n = denied_n = 0
                want0 = want
                if self._sched_on():
                    # graftsched: the whole wave is ONE batched agent RPC
                    # granted from the node's local resource view; the
                    # agent falls back to server-side parking / controller
                    # spillback itself when it can grant nothing.
                    if preferred is not None:
                        r = await _probe_preferred()
                        if r is not None:
                            _start_runner(r)
                            granted_n += 1
                            want -= 1
                    if want > 0:
                        try:
                            # lint: allow(rpc-in-loop: one BATCHED lease wave per pump iteration — the batching IS this call; per-lease RPCs are the legacy path)
                            rb = await self.agent.call(
                                "request_lease_batch", want,
                                spec0.resources, spec0.placement_group,
                                spec0.pg_bundle_index,
                                spec0.scheduling_strategy,
                                spec0.label_selector)
                            grants = rb.get("granted") or []
                            for r in grants:
                                _start_runner(r)
                            granted_n += len(grants)
                            denied_n = want - len(grants)
                        except Exception as e:
                            errors.append(e)
                    results_n = max(1, len(errors) + (1 if granted_n
                                                      or denied_n else 0))
                else:
                    results = await asyncio.gather(
                        *[_request_one() for _ in range(want)],
                        return_exceptions=True)
                    errors = [r for r in results
                              if isinstance(r, BaseException)]
                    granted_n = sum(1 for r in results
                                    if isinstance(r, dict)
                                    and r.get("granted"))
                    denied_n = sum(1 for r in results
                                   if isinstance(r, dict)
                                   and not r.get("granted"))
                    results_n = len(results)
                if denied_n:
                    self._class_lease_cap[key] = max(
                        1, len(runners))
                elif granted_n == want0 and q:
                    # Gentle growth: +1 per fully-granted wave with
                    # backlog left (aggressive doubling overshoots into
                    # park-then-surplus-worker churn on small nodes).
                    self._class_lease_cap[key] = min(max_leases, cap + 1)
                if errors and len(errors) == results_n:
                    # Agent unreachable: don't hang callers forever — after
                    # a sustained streak, fail everything still queued so
                    # _submit_with_retries / the caller sees the error.
                    fail_streak += 1
                    if fail_streak >= 40:
                        while q:
                            _, fut = q.pop(0)
                            if not fut.done():
                                fut.set_exception(WorkerCrashedError(
                                    f"node agent unreachable: {errors[0]!r}"))
                        return
                    await asyncio.sleep(0.05)
                else:
                    fail_streak = 0
                # No client-side poll on denial: the agent parks denied
                # requests server-side (lease_queue_wait_ms) and replies
                # only when granted or its wait budget expires, so looping
                # immediately is not a busy-poll.
        finally:
            self._class_pumps.pop(key, None)
            # Re-arm if tasks raced in while we were exiting.
            if self._class_queues.get(key):
                self._ensure_pump(key)

    async def _lease_runner(self, key: tuple, lease: dict) -> None:
        """Feed queued tasks of this class through one leased worker with up
        to ``worker_lease_pipeline_depth`` pushes in flight (the RPC client
        is multiplexed; execution on the worker stays serial in its exec
        pool). Pipelining hides per-task RPC latency — the reference gets
        its small-task throughput the same way (normal_task_submitter.cc
        pipelines onto cached leases). Returns the lease when the worker
        looks broken, or when the backlog drains AND stays drained for
        the graftsched keep-alive TTL — steady-state task streams pay
        one worker push per task and zero lease RPCs."""
        q = self._class_queues[key]
        worker_addr = tuple(lease["worker_addr"])
        lease_node = lease.get("spilled_to", self.agent_addr)
        node_hex = (lease.get("node_id") or b"").hex()[:12]
        client = self._client_for_worker(worker_addr)
        depth = max(1, GlobalConfig.worker_lease_pipeline_depth)
        keepalive = (GlobalConfig.graftsched_keepalive_ms / 1000
                     if self._sched_on() else 0.0)
        ev = self._class_event(key)
        inflight: set = set()
        broken = False
        try:
            while not broken:
                while q and len(inflight) < depth:
                    # Coalesce a run of REF-FREE specs into one batched
                    # push (same RPC-amortization as the actor path; a
                    # spec with ref args ships alone — its dependency may
                    # ride this same batch's reply, which the owner only
                    # processes after every member finishes). Slow
                    # classes don't coalesce: a batch reply would delay
                    # each member's result until the SLOWEST finishes.
                    cap = 16
                    if self._class_task_ms.get(key, 0.0) > 10.0:
                        cap = 1
                    batch: list = []
                    while q and len(batch) < cap:
                        spec, fut = q[0]
                        if fut.done():  # cancelled/raced
                            q.pop(0)
                            continue
                        if self._task_arg_refs.get(spec.task_id) \
                                or spec.streaming:
                            # Ref-args specs ship alone (dependency may
                            # ride this batch's reply). STREAMING specs
                            # ship alone too: the batch reply carries
                            # each generator's streamed_total, so
                            # coalescing would withhold every stream's
                            # COMPLETION until the slowest generator in
                            # the batch finishes — and a consumer that
                            # gates later work on an earlier stream's
                            # end (the Data executor's ordered emission)
                            # deadlocks against it.
                            if batch:
                                break  # close the ref-free run first
                            q.pop(0)
                            batch.append((spec, fut))
                            break
                        q.pop(0)
                        batch.append((spec, fut))
                    if not batch:
                        continue
                    if self._trail_on():
                        for bspec, _bfut in batch:
                            self._record_task_event(
                                bspec.task_id, bspec.name, "LEASED",
                                attempt=bspec.retry_count, node=node_hex)
                    if len(batch) == 1:
                        inflight.add(asyncio.ensure_future(
                            self._push_one(client, *batch[0], key=key)))
                    else:
                        inflight.add(asyncio.ensure_future(
                            self._push_task_batch_out(client, batch,
                                                      key)))
                if not inflight:
                    if q:
                        continue  # popped only done-futs: refill
                    # graftsched keep-alive: the backlog drained — hold
                    # the leased worker for the TTL instead of paying
                    # the return+re-request lease round-trip pair on
                    # the next burst. The pump counts parked runners,
                    # so it never over-leases while we wait.
                    if keepalive <= 0:
                        break
                    ev.clear()
                    if q:
                        continue  # a submit raced the clear: drain it
                    try:
                        await asyncio.wait_for(ev.wait(), keepalive)
                    except asyncio.TimeoutError:
                        pass
                    if not q:
                        break
                    continue
                done, inflight = await asyncio.wait(
                    inflight, return_when=asyncio.FIRST_COMPLETED)
                broken = any(d.result() is False for d in done)
            if inflight:  # worker suspect: let in-flight pushes settle
                await asyncio.wait(inflight)
        finally:
            agent = self.agent if tuple(lease_node) == tuple(self.agent_addr) \
                else self._client_for_worker(tuple(lease_node))
            spawn(self._return_lease_quiet(
                agent, lease["lease_id"]))

    def _note_class_ms(self, key: Optional[tuple], ms: float) -> None:
        if key is None:
            return
        prev = self._class_task_ms.get(key, ms)
        self._class_task_ms[key] = 0.7 * prev + 0.3 * ms

    def _note_task_phases(self, spec: TaskSpec, t_push: int,
                          t_reply: int) -> None:
        """Fold one settled task into the phase accumulators: submit
        (API entry -> class-queue enqueue), lease (enqueue -> push),
        run (push -> reply), reply (reply -> refs settled)."""
        ph0 = getattr(spec, "_ph0", None)
        if ph0 is None:
            return
        ph = self._task_phase
        ph["submit"] += spec._ph1 - ph0
        ph["lease"] += t_push - spec._ph1
        ph["run"] += t_reply - t_push
        ph["reply"] += time.perf_counter_ns() - t_reply
        ph["tasks"] += 1

    def task_phase_snapshot(self) -> Dict[str, int]:
        """Copy of the task-phase breakdown counters (ns per phase +
        total tasks); consumed by bench_core.py so a dispatch regression
        localizes to submit vs lease vs run vs reply."""
        return dict(self._task_phase)

    async def _push_one(self, client: RpcClient, spec: TaskSpec,
                        fut: asyncio.Future,
                        key: Optional[tuple] = None) -> bool:
        """Push one task; True on transport success (user errors travel in
        the reply), False when the worker is suspect."""
        self._task_exec_addr[spec.task_id] = tuple(client._address)
        try:
            t0 = time.perf_counter_ns()
            reply = await client.call("push_task",
                                      pickle.dumps(spec, protocol=5))
            tr = time.perf_counter_ns()
            self._note_class_ms(key, (tr - t0) / 1e6)
            self._process_task_reply(spec, reply, client)
            self._note_task_phases(spec, t0, tr)
            self._release_arg_refs(spec)
            if not fut.done():
                fut.set_result(None)
            return True
        except BaseException as e:
            if not fut.done():
                fut.set_exception(e if isinstance(e, Exception)
                                  else WorkerCrashedError(repr(e)))
            return False
        finally:
            self._task_exec_addr.pop(spec.task_id, None)

    async def _push_task_batch_out(self, client: RpcClient, items: list,
                                   key: Optional[tuple] = None) -> bool:
        """Push a coalesced batch of ref-free normal tasks; True on
        transport success (user errors travel per-reply)."""
        blobs = []
        for spec, _fut in items:
            self._task_exec_addr[spec.task_id] = tuple(client._address)
            blobs.append(pickle.dumps(spec, protocol=5))
        try:
            t0 = time.perf_counter_ns()
            replies = await client.call("push_task_batch", blobs)
            tr = time.perf_counter_ns()
            self._note_class_ms(key, (tr - t0) / 1e6 / len(items))
            for (spec, fut), reply in zip(items, replies):
                self._process_task_reply(spec, reply, client)
                self._note_task_phases(spec, t0, tr)
                self._release_arg_refs(spec)
                if not fut.done():
                    fut.set_result(None)
            return True
        except BaseException as e:
            err = e if isinstance(e, Exception) else \
                WorkerCrashedError(repr(e))
            for _spec, fut in items:
                if not fut.done():
                    fut.set_exception(err)
            return False
        finally:
            for spec, _fut in items:
                self._task_exec_addr.pop(spec.task_id, None)

    async def _return_lease_quiet(self, agent: RpcClient, lease_id) -> None:
        try:
            await agent.call("return_lease", lease_id)
        except Exception:
            pass

    def _release_arg_refs(self, spec: TaskSpec) -> None:
        self._cancelled.discard(spec.task_id)  # settled: prune bookkeeping
        for ref in self._task_arg_refs.pop(spec.task_id, ()):
            self.remove_local_ref(ref)

    def release_actor_arg_refs(self, actor_id: bytes) -> None:
        """Drop the pins on an actor's constructor args (kill / death)."""
        for ref in self._actor_arg_refs.pop(actor_id, ()):
            self.remove_local_ref(ref)

    def _process_task_reply(self, spec: TaskSpec, reply: dict,
                            client: Optional[RpcClient] = None) -> None:
        if reply.get("error") is not None:
            from ray_tpu_torch.core.common import TaskCancelledError
            err = serialization.deserialize(reply["error"],
                                            reply["error_meta"])
            self._record_task_event(
                spec.task_id, spec.name,
                "CANCELLED" if isinstance(err, TaskCancelledError)
                else "FAILED",
                spec.trace_id, spec.parent_span,
                attempt=spec.retry_count, err=repr(err)[:256])
            if spec.streaming:
                self._fail_stream(spec.task_id, err)
                return
            for i in range(spec.num_returns):
                oid = ObjectID.for_task_return(TaskID(spec.task_id), i)
                self._mark_error(oid.binary(), err)
            return
        self._record_task_event(spec.task_id, spec.name, "FINISHED",
                                spec.trace_id, spec.parent_span,
                                attempt=spec.retry_count)
        if spec.streaming:
            st = self._streams.get(spec.task_id)
            if st is not None:
                st.total = reply["streamed_total"]
                if st.event is not None:
                    st.event.set()
            return
        adopt: list = []  # (oid, ref_descs) for refs forwarded in results
        for i, ret in enumerate(reply["returns"]):
            oid = ObjectID.for_task_return(TaskID(spec.task_id), i)
            if ret[0] == "inline":
                self._mark_ready_inline(oid.binary(), ret[1], ret[2])
                descs = ret[3] if len(ret) > 3 else ()
            else:  # ("stored", node_id, agent_addr, size, ref_descs)
                self._mark_ready_stored(oid.binary(), ret[1], tuple(ret[2]),
                                        ret[3])
                descs = ret[4] if len(ret) > 4 else ()
            if descs:
                adopt.append((oid.binary(), descs))
        if adopt:
            self._spawn(self._adopt_reply_refs(spec.task_id, adopt, client))

    async def _adopt_reply_refs(self, task_id: bytes, adopt: list,
                                client: Optional[RpcClient]) -> None:
        """Register this owner's borrows on ObjectRefs forwarded inside a
        task's results, attach them to the result entries (released when
        the result is freed), then ack the executing worker so it drops
        its proxy borrow — the handoff is confirmed, not timer-based."""
        for oid, descs in adopt:
            refs = []
            for b, owner in descs:
                r = ObjectRef(ObjectID(bytes(b)),
                              tuple(owner) if owner else None)
                # Lifetime is managed via the entry's contained-borrow
                # protocol (like put), not Python GC of this proxy object.
                r._weakref_released = True
                if self._is_self_owned(r):
                    await self.add_borrow(r.binary())
                else:
                    await self._notify_add_borrow(tuple(r.owner_addr),
                                                  r.binary())
                refs.append(r)
            e = self.objects.get(oid)
            if e is not None:
                e.contained.extend(refs)
            else:  # result already freed: release the borrows right away
                for r in refs:
                    await self._release_borrow(r)
        if client is not None:
            try:
                await client.call("ack_reply_refs", task_id)
            except Exception:
                pass  # worker gone: its grace fallback cleans up

    # ------------------------------------------------------------------
    # cancellation (owner side; reference: core_worker.cc CancelTask)
    # ------------------------------------------------------------------
    def cancel(self, target, force: bool = False) -> None:
        """Cancel a task by its ObjectRef or ObjectRefGenerator. Queued
        tasks are dropped; a running task gets TaskCancelledError raised
        in its exec thread (force=True kills the worker process)."""
        from ray_tpu_torch.core.ref import ObjectRefGenerator
        if isinstance(target, ObjectRefGenerator):
            task_id = target.task_id
        else:
            task_id = ObjectID(target.binary()).task_id().binary()
        self._run(self._cancel_async(task_id, force)).result()

    async def _cancel_async(self, task_id: bytes, force: bool) -> None:
        from ray_tpu_torch.core.common import TaskCancelledError
        if (task_id not in self._task_arg_refs
                and task_id not in self._streams):
            return  # already settled: nothing to cancel (and nothing leaks)
        self._cancelled.add(task_id)
        err = TaskCancelledError(f"task {TaskID(task_id)} cancelled")
        # Drop from any scheduling-class queue (not yet pushed).
        for q in self._class_queues.values():
            for item in list(q):
                spec, fut = item
                if spec.task_id == task_id:
                    q.remove(item)
                    if not fut.done():
                        fut.set_exception(err)
        # Interrupt if already executing somewhere.
        addr = self._task_exec_addr.get(task_id)
        if addr is not None:
            try:
                await self._client_for_worker(addr).call(
                    "cancel_task", task_id, force)
            except Exception:
                pass  # dead (force) or unreachable: push path surfaces it

    async def _resubmit_task(self, e: ObjectEntry) -> None:
        """Lineage reconstruction: re-run the creating task."""
        spec = e.creating_task
        assert spec is not None
        logger.info("reconstructing via resubmit of task %s", spec.name)
        for i in range(spec.num_returns):
            oid = ObjectID.for_task_return(TaskID(spec.task_id), i)
            ent = self._entry(oid.binary(), create=True)
            ent.state = PENDING
            ent.locations.clear()
            ent.inline = None
            ent.event = asyncio.Event()
        await self._submit_with_retries(spec)

    # ------------------------------------------------------------------
    # actors (owner side)
    # ------------------------------------------------------------------
    def create_actor(self, cls, args, kwargs, *, name: str = "",
                     max_restarts: int = 0, max_task_retries: int = 0,
                     resources: Optional[dict] = None, placement_group=None,
                     pg_bundle_index: int = -1,
                     runtime_env: Optional[dict] = None,
                     max_concurrency: int = 0,
                     label_selector: Optional[dict] = None) -> ActorHandle:
        actor_id = ActorID.random()
        self._ensure_actor_sub()
        # Package working_dir/py_modules to the controller KV and rewrite
        # runtime_env into wire form (reference: runtime_env URI packaging).
        if runtime_env and ("working_dir" in runtime_env
                            or "py_modules" in runtime_env):
            from ray_tpu_torch.core.runtime_env import upload_packages
            runtime_env = upload_packages(self, runtime_env)
        held: List[ObjectRef] = []
        creation = {
            "cls_blob": cloudpickle.dumps(cls),
            "args": self._serialize_args(args, kwargs, held),
            "actor_id": actor_id.binary(),
            "max_restarts": max_restarts,
            "max_concurrency": max_concurrency,
            "runtime_env": runtime_env,
        }
        self._actor_arg_refs[actor_id.binary()] = held
        spec_blob = cloudpickle.dumps(creation)
        placement = ((placement_group, pg_bundle_index)
                     if placement_group is not None else None)
        register = self.controller.call(
            "create_actor", actor_id.binary(), spec_blob, name, max_restarts,
            resources or {"CPU": 1.0}, placement,
            runtime_env=runtime_env,
            label_selector=label_selector)
        if threading.get_ident() == getattr(self._io_thread, "ident",
                                            None):
            # Creating an actor from an async actor method: the handle
            # works immediately (actor_id is client-generated; method
            # pushes wait on wait_actor_ready), so the controller
            # registration can complete in the background rather than
            # deadlocking the loop.
            self._spawn(register)
        else:
            self._run(register).result()
        method_names = [m for m in dir(cls)
                        if not m.startswith("_") and callable(getattr(cls, m))]
        return ActorHandle(actor_id, name or cls.__name__, method_names,
                           max_task_retries)

    def submit_actor_task(self, handle: ActorHandle, method: str, args,
                          kwargs, *, num_returns=1):
        actor_id = handle.actor_id.binary()
        self._ensure_actor_sub()
        streaming = num_returns == "streaming"
        task_id = TaskID.random()
        tid = task_id.binary()
        wid = self.worker_id.binary()
        held: List[ObjectRef] = []
        spec = TaskSpec(
            task_id=tid,
            name=f"{handle._name}.{method}",
            func_id=b"",
            args=self._serialize_args(args, kwargs, held),
            num_returns=1 if streaming else num_returns,
            streaming=streaming,
            resources={},
            owner_addr=self.address,
            owner_worker_id=wid,
            actor_id=actor_id,
            method_name=method,
            seqno=-1,  # assigned at push time (incarnation-aware)
            caller_id=wid,
            max_retries=handle._max_task_retries,
        )
        spec.trace_id, spec.parent_span = self._trace_for_new_task(tid)
        self._task_arg_refs[tid] = held
        self._record_task_event(tid, spec.name, "SUBMITTED",
                                spec.trace_id, spec.parent_span,
                                actor=actor_id)
        if streaming:
            from ray_tpu_torch.core.ref import ObjectRefGenerator
            self._streams[task_id.binary()] = _StreamState()
            self._spawn(self._submit_actor_and_track(spec))
            return ObjectRefGenerator(task_id.binary())
        refs = []
        for i in range(num_returns):
            oid = ObjectID.for_task_return(task_id, i)
            ref = ObjectRef(oid, self.address)
            self.add_local_ref(ref)
            self._entry(oid.binary(), create=True)
            refs.append(ref)
        # Hot path: no per-call coroutine/Task/Future. Append straight to
        # the per-actor push buffer (GIL-atomic from this user thread) and
        # poke the dispatch drainer — one loop wakeup per burst. A None
        # future means completion is settled through the return-ref
        # entries themselves (_settle_spec_error / _process_task_reply).
        self._actor_push_buf.setdefault(actor_id, []).append((spec, None))
        self._poke_dispatch(actor_id)
        return refs[0] if num_returns == 1 else refs

    async def _submit_actor_and_track(self, spec: TaskSpec) -> None:
        try:
            await self._submit_actor_with_retries(spec)
        except BaseException as e:
            from ray_tpu_torch.core.common import TaskCancelledError
            self._record_task_event(
                spec.task_id, spec.name,
                "CANCELLED" if isinstance(e, TaskCancelledError)
                else "FAILED",
                spec.trace_id, spec.parent_span,
                attempt=spec.retry_count, err=repr(e)[:256],
                actor=spec.actor_id)
            err = e if isinstance(e, Exception) else WorkerCrashedError(repr(e))
            if spec.streaming:
                self._fail_stream(spec.task_id, err)
            else:
                for i in range(spec.num_returns):
                    oid = ObjectID.for_task_return(TaskID(spec.task_id), i)
                    self._mark_error(oid.binary(), err)
            self._release_arg_refs(spec)

    def _ensure_actor_sub(self) -> None:
        """Subscribe (once) to controller actor-state events so deaths and
        restarts are pushed instead of discovered via failed RPCs."""
        if self._actor_sub is not None:
            return
        from ray_tpu_torch.core.pubsub import Subscription

        def on_event(ev: dict) -> None:
            actor_id = ev["actor_id"]
            known = (actor_id in self._actor_incarnation
                     or actor_id in self._actor_clients
                     or actor_id in self._actor_arg_refs)
            if not known:
                return
            if ev["state"] == ActorState.DEAD:
                self._actor_clients.pop(actor_id, None)
                while len(self._actor_deaths) >= 4096:  # bounded bookkeeping
                    self._actor_deaths.pop(next(iter(self._actor_deaths)))
                self._actor_deaths[actor_id] = ev.get("death_reason", "")
                self.release_actor_arg_refs(actor_id)
            elif ev["state"] == ActorState.RESTARTING:
                # Stale address: drop so the next submit re-resolves.
                self._actor_clients.pop(actor_id, None)

        self._actor_sub = Subscription(self.controller, "actor_events",
                                       on_event)
        self._spawn(self._start_actor_sub())

    async def _start_actor_sub(self) -> None:
        if self._actor_sub is not None:
            self._actor_sub.start()

    async def _actor_client(self, actor_id: bytes,
                            refresh: bool = False) -> RpcClient:
        if actor_id in self._actor_deaths:
            from ray_tpu_torch.core.common import ActorDiedError
            raise ActorDiedError(
                f"actor is DEAD: {self._actor_deaths[actor_id]}")
        cached = None if refresh else self._actor_clients.get(actor_id)
        if cached is not None:
            return cached[1]
        info = await self.controller.call("wait_actor_ready", actor_id)
        if info["state"] != "ALIVE":
            from ray_tpu_torch.core.common import ActorDiedError
            self.release_actor_arg_refs(actor_id)
            raise ActorDiedError(
                f"actor is {info['state']}: {info.get('death_reason', '')}")
        addr = tuple(info["addr"])
        incarnation = info.get("incarnation", 0)
        if self._actor_incarnation.get(actor_id) != incarnation:
            # New incarnation: the restarted worker expects seqno 0 from every
            # caller again (its ordering state died with the old process).
            self._actor_seq_out[actor_id] = 0
            self._actor_incarnation[actor_id] = incarnation
        # Transport-level retries are exactly-once (request-id dedup on the
        # server), so a lost reply or injected failure re-sends the SAME
        # seqno instead of burning a new one — a fresh seqno for a push the
        # worker never saw would park its ordering queue forever.
        client = RpcClient(addr, max_retries=3)
        self._actor_clients[actor_id] = (addr, client, incarnation)
        return client

    # ------------------------------------------------------------------
    # graftrpc dispatch plane (native hot path for push_task_batch)
    # ------------------------------------------------------------------
    async def graft_sock(self) -> str:
        """Dispatch-plane discovery (control-plane RPC): path of this
        worker's graftrpc listener, '' when the native plane is off."""
        return self._graft_path if self._graft is not None else ""

    def _on_graft_frame(self, conn: int, op: int, flags: int, chan: int,
                        seq: int, payload: bytes) -> None:
        from ray_tpu_torch.core._native import graftrpc
        if op == graftrpc.OP_REPLY:
            ch = self._graft_chan_by_conn.get(conn)
            if ch is not None:
                ch.on_reply(seq, flags, payload)
        elif op == graftrpc.OP_CALL:
            spawn(self._serve_graft_call(conn, chan, seq, payload))
        elif op == graftrpc.OP_INTERN:
            graftrpc.intern_frame_apply(
                payload, self._graft_interns.setdefault(conn, {}))

    def _on_graft_close(self, conn: int) -> None:
        self._graft_interns.pop(conn, None)
        ch = self._graft_chan_by_conn.pop(conn, None)
        if ch is not None:
            # In-flight calls surface as a retriable transport loss; the
            # actor retry loop re-resolves the client and assigns FRESH
            # seqnos (replaying old ones would park the peer's gate).
            ch.fail(RpcConnectionLost("graftrpc connection lost"))
            for addr, cached in list(self._graft_channels.items()):
                if cached is ch:
                    self._graft_channels.pop(addr, None)

    async def _graft_channel_for(self, client: RpcClient):
        """Dispatch-plane channel to the peer behind `client`, or None
        when the plane is off locally, the peer has no listener (cached
        negatively), or discovery/connect fails. Discovery is
        single-flight per address: a burst of concurrent batches shares
        one dial instead of opening one connection each."""
        if self._graft is None:
            return None
        addr = client._address if isinstance(client._address, str) \
            else tuple(client._address)
        ch = self._graft_channels.get(addr)
        if ch is not None and not ch.closed:
            return ch
        if addr in self._graft_no:
            return None
        fut = self._graft_dialing.get(addr)
        if fut is None:
            fut = spawn(self._graft_dial(client, addr))
            self._graft_dialing[addr] = fut
            fut.add_done_callback(
                lambda _f, _a=addr: self._graft_dialing.pop(_a, None))
        try:
            return await asyncio.shield(fut)
        except Exception:
            return None

    async def _graft_dial(self, client: RpcClient, addr):
        try:
            path = await client.call("graft_sock")
        except RpcApplicationError:
            path = ""  # older peer: no such method
        except Exception:
            return None  # transient: let the asyncio path surface it
        if not path or not os.path.exists(path):
            self._graft_no.add(addr)
            return None
        from ray_tpu_torch.core._native import graftrpc
        try:
            conn = self._graft.connect(path)
        except graftrpc.GraftError:
            self._graft_no.add(addr)
            return None
        ch = graftrpc.GraftChannel(self._graft, conn)
        self._graft_channels[addr] = ch
        self._graft_chan_by_conn[conn] = ch
        return ch

    async def _serve_graft_call(self, conn: int, chan: int, seq: int,
                                payload: bytes) -> None:
        """Executor side of one OP_CALL frame. Failures that escape the
        per-task reply shape (codec drift, unknown intern id) come back
        as a whole-batch FLAG_ERR — the caller fails the batch hard
        rather than retrying what may have half-executed. ``chan`` is
        the caller's graftscope trace tag: echoing it on the REPLY lets
        the caller's flight recorder pair the two frames into a wire
        span (graftscope.SpanAssembler)."""
        from ray_tpu_torch.core._native import graftrpc
        try:
            specs = graftrpc.decode_call(
                payload, self._graft_interns.get(conn, {}))
            replies = await self._serve_specs(specs)
            out = graftrpc.encode_replies(replies)
            flags = 0
        except BaseException as e:  # noqa: BLE001 — crosses the wire
            try:
                out = pickle.dumps(repr(e), protocol=5)
            except Exception:
                out = pickle.dumps("<unrepresentable dispatch error>",
                                   protocol=5)
            flags = graftrpc.FLAG_ERR
        if self._graft is not None:
            self._graft.send(conn, graftrpc.OP_REPLY, seq, out, flags=flags,
                             chan=chan)

    # Max actor tasks coalesced into one push_task_batch RPC. Batching
    # amortizes the per-RPC cost (framing, dedup, task spawn, reply hop)
    # across a burst of submissions to the same actor — the reference's
    # submit path pipelines through gRPC streams for the same reason
    # (normal_task_submitter.cc backlog pipelining).
    _ACTOR_PUSH_BATCH = 64

    async def _submit_actor_with_retries(self, spec: TaskSpec) -> None:
        """Join the per-actor push batch; the flusher coalesces every
        submission buffered while the previous RPC was in flight.
        (Streaming tasks still ride this awaited path; plain actor calls
        enqueue directly from submit_actor_task with no future.)"""
        fut = asyncio.get_running_loop().create_future()
        self._actor_push_buf.setdefault(spec.actor_id, []).append((spec, fut))
        self._poke_dispatch(spec.actor_id)
        await fut

    def _spec_settled(self, spec: TaskSpec, fut) -> bool:
        """Whether a buffered submission already completed/failed. The
        taskless hot path (fut=None) is settled exactly when its arg-ref
        entry is gone — _release_arg_refs pops it on every settle path."""
        if fut is not None:
            return fut.done()
        return spec.task_id not in self._task_arg_refs

    def _settle_spec_error(self, spec: TaskSpec, fut,
                           err: Exception) -> None:
        """Fail a buffered/batched actor submission. With a future, the
        awaiting _submit_actor_and_track wrapper does the bookkeeping;
        without one (direct hot path) the return refs are marked here."""
        if fut is not None:
            if not fut.done():
                fut.set_exception(err)
            return
        if spec.task_id not in self._task_arg_refs:
            return  # already settled
        self._record_task_event(spec.task_id, spec.name, "FAILED",
                                spec.trace_id, spec.parent_span,
                                attempt=spec.retry_count,
                                err=repr(err)[:256], actor=spec.actor_id)
        for i in range(spec.num_returns):
            oid = ObjectID.for_task_return(TaskID(spec.task_id), i)
            self._mark_error(oid.binary(), err)
        self._release_arg_refs(spec)

    # In-flight batch RPCs per actor. Multiple must be allowed: an async
    # actor method may PARK awaiting a later call (signal patterns) — a
    # single-in-flight flusher would deadlock it. Seqno ordering across
    # concurrent batches is preserved by assignment order here plus the
    # worker's per-caller ordering gate.
    _ACTOR_PUSH_INFLIGHT = 32

    async def _flush_actor_pushes(self, actor_id: bytes) -> None:
        buf = self._actor_push_buf.setdefault(actor_id, [])
        sem = self._actor_push_sem.get(actor_id)
        if sem is None:
            sem = self._actor_push_sem[actor_id] = asyncio.Semaphore(
                self._ACTOR_PUSH_INFLIGHT)
        try:
            while buf:
                # Slow methods don't coalesce: a batch reply lands only
                # after every member executed, so batching multi-ms tasks
                # would delay early results for no dispatch win.
                cap = self._ACTOR_PUSH_BATCH
                if self._actor_task_ms.get(actor_id, 0.0) > 10.0:
                    cap = 1
                # Tasks with OBJECT-REF args always ship alone: a
                # coalesced dependent whose upstream's reply rides the
                # same RPC could never resolve its argument (the owner
                # marks the upstream ready only when the batch returns).
                # Refs nested inside containers count too — the wire arg
                # is kind 'v' but _task_arg_refs (which includes
                # contained refs) still holds them.
                # And one retry budget per batch: never coalesce tasks
                # with different max_retries.
                def _has_refs(spec):
                    return (_spec_has_ref_args(spec)
                            or bool(self._task_arg_refs.get(spec.task_id)))
                n = 1
                if not _has_refs(buf[0][0]):
                    while (n < cap and n < len(buf)
                           and not _has_refs(buf[n][0])
                           and buf[n][0].max_retries
                           == buf[0][0].max_retries
                           # Same method only: a fast probe must never
                           # wait on a batch of slow calls (async actors
                           # reply per batch, not per member).
                           and buf[n][0].method_name
                           == buf[0][0].method_name):
                        n += 1
                batch = buf[:n]
                del buf[:n]
                await sem.acquire()
                try:
                    # Prepare IN flusher order (seqnos must follow the
                    # submission order even with concurrent sends).
                    prepared = await self._prepare_actor_batch(actor_id,
                                                               batch)
                except BaseException as e:
                    sem.release()
                    err = e if isinstance(e, Exception) \
                        else WorkerCrashedError(repr(e))
                    for spec, fut in batch:
                        self._settle_spec_error(spec, fut, err)
                    continue
                if prepared is None:
                    sem.release()
                    continue
                # lint: allow(rpc-in-loop: this loop IS the coalescer — one batched push per drained batch, inflight-bounded by the semaphore)
                task = spawn(self._send_actor_batch(actor_id, *prepared))
                task.add_done_callback(lambda _t, _s=sem: _s.release())
        finally:
            self._actor_flushing.discard(actor_id)
            # Submissions land from user threads: one may have appended
            # after this loop's empty check while the flushing flag was
            # still set (its poke found us "running"). Re-poke so it is
            # never stranded.
            if buf:
                self._poke_dispatch(actor_id)

    async def _prepare_actor_batch(self, actor_id: bytes, batch: list):
        """Resolve the client + assign seqnos, in order. Returns
        (client, live) or None if nothing left. Wire encoding is
        deferred to the send (the graft path never pickles full specs)."""
        from ray_tpu_torch.core.common import TaskCancelledError
        live = []
        for spec, fut in batch:
            if self._spec_settled(spec, fut):
                continue
            if spec.task_id in self._cancelled:
                self._settle_spec_error(spec, fut, TaskCancelledError(
                    f"task {spec.name} cancelled"))
            else:
                live.append((spec, fut))
        if not live:
            return None
        client = await self._actor_client(actor_id)
        for spec, _ in live:
            spec.seqno = self._actor_seq_out.get(actor_id, 0)
            self._actor_seq_out[actor_id] = spec.seqno + 1
            self._task_exec_addr[spec.task_id] = tuple(client._address)
        return client, live

    async def _push_batch_transport(self, actor_id: bytes, client,
                                    live: list) -> list:
        """One push attempt: the graftrpc dispatch plane when available,
        the asyncio control-plane RPC otherwise. A GraftSendError means
        the frame never hit the wire, so falling back WITHIN the attempt
        cannot double-execute; any post-send loss surfaces as
        RpcConnectionLost and rides the caller's retry loop (which
        refreshes the client and assigns fresh seqnos)."""
        specs = [spec for spec, _ in live]
        chan = await self._graft_channel_for(client)
        if chan is not None:
            from ray_tpu_torch.core._native.graftrpc import GraftSendError
            # Lease a graftscope trace tag so the recorder's SEND/RECV
            # records for this batch stitch into dispatch + wire spans
            # under the submitting task (the tag rides the frame
            # header's spare chan field; the executor echoes it).
            tag = 0
            asm = self._scope_asm()
            if asm is not None:
                s0 = specs[0]
                parent = s0.parent_span or s0.task_id
                tag = asm.lease_tag(
                    s0.trace_id.hex() if s0.trace_id else "",
                    parent.hex() if parent else "",
                    s0.name, len(specs))
            try:
                return await chan.call_batch(specs, chan=tag)
            except GraftSendError:
                pass
        blobs = [pickle.dumps(spec, protocol=5) for spec in specs]
        return await client.call("push_task_batch", blobs)

    async def _send_actor_batch(self, actor_id: bytes, client,
                                live: list) -> None:
        from ray_tpu_torch.core.common import ActorDiedError, TaskCancelledError
        attempts = live[0][0].max_retries + 1
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            if attempt > 0:
                # Cancellation can land while the actor is unreachable:
                # drop cancelled members before re-pushing.
                still = []
                for spec, fut in live:
                    if self._spec_settled(spec, fut):
                        continue
                    if spec.task_id in self._cancelled:
                        self._settle_spec_error(spec, fut, TaskCancelledError(
                            f"task {spec.name} cancelled"))
                    else:
                        still.append((spec, fut))
                live = still
                if not live:
                    return
                try:
                    client = await self._actor_client(actor_id,
                                                      refresh=True)
                except BaseException as e:
                    last = e if isinstance(e, Exception) else \
                        WorkerCrashedError(repr(e))
                    break
                for spec, _ in live:
                    spec.seqno = self._actor_seq_out.get(actor_id, 0)
                    self._actor_seq_out[actor_id] = spec.seqno + 1
                    self._task_exec_addr[spec.task_id] = \
                        tuple(client._address)
            t0 = time.monotonic()
            try:
                try:
                    # lint: allow(rpc-in-loop: retry loop — one batched push per attempt, not per item)
                    replies = await self._push_batch_transport(
                        actor_id, client, live)
                finally:
                    for spec, _ in live:
                        self._task_exec_addr.pop(spec.task_id, None)
                # EMA of per-task wall time steers the coalescing cap.
                per_task_ms = (time.monotonic() - t0) * 1000 / len(live)
                prev = self._actor_task_ms.get(actor_id, per_task_ms)
                self._actor_task_ms[actor_id] = \
                    0.7 * prev + 0.3 * per_task_ms
                for (spec, fut), reply in zip(live, replies):
                    self._process_task_reply(spec, reply, client)
                    self._release_arg_refs(spec)
                    if fut is not None and not fut.done():
                        fut.set_result(None)
                return
            except (RpcConnectionLost, ConnectionError, OSError) as e:
                last = e
                # Invalidate the cached client so the next submit (this retry
                # or a future task) re-resolves the actor's current address.
                self._actor_clients.pop(actor_id, None)
                await asyncio.sleep(GlobalConfig.task_retry_delay_ms / 1000)
            except BaseException as e:
                last = e if isinstance(e, Exception) else \
                    WorkerCrashedError(repr(e))
                break
        err = last if isinstance(last, Exception) and not isinstance(
            last, (RpcConnectionLost, ConnectionError, OSError)) else \
            ActorDiedError(
                f"actor task batch ({len(live)} tasks) failed after "
                f"{attempts} attempts ({last!r})")
        for spec, fut in live:
            self._settle_spec_error(spec, fut, err)

    # ------------------------------------------------------------------
    # task execution (worker side)
    # ------------------------------------------------------------------
    @long_poll
    async def create_actor_local(self, spec_blob: bytes) -> None:
        creation = cloudpickle.loads(spec_blob)
        renv = creation.get("runtime_env")
        if renv:
            # working_dir / py_modules land before the user class exists
            # (env_vars already landed at process spawn).
            from ray_tpu_torch.core.runtime_env import apply_in_worker
            loop0 = asyncio.get_running_loop()
            await loop0.run_in_executor(
                None, apply_in_worker, self, renv)
        cls = cloudpickle.loads(creation["cls_blob"])
        args, kwargs = await self._resolve_args(creation["args"])
        loop = asyncio.get_running_loop()
        instance = await loop.run_in_executor(
            self._exec_pool, lambda: cls(*args, **kwargs))
        self._actor_instance = instance
        self._actor_id = creation["actor_id"]
        self._is_actor_worker = True
        # ASYNC ACTOR (reference: _raylet.pyx async actors + fiber.h):
        # any coroutine method makes the actor async — its async methods
        # run CONCURRENTLY on the io loop (unordered, capped by
        # max_concurrency), sync methods still serialize in the exec pool.
        # Detection scans the CLASS statically: instance getattr would
        # trigger property getters, and __call__-only async actors count.
        import inspect

        def _is_coro_attr(name: str) -> bool:
            f = inspect.getattr_static(cls, name, None)
            if isinstance(f, (staticmethod, classmethod)):
                f = f.__func__
            return inspect.iscoroutinefunction(f)

        self._actor_is_async = any(
            _is_coro_attr(m) for m in dir(cls)
            if not m.startswith("__") or m == "__call__")
        self._actor_sem = asyncio.Semaphore(
            int(creation.get("max_concurrency") or 1000))

    async def cancel_task(self, task_id: bytes, force: bool = False) -> bool:
        """Cancel an incoming/running task on THIS worker (reference:
        core_worker.cc HandleCancelTask). Non-force interrupts pure-Python
        user code by raising TaskCancelledError in the exec thread; force
        kills the worker process."""
        if force:
            os._exit(1)
        self._exec_cancelled.add(task_id)
        tid = self._exec_threads.get(task_id)
        if tid is not None:
            import ctypes
            from ray_tpu_torch.core.common import TaskCancelledError
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(tid),
                ctypes.py_object(TaskCancelledError))
            return True  # interrupted the running task's own thread
        return False  # queued/unknown: the exec-entry flag check handles it

    @long_poll
    async def push_task_batch(self, blobs: list) -> list:
        """Coalesced actor pushes: ordering still rides each task's seqno
        (gather keeps async-actor concurrency; sync actors serialize in
        the exec pool regardless). Consecutive PLAIN sync tasks (actor
        method, no kwargs-side refs pending, not streaming, in seqno
        order, no builtin dispatch) additionally execute in ONE exec-pool
        hop — two thread switches per batch instead of per task."""
        return await self._serve_specs([pickle.loads(b) for b in blobs])

    async def _serve_specs(self, specs: list) -> list:
        """Shared executor entry for both transports: the asyncio
        push_task_batch RPC and graftrpc OP_CALL frames."""
        if (self._is_actor_worker
                and not getattr(self, "_actor_is_async", False)
                and self._batch_fast_eligible(specs)):
            return await self._push_batch_fast(specs)
        return list(await asyncio.gather(
            *[self._push_task_spec(s) for s in specs]))

    def _batch_fast_eligible(self, specs: list) -> bool:
        caller = specs[0].caller_id
        seq = specs[0].seqno
        for s in specs:
            if (not s.is_actor_task or s.streaming
                    or s.method_name.startswith("__rt_dag")
                    or s.caller_id != caller or s.seqno != seq
                    or s.num_returns != 1):
                return False
            seq += 1
        return True

    def _error_reply(self, err: BaseException, tb: str = "") -> dict:
        from ray_tpu_torch.core.common import TaskCancelledError
        if not isinstance(err, TaskCancelledError):
            err = TaskError(repr(err), tb)
        sv = serialization.serialize_error(err)
        return {"error": sv.to_bytes(), "error_meta": sv.meta()}

    async def _serialize_return(self, task_id: bytes, index: int,
                                value: Any) -> tuple:
        """One return value -> wire tuple (shared by _execute and the
        batch fast path: inline-vs-stored choice + forwarded-ref holds
        must never diverge between the two)."""
        sv = serialization.serialize(value)
        ref_descs = _ref_descs(sv)
        await self._hold_reply_refs(task_id, sv.contained_refs)
        if sv.total_size <= GlobalConfig.max_direct_call_object_size:
            return ("inline", sv.to_bytes(), sv.meta(), ref_descs)
        oid = ObjectID.for_task_return(TaskID(task_id), index)
        await self._store_put(oid.binary(), sv)
        return ("stored", self.node_id, self.agent_addr, sv.total_size,
                ref_descs)

    async def _push_batch_fast(self, specs: list) -> list:
        import inspect as _inspect

        first = specs[0]
        if self._trail_on():
            node = self.node_id.hex()[:12] if self.node_id else ""
            wkr = self.worker_id.hex()[:8]
            for s in specs:
                self._record_task_event(
                    s.task_id, s.name, "RUNNING",
                    attempt=s.retry_count, node=node, worker=wkr,
                    actor=s.actor_id)
        # Per-caller ordering gate, once for the whole contiguous run.
        if first.seqno != self._actor_seqno.get(first.caller_id, 0):
            ev = asyncio.Event()
            self._actor_waiters.setdefault(
                first.caller_id, {})[first.seqno] = ev
            await ev.wait()
        try:
            resolved = []   # ("ok", spec, method, args, kwargs) |
            #                 ("err", spec, exception, traceback)
            fallback = False
            for s in specs:
                try:
                    args, kwargs = await self._resolve_args(s.args)
                    method = getattr(self._actor_instance, s.method_name)
                except BaseException as e:
                    # Per-task isolation: a lost arg or bad method name
                    # fails ITS task, not the 63 coalesced neighbors.
                    resolved.append(("err", s, e, traceback.format_exc()))
                    continue
                if _inspect.iscoroutinefunction(method):
                    fallback = True  # mixed sync/async class
                    break
                resolved.append(("ok", s, method, args, kwargs))
            if fallback:
                # Per-task path (gate already passed for the first seqno;
                # push_task re-checks and proceeds).
                return list(await asyncio.gather(
                    *[self._push_task_spec(s) for s in specs]))

            def run_all():
                from ray_tpu_torch.core.common import TaskCancelledError
                out = []
                tid = threading.get_ident()
                for item in resolved:
                    if item[0] == "err":
                        out.append((False, item[2], item[3]))
                        continue
                    _, s, method, args, kwargs = item
                    if s.task_id in self._exec_cancelled:
                        self._exec_cancelled.discard(s.task_id)
                        out.append((False, TaskCancelledError(
                            f"task {s.name} cancelled"), ""))
                        continue
                    # Register for cancel interruption, like _execute.
                    self._exec_threads[s.task_id] = tid
                    try:
                        out.append((True, method(*args, **kwargs), ""))
                    except BaseException as e:  # per-task error reply
                        out.append((False, e, traceback.format_exc()))
                    finally:
                        self._exec_threads.pop(s.task_id, None)
                return out

            results = await asyncio.get_running_loop().run_in_executor(
                self._exec_pool, run_all)
            replies = []
            for item, (ok, value, tb) in zip(resolved, results):
                s = item[1]
                self._exec_cancelled.discard(s.task_id)
                if not ok:
                    replies.append(self._error_reply(value, tb))
                    continue
                ret = await self._serialize_return(s.task_id, 0, value)
                replies.append({"error": None, "returns": [ret]})
            return replies
        finally:
            last = specs[-1]
            self._actor_seqno[first.caller_id] = last.seqno + 1
            waiters = self._actor_waiters.get(first.caller_id)
            if waiters:
                nxt = waiters.pop(last.seqno + 1, None)
                if nxt is not None:
                    nxt.set()

    async def push_task(self, spec_blob: bytes) -> dict:
        return await self._push_task_spec(pickle.loads(spec_blob))

    async def _push_task_spec(self, spec: TaskSpec) -> dict:
        if spec.is_actor_task and getattr(self, "_actor_is_async", False):
            # Async actors execute unordered + concurrently (reference:
            # async actor semantics — ordering is explicitly dropped).
            async with self._actor_sem:
                return await self._execute(spec)
        if spec.is_actor_task:
            # Enforce per-caller seqno ordering (reference:
            # task_execution/actor_scheduling_queue.cc). Each out-of-order
            # push parks on its own event; completion wakes exactly the
            # successor seqno.
            assert self._is_actor_worker, "not an actor worker"
            if spec.seqno != self._actor_seqno.get(spec.caller_id, 0):
                ev = asyncio.Event()
                self._actor_waiters.setdefault(
                    spec.caller_id, {})[spec.seqno] = ev
                await ev.wait()
        try:
            return await self._execute(spec)
        finally:
            if spec.is_actor_task:
                # Advance even if a stale/lower seqno arrived (dedup'd
                # upstream); the successor waiter is keyed exactly.
                self._actor_seqno[spec.caller_id] = spec.seqno + 1
                waiters = self._actor_waiters.get(spec.caller_id)
                if waiters:
                    nxt = waiters.pop(spec.seqno + 1, None)
                    if nxt is not None:
                        nxt.set()

    async def _resolve_args(self, wire_args: list) -> Tuple[list, dict]:
        args: list = []
        kwargs: dict = {}
        for a in wire_args:
            if a[0] == "p":
                kind, rest = a[1], a[2:]
                target = args
                key = None
            else:  # ("k", name, kind, ...)
                key = a[1]
                kind, rest = a[2], a[3:]
                target = None
            if kind == "v":
                val = serialization.deserialize(rest[0], rest[1])
            else:
                ref = ObjectRef(ObjectID(rest[0]), tuple(rest[1]))
                self.on_ref_deserialized(ref)
                # Task-arg prefetch: lowest pull priority (reference:
                # pull_manager.cc get > wait > task args).
                val = await self.get_async(ref, _priority=2)
            if key is None:
                args.append(val)
            else:
                kwargs[key] = val
        return args, kwargs

    async def _execute(self, spec: TaskSpec) -> dict:
        loop = asyncio.get_running_loop()
        if self._trail_on():
            # Executor-side transition: the owner can't see RUNNING (it
            # only sees the push RPC settle), so the executing worker
            # reports it — node + worker provenance come from here.
            self._record_task_event(
                spec.task_id, spec.name, "RUNNING",
                attempt=spec.retry_count,
                node=self.node_id.hex()[:12] if self.node_id else "",
                worker=self.worker_id.hex()[:8], actor=spec.actor_id)
        try:
            if spec.task_id in self._exec_cancelled:
                self._exec_cancelled.discard(spec.task_id)
                from ray_tpu_torch.core.common import TaskCancelledError
                raise TaskCancelledError(f"task {spec.name} cancelled")
            args, kwargs = await self._resolve_args(spec.args)
            async_method = None
            if spec.is_actor_task:
                # Compiled-DAG builtins (reference: compiled graphs run
                # inside a dedicated actor executable loop; ours installs
                # two worker-provided methods instead).
                if spec.method_name == "__rt_dag_call__":
                    method = self._builtin_dag_call
                elif spec.method_name == "__rt_dag_allreduce__":
                    method = self._builtin_dag_allreduce
                else:
                    method = getattr(self._actor_instance,
                                     spec.method_name)
                import inspect as _inspect
                if _inspect.iscoroutinefunction(method):
                    async_method = method
                user_fn = lambda: method(*args, **kwargs)  # noqa: E731
            else:
                func = await self._load_function(
                    spec.func_id, retry=spec.fn_async_export)
                user_fn = lambda: func(*args, **kwargs)  # noqa: E731

            # The task->thread registration is made by the EXEC THREAD itself: with
            # pipelined dispatch several _execute coroutines are alive at
            # once and a coroutine-side marker would track the wrong task
            # (cancel would then interrupt an unrelated task). The cancel
            # flag is re-checked here too — a cancel can land while the
            # task is parked in the exec pool behind another task.
            def fn():
                from ray_tpu_torch.core._native import graftprof
                self._exec_threads[spec.task_id] = threading.get_ident()
                _trace_local.ctx = (spec.trace_id or spec.task_id,
                                    spec.task_id)
                # Profiler attribution: register this exec thread for
                # native CPU sampling (idempotent) and tag its wall
                # stacks with the running task until the finally.
                graftprof.register_current_thread("py-exec")
                graftprof.set_task_context(
                    spec.task_id.hex(),
                    spec.actor_id.hex()[:12] if spec.actor_id else "",
                    spec.name)
                try:
                    if spec.task_id in self._exec_cancelled:
                        from ray_tpu_torch.core.common import TaskCancelledError
                        raise TaskCancelledError(
                            f"task {spec.name} cancelled")
                    return user_fn()
                finally:
                    graftprof.clear_task_context()
                    _trace_local.ctx = None
                    self._exec_threads.pop(spec.task_id, None)
                    from ray_tpu_torch.core._native import graftlog
                    graftlog.flush_stdio_tee()

            if spec.streaming:
                return await self._execute_streaming(spec, user_fn)
            if async_method is not None:
                # Async actor method: runs on the io loop, concurrent with
                # other async methods (no exec-pool hop, no ordering).
                # Profiler attribution tags the LOOP thread: concurrent
                # async methods time-share it, so their samples split by
                # whichever was registered last — exact for the common
                # one-method-at-a-time actor, approximate under overlap.
                from ray_tpu_torch.core._native import graftprof
                tok = _trace_ctxvar.set(
                    (spec.trace_id or spec.task_id, spec.task_id))
                graftprof.set_task_context(
                    spec.task_id.hex(),
                    spec.actor_id.hex()[:12] if spec.actor_id else "",
                    spec.name)
                try:
                    result = await async_method(*args, **kwargs)
                finally:
                    graftprof.clear_task_context()
                    _trace_ctxvar.reset(tok)
                    from ray_tpu_torch.core._native import graftlog
                    graftlog.flush_stdio_tee()
            else:
                result = await loop.run_in_executor(self._exec_pool, fn)
        except BaseException as e:  # user error -> error payload to owner
            from ray_tpu_torch.core.common import TaskCancelledError
            tb = traceback.format_exc()
            if isinstance(e, TaskCancelledError):
                err: BaseException = e  # surfaces as-is at ray.get
            else:
                err = TaskError(repr(e), tb)
            sv = serialization.serialize_error(err)
            return {"error": sv.to_bytes(), "error_meta": sv.meta()}
        finally:
            self._exec_cancelled.discard(spec.task_id)

        results = (result,) if spec.num_returns == 1 else tuple(result)
        returns = [await self._serialize_return(spec.task_id, i, value)
                   for i, value in enumerate(results)]
        return {"error": None, "returns": returns}

    async def _hold_reply_refs(self, key, contained_refs) -> None:
        """ObjectRefs FORWARDED inside a task result race their own
        lifetime: once serialized, the worker's last Python reference can
        die (freeing a self-owned object) before the receiver's borrow
        registration lands. Take a proxy borrow held until the receiver
        ACKNOWLEDGES that its own borrow landed (ack_reply_refs), with a
        long fallback timer only for receiver death (reference:
        reference_count.cc tracks borrowers through nested task returns
        explicitly)."""
        refs = list(contained_refs)
        if not refs:
            return
        for r in refs:
            if self._is_self_owned(r):
                await self.add_borrow(r.binary())
            else:
                await self._notify_add_borrow(tuple(r.owner_addr),
                                              r.binary())
        fresh = key not in self._reply_holds
        self._reply_holds.setdefault(key, []).extend(refs)
        if fresh:
            # Fallback only: a live receiver acks well before this (which
            # cancels the timer); a dead receiver's borrows are moot, so
            # release ours eventually.
            async def _drop_after_grace():
                await asyncio.sleep(GlobalConfig.reply_ref_grace_s)
                self._reply_hold_timers.pop(key, None)
                await self.ack_reply_refs(key)

            self._reply_hold_timers[key] = spawn(_drop_after_grace())

    async def ack_reply_refs(self, key) -> None:
        """Receiver confirms its borrow on forwarded reply refs landed:
        drop the proxy borrows taken in _hold_reply_refs. Idempotent."""
        if isinstance(key, list):  # over-the-wire tuples arrive as lists
            key = tuple(key)
        timer = self._reply_hold_timers.pop(key, None)
        if timer is not None:
            timer.cancel()
        for r in self._reply_holds.pop(key, ()):
            await self._release_borrow(r)

    async def _release_borrow(self, r: ObjectRef) -> None:
        """Drop one borrow on a ref, local or via its remote owner."""
        try:
            if self._is_self_owned(r):
                await self.remove_borrow(r.binary())
            else:
                await self._notify_remove_borrow(tuple(r.owner_addr),
                                                 r.binary())
        except Exception:
            pass

    async def _execute_streaming(self, spec: TaskSpec, fn) -> dict:
        """Run a generator task: the exec thread pulls items from the user
        generator and emits each to the owner as its own return object,
        with a small send window; the owner's report handler parks its
        reply for consumer backpressure (reference:
        task_manager.cc HandleReportGeneratorItemReturns +
        generator_waiter.cc)."""
        from ray_tpu_torch.core.common import TaskCancelledError
        loop = asyncio.get_running_loop()
        owner = self._client_for_worker(tuple(spec.owner_addr))

        def run_gen() -> int:
            from collections import deque
            from ray_tpu_torch.core._native import graftprof
            self._exec_threads[spec.task_id] = threading.get_ident()
            _trace_local.ctx = (spec.trace_id or spec.task_id,
                                spec.task_id)
            graftprof.register_current_thread("py-exec")
            graftprof.set_task_context(
                spec.task_id.hex(),
                spec.actor_id.hex()[:12] if spec.actor_id else "",
                spec.name)
            try:
                if spec.task_id in self._exec_cancelled:
                    raise TaskCancelledError(f"task {spec.name} cancelled")
                gen = fn()
                if not hasattr(gen, "__iter__"):
                    raise TypeError(
                        f"streaming task {spec.name} must return an "
                        f"iterable, got {type(gen).__name__}")
                pending = deque()
                count = 0
                consumer_gone = False
                for item in gen:
                    sv = serialization.serialize(item)
                    pending.append(asyncio.run_coroutine_threadsafe(
                        self._emit_stream_item(owner, spec, count, sv), loop))
                    count += 1
                    while len(pending) >= 4:  # send window
                        if not pending.popleft().result():
                            consumer_gone = True
                            break
                    if consumer_gone:
                        break
                    if spec.task_id in self._exec_cancelled:
                        raise TaskCancelledError(
                            f"task {spec.name} cancelled")
                close = getattr(gen, "close", None)
                if close is not None:
                    close()
                while pending:
                    pending.popleft().result()
                return count
            finally:
                graftprof.clear_task_context()
                _trace_local.ctx = None
                self._exec_threads.pop(spec.task_id, None)
                from ray_tpu_torch.core._native import graftlog
                graftlog.flush_stdio_tee()

        try:
            # Async actors stream CONCURRENTLY (default thread pool): a
            # long-running generator must not head-of-line-block the
            # single ordered exec thread — two clients streaming from one
            # replica each get their own producer thread. Sync actors
            # keep the ordered exec pool.
            pool = None if getattr(self, "_actor_is_async", False) \
                else self._exec_pool
            total = await loop.run_in_executor(pool, run_gen)
        except BaseException as e:
            tb = traceback.format_exc()
            err = e if isinstance(e, TaskCancelledError) else \
                TaskError(repr(e), tb)
            sv = serialization.serialize_error(err)
            return {"error": sv.to_bytes(), "error_meta": sv.meta()}
        finally:
            self._exec_cancelled.discard(spec.task_id)
        return {"error": None, "streamed_total": total}

    async def _emit_stream_item(self, owner: RpcClient, spec: TaskSpec,
                                index: int, sv) -> bool:
        """Report one yielded item to the owner; False = consumer gone."""
        hold_key = (spec.task_id, index)
        ref_descs = _ref_descs(sv)
        await self._hold_reply_refs(hold_key, sv.contained_refs)
        try:
            if sv.total_size <= GlobalConfig.max_direct_call_object_size:
                reply = await owner.call(
                    "report_streamed_return", spec.task_id, index, "inline",
                    sv.to_bytes(), sv.meta(), None, None, 0, ref_descs)
            else:
                oid = ObjectID.for_task_return(TaskID(spec.task_id), index)
                await self._store_put(oid.binary(), sv)
                reply = await owner.call(
                    "report_streamed_return", spec.task_id, index, "stored",
                    None, None, self.node_id, self.agent_addr,
                    sv.total_size, ref_descs)
        finally:
            # The owner registers its borrows inside the report handler,
            # before replying — so the RPC returning (or failing: a dead
            # owner's borrows are moot) confirms the handoff.
            await self.ack_reply_refs(hold_key)
        return bool(reply.get("accepted"))

    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        try:
            self._exec_pool.shutdown(wait=False)
        except Exception:
            pass

        # Drop the recycled staging inode (its pages die with us; live
        # objects hold their own hex link).
        self._scratch_close()

        async def _close_graft():
            # Loop-affine close (sends happen only on this loop, so the
            # reactor stop can never race one).
            ep, self._graft = self._graft, None
            if ep is not None:
                ep.close()

        if self._graft is not None:
            try:
                self._run(_close_graft()).result(timeout=2.0)
            except Exception:
                pass
            try:
                if self._graft_path:
                    os.unlink(self._graft_path)
            except OSError:
                pass

        async def _cancel_all():
            for t in asyncio.all_tasks():
                if t is not asyncio.current_task():
                    t.cancel()

        try:
            self._run(_cancel_all()).result(timeout=1.0)
        except Exception:
            pass
        try:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._io_thread.join(timeout=2.0)
        except Exception:
            pass
