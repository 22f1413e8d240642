"""Node agent — the per-node runtime daemon (raylet equivalent).

Analogue of the reference's raylet (reference: src/ray/raylet/node_manager.cc
lease service + src/ray/raylet/worker_pool.cc + scheduling/cluster_lease_manager.cc
spillback + placement_group_resource_manager.cc bundles), with the plasma store
hosted in-process (reference: src/ray/object_manager/plasma/store_runner.cc)
and node-to-node chunked object transfer (reference:
src/ray/object_manager/object_manager.cc Push/Pull).

Responsibilities:
  * register + heartbeat with the controller (resource gossip)
  * worker pool: spawn/reuse python worker processes; dedicated actor workers
  * lease-based task scheduling: grant locally when resources fit, else
    spillback via the controller's hybrid policy to another agent
  * placement-group bundle prepare/commit/return (2-phase commit participant)
  * shared-memory object store host: create/seal/get control plane for local
    workers (data plane is direct mmap), seal-waiters, location registration
    with object owners, pull-from-remote chunked transfer
  * child worker monitoring: actor death reporting, lease cleanup
"""

from __future__ import annotations

import asyncio
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.common import (Address, labels_match, resources_add,
                                       resources_fit, resources_sub)
from ray_tpu_torch.core.ids import NodeID, ObjectID
from ray_tpu_torch.core.object_store import LocalObjectStore
from ray_tpu_torch.core.pubsub import Subscription
from ray_tpu_torch.core.rpc import RpcClient, RpcServer, long_poll
from ray_tpu_torch.utils import get_logger
from ray_tpu_torch.utils.aio import spawn
from ray_tpu_torch.utils.config import GlobalConfig

logger = get_logger("node_agent")


def _pread_file(path: str, offset: int, length: int) -> bytes:
    """Executor-side chunk read: data-plane copies stay off the io loop."""
    with open(path, "rb") as f:
        f.seek(offset)
        return f.read(length)


def _pwrite_file(path: str, data: bytes, offset: int) -> None:
    """Executor-side chunk write (open-per-chunk is a tmpfs metadata op;
    the multi-MB pwrite is the cost being moved off the loop)."""
    fd = os.open(path, os.O_RDWR)
    try:
        os.pwrite(fd, data, offset)
    finally:
        os.close(fd)


class _ExternalProc:
    """Process we did not spawn (the driver); liveness via kill(pid, 0)."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        try:
            os.kill(self.pid, 0)
            return None
        except OSError:
            self.returncode = -1
            return -1

    def terminate(self) -> None:
        pass  # never kill processes we don't own


class PullScheduler:
    """Priority-admitted, bounded-concurrency transfer slots (reference:
    src/ray/object_manager/pull_manager.cc — get > wait > task-arg
    priorities, bandwidth-bounded active pulls, and a get request
    RE-prioritizes an already-queued pull). Priorities: 0 = ray.get,
    1 = ray.wait, 2 = task-arg prefetch."""

    def __init__(self, max_concurrent: int):
        self.max_concurrent = max_concurrent
        self._active = 0
        self._seq = 0
        self._waiters: list = []  # heap of (priority, seq, token)

    async def acquire(self, priority: int,
                      token: Optional[dict] = None) -> dict:
        """Returns the slot token (pass to promote/release). A caller
        may pre-create the token to share it (dedup promotion) before
        awaiting admission."""
        import heapq
        if token is None:
            token = {"ev": asyncio.Event(), "granted": False}
        if self._active < self.max_concurrent:
            self._active += 1
            token["granted"] = True
            return token
        self._seq += 1
        heapq.heappush(self._waiters, (priority, self._seq, token))
        await token["ev"].wait()
        return token

    def promote(self, token: dict, priority: int) -> None:
        """Move a queued token to a better priority (a ray.get landing on
        an in-flight prefetch must not inherit its queue position)."""
        import heapq
        if token.get("granted"):
            return
        self._seq += 1
        # The old heap entry stays as a stale duplicate; release() skips
        # already-granted tokens, so only the first pop wins.
        heapq.heappush(self._waiters, (priority, self._seq, token))

    def release(self) -> None:
        import heapq
        while self._waiters:
            _, _, token = heapq.heappop(self._waiters)
            if token.get("granted"):
                continue  # stale duplicate from promote()
            token["granted"] = True
            token["ev"].set()  # slot hand-off
            return
        self._active -= 1


class WorkerProc:
    def __init__(self, proc: subprocess.Popen, worker_id: bytes):
        self.proc = proc
        self.worker_id = worker_id
        self.addr: Optional[Address] = None
        self.client: Optional[RpcClient] = None
        self.ready = asyncio.Event()
        self.dedicated_actor: Optional[bytes] = None
        self.current_lease: Optional[bytes] = None
        self.idle_since: float = 0.0
        self.spawned_at: float = time.monotonic()
        self.max_restarts: int = 0  # for dedicated actor workers
        self.cgroup_scope = None    # WorkerCgroup for isolated workers
        self.python_exe: Optional[str] = None  # venv python (GC marker)


class NodeAgent:
    def __init__(self, controller_addr: Address, resources: Dict[str, float],
                 session_dir: str, labels: Optional[Dict[str, str]] = None,
                 host: str = "127.0.0.1"):
        self.node_id = NodeID.random()
        self.controller_addr = controller_addr
        self.controller = RpcClient(controller_addr)
        self.host = host
        self.resources_total = dict(resources)
        self._venv_locks: Dict[str, asyncio.Lock] = {}
        self.labels = dict(labels or {})
        # GPU accelerator manager: advertise whole GPUs as a first-class
        # resource + the accelerator-type label (reference:
        # accelerators/nvidia_gpu.py). Discovery touches no CUDA context.
        from ray_tpu_torch import accelerators
        self.gpu_free_ids: List[int] = []
        self.gpu_assigned: Dict[bytes, List[int]] = {}  # actor_id -> GPUs
        # actor_id -> (resources, pg, bundle_index) for release on death
        self.actor_allocations: Dict[bytes, tuple] = {}
        if "GPU" not in self.resources_total:
            gpus = accelerators.visible_gpu_ids()
            # Advertised even at 0: num_gpus=1 then parks as pending.
            self.resources_total["GPU"] = float(len(gpus))
            self.gpu_free_ids = list(gpus)
        else:
            self.gpu_free_ids = list(range(int(
                self.resources_total["GPU"])))
        for k, v in accelerators.node_labels().items():
            self.labels.setdefault(k, v)
        self.resources_available = dict(self.resources_total)
        self.session_dir = session_dir
        self.port: Optional[int] = None

        store_dir = os.path.join("/dev/shm", "ray_tpu_torch",
                                 os.path.basename(session_dir),
                                 self.node_id.hex()[:12])
        os.makedirs(os.path.dirname(store_dir), exist_ok=True)
        self.store = LocalObjectStore(
            store_dir, GlobalConfig.object_store_memory_bytes)
        self._seal_waiters: Dict[bytes, asyncio.Event] = {}
        self._pulls: Dict[bytes, tuple] = {}  # oid -> (future, slot token)
        self._pull_sched = PullScheduler(
            GlobalConfig.max_concurrent_object_pulls)
        self._push_rx: Dict[bytes, str] = {}  # in-flight inbound pushes
        # Primary-copy ledger + spill state (reference:
        # src/ray/raylet/local_object_manager.cc pins primaries and spills
        # them to disk under memory pressure; restore on demand). Insertion
        # order doubles as spill priority (oldest first).
        self._primary: Dict[bytes, int] = {}         # oid -> total size
        self._spilled: Dict[bytes, tuple] = {}       # oid -> (path, ds, ms)
        self._spill_dir = (GlobalConfig.object_spill_dir
                           or os.path.join(session_dir, "spill",
                                           self.node_id.hex()[:12]))
        self._spill_lock = asyncio.Lock()
        self._restores: Dict[bytes, asyncio.Future] = {}
        self.num_spilled = 0
        self.bytes_spilled = 0
        self.num_restored = 0

        self.workers: Dict[bytes, WorkerProc] = {}       # by worker_id
        self.idle_workers: List[WorkerProc] = []
        # graftpulse: latest cumulative scope blocks forwarded by each
        # worker (rpc/copy/shm kinds only tick in worker processes)
        self._worker_scope: Dict[bytes, Tuple[dict, dict]] = {}
        self._pending_registration: Dict[int, WorkerProc] = {}  # by pid
        # lease_id -> (worker, resources, pg_id|None, bundle_index)
        self.leases: Dict[bytes, tuple] = {}
        self._lease_seq = 0
        # pg_id -> bundle_index -> resources (prepared or committed)
        self.bundles: Dict[bytes, Dict[int, Dict[str, float]]] = {}
        self._bundle_prepared_at: Dict[tuple, float] = {}
        self._worker_seq = 0  # isolated-worker cgroup scope naming
        self.bundle_available: Dict[Tuple[bytes, int], Dict[str, float]] = {}
        self._peer_clients: Dict[Address, RpcClient] = {}
        self._resource_cv = asyncio.Condition()
        self._lease_ticket_seq = 0
        self._lease_waiters: Dict[int, dict] = {}  # FIFO grant order
        # graftsched: coalesced fire-and-forget resource-delta sync to
        # the controller (ray_syncer's shape) — grants/returns between
        # heartbeats mark dirty; one RPC per coalescing window.
        self._sched_sync_scheduled = False
        # graftpulse: worker-shipped sparse scope DELTAS banked between
        # pulse ticks (the workers pre-aggregate; the tick only merges).
        self._pulse_banked: Dict[str, tuple] = {}
        self._pulse_rss = (0, 0)  # (tick stamp, cached summed worker RSS)
        self._pulse_tick = 0
        # grafttrail: node-level batch of task/object transitions. Hosted
        # workers hand their task batches over one local hop
        # (report_trail); the agent adds object provenance from the store
        # journal and its own RPC paths, and a flush tick ships the lot
        # to the controller fire-and-forget (graftpulse's shape).
        self._trail_tasks: List[tuple] = []
        self._trail_objects: List[tuple] = []
        self._trail_cap = 20000
        self._trail_on = False  # set from config in start()
        # graftprof: hosted workers hand their profile deltas over one
        # local hop (report_prof); a flush tick forwards the node batch
        # to the controller fire-and-forget. The rolling window feeds
        # the pulse's on-CPU%/GIL% gauges.
        self._prof_buf: List[dict] = []
        self._prof_window: List[tuple] = []  # (rx_s, wall, oncpu, gil)
        # graftlog: one RingReader cursor per hosted pid (plus our own);
        # the log tick tails the rings and ships coalesced batches to
        # the controller LogStore fire-and-forget. On worker death the
        # ring FILE outlives the process — the salvage path decodes the
        # tail post-mortem and forwards it for the grafttrail join.
        self._log_on = False  # set from config in start()
        self._log_readers: Dict[int, object] = {}
        self._log_buf: List[dict] = []
        self._node_hex = self.node_id.hex()[:12]
        self._shutdown = False

    # ------------------------------------------------------------------
    # startup / heartbeat
    # ------------------------------------------------------------------
    async def start(self, port: int = 0) -> int:
        server = RpcServer("node_agent")
        server.register_object(self)
        self.port = await server.start_tcp(self.host, port)
        # Same-host clients skip the TCP loopback stack: a unix socket
        # shaves ~30% off every store/lease RPC (reference: raylet IPC is
        # a unix socket too, src/ray/ipc/).
        # Native fast-path sidecar: a C server thread in this process
        # serves workers' hot object ops (put-ingest/get/release/delete)
        # straight against the shm store — no event loop on the data
        # path. Lifecycle events flow back through the notify pipe into
        # the asyncio loop so Python keeps the primary ledger and seal
        # waiters authoritative (reference: the plasma store socket,
        # plasma/store_runner.cc).
        self._fastpath = None
        if GlobalConfig.store_fastpath:
            try:
                from ray_tpu_torch.core.object_store import StoreSidecar
                fp_sock = os.path.join(self.session_dir,
                                       f"store-{self.node_id.hex()[:8]}.sock")
                self._fastpath = StoreSidecar(self.store, fp_sock)
                asyncio.get_running_loop().add_reader(
                    self._fastpath.notify_fd, self._drain_fastpath_events)
            except Exception as e:
                logger.warning("store fast path disabled: %r", e)
                self._fastpath = None
        # The sidecar threads above record into this process's
        # graftscope rings; apply the config flag before they get busy.
        from ray_tpu_torch.core._native import graftscope
        graftscope.configure_from_flags()
        self._sock_path = os.path.join(self.session_dir,
                                       f"agent-{self.port}.sock")
        try:
            if os.path.exists(self._sock_path):
                os.unlink(self._sock_path)
            await server.start_unix(self._sock_path)
        except Exception:
            self._sock_path = ""
        self._server = server
        await self.controller.call(
            "register_node", self.node_id.binary(), (self.host, self.port),
            self.resources_total, self.labels)
        spawn(self._heartbeat_loop())
        spawn(self._reap_loop())
        spawn(self._metrics_loop())
        from ray_tpu_torch.core._native import graftpulse
        if graftpulse.enabled():
            spawn(self._pulse_loop())
        from ray_tpu_torch.core._native import grafttrail
        self._trail_on = grafttrail.enabled()
        if self._trail_on:
            spawn(self._trail_loop())
        # graftprof in the agent process: the native sampler covers the
        # sidecar threads (reactor, store conn/accept, copy workers,
        # reaper) that registered at thread birth; worker profile deltas
        # are forwarded by _prof_loop.
        from ray_tpu_torch.core._native import graftprof
        graftprof.configure_from_flags()
        if graftprof.enabled():
            graftprof.start()
            spawn(self._prof_loop())
        # graftlog: the agent writes its own crash-persistent ring and
        # tails every hosted worker's ring on the log tick.
        from ray_tpu_torch.core._native import graftlog
        graftlog.configure_from_flags()
        self._log_on = graftlog.enabled()
        if self._log_on:
            try:
                graftlog.open_ring(self.store.dir)
            except Exception as e:
                logger.debug("graftlog agent ring unavailable: %r", e)
            spawn(self._log_loop())
        if GlobalConfig.memory_monitor_refresh_ms > 0:
            spawn(self._memory_monitor_loop())
        if GlobalConfig.worker_prestart > 0:
            spawn(self._prestart_workers(GlobalConfig.worker_prestart))
        # Cluster membership via controller pubsub (reference: raylets
        # subscribe to GCS node-info channel, not direct RPC pushes).
        self._node_sub = Subscription(
            self.controller, "node_events", self._on_node_event,
            from_latest=True).start()
        logger.info("node agent %s on %s:%d resources=%s",
                    self.node_id.hex()[:8], self.host, self.port,
                    self.resources_total)
        return self.port

    def _surviving_actors(self) -> list:
        """Dedicated actors whose worker processes are still alive —
        reported on (re-)registration so the controller can fail over
        only the ones that actually died."""
        return [w.dedicated_actor for w in self.workers.values()
                if w.dedicated_actor is not None
                and w.proc.poll() is None]

    async def _reregister(self) -> None:
        """register_node with the SAME node id (controller restarted or
        replaced) so running workers/actors stay addressable."""
        await self.controller.call(
            "register_node", self.node_id.binary(),
            (self.host, self.port), self.resources_total, self.labels,
            hosted_actors=self._surviving_actors())

    async def retarget_controller(self, addr) -> bool:
        """Point this agent at a REPLACEMENT controller (head failover:
        a new controller restored the cluster state from the durable
        store on another node). Re-registers with the same node id,
        repoints the membership subscription, and propagates the new
        address to every live hosted worker, whose core workers hold
        their own controller clients (reference: raylet reconnecting to
        the restarted GCS, gcs_rpc_client address refresh)."""
        addr = (addr[0], int(addr[1]))
        logger.info("retargeting controller %s -> %s",
                    self.controller_addr, addr)
        old = self.controller
        self.controller_addr = addr
        self.controller = RpcClient(addr)
        try:
            await old.close()
        except Exception:
            pass
        await self._reregister()
        self._node_sub.retarget(self.controller)
        for w in list(self.workers.values()):
            if w.proc.poll() is not None or w.client is None:
                continue
            try:
                await w.client.call("retarget_controller", addr)
            except Exception as e:
                logger.warning("worker %s retarget failed: %r",
                               w.worker_id.hex()[:8], e)
        return True

    async def _heartbeat_loop(self) -> None:
        period = GlobalConfig.resource_broadcast_period_ms / 1000
        while not self._shutdown:
            try:
                alive = await self.controller.call(
                    "heartbeat", self.node_id.binary(),
                    self.resources_available)
                if alive == "unknown":
                    # Controller restarted without our registration:
                    # re-register with the SAME node id so running
                    # workers/actors stay addressable, and report which
                    # actors we still host so the controller can fail
                    # over the ones that died during the outage.
                    logger.info("controller restarted; re-registering")
                    await self._reregister()
                elif not alive:
                    logger.warning("controller declared this node dead")
            except Exception as e:
                logger.debug("heartbeat failed: %r", e)
            await asyncio.sleep(period)

    async def _metrics_loop(self) -> None:
        """Push this node's metric registry to the controller every
        metrics_report_period_ms (reference: per-node metrics agent,
        _private/metrics_agent.py -> Prometheus)."""
        from ray_tpu_torch.utils import metrics as M
        store_used = M.Gauge("raytpu_object_store_used_bytes",
                             "shm object store bytes in use")
        store_objs = M.Gauge("raytpu_object_store_objects",
                             "objects resident in the shm store")
        spilled = M.Gauge("raytpu_objects_spilled_total",
                          "objects spilled to disk")
        workers = M.Gauge("raytpu_workers", "worker processes alive")
        leases = M.Gauge("raytpu_active_leases", "granted worker leases")
        # graftscope: the sidecar's recorder rings live in THIS process
        # (store_server.cc threads), so the agent's tick is where
        # sidecar service/rename records become timeline spans and the
        # counter block becomes metric deltas (amortization point).
        from ray_tpu_torch.core._native import graftscope
        scope_asm = None
        period = max(0.5, GlobalConfig.metrics_report_period_ms / 1000)
        last_sweep = 0.0
        while not self._shutdown:
            await asyncio.sleep(period)
            # Sweep orphaned ingest files (a worker that died between its
            # direct write and the store_ingest RPC leaks one tmp file).
            now = time.monotonic()
            if now - last_sweep > 30.0:
                last_sweep = now
                try:
                    for name in os.listdir(self.store.dir):
                        # "put-" files are graftcopy stagings (worker
                        # died between linkat and OP_PUT/store_ingest).
                        # "scratch-" files are per-worker recycled
                        # staging inodes: long-idle ones belong to dead
                        # (or dormant) workers and pin tmpfs pages;
                        # dropping the name is always safe — a live
                        # object's hex link is untouched, and a live
                        # worker recovers with a fresh scratch.
                        # "shmslab-" files (graftshm arena slabs) are
                        # STORE-owned — live objects and the warm free
                        # list both live under those names; the sidecar
                        # reclaims orphaned staged entries itself on
                        # client disconnect, so the sweep must never
                        # touch them (the `continue` below).
                        if name.startswith("scratch-"):
                            age_cap = 600
                        elif name.startswith(("ingest-", "put-")):
                            age_cap = 120
                        elif name.startswith("logring-"):
                            # graftlog rings whose writer is gone and
                            # whose salvage window has passed (salvage
                            # unlinks on success; this catches ship
                            # failures, agent restarts, and external
                            # processes — e.g. a dead driver). mtime is
                            # creation time here: mmap stores don't
                            # touch it, so the age gate is just a grace
                            # period for an in-flight salvage.
                            try:
                                rpid = int(name.rsplit("-", 1)[1])
                            except (ValueError, IndexError):
                                continue
                            if self._pid_alive(rpid):
                                continue
                            age_cap = 60
                        else:
                            continue
                        p = os.path.join(self.store.dir, name)
                        try:
                            if time.time() - os.path.getmtime(p) > age_cap:
                                os.unlink(p)
                        except OSError:
                            pass
                except OSError:
                    pass
            try:
                if graftscope.available() and graftscope.enabled():
                    graftscope.publish_counters()
                    if scope_asm is None:
                        scope_asm = graftscope.SpanAssembler(
                            "agent:" + self.node_id.hex()[:12])
                    spans = scope_asm.feed(graftscope.drain_records())
                    if spans:
                        await self.controller.call(
                            "report_native_spans", spans[-5000:])
                store_used.set(self.store.used())
                store_objs.set(self.store.num_objects())
                spilled.set(self.num_spilled)
                workers.set(len(self.workers))
                leases.set(len(self.leases))
                await self.controller.call(
                    "report_metrics", self.node_id.binary(),
                    M.snapshot_all())
            except Exception as e:
                logger.debug("metrics push failed: %r", e)

    async def _pulse_loop(self) -> None:
        """graftpulse tick: assemble one fixed-schema pulse (scope
        counter + histogram deltas, graftshm arena occupancy, store
        object counts, lease queue depth, summed worker RSS) and ship it
        to the controller fire-and-forget. A missed reply costs nothing
        — the controller's health FSM reads pulse *cadence*, and the
        next tick carries fresh deltas regardless."""
        from ray_tpu_torch.core._native import graftpulse
        from ray_tpu_torch.utils import events as E
        asm = graftpulse.PulseAssembler()
        period = max(0.05, GlobalConfig.pulse_period_ms / 1000)
        loop = asyncio.get_running_loop()
        while not self._shutdown:
            await asyncio.sleep(period)
            try:
                # Loop side: only in-memory snapshots (dict sizes, the
                # scope block map, a waitpid poll per worker). The tick's
                # real work — the sidecar shm_stats FFI, the /proc RSS
                # scan, and the assembler's delta crunch — folds into
                # ONE executor job, so a dispatch-adjacent tick costs the
                # event loop one hop instead of an FFI call plus a file
                # walk plus the assemble between every frame it pumps.
                self._worker_scope = {
                    wid: blocks
                    for wid, blocks in self._worker_scope.items()
                    if wid in self.workers}
                extra = {"w:" + wid.hex()[:12]: blocks
                         for wid, blocks in self._worker_scope.items()}
                banked, self._pulse_banked = self._pulse_banked, {}
                self._pulse_tick += 1
                # The per-worker /proc RSS walk is the tick's only file
                # i/o; RSS moves on seconds timescales, so refresh it on
                # every 5th tick and reuse the cached sum in between.
                scan_rss = (self._pulse_tick % 5) == 1
                pids = ([w.proc.pid for w in self.workers.values()
                         if w.proc.poll() is None] if scan_rss else [])
                fp = self._fastpath
                oncpu_pm, gil_pm = self._prof_permille()
                store_used = self.store.used()
                store_capacity = self.store.capacity()
                store_objects = self.store.num_objects()
                num_workers = len(self.workers)
                queue_depth = len(self.leases) + len(self._lease_waiters)
                events_dropped = E.dropped_total()

                def tick_job() -> bytes:
                    free_b = free_slabs = 0
                    if fp is not None:
                        free_b, free_slabs, _ = fp.shm_stats()
                    if scan_rss:
                        rss = sum(graftpulse.proc_rss_bytes(p)
                                  for p in pids)
                        self._pulse_rss = (self._pulse_tick, rss)
                    else:
                        rss = self._pulse_rss[1]
                    return graftpulse.encode(asm.assemble(
                        extra_sources=extra,
                        banked_deltas=banked,
                        store_used=store_used,
                        store_capacity=store_capacity,
                        store_objects=store_objects,
                        shm_free_chunks=free_slabs,
                        shm_arena_bytes=free_b,
                        num_workers=num_workers,
                        queue_depth=queue_depth,
                        rss_bytes=rss,
                        events_dropped=events_dropped,
                        prof_oncpu_permille=oncpu_pm,
                        prof_gil_permille=gil_pm))

                payload = await loop.run_in_executor(None, tick_job)
                await asyncio.wait_for(
                    self.controller.call(
                        "report_pulse", self.node_id.binary(), payload),
                    timeout=max(period, 1.0))
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.debug("pulse push failed: %r", e)

    # ------------------------------------------------------------------
    # memory monitor + OOM killing (reference: src/ray/common/
    # memory_monitor.h polls /proc; raylet/worker_killing_policy_
    # retriable_fifo.cc picks the newest retriable work first)
    # ------------------------------------------------------------------
    def _memory_usage_fraction(self) -> float:
        test_file = GlobalConfig.memory_monitor_test_file
        if test_file:
            try:
                with open(test_file) as f:
                    return float(f.read().strip())
            except Exception:
                return 0.0
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, _, rest = line.partition(":")
                    info[k] = int(rest.strip().split()[0])
            total = info.get("MemTotal", 0)
            avail = info.get("MemAvailable", total)
            return 1.0 - avail / total if total else 0.0
        except Exception:
            return 0.0

    async def _memory_monitor_loop(self) -> None:
        period = GlobalConfig.memory_monitor_refresh_ms / 1000
        threshold = GlobalConfig.memory_usage_threshold
        while not self._shutdown:
            await asyncio.sleep(period)
            usage = self._memory_usage_fraction()
            if usage <= threshold:
                continue
            victim, retriable = self._pick_oom_victim()
            if victim is None:
                continue
            logger.warning(
                "node memory %.0f%% > %.0f%%: killing worker pid=%s (%s)",
                usage * 100, threshold * 100,
                getattr(victim.proc, "pid", "?"),
                "its tasks are retriable" if retriable
                else "restartable actor")
            self.num_oom_kills = getattr(self, "num_oom_kills", 0) + 1
            try:
                victim.proc.terminate()
            except Exception:
                pass
            # Cooldown: let the kill land and memory readings catch up
            # before selecting another victim, else sustained pressure
            # kills one worker per tick faster than /proc/meminfo moves.
            await asyncio.sleep(max(period, 1.0))

    def _pick_oom_victim(self) -> Tuple[Optional[WorkerProc], bool]:
        """Newest LEASED task worker first (retriable-FIFO, by spawn time
        — PIDs wrap and get reused); dedicated actor workers only as a
        last resort and only if their actor can restart (killing a
        max_restarts=0 actor permanently fails it); external procs never.
        Returns (victim, tasks_are_retriable)."""
        leased = [w for w in self.workers.values()
                  if w.current_lease is not None
                  and isinstance(w.proc, subprocess.Popen)]
        if leased:
            return max(leased, key=lambda w: w.spawned_at), True
        actors = [w for w in self.workers.values()
                  if w.dedicated_actor is not None and w.max_restarts != 0
                  and isinstance(w.proc, subprocess.Popen)]
        if actors:
            return max(actors, key=lambda w: w.spawned_at), False
        return None, False

    async def _reap_loop(self) -> None:
        """Monitor child worker processes; clean up on death; retire idle
        workers past their TTL (reference: worker_pool.cc idle killing)."""
        ttl = GlobalConfig.worker_pool_idle_ttl_s
        while not self._shutdown:
            await asyncio.sleep(0.1)
            for wid, w in list(self.workers.items()):
                if w.proc.poll() is not None:
                    await self._on_worker_death(w)
            now = time.monotonic()
            for w in list(self.idle_workers):
                if w.idle_since and now - w.idle_since > ttl:
                    self.idle_workers.remove(w)
                    try:
                        w.proc.terminate()
                    except Exception:
                        pass

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False
        except OSError:
            return True  # EPERM etc: it exists

    async def _on_worker_death(self, w: WorkerProc) -> None:
        self.workers.pop(w.worker_id, None)
        if w in self.idle_workers:
            self.idle_workers.remove(w)
        # Forensics first: the dead process's log ring is still on the
        # filesystem — salvage the tail before anything else can race
        # the file away.
        try:
            await self._salvage_worker_log(w)
        except Exception as e:
            logger.debug("log salvage failed for pid %s: %r",
                         w.proc.pid, e)
        scope = getattr(w, "cgroup_scope", None)
        if scope is not None:
            scope.cleanup()
        if w.current_lease is not None:
            lease = self.leases.pop(w.current_lease, None)
            if lease:
                _, res, pg, bundle_index = lease
                await self._return_resources(res, pg, bundle_index)
                self._mark_sched_dirty()
            w.current_lease = None
        if w.dedicated_actor is not None:
            actor_id = w.dedicated_actor
            w.dedicated_actor = None
            await self._release_actor_allocation(actor_id)
            try:
                await self.controller.call(
                    "report_actor_death", actor_id,
                    f"worker process exited with code {w.proc.returncode}")
            except Exception:
                pass

    async def _return_resources(self, res: Dict[str, float],
                                pg: Optional[bytes],
                                bundle_index: int) -> None:
        """Give resources back to their pool (bundle or node) + wake waiters."""
        if not res:
            return
        if pg is not None:
            ba = self.bundle_available.get((pg, bundle_index))
            if ba is not None:
                resources_add(ba, res)
            async with self._resource_cv:
                self._resource_cv.notify_all()
        else:
            await self._free_resources(res)

    async def _release_actor_allocation(self, actor_id: bytes) -> None:
        gpus = self.gpu_assigned.pop(actor_id, None)
        if gpus:
            self.gpu_free_ids.extend(gpus)
            self.gpu_free_ids.sort()
        alloc = self.actor_allocations.pop(actor_id, None)
        if alloc:
            res, pg, bundle_index = alloc
            await self._return_resources(res, pg, bundle_index)

    async def _free_resources(self, res: Dict[str, float]) -> None:
        async with self._resource_cv:
            resources_add(self.resources_available, res)
            self._resource_cv.notify_all()

    # ------------------------------------------------------------------
    # worker pool (reference: src/ray/raylet/worker_pool.cc)
    # ------------------------------------------------------------------
    def _gc_venv_cache(self) -> List[str]:
        """LRU-evict cached venvs past the size cap (reference:
        runtime_env cache GC — the reference deletes unused runtime-env
        cache entries by cache size; ours keys on READY mtime, which
        _ensure_pip_env touches on every reuse). Venvs whose python a
        LIVE worker runs are never evicted. Returns evicted dirs."""
        cap = GlobalConfig.runtime_env_cache_bytes
        root = os.path.join(self.session_dir, "venvs")
        if cap <= 0 or not os.path.isdir(root):
            return []
        in_use = set()
        # Workers still between spawn and registration count too — their
        # interpreter may be starting from the venv right now. Snapshots:
        # this runs on an executor thread while the loop mutates the
        # dicts.
        for w in (list(self.workers.values())
                  + list(self._pending_registration.values())):
            exe = getattr(w, "python_exe", None)
            if exe and exe.startswith(root):
                # <root>/<key>/bin/python -> <root>/<key>
                in_use.add(os.path.dirname(os.path.dirname(exe)))
        entries = []
        total = 0
        for name in os.listdir(root):
            d = os.path.join(root, name)
            ready = os.path.join(d, "READY")
            if not os.path.isdir(d) or not os.path.exists(ready):
                continue
            try:
                size = sum(os.path.getsize(os.path.join(r, f))
                           for r, _, fs in os.walk(d) for f in fs)
                mtime = os.path.getmtime(ready)
            except OSError:
                continue  # concurrently removed
            entries.append((mtime, d, size))
            total += size
        evicted = []
        now = time.time()
        for mtime, d, size in sorted(entries):  # oldest READY first
            if total <= cap:
                break
            # Grace window: a just-touched READY means a lock-free reuse
            # may be handing this venv out right now.
            if d in in_use or now - mtime < 60.0:
                continue
            shutil.rmtree(d, ignore_errors=True)
            total -= size
            evicted.append(d)
            logger.info("evicted cached runtime env %s (%d bytes)",
                        os.path.basename(d), size)
        return evicted

    async def _ensure_pip_env(self, pip: List[str]) -> str:
        """Create (or reuse) a per-content venv with the requested
        packages (reference: python/ray/_private/runtime_env/pip.py —
        one cached venv per requirements hash; --system-site-packages so
        the runtime's own deps stay visible). Returns the venv's python.

        Offline-friendly: local directories/wheels install with
        --no-build-isolation; index packages need egress."""
        import hashlib
        key = hashlib.sha1("\n".join(sorted(pip)).encode()).hexdigest()[:16]
        venv_dir = os.path.join(self.session_dir, "venvs", key)
        python = os.path.join(venv_dir, "bin", "python")
        ready = os.path.join(venv_dir, "READY")
        try:
            os.utime(ready)  # LRU touch: reuse refreshes eviction order
            return python
        except OSError:
            pass  # absent, or GC raced the touch: take the locked path
        lock = self._venv_locks.setdefault(key, asyncio.Lock())
        async with lock:
            try:
                os.utime(ready)
                return python
            except OSError:
                pass
            loop = asyncio.get_running_loop()
            # One GC at a time: two concurrent sweeps could rmtree a dir
            # the other is mid-os.walk on.
            gc_lock = self._venv_locks.setdefault("__gc__", asyncio.Lock())
            async with gc_lock:
                await loop.run_in_executor(None, self._gc_venv_cache)

            def _build():
                import glob
                import venv as venv_mod
                tmp = f"{venv_dir}.tmp-{os.getpid()}"
                venv_mod.create(tmp, system_site_packages=True,
                                with_pip=True)
                # The agent may itself run inside a venv; system_site_
                # packages then exposes the BASE python's site-packages,
                # not the agent's. A .pth appends the agent environment's
                # site-packages (jax, setuptools, ...) AFTER the new
                # venv's own — installed packages still win.
                parent_sp = [p for p in sys.path
                             if p.rstrip("/").endswith("site-packages")]
                venv_sp = glob.glob(
                    os.path.join(tmp, "lib", "python*",
                                 "site-packages"))[0]
                with open(os.path.join(venv_sp, "_agent_env.pth"),
                          "w") as f:
                    f.write("\n".join(parent_sp) + "\n")
                cmd = [os.path.join(tmp, "bin", "python"), "-m", "pip",
                       "install", "--no-build-isolation", "--quiet", *pip]
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=600)
                if proc.returncode != 0:
                    shutil.rmtree(tmp, ignore_errors=True)
                    raise RuntimeError(
                        f"pip runtime_env install failed: "
                        f"{proc.stderr[-2000:]}")
                open(os.path.join(tmp, "READY"), "w").close()
                try:
                    os.rename(tmp, venv_dir)
                except OSError:  # raced with another agent process
                    shutil.rmtree(tmp, ignore_errors=True)

            await loop.run_in_executor(None, _build)
            return python

    def _container_argv(self, image_uri: str, env: Dict[str, str],
                        user_env: Optional[Dict[str, str]] = None,
                        memory_bytes: Optional[int] = None,
                        cpus: Optional[float] = None) -> List[str]:
        """Worker argv for an image_uri runtime env (reference:
        _private/runtime_env/image_uri.py — the worker process runs
        inside a container). The command is a TEMPLATE from config
        (default podman; swap for docker or a test stub), with
        {session_dir}/{image} substitution, {env_flags} expanding to
        --env k=v (runtime plumbing vars PLUS every user env_vars key —
        user vars must reach the container even without a recognized
        prefix), and {memory_flags} expanding to the container runtime's
        memory cap (host cgroups can't reach the containerized
        workload)."""
        import json as _json
        template = _json.loads(GlobalConfig.container_run_template)
        keep_prefixes = ("RAY_TPU_TORCH_", "CUDA_", "NCCL_", "TORCH_",
                         "PYTHON")
        forward = {k: v for k, v in env.items()
                   if k.startswith(keep_prefixes)}
        for k, v in (user_env or {}).items():
            if v is not None:  # None-unset: simply don't forward
                forward[str(k)] = str(v)
        env_flags = [f"--env={k}={v}" for k, v in sorted(forward.items())]
        mem_flags = ([f"--memory={int(memory_bytes)}"]
                     if memory_bytes else [])
        if cpus:
            mem_flags.append(f"--cpus={cpus}")
        argv: List[str] = []
        for part in template:
            if part == "{env_flags}":
                argv.extend(env_flags)
            elif part == "{memory_flags}":
                argv.extend(mem_flags)
            else:
                argv.append(part.replace("{image}", image_uri)
                            .replace("{session_dir}", self.session_dir))
        return argv

    def _spawn_worker(self, extra_env: Optional[Dict[str, str]] = None,
                      python_exe: Optional[str] = None,
                      memory_bytes: Optional[int] = None,
                      cpus: Optional[float] = None,
                      image_uri: Optional[str] = None) -> WorkerProc:
        env = dict(os.environ)
        stack_token = f"{os.getpid()}-{self._worker_seq}-{time.time_ns()}"
        env["RAY_TPU_TORCH_STACK_TOKEN"] = stack_token
        env["RAY_TPU_TORCH_AGENT_ADDR"] = f"{self.host}:{self.port}"
        env["RAY_TPU_TORCH_CONTROLLER_ADDR"] = \
            f"{self.controller_addr[0]}:{self.controller_addr[1]}"
        env["RAY_TPU_TORCH_NODE_ID"] = self.node_id.hex()
        env["RAY_TPU_TORCH_SESSION_DIR"] = self.session_dir
        if getattr(self, "_sock_path", ""):
            env["RAY_TPU_TORCH_AGENT_SOCK"] = self._sock_path
        if extra_env:
            # runtime_env env_vars (reference: runtime_env plugin env_vars)
            # must land before the interpreter starts: CUDA reads
            # CUDA_VISIBLE_DEVICES when the worker first initializes it.
            # A value of None UNSETS the var (e.g. an inherited pinning).
            for k, v in extra_env.items():
                if v is None:
                    env.pop(str(k), None)
                else:
                    env[str(k)] = str(v)
        capture = GlobalConfig.log_to_driver
        if capture:
            # Piped stdout would otherwise block-buffer: prints inside
            # tasks must reach the driver promptly.
            env["PYTHONUNBUFFERED"] = "1"
        # Resource isolation for DEDICATED workers (reference:
        # src/ray/common/cgroup2/): cgroup v2 scope when writable, heap
        # rlimit as the opt-in fallback; otherwise the node memory
        # monitor's OOM policy is the only enforcement.
        from ray_tpu_torch.utils.cgroups import (create_worker_cgroup,
                                                 rlimit_preexec)
        scope = None
        preexec = None
        container_mem = container_cpus = None
        if image_uri:
            # Host cgroups/rlimits would bind the podman CLIENT, not the
            # containerized workload — the container runtime enforces the
            # memory/CPU caps instead ({memory_flags} in the template).
            container_mem, container_cpus = memory_bytes, cpus
            memory_bytes = None
            cpus = None
        if memory_bytes or cpus:
            if GlobalConfig.cgroup_isolation:
                scope = create_worker_cgroup(
                    f"w-{os.getpid()}-{self._worker_seq}",
                    memory_bytes=memory_bytes, cpus=cpus)
                self._worker_seq += 1
                if not scope.active:
                    scope = None
            if scope is None and memory_bytes \
                    and GlobalConfig.worker_rlimit_memory:
                preexec = rlimit_preexec(int(memory_bytes))
        if image_uri:
            argv = self._container_argv(image_uri, env,
                                        user_env=extra_env,
                                        memory_bytes=container_mem,
                                        cpus=container_cpus)
        else:
            argv = [python_exe or sys.executable, "-m",
                    "ray_tpu_torch.core.worker_main"]
        try:
            proc = subprocess.Popen(
                argv,
                env=env, cwd=os.getcwd(),
                stdout=subprocess.PIPE if capture else None,
                stderr=subprocess.STDOUT if capture else None,
                text=capture or None,
                errors="replace" if capture else None,
                preexec_fn=preexec)
        except BaseException:
            if scope is not None:  # never leak the cgroup dir
                scope.cleanup()
            raise
        if scope is not None:
            scope.add_pid(proc.pid)
        w = WorkerProc(proc, b"")
        w.cgroup_scope = scope
        w.python_exe = python_exe  # venv-GC in-use marker
        w.stack_token = stack_token
        self._pending_registration[proc.pid] = w
        if capture:
            self._start_log_pump(proc)
        return w

    # Coalescing bounds for the log pump: a fast-printing worker ships
    # at most _LOG_PUMP_BATCH lines per publish RPC; the queue bound is
    # what back-pressures the pipe when the controller falls behind.
    _LOG_PUMP_QUEUE = 1024
    _LOG_PUMP_BATCH = 128

    def _start_log_pump(self, proc) -> None:
        """Forward the worker's stdout/stderr lines to the controller's
        log_events pubsub channel (reference: _private/log_monitor.py
        tailing + worker.py print_worker_logs on the driver).

        Two threads around one bounded queue. The reader drains the
        pipe and blocks on ``put`` when the queue fills, so a
        fast-printing worker still back-pressures through the pipe
        instead of queueing unbounded lines. The shipper BLOCKS for the
        first line, then drains whatever else is already queued into
        one batched publish — a lone trailing line ships immediately
        (no time-based flush that would strand it until the NEXT line
        arrives), while a burst coalesces into ~batch-sized RPCs
        instead of a controller round-trip per line."""
        import queue
        import threading

        loop = asyncio.get_running_loop()
        q: "queue.Queue" = queue.Queue(maxsize=self._LOG_PUMP_QUEUE)

        async def _publish(lines):
            try:
                await self.controller.call("publish_logs", [
                    {"pid": proc.pid, "node": self.node_id.hex()[:8],
                     "line": ln} for ln in lines])
            except Exception:
                pass

        def reader():
            assert proc.stdout is not None
            for line in proc.stdout:
                q.put(line.rstrip("\n"))
            q.put(None)  # EOF: flush and stop the shipper

        def shipper():
            eof = False
            while not eof:
                item = q.get()
                if item is None:
                    return
                batch = [item]
                while len(batch) < self._LOG_PUMP_BATCH:
                    try:
                        nxt = q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        eof = True
                        break
                    batch.append(nxt)
                try:
                    asyncio.run_coroutine_threadsafe(
                        _publish(batch), loop).result(10)
                except Exception:
                    pass

        threading.Thread(target=reader, daemon=True,
                         name=f"logpump-{proc.pid}").start()
        threading.Thread(target=shipper, daemon=True,
                         name=f"logship-{proc.pid}").start()

    async def register_worker(self, worker_id: bytes, pid: int, port: int) -> dict:
        w = self._pending_registration.pop(pid, None)
        if w is None:  # worker we did not spawn (e.g. the driver): track only
            w = WorkerProc(_ExternalProc(pid), worker_id)
        w.worker_id = worker_id
        w.addr = (self.host, port)
        w.client = RpcClient(w.addr)
        self.workers[worker_id] = w
        w.ready.set()
        return {"node_id": self.node_id.binary(),
                "store_dir": self.store._dir}

    async def sock_path(self) -> str:
        """Unix-socket endpoint for same-host clients ('' if disabled)."""
        return getattr(self, "_sock_path", "")

    async def report_scope(self, worker_id: bytes, counters: dict,
                           hists: dict) -> None:
        """graftpulse (legacy transport): a worker's cumulative scope
        counter/histogram blocks, forwarded on its flush tick. The pulse
        loop folds these into the node pulse — the hot client-side kinds
        (rpc_send/flush, copy scatter, shm in-place writes) never tick
        in the agent process, so without them the pulse would carry
        sidecar service ops and nothing else. New workers pre-aggregate
        and ship sparse deltas via report_scope_delta instead."""
        if worker_id in self.workers:
            self._worker_scope[worker_id] = (counters, hists)

    async def report_scope_delta(self, worker_id: bytes,
                                 deltas: dict) -> None:
        """graftpulse: a worker's PRE-AGGREGATED sparse scope deltas for
        its last flush window (non-zero rows only). Banking is a plain
        dict merge keyed by kind — bounded by the kind vocabulary, cheap
        enough to run inline on receive — so the pulse tick's fold
        shrinks to one merge of this bank instead of a per-source
        cumulative-block normalization while dispatch is running."""
        if worker_id not in self.workers:
            return
        from ray_tpu_torch.core._native.graftpulse import merge_hists
        bank = self._pulse_banked
        for name, d in deltas.items():
            dh = tuple(int(x) for x in d[3])
            acc = bank.get(name)
            if acc is None:
                bank[name] = (int(d[0]), int(d[1]), int(d[2]), dh)
            else:
                bank[name] = (acc[0] + int(d[0]), acc[1] + int(d[1]),
                              acc[2] + int(d[2]), merge_hists(acc[3], dh))

    async def report_prof(self, worker_id: bytes, payload: dict) -> None:
        """graftprof: one hosted worker's profile delta for the last
        flush window. Buffered for the fire-and-forget controller
        forward; the wall/on-CPU/GIL totals also feed the node pulse's
        hot-node gauges."""
        if worker_id not in self.workers or not isinstance(payload, dict):
            return
        self._prof_buf.append(payload)
        if len(self._prof_buf) > 256:  # forward-loop outage bound
            del self._prof_buf[:128]
        self._prof_window.append((time.time(),
                                  int(payload.get("wall_ns") or 0),
                                  int(payload.get("oncpu_ns") or 0),
                                  int(payload.get("gil_ns") or 0)))

    def _prof_permille(self, horizon_s: float = 6.0) -> Tuple[int, int]:
        """Worker on-CPU and GIL-wait shares (permille of summed worker
        wall time) over the recent report window — the pulse gauges."""
        cutoff = time.time() - horizon_s
        self._prof_window = [w for w in self._prof_window
                             if w[0] >= cutoff]
        wall = sum(w[1] for w in self._prof_window)
        if wall <= 0:
            return 0, 0
        oncpu = sum(w[2] for w in self._prof_window)
        gil = sum(w[3] for w in self._prof_window)
        return (min(1000, oncpu * 1000 // wall),
                min(1000, gil * 1000 // wall))

    async def _prof_loop(self) -> None:
        """Forward buffered worker profile deltas to the controller
        (fire-and-forget, the grafttrail transport shape). The agent's
        own process ships a delta too so sidecar-thread CPU shows up in
        `prof top`."""
        from ray_tpu_torch.core._native import graftprof
        while not self._shutdown:
            await asyncio.sleep(2.0)
            try:
                own = graftprof.collect_flush()
            except Exception:
                own = None
            if own is not None:
                self._prof_buf.append(own)
            if not self._prof_buf:
                continue
            batch, self._prof_buf = self._prof_buf, []
            try:
                await asyncio.wait_for(
                    self.controller.call("report_prof_batch",
                                         self.node_id.binary(), batch),
                    timeout=2.0)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.debug("prof forward failed: %r", e)

    def _log_rows(self, pid: int, recs) -> List[dict]:
        return [{"pid": pid, "level": r.level, "source": r.source,
                 "seq": r.seq, "t_ns": r.t_ns, "task": r.task,
                 "actor": r.actor, "msg": r.msg, "line_len": r.line_len}
                for r in recs]

    async def _log_loop(self) -> None:
        """graftlog tick: tail every hosted worker's ring file (plus
        our own) from persistent cursors and ship the coalesced batch
        to the controller LogStore fire-and-forget (the grafttrail
        transport shape). Readers for vanished pids are dropped — the
        death path salvages their rings."""
        from ray_tpu_torch.core._native import graftlog
        period = max(0.1, GlobalConfig.log_flush_ms / 1000)
        while not self._shutdown:
            await asyncio.sleep(period)
            try:
                pids = {w.proc.pid for w in self.workers.values()}
                pids.add(os.getpid())
                for pid in list(self._log_readers):
                    if pid not in pids:
                        del self._log_readers[pid]
                for pid in pids:
                    rd = self._log_readers.get(pid)
                    if rd is None:
                        rd = self._log_readers[pid] = graftlog.RingReader(
                            graftlog.ring_path(self.store.dir, pid))
                    self._log_buf.extend(
                        self._log_rows(pid, rd.poll(2048)))
            except Exception as e:
                logger.debug("log tail failed: %r", e)
            if not self._log_buf:
                continue
            if len(self._log_buf) > 8192:  # forward-outage bound
                del self._log_buf[:len(self._log_buf) - 8192]
            batch, self._log_buf = self._log_buf, []
            try:
                await asyncio.wait_for(
                    self.controller.call("report_log_batch",
                                         self.node_id.binary(), batch),
                    timeout=2.0)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # Re-buffer (capped) and retry next tick.
                self._log_buf = (batch + self._log_buf)[-8192:]
                logger.debug("log forward failed: %r", e)

    async def _salvage_worker_log(self, w: WorkerProc) -> None:
        """Postmortem forensics: decode the dead process's ring file
        tail and forward it for LogStore ingest + the grafttrail
        attempt join. The controller's per-(node, pid) seq high-water
        drops whatever the live tail already shipped, so the overlap
        is harmless. The file is unlinked only after a successful
        ship — the sweep reclaims it otherwise."""
        if not self._log_on:
            return
        from ray_tpu_torch.core._native import graftlog
        pid = w.proc.pid
        self._log_readers.pop(pid, None)
        path = graftlog.ring_path(self.store.dir, pid)
        meta, tail = graftlog.salvage_ring(
            path, int(GlobalConfig.log_tail_lines))
        if not meta:
            return
        meta["exit_code"] = w.proc.returncode
        try:
            await asyncio.wait_for(
                self.controller.call(
                    "report_log_salvage", self.node_id.binary(), pid,
                    meta, self._log_rows(pid, tail)),
                timeout=2.0)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            logger.debug("log salvage ship failed for pid %s: %r", pid, e)
            return
        try:
            os.unlink(path)
        except OSError:
            pass

    async def _prestart_workers(self, n: int) -> None:
        """Warm the pool at startup (reference: worker_pool.cc
        PrestartWorkers): bursts then never pay a process spawn."""
        procs = []
        for _ in range(n):
            if len(self.workers) + len(procs) >= n:
                break
            try:
                procs.append(self._spawn_worker())
            except Exception:
                break
        for w in procs:
            try:
                await asyncio.wait_for(
                    w.ready.wait(), GlobalConfig.worker_register_timeout_s)
                self._push_idle(w)
            except Exception:
                try:
                    w.proc.terminate()
                except Exception:
                    pass

    async def _pop_worker(self) -> WorkerProc:
        while self.idle_workers:
            w = self.idle_workers.pop()
            if w.proc.poll() is None:
                return w
        w = self._spawn_worker()
        await asyncio.wait_for(w.ready.wait(),
                               GlobalConfig.worker_register_timeout_s)
        return w

    def _push_idle(self, w: WorkerProc) -> None:
        if w.proc.poll() is None and w.dedicated_actor is None:
            # Keep warm at least as many workers as the node's CPU slots:
            # a burst that uses all slots would otherwise pay a process
            # spawn per (slots - idle_cap) worker on EVERY burst.
            cap = max(GlobalConfig.worker_pool_max_idle_workers,
                      int(self.resources_total.get("CPU", 0)))
            if len(self.idle_workers) < cap:
                w.idle_since = time.monotonic()
                self.idle_workers.append(w)
            else:
                w.proc.terminate()

    # ------------------------------------------------------------------
    # leases (reference: cluster_lease_manager.cc QueueAndScheduleLease +
    # spillback ScheduleOnNode)
    # ------------------------------------------------------------------
    def _mint_lease(self) -> dict:
        self._lease_seq += 1
        lease_id = self._lease_seq.to_bytes(8, "big") + \
            self.node_id.binary()[:8]
        return {"granted": True, "lease_id": lease_id,
                "node_id": self.node_id.binary()}

    def _mark_sched_dirty(self) -> None:
        """graftsched: schedule ONE coalesced fire-and-forget resource
        delta to the controller (ray_syncer-style broadcast). Grants and
        returns between heartbeats otherwise leave the controller's
        spillback view up to resource_broadcast_period_ms stale."""
        if self._sched_sync_scheduled or self._shutdown:
            return
        self._sched_sync_scheduled = True
        spawn(self._sched_delta_sync())

    async def _sched_delta_sync(self) -> None:
        try:
            await asyncio.sleep(
                max(0.0, GlobalConfig.sched_delta_ms / 1000))
            self._sched_sync_scheduled = False
            await self.controller.call(
                "report_sched_delta", self.node_id.binary(),
                dict(self.resources_available), len(self.leases))
        except Exception:
            self._sched_sync_scheduled = False  # next change re-arms

    def _resolve_bundle(self, pg: bytes, bundle_index: int,
                        resources: dict) -> int:
        """Resolve the default ``bundle_index=-1`` ("any bundle of the
        PG") to a concrete COMMITTED bundle on this node — the
        ``bundle_available`` pools are keyed by concrete index, so an
        unresolved -1 never matches and the request would park forever.
        Prefers the lowest-indexed bundle whose remaining reservation
        fits ``resources``; falls back to any local bundle of the PG
        (so the request parks on a real pool and wakes when leases
        return); returns -1 when this node hosts none."""
        if bundle_index >= 0:
            return bundle_index
        best = fallback = -1
        for (pg_id, idx), avail in self.bundle_available.items():
            if pg_id != pg:
                continue
            if resources_fit(avail, resources):
                if best < 0 or idx < best:
                    best = idx
            elif fallback < 0 or idx < fallback:
                fallback = idx
        return best if best >= 0 else fallback

    @long_poll
    async def request_lease_batch(self, count: int, resources: dict,
                                  pg: Optional[bytes] = None,
                                  bundle_index: int = -1, strategy=None,
                                  label_selector: Optional[dict] = None
                                  ) -> dict:
        """Grant up to ``count`` leases of ONE scheduling class in a
        single RPC from the local resource view (reference: the raylet's
        cluster_lease_manager grants locally and ray_syncer broadcasts
        the delta — no per-lease control-plane round-trip). Grants stop
        at the first local miss (no fit, no warm worker); zero grants
        fall back to the single parked/spilling path so batch callers
        inherit server-side parking and controller spillback."""
        granted: list = []
        count = max(1, int(count))
        local_ok = pg is not None or (
            labels_match(self.labels, label_selector)
            and self._strategy_allows_local(strategy))
        while local_ok and len(granted) < count:
            b = (self._resolve_bundle(pg, bundle_index, resources)
                 if pg is not None else bundle_index)
            avail = (self.bundle_available.get((pg, b))
                     if pg is not None else self.resources_available)
            if avail is None or not resources_fit(avail, resources):
                break
            # FIFO fairness vs already-parked single requests: a batch
            # must not jump a satisfiable earlier waiter.
            if self._lease_waiters and self._lease_head_blocked(
                    self._lease_ticket_seq + 1, avail, pg, b):
                break
            if granted and not self.idle_workers:
                # Only the first grant of a wave may wait on a worker
                # spawn; the rest would serialize spawn latency behind
                # one RPC. The client re-requests for the remainder.
                break
            resources_sub(avail, resources)
            try:
                w = await self._pop_worker()
            except Exception:
                resources_add(avail, resources)
                break
            r = self._mint_lease()
            w.current_lease = r["lease_id"]
            self.leases[r["lease_id"]] = (w, dict(resources), pg, b)
            r["worker_addr"] = w.addr
            granted.append(r)
        if granted:
            self._mark_sched_dirty()
            async with self._resource_cv:
                self._resource_cv.notify_all()
            return {"granted": granted}
        r = await self.request_lease(resources, pg, bundle_index, strategy,
                                     label_selector)
        if r.get("granted"):
            return {"granted": [r]}
        return {"granted": [], "retry": True}

    @long_poll
    async def request_lease(self, resources: dict, pg: Optional[bytes] = None,
                            bundle_index: int = -1, strategy=None,
                            label_selector: Optional[dict] = None,
                            _no_spill: bool = False,
                            queue_wait_ms: Optional[int] = None) -> dict:
        """Grant a worker lease, parking the request SERVER-SIDE while
        resources are busy (reference: cluster_lease_manager.cc queues leases
        and replies when granted, rather than making clients poll). The
        request waits up to ``lease_queue_wait_ms`` on the resource condvar;
        only then does the client see retry=True and re-request."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + (
            queue_wait_ms if queue_wait_ms is not None
            else GlobalConfig.lease_queue_wait_ms) / 1000
        # FIFO fairness ticket (reference: cluster_lease_manager.cc
        # grants queued leases in order): without it, parked requests
        # re-check in wake-rotation order and under scarcity the LAST
        # submitted task can win every freed slot — reversing completion
        # order and starving the head of the queue.
        self._lease_ticket_seq += 1
        ticket = self._lease_ticket_seq
        waiters = self._lease_waiters
        waiters[ticket] = {"resources": dict(resources), "pg": pg,
                           "bundle": bundle_index,
                           "labels": label_selector,
                           "strategy": strategy}
        try:
            return await self._request_lease_inner(
                ticket, deadline, resources, pg, bundle_index, strategy,
                label_selector, _no_spill)
        finally:
            waiters.pop(ticket, None)
            # A grant consumed resources; wake peers so the new head
            # re-checks promptly.
            async with self._resource_cv:
                self._resource_cv.notify_all()

    def _lease_head_blocked(self, ticket: int, avail, pg,
                            bundle_index: int) -> bool:
        """True when an EARLIER parked request drawing from the SAME
        resource pool could also be satisfied by `avail` — this later
        request defers to it (FIFO among satisfiable waiters). Waiters
        that can never be granted locally (different PG bundle pool,
        unmatched labels, hard affinity elsewhere) or don't fit never
        block anyone — else a stuck head would idle the node."""
        for t, w in self._lease_waiters.items():
            if t >= ticket:
                continue
            if w["pg"] != pg:
                continue  # disjoint pools can't contend
            # A -1 waiter ("any bundle of the PG") may resolve to THIS
            # bundle's pool, so it contends with every index; only two
            # CONCRETE, different indexes are provably disjoint.
            if (w["bundle"] >= 0 and bundle_index >= 0
                    and w["bundle"] != bundle_index):
                continue
            if w["pg"] is None and not (
                    labels_match(self.labels, w["labels"])
                    and self._strategy_allows_local(w["strategy"])):
                continue  # never locally grantable: don't let it starve
            if avail is not None and resources_fit(avail,
                                                   w["resources"]):
                return True
        return False

    async def _request_lease_inner(self, ticket: int, deadline: float,
                                   resources: dict, pg, bundle_index,
                                   strategy, label_selector,
                                   _no_spill) -> dict:
        loop = asyncio.get_running_loop()
        while True:
            # Placement-group tasks must run on the bundle's node.
            # Resolve the default bundle_index=-1 to a concrete local
            # bundle each pass — commits and returned leases between
            # parks can change which bundle (if any) fits.
            b = (self._resolve_bundle(pg, bundle_index, resources)
                 if pg is not None else bundle_index)
            if pg is not None and (pg, b) not in self.bundle_available \
                    and not _no_spill:
                info = await self.controller.call("get_pg_info", pg)
                if info is None or info["state"] != "CREATED":
                    if not await self._park_until(deadline):
                        return {"granted": False, "retry": True}
                    continue
                if bundle_index >= 0:
                    node_id = info["bundle_nodes"][bundle_index]
                else:
                    # -1 with no local bundle: any node hosting one of
                    # the PG's bundles will do; its agent re-resolves.
                    node_id = next(
                        (n for n in info["bundle_nodes"]
                         if n is not None
                         and n != self.node_id.binary()), None)
                if node_id is not None \
                        and node_id != self.node_id.binary():
                    nodes = await self.controller.call("get_nodes")
                    for n in nodes:
                        if n["node_id"] == node_id:
                            return await self._spill_to(tuple(n["addr"]),
                                                        resources, pg,
                                                        bundle_index, strategy)
                    return {"granted": False, "retry": True}

            # Label + strategy constraints: this node must satisfy both
            # to grant locally (PG tasks inherit their bundle's placement
            # instead). A hard node_affinity for ANOTHER node must spill
            # there even when this node has capacity.
            local_ok = pg is not None or (
                labels_match(self.labels, label_selector)
                and self._strategy_allows_local(strategy))
            avail = (self.bundle_available.get((pg, b))
                     if pg is not None else self.resources_available)
            if not local_ok:
                avail = None
            if avail is not None and resources_fit(avail, resources) \
                    and not self._lease_head_blocked(ticket, avail, pg,
                                                     b):
                resources_sub(avail, resources)
                try:
                    w = await self._pop_worker()
                except Exception as e:
                    resources_add(avail, resources)
                    return {"granted": False, "retry": True, "error": repr(e)}
                r = self._mint_lease()
                w.current_lease = r["lease_id"]
                # Store the RESOLVED index so return_lease credits the
                # bundle pool the grant actually drew from.
                self.leases[r["lease_id"]] = (w, dict(resources), pg, b)
                r["worker_addr"] = w.addr
                self._mark_sched_dirty()
                return r

            if not _no_spill and pg is None:
                # Spillback: ask the controller for a feasible node.
                pick = await self.controller.call("pick_node", resources,
                                                  [self.node_id.binary()],
                                                  strategy, label_selector)
                if pick is not None:
                    return await self._spill_to(tuple(pick["addr"]), resources,
                                                pg, bundle_index, strategy,
                                                label_selector)
            # Nothing feasible now: park on the resource condvar until
            # something frees up or the queue-wait budget expires.
            if not await self._park_until(deadline):
                return {"granted": False, "retry": True}

    def _strategy_allows_local(self, strategy) -> bool:
        if not isinstance(strategy, dict):
            return True
        if strategy.get("kind") == "node_affinity":
            return (strategy.get("node_id") == self.node_id.binary()
                    or bool(strategy.get("soft")))
        return True  # spread balances via the controller's pick

    async def _park_until(self, deadline: float) -> bool:
        """Wait for a resource-availability change until `deadline`.
        Returns False once the deadline has passed."""
        loop = asyncio.get_running_loop()
        remaining = deadline - loop.time()
        if remaining <= 0:
            return False
        async with self._resource_cv:
            try:
                # Cap the park so remote state (PG creation, spillback
                # candidates) is re-checked even without a local notify.
                await asyncio.wait_for(self._resource_cv.wait(),
                                       min(remaining, 0.25))
            except asyncio.TimeoutError:
                pass
        return True

    async def _spill_to(self, addr: Address, resources, pg, bundle_index,
                        strategy, label_selector=None) -> dict:
        peer = self._peer(addr)
        reply = await peer.call("request_lease", resources, pg, bundle_index,
                                strategy, label_selector, _no_spill=True)
        if reply.get("granted"):
            reply["spilled_to"] = addr
        return reply

    async def return_lease(self, lease_id: bytes) -> None:
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return
        w, res, pg, bundle_index = lease
        w.current_lease = None
        await self._return_resources(res, pg, bundle_index)
        self._push_idle(w)
        self._mark_sched_dirty()

    # ------------------------------------------------------------------
    # placement group bundles (2-phase commit participant)
    # ------------------------------------------------------------------
    async def prepare_bundle(self, pg_id: bytes, index: int,
                             resources: dict) -> bool:
        # Idempotent: a restored controller re-driving a PENDING PG may
        # re-prepare a bundle this agent already holds from before the
        # restart — re-subtracting would leak resources (and the held
        # reservation would block its own retry).
        if index in self.bundles.get(pg_id, {}):
            return True
        if resources_fit(self.resources_available, resources):
            resources_sub(self.resources_available, resources)
            self.bundles.setdefault(pg_id, {})[index] = dict(resources)
            self._bundle_prepared_at[(pg_id, index)] = time.monotonic()
            return True
        return False

    async def commit_bundle(self, pg_id: bytes, index: int) -> None:
        res = self.bundles.get(pg_id, {}).get(index)
        if res is not None:
            self.bundle_available[(pg_id, index)] = dict(res)
            async with self._resource_cv:
                self._resource_cv.notify_all()

    async def return_bundle(self, pg_id: bytes, index: int) -> None:
        res = self.bundles.get(pg_id, {}).pop(index, None)
        self._bundle_prepared_at.pop((pg_id, index), None)
        if res is not None:
            self.bundle_available.pop((pg_id, index), None)
            await self._free_resources(res)

    async def prepare_commit_bundles(self, pg_id: bytes,
                                     items: list) -> bool:
        """graftsched one-op PG participant: prepare AND commit every
        bundle this node hosts in ONE agent round, all-or-nothing. The
        controller already planned against a consistent snapshot, so the
        2-phase split buys nothing on the happy path — a local miss
        rolls this node back here and the controller falls back to the
        retrying 2-phase scheduler. ``items`` is [(index, resources)]."""
        done: list = []
        for index, resources in items:
            if await self.prepare_bundle(pg_id, index, resources):
                done.append(index)
            else:
                for i in done:
                    await self.return_bundle(pg_id, i)
                return False
        for index in done:
            await self.commit_bundle(pg_id, index)
        self._mark_sched_dirty()
        return True

    async def return_bundles(self, pg_id: bytes, indices: list) -> None:
        """Batched bundle release: one agent round per node on PG remove
        (the per-bundle loop stays controller-side but coalesces into a
        single RPC here)."""
        for index in indices:
            await self.return_bundle(pg_id, index)
        self._mark_sched_dirty()

    # Reservations younger than this never reconcile away: the
    # controller's valid/pending sets are a snapshot and a prepare can
    # land between snapshot and this RPC (TOCTOU).
    _BUNDLE_RECONCILE_GRACE_S = 30.0

    async def reconcile_bundles(self, valid_pairs: list,
                                pending_pg_ids: list) -> None:
        """Drop reservations the controller no longer recognizes (its
        2-phase commit placed the PG elsewhere, or the PG is gone) —
        reservations of still-PENDING PGs, and any prepared within the
        grace window, are left for the in-flight prepare/commit to
        settle."""
        valid = {(bytes(p), int(i)) for p, i in valid_pairs}
        pending = {bytes(p) for p in pending_pg_ids}
        now = time.monotonic()
        for pg_id in list(self.bundles):
            if pg_id in pending:
                continue
            for index in list(self.bundles.get(pg_id, {})):
                if (pg_id, index) in valid:
                    continue
                prepared_at = self._bundle_prepared_at.get(
                    (pg_id, index), now)
                if now - prepared_at < self._BUNDLE_RECONCILE_GRACE_S:
                    continue
                logger.info("reconcile: releasing orphaned bundle "
                            "(%s, %d)", pg_id.hex()[:8], index)
                await self.return_bundle(pg_id, index)

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    @long_poll
    async def start_actor(self, actor_id: bytes, spec_blob: bytes,
                          resources: dict, pg: Optional[bytes],
                          bundle_index: int,
                          env_vars: Optional[Dict[str, str]] = None,
                          max_restarts: int = 0,
                          pip: Optional[List[str]] = None,
                          image_uri: Optional[str] = None) -> dict:
        gpu_req = float(resources.get("GPU", 0))
        if gpu_req != int(gpu_req):
            # GPUs are pinned as whole devices: a fractional GPU would
            # desynchronize pinning from the resource vector.
            raise ValueError(f"GPU requests must be whole devices, got "
                             f"{gpu_req}")
        if pg is not None:
            bundle_index = self._resolve_bundle(pg, bundle_index,
                                                resources)
        avail = (self.bundle_available.get((pg, bundle_index))
                 if pg is not None else self.resources_available)
        if avail is None or not resources_fit(avail, resources):
            raise RuntimeError("insufficient resources for actor")
        resources_sub(avail, resources)
        # Pin specific GPUs to this worker (CUDA_VISIBLE_DEVICES).
        gpus: List[int] = []
        n_gpu = int(gpu_req)
        if n_gpu > 0:
            if len(self.gpu_free_ids) < n_gpu:
                resources_add(avail, resources)
                raise RuntimeError("insufficient GPUs for actor")
            gpus = self.gpu_free_ids[:n_gpu]
            del self.gpu_free_ids[:n_gpu]
            from ray_tpu_torch import accelerators
            env_vars = dict(env_vars or {})
            # Explicit user pinning wins over automatic assignment.
            for k, v in accelerators.worker_env_for_gpus(gpus).items():
                env_vars.setdefault(k, v)
        w: Optional[WorkerProc] = None
        try:
            # pip runtime env: the worker runs on a cached per-requirements
            # venv's python (reference: runtime_env/pip.py). INSIDE the
            # try: a failed venv build must roll back the resources and
            # GPUs reserved above, like any other startup failure.
            if pip and image_uri:
                raise ValueError(
                    "runtime_env cannot combine pip with image_uri — the "
                    "container uses the image's interpreter; bake the "
                    "packages into the image")
            python_exe = await self._ensure_pip_env(pip) if pip else None
            w = self._spawn_worker(  # dedicated, never pooled
                env_vars, python_exe,
                memory_bytes=int(resources["memory"])
                if resources.get("memory") else None,
                cpus=float(resources.get("CPU", 0)) or None,
                image_uri=image_uri)
            await asyncio.wait_for(w.ready.wait(),
                                   GlobalConfig.worker_register_timeout_s)
            w.dedicated_actor = actor_id
            w.max_restarts = max_restarts
            if gpus:
                self.gpu_assigned[actor_id] = gpus
            self.actor_allocations[actor_id] = (dict(resources), pg,
                                                bundle_index)
            assert w.client is not None
            await w.client.call("create_actor_local", spec_blob)
            return {"addr": w.addr}
        except Exception:
            # Full cleanup so the orphaned worker's later death cannot
            # double-release resources or report a bogus actor death.
            self.actor_allocations.pop(actor_id, None)
            self.gpu_assigned.pop(actor_id, None)
            if w is not None:
                w.dedicated_actor = None
                try:
                    w.proc.terminate()
                except Exception:
                    pass
            resources_add(avail, resources)
            if gpus:
                self.gpu_free_ids.extend(gpus)
                self.gpu_free_ids.sort()
            raise

    async def kill_actor_worker(self, actor_id: bytes) -> None:
        for w in self.workers.values():
            if w.dedicated_actor == actor_id:
                w.dedicated_actor = None  # suppress death report (intended)
                await self._release_actor_allocation(actor_id)
                w.proc.terminate()
                return

    # ------------------------------------------------------------------
    # object store control plane (local workers call these)
    # ------------------------------------------------------------------
    async def store_create(self, oid: bytes, data_size: int,
                           meta_size: int) -> str:
        return await self._with_spill_retry(
            lambda: self.store.create(ObjectID(oid), data_size, meta_size),
            data_size + meta_size)

    def _drain_fastpath_events(self) -> None:
        """Runs on the event loop when the sidecar journal signals:
        apply the bookkeeping Python owns for objects the C path
        admitted/deleted. The journal's origin byte (the wire op behind
        the folded record) becomes grafttrail object provenance: which
        plane admitted the bytes (shm slab vs staging-file copy) and why
        a delete happened (explicit / LRU drop / staged reclaim)."""
        from ray_tpu_torch.core._native import grafttrail
        try:
            events = self._fastpath.drain()
        except Exception as e:
            logger.warning("fastpath drain failed: %r", e)
            return
        for op, origin, oid, size in events:
            if op == 1:  # ingest (admitted pinned = primary copy)
                self._primary[oid] = size
                ev = self._seal_waiters.pop(oid, None)
                if ev:
                    ev.set()
                self._trail_object(
                    oid, "sealed", size=size,
                    plane=grafttrail.ORIGIN_PLANE.get(origin, "copy"))
            elif op == 4:  # delete
                was_primary = self._primary.pop(oid, None) is not None
                self._drop_spilled(oid)
                # An LRU drop (origin 7) evicts an unpinned SECONDARY
                # copy — the primary elsewhere is still live, so that is
                # not a free in the ledger's sense.
                if origin != 7 or was_primary:
                    self._trail_object(
                        oid, "freed",
                        reason=grafttrail.ORIGIN_FREED.get(origin,
                                                           "delete"))
            elif op == 9:  # graftshm slab staged (created, not yet sealed)
                self._trail_object(oid, "created", size=size, plane="shm")

    def _trail_object(self, oid: bytes, op: str, **info) -> None:
        if not self._trail_on:
            return
        from ray_tpu_torch.core._native import grafttrail
        self._trail_objects.append(grafttrail.object_event(
            oid.hex(), op, time.time(), node=self._node_hex, **info))
        drop = len(self._trail_objects) - self._trail_cap
        if drop > 0:
            del self._trail_objects[:drop]

    async def report_trail(self, worker_id: bytes, events: list,
                           objects: Optional[list] = None) -> None:
        """Hosted workers hand their task-transition batches here (one
        unix-socket hop); the flush tick ships the node's whole batch to
        the controller. ``objects`` carries owner-attested object events
        — the graftsched 'inline' plane, whose objects never touch the
        store so the journal cannot see them."""
        self._trail_tasks.extend(events)
        drop = len(self._trail_tasks) - self._trail_cap
        if drop > 0:
            del self._trail_tasks[:drop]
        if objects:
            self._trail_objects.extend(objects)
            drop = len(self._trail_objects) - self._trail_cap
            if drop > 0:
                del self._trail_objects[:drop]

    async def trail_residents(self) -> list:
        """Hex oids this node currently holds (store primaries + spilled
        copies) — the audit's ground truth for leak reconciliation."""
        return [o.hex() for o in (set(self._primary) | set(self._spilled))]

    async def _trail_loop(self) -> None:
        period = max(0.05, GlobalConfig.trail_flush_ms / 1000)
        while not self._shutdown:
            await asyncio.sleep(period)
            await self._trail_flush(timeout=max(period, 1.0))

    async def _trail_flush(self, timeout: float = 1.0) -> None:
        if not self._trail_tasks and not self._trail_objects:
            return
        tasks, self._trail_tasks = self._trail_tasks, []
        objects, self._trail_objects = self._trail_objects, []
        try:
            await asyncio.wait_for(
                self.controller.call("report_trail_batch",
                                     self.node_id.binary(), tasks, objects),
                timeout=timeout)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # Re-buffer (capped) so a controller hiccup isn't data loss.
            self._trail_tasks = (tasks + self._trail_tasks)[-self._trail_cap:]
            self._trail_objects = \
                (objects + self._trail_objects)[-self._trail_cap:]
            logger.debug("trail push failed: %r", e)

    async def store_info(self) -> dict:
        """Store facts a local worker needs for the direct-write put path."""
        return {"dir": self.store.dir,
                "fastpath_sock": (self._fastpath.sock_path
                                  if self._fastpath else "")}

    async def _with_spill_retry(self, op, total: int):
        """Run a store-admission op, spilling/queueing on full (shared
        backpressure for create and ingest; reference:
        plasma/create_request_queue.cc)."""
        from ray_tpu_torch.core.object_store import ObjectStoreFullError
        if total > self.store.capacity():
            # Larger than the whole store: spilling can never help.
            raise ObjectStoreFullError(
                f"object of {total} bytes exceeds store capacity "
                f"{self.store.capacity()}")
        deadline = asyncio.get_running_loop().time() + 5.0
        while True:
            try:
                return op()
            except ObjectStoreFullError:
                # Unpinned (secondary) copies were already LRU-evicted by
                # the native store; make room by spilling pinned primaries
                # to disk, then briefly queue while in-flight readers
                # release space.
                await self._spill_for(total)
                try:
                    return op()
                except ObjectStoreFullError:
                    if asyncio.get_running_loop().time() >= deadline:
                        raise
                    await asyncio.sleep(0.1)

    async def store_ingest(self, oid: bytes, src_name: str, data_size: int,
                           meta_size: int) -> None:
        """One-RPC put: the worker already wrote `<store_dir>/<src_name>`;
        account + evict/spill if needed + rename it in as a SEALED
        primary. Collapses the create+seal round-trips (the accounting
        window moves to ingest time — tmpfs briefly holds the payload
        unaccounted, bounded by the writer's in-flight puts)."""
        if not src_name.startswith(("ingest-", "put-")) or "/" in src_name:
            raise ValueError(f"bad ingest source {src_name!r}")
        src = os.path.join(self.store.dir, src_name)
        o = ObjectID(oid)
        try:
            await self._with_spill_retry(
                lambda: self.store.ingest(o, src, data_size, meta_size),
                data_size + meta_size)
        except BaseException:
            try:
                os.unlink(src)  # never strand the payload in tmpfs
            except OSError:
                pass
            raise
        # ingest() admitted the object already pinned (atomic primary
        # admission); only the ledger + seal waiters remain.
        self._primary[oid] = data_size + meta_size
        ev = self._seal_waiters.pop(oid, None)
        if ev:
            ev.set()
        self._trail_object(oid, "sealed", size=data_size + meta_size,
                           plane="fallback")

    async def store_seal(self, oid: bytes, owner_addr=None,
                         size: int = 0) -> None:
        o = ObjectID(oid)
        self.store.seal(o)
        # Worker-created objects are PRIMARY copies on this node: pin them
        # so LRU eviction can never drop the only copy of a live object
        # (reference: local_object_manager.cc PinObjectsAndWaitForFree).
        self.store.pin(o)
        got = self.store.get(o)
        if got is not None:
            self._primary[oid] = got[1] + got[2]
            self.store.release(o)
        ev = self._seal_waiters.pop(oid, None)
        if ev:
            ev.set()
        self._trail_object(oid, "sealed", size=self._primary.get(oid, size),
                           plane="fallback",
                           owner=("%s:%s" % tuple(owner_addr)
                                  if owner_addr else ""))
        if owner_addr is not None:
            spawn(self._register_location(o, tuple(owner_addr),
                                                          size))

    # --- spilling (reference: local_object_manager.cc SpillObjects /
    # restore; objects served straight from spill files for remote pulls
    # like spilled_object_reader.cc) ------------------------------------
    async def _spill_for(self, need_bytes: int) -> None:
        async with self._spill_lock:
            cap = self.store.capacity()
            target = max(need_bytes,
                         GlobalConfig.object_store_min_spill_bytes)
            loop = asyncio.get_running_loop()
            os.makedirs(self._spill_dir, exist_ok=True)
            freed = 0
            for oid in list(self._primary):
                if self.store.used() + need_bytes <= cap and freed >= target:
                    break
                got = self.store.get(ObjectID(oid))
                if got is None:
                    self._primary.pop(oid, None)
                    continue
                path, ds, ms = got
                spill_path = os.path.join(self._spill_dir,
                                          ObjectID(oid).hex())
                try:
                    await loop.run_in_executor(
                        None, shutil.copyfile, path, spill_path)
                finally:
                    self.store.release(ObjectID(oid))
                self.store.delete(ObjectID(oid))
                self._primary.pop(oid, None)
                self._spilled[oid] = (spill_path, ds, ms)
                self.num_spilled += 1
                self.bytes_spilled += ds + ms
                freed += ds + ms
            logger.info("spilled %d bytes to %s (store used %d/%d)",
                        freed, self._spill_dir, self.store.used(), cap)

    async def _restore_spilled(self, oid: bytes) -> Optional[Tuple[str, int, int]]:
        # Serialize concurrent restores per object (same pattern as
        # pull_object): a second caller must not see the half-copied,
        # unsealed object.
        fut = self._restores.get(oid)
        if fut is not None:
            await asyncio.shield(fut)
            return self.store.get(ObjectID(oid))
        entry = self._spilled.get(oid)
        if entry is None:
            return None
        fut = asyncio.get_running_loop().create_future()
        self._restores[oid] = fut
        try:
            spill_path, ds, ms = entry
            o = ObjectID(oid)
            path = await self.store_create(oid, ds, ms)
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, shutil.copyfile, spill_path,
                                       path)
            self.store.seal(o)
            self.store.pin(o)
            self._primary[oid] = ds + ms
            self._spilled.pop(oid, None)
            try:
                os.unlink(spill_path)
            except OSError:
                pass
            self.num_restored += 1
            fut.set_result(True)
            return self.store.get(o)
        except BaseException as e:
            fut.set_exception(e)
            raise
        finally:
            self._restores.pop(oid, None)

    async def _register_location(self, oid: ObjectID, owner_addr: Address,
                                 size: int) -> None:
        try:
            client = self._peer(owner_addr)
            await client.call("add_location", oid.binary(),
                              self.node_id.binary(),
                              (self.host, self.port), size)
        except Exception as e:
            logger.debug("add_location failed for %s: %r", oid, e)

    async def store_get(self, oid: bytes) -> Optional[Tuple[str, int, int]]:
        got = self.store.get(ObjectID(oid))
        if got is None and oid in self._spilled:
            got = await self._restore_spilled(oid)
        return got

    async def store_release(self, oid: bytes) -> None:
        self.store.release(ObjectID(oid))

    async def store_delete(self, oid: bytes) -> None:
        self.store.delete(ObjectID(oid))
        was_primary = self._primary.pop(oid, None) is not None
        self._drop_spilled(oid)
        if was_primary:
            self._trail_object(oid, "freed", reason="delete")

    async def store_contains(self, oid: bytes) -> int:
        c = self.store.contains(ObjectID(oid))
        if c == 0 and oid in self._spilled:
            return 1  # spilled-but-local counts as present (restored on get)
        return c

    @long_poll
    async def wait_seal(self, oid: bytes, timeout: float = 1.0) -> bool:
        if self.store.contains(ObjectID(oid)) == 1:
            return True
        ev = self._seal_waiters.setdefault(oid, asyncio.Event())
        try:
            await asyncio.wait_for(ev.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    # --- node-to-node transfer -------------------------------------------
    def _peer(self, addr: Address) -> RpcClient:
        addr = tuple(addr)
        client = self._peer_clients.get(addr)
        if client is None:
            client = RpcClient(addr)
            self._peer_clients[addr] = client
        return client

    async def object_info(self, oid: bytes) -> Optional[Tuple[int, int]]:
        got = self.store.get(ObjectID(oid))
        if got is None:
            spilled = self._spilled.get(oid)
            if spilled is not None:
                return spilled[1], spilled[2]
            return None
        path, ds, ms = got
        self.store.release(ObjectID(oid))
        return ds, ms

    async def fetch_chunk(self, oid: bytes, offset: int, length: int) -> bytes:
        for attempt in range(3):
            got = self.store.get(ObjectID(oid))
            if got is None:
                # Serve remote pulls straight from the spill file — no
                # restore churn (reference: spilled_object_reader.cc).
                # Spill files live on real disk: read off-loop. A
                # concurrent restore may unlink the file under us; retry
                # re-resolves against the (now restored) store.
                spilled = self._spilled.get(oid)
                if spilled is None:
                    restore_fut = self._restores.get(oid)
                    if restore_fut is not None:
                        await asyncio.shield(restore_fut)
                        continue
                    raise KeyError(f"object not local: {ObjectID(oid)}")

                def _read_spill(path=spilled[0]):
                    with open(path, "rb") as f:
                        f.seek(offset)
                        return f.read(length)

                try:
                    return await asyncio.get_running_loop().run_in_executor(
                        None, _read_spill)
                except FileNotFoundError:
                    continue  # restored mid-read: serve from the store
            path, ds, ms = got
            try:
                return await asyncio.get_running_loop().run_in_executor(
                    None, _pread_file, path, offset, length)
            finally:
                self.store.release(ObjectID(oid))
        raise KeyError(f"object not local: {ObjectID(oid)}")

    @long_poll
    async def pull_object(self, oid: bytes, from_addr,
                          priority: int = 0) -> bool:
        """Fetch a remote object into the local store (idempotent).
        priority: 0 = ray.get, 1 = ray.wait, 2 = task-arg prefetch —
        admitted through the bounded PullScheduler so a broadcast of arg
        prefetches can't starve interactive gets."""
        o = ObjectID(oid)
        if self.store.contains(o) == 1:
            return True
        existing = self._pulls.get(oid)
        if existing is not None:
            fut0, token0 = existing
            # A get landing on a queued prefetch jumps the queue with it.
            self._pull_sched.promote(token0, priority)
            return await asyncio.shield(fut0)
        fut = asyncio.get_running_loop().create_future()
        token = {"ev": asyncio.Event(), "granted": False}
        self._pulls[oid] = (fut, token)
        await self._pull_sched.acquire(priority, token)
        try:
            # Re-check after queueing: a concurrent push may have already
            # delivered the object while this pull waited for a slot.
            if self.store.contains(o) == 1:
                fut.set_result(True)
                return True
            peer = self._peer(tuple(from_addr))
            info = await peer.call("object_info", oid)
            if info is None:
                raise KeyError("remote no longer has object")
            ds, ms = info
            total = ds + ms
            # Backpressured create: spills pinned primaries if the store is
            # full of them (a plain store.create would fail forever).
            path = await self.store_create(oid, ds, ms)
            chunk = GlobalConfig.object_transfer_chunk_bytes
            loop = asyncio.get_running_loop()
            off = 0
            while off < total:
                n = min(chunk, total - off)
                data = await peer.call("fetch_chunk", oid, off, n)
                # Chunk-sized copies run off the loop (a multi-MB write
                # would stall every RPC sharing it).
                await loop.run_in_executor(None, _pwrite_file, path,
                                           data, off)
                off += n
            self.store.seal(o)
            ev = self._seal_waiters.pop(oid, None)
            if ev:
                ev.set()
            fut.set_result(True)
            return True
        except Exception as e:
            try:
                self.store.delete(o)
            except Exception:
                pass
            fut.set_exception(e)
            raise
        finally:
            self._pull_sched.release()
            self._pulls.pop(oid, None)

    @long_poll
    async def push_object(self, oid: bytes, target_addr) -> bool:
        """PUSH a local object to a peer node (reference:
        object_manager.cc:321 Push — the proactive half of the transfer
        plane; broadcast producers ship copies without N pull round
        trips). Chunked through the same transfer framing as pulls."""
        o = ObjectID(oid)
        got = self.store.get(o)
        if got is None:
            raise KeyError(f"object not local: {o}")
        path, ds, ms = got
        try:
            peer = self._peer(tuple(target_addr))
            wanted = await peer.call("receive_push_begin", oid, ds, ms)
            if not wanted:
                return True  # target already has it (sealed)
            try:
                total = ds + ms
                chunk = GlobalConfig.object_transfer_chunk_bytes
                loop = asyncio.get_running_loop()
                off = 0
                while off < total:
                    data = await loop.run_in_executor(
                        None, _pread_file, path, off,
                        min(chunk, total - off))
                    await peer.call("receive_push_chunk", oid, off,
                                    data)
                    off += len(data)
                await peer.call("receive_push_end", oid)
            except BaseException:
                # Never leave the receiver with an unsealed husk: it
                # would poison both retried pushes and future pulls.
                try:
                    await peer.call("receive_push_abort", oid)
                except Exception:
                    pass
                raise
            return True
        finally:
            self.store.release(o)

    async def receive_push_begin(self, oid: bytes, data_size: int,
                                 meta_size: int) -> bool:
        if self.store.contains(ObjectID(oid)) == 1:
            return False  # already sealed locally
        if oid in self._push_rx:
            return True   # resume: a crashed push restarts over the file
        path = await self.store_create(oid, data_size, meta_size)
        self._push_rx[oid] = path
        return True

    async def receive_push_abort(self, oid: bytes) -> None:
        if self._push_rx.pop(oid, None) is not None:
            try:
                self.store.delete(ObjectID(oid))
            except Exception:
                pass

    async def receive_push_chunk(self, oid: bytes, offset: int,
                                 data: bytes) -> None:
        path = self._push_rx.get(oid)
        if path is None:
            raise KeyError(f"no push in progress for {ObjectID(oid)}")
        await asyncio.get_running_loop().run_in_executor(
            None, _pwrite_file, path, data, offset)

    async def receive_push_end(self, oid: bytes) -> None:
        if self._push_rx.pop(oid, None) is None:
            return
        self.store.seal(ObjectID(oid))
        ev = self._seal_waiters.pop(oid, None)
        if ev:
            ev.set()

    async def free_objects(self, oids: list) -> None:
        for oid in oids:
            try:
                self.store.delete(ObjectID(oid))
            except Exception:
                pass
            if self._primary.pop(oid, None) is not None \
                    or oid in self._spilled:
                self._trail_object(oid, "freed", reason="delete")
            self._drop_spilled(oid)

    def _drop_spilled(self, oid: bytes) -> None:
        entry = self._spilled.pop(oid, None)
        if entry is not None:
            try:
                os.unlink(entry[0])
            except OSError:
                pass

    # ------------------------------------------------------------------
    # notifications / state
    # ------------------------------------------------------------------
    async def _on_node_event(self, event: dict) -> None:
        if event.get("type") == "dead":
            # Locations are owner-tracked; drop the dead peer's RPC client
            # so pulls stop targeting it.
            addr = tuple(event.get("addr") or ())
            client = self._peer_clients.pop(addr, None)
            if client is not None:
                try:
                    await client.close()
                except Exception:
                    pass

    async def dump_stacks(self, profile_s: float = 0.0) -> dict:
        """Python stacks of every live worker on this node (reference:
        `ray stack`, scripts.py:2706). Fast path: the worker's own
        worker_stacks RPC (io loop alive). Fallback for a WEDGED worker:
        SIGUSR1 triggers its faulthandler dump to
        <session>/stacks/<pid>.txt, which we read back — that path works
        as long as the process can run signal handlers.

        profile_s > 0 switches the RPC path from a single snapshot to a
        graftprof fold over that many seconds (`ray_tpu stack
        --profile N`); the signal fallback stays a snapshot."""
        import signal
        profile_s = min(max(0.0, float(profile_s or 0.0)), 30.0)
        rpc_timeout = 2.0 + profile_s
        out: dict = {}
        for w in list(self.workers.values()):
            if not isinstance(w.proc, subprocess.Popen) \
                    or w.proc.poll() is not None:
                continue
            pid = w.proc.pid
            entry = {"worker_id": w.worker_id.hex()[:12],
                     "actor": (w.dedicated_actor.hex()[:12]
                               if w.dedicated_actor else None)}
            stacks = None
            if w.client is not None:
                try:
                    stacks = await asyncio.wait_for(
                        w.client.call("worker_stacks", profile_s),
                        timeout=rpc_timeout)
                    entry["via"] = "rpc"
                except Exception as e:
                    entry["rpc_error"] = repr(e)  # kept for diagnosis
                    stacks = None
            if stacks is None:
                token = getattr(w, "stack_token", None) or str(pid)
                path = os.path.join(self.session_dir, "stacks",
                                    f"{token}.txt")
                try:
                    # Never truncate: the worker's faulthandler fd keeps
                    # its own offset (a truncate would leave NUL padding
                    # before the next dump). Read only the bytes this
                    # signal appends, polling until the handler ran.
                    pre = os.path.getsize(path) \
                        if os.path.exists(path) else 0
                    os.kill(pid, signal.SIGUSR1)
                    text = ""
                    deadline = asyncio.get_running_loop().time() + 2.0
                    while asyncio.get_running_loop().time() < deadline:
                        await asyncio.sleep(0.05)
                        if os.path.exists(path) \
                                and os.path.getsize(path) > pre:
                            await asyncio.sleep(0.05)  # let it finish
                            # lint: allow-blocking(bounded faulthandler tail read on tmpfs; diagnostics-only path)
                            with open(path) as f:
                                f.seek(pre)
                                text = f.read()
                            break
                    stacks = {"faulthandler": text} if text else None
                    entry["via"] = "signal"
                    if not text:
                        entry["error"] = "signal dump timed out"
                except Exception as e:
                    entry["error"] = repr(e)
            entry["stacks"] = stacks or {}
            out[pid] = entry
        return out

    async def agent_stats(self) -> dict:
        return {
            "node_id": self.node_id.binary(),
            "resources_total": self.resources_total,
            "resources_available": self.resources_available,
            "num_workers": len(self.workers),
            "num_idle": len(self.idle_workers),
            "store_used": self.store.used(),
            "store_capacity": self.store.capacity(),
            "store_objects": self.store.num_objects(),
            "store_evictions": self.store.num_evictions(),
            "store_pinned": len(self._primary),
            "num_spilled": self.num_spilled,
            "bytes_spilled": self.bytes_spilled,
            "num_restored": self.num_restored,
            "num_oom_kills": getattr(self, "num_oom_kills", 0),
            "spilled_objects": len(self._spilled),
            "event_stats": {m: tuple(v)
                            for m, v in self._server.event_stats.items()},
        }

    async def ping(self) -> str:
        return "pong"

    async def probe_free_port(self) -> int:
        """Pick a currently-free TCP port on THIS host (used by the train
        controller to place the torch.distributed rendezvous on rank 0's
        node rather than probing from the driver's host)."""
        import socket
        s = socket.socket()
        s.bind((self.host, 0))
        port = s.getsockname()[1]
        s.close()
        return port

    async def shutdown_node(self) -> None:
        self._shutdown = True
        if self._fastpath is not None:
            try:
                asyncio.get_running_loop().remove_reader(
                    self._fastpath.notify_fd)
                # lint: allow-blocking(shutdown path: sidecar stop must join its C threads before store teardown; the loop exits 0.2s later)
                self._fastpath.stop()
            except Exception:
                pass
        for w in self.workers.values():
            if w.proc.poll() is None:
                try:
                    w.proc.terminate()
                except Exception:
                    pass
        # Workers' graftrpc listener sockets live in the session dir;
        # terminated workers can't unlink their own, so sweep them here.
        try:
            import glob
            for p in glob.glob(os.path.join(self.session_dir,
                                            "graft-*.sock")):
                try:
                    os.unlink(p)
                except OSError:
                    pass
        except Exception:
            pass
        asyncio.get_running_loop().call_later(0.2, sys.exit, 0)


def main() -> None:
    import argparse
    import json

    p = argparse.ArgumentParser()
    p.add_argument("--controller", required=True, help="host:port")
    p.add_argument("--resources", default="{}", help="JSON resource dict")
    p.add_argument("--labels", default="{}")
    p.add_argument("--session-dir", required=True)
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args()
    host, port_s = args.controller.rsplit(":", 1)
    resources = json.loads(args.resources)
    if "CPU" not in resources:
        resources["CPU"] = float(os.cpu_count() or 1)

    async def run():
        agent = NodeAgent((host, int(port_s)), resources, args.session_dir,
                          json.loads(args.labels))
        port = await agent.start(args.port)
        print(f"AGENT_PORT={port}", flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
