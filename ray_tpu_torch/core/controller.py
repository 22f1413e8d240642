"""Controller — the head-node control plane (GCS equivalent).

Analogue of the reference's GCS server (reference: src/ray/gcs/gcs_server.cc
and its managers: gcs_node_manager.cc, gcs_actor_manager.cc +
gcs_actor_scheduler.cc, gcs_placement_group_manager.cc /
gcs_placement_group_scheduler.cc 2-phase commit, gcs_kv_manager.cc,
gcs_job_manager.cc, gcs_health_check_manager.cc). One asyncio process holding
cluster metadata:

  * node table + liveness (heartbeat timeout -> DEAD, broadcast to agents)
  * actor lifecycle FSM (PENDING -> ALIVE -> RESTARTING -> DEAD with
    max_restarts), actor scheduling onto node agents, named actors
  * placement groups with 2-phase prepare/commit bundle reservation
  * namespaced KV store (function table lives in ns="fn")
  * cluster resource view + hybrid node-picking policy for lease spillback

State is in-memory (the reference's default store_client is also in-memory;
Redis-backed persistence is the fault-tolerance extension point).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.common import (ActorState, Address, NodeState, PGState,
                                       labels_match, resources_add, resources_fit,
                                       resources_sub)
from ray_tpu_torch.core.pubsub import PubsubHub
from ray_tpu_torch.core.rpc import RpcClient, RpcServer, long_poll
from ray_tpu_torch.utils import get_logger
from ray_tpu_torch.utils.aio import spawn
from ray_tpu_torch.utils.config import GlobalConfig

logger = get_logger("controller")


class NodeEntry:
    def __init__(self, node_id: bytes, addr: Address,
                 resources: Dict[str, float], labels: Dict[str, str]):
        self.node_id = node_id
        self.addr = addr
        self.resources_total = dict(resources)
        self.resources_available = dict(resources)
        self.labels = labels
        self.state = NodeState.ALIVE
        self.last_heartbeat = time.monotonic()
        self.client = RpcClient(addr)
        self.num_leases = 0  # last graftsched delta-synced lease count


class ActorEntry:
    def __init__(self, actor_id: bytes, spec_blob: bytes, name: str,
                 max_restarts: int, resources: Dict[str, float],
                 placement: Optional[Tuple[bytes, int]],
                 runtime_env: Optional[dict] = None,
                 label_selector: Optional[Dict[str, str]] = None):
        self.actor_id = actor_id
        self.spec_blob = spec_blob
        self.name = name
        self.max_restarts = max_restarts
        self.restarts_used = 0
        self.resources = resources
        self.placement = placement
        self.runtime_env = runtime_env or {}
        self.label_selector = label_selector
        self.state = ActorState.PENDING
        self.addr: Optional[Address] = None
        self.node_id: Optional[bytes] = None
        self.death_reason = ""
        self.event = asyncio.Event()  # set on ALIVE or DEAD transitions


class PGEntry:
    def __init__(self, pg_id: bytes, bundles: List[Dict[str, float]],
                 strategy: str,
                 bundle_label_selector: Optional[List[dict]] = None):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        # Per-bundle node-label constraints; the special value "$same"
        # gangs bundles onto nodes sharing ONE value for that key (slice-
        # atomic reservation, reference: tpu.py:145 reserve_tpu_slice).
        self.bundle_label_selector = bundle_label_selector
        self.state = PGState.PENDING
        self.bundle_nodes: List[Optional[bytes]] = [None] * len(bundles)
        self.event = asyncio.Event()


class Controller:
    def __init__(self):
        self.nodes: Dict[bytes, NodeEntry] = {}
        self.actors: Dict[bytes, ActorEntry] = {}
        self.named_actors: Dict[str, bytes] = {}
        self.pgs: Dict[bytes, PGEntry] = {}
        self.kv: Dict[str, Dict[str, bytes]] = {}
        self.jobs: Dict[bytes, dict] = {}
        self._next_job = 1
        self._health_task: Optional[asyncio.Task] = None
        self._node_seq = 0  # round-robin cursor for SPREAD
        # Long-poll pubsub hub (reference: gcs pubsub_handler.cc). Channels:
        #   node_events  — {"type": "added"|"dead", "node_id", "addr"}
        #   actor_events — {"actor_id", "state", "addr", "death_reason"}
        #   log_events   — driver-facing error/log lines
        self.pubsub = PubsubHub()
        # Structured event export (reference: ray_event_recorder.cc +
        # aggregator pipeline): every pubsub-published lifecycle event
        # and task transition also lands in the JSONL sink when
        # event_export_path is set.
        from ray_tpu_torch.utils.events import exporter_from_config
        self._event_exporter = exporter_from_config()
        if self._event_exporter is not None:
            hub_publish = self.pubsub.publish

            def publish_and_export(channel, event,
                                   _pub=hub_publish):
                if channel != "log_events":  # log lines are not events
                    self._event_exporter.emit(channel, event)
                return _pub(channel, event)

            self.pubsub.publish = publish_and_export
        # Observability sinks (reference: gcs_task_manager.cc task events
        # + the metrics agent pipeline).
        from collections import deque
        self.task_events: "deque" = deque(maxlen=50000)
        self.node_metrics: Dict[str, dict] = {}
        # graftscope native spans (flight-recorder records stitched by
        # workers/agents) + oid64 -> (trace_id, parent_span) learned
        # from put-side spans, used to parent the agent's context-free
        # sidecar spans in timeline().
        self.native_spans: "deque" = deque(maxlen=50000)
        self._oid_trace: Dict[int, tuple] = {}
        # graftpulse: per-node pulse time series + cluster SLO aggregates
        # (keyed by node_id.hex()[:12], same as node_metrics). The health
        # FSM in _health_loop reads pulse cadence from here; the
        # dashboard /api/cluster + /metrics/cluster and the autoscaler
        # read the folded aggregates.
        from ray_tpu_torch.core._native.graftpulse import ClusterAggregator
        self.pulse = ClusterAggregator(GlobalConfig.pulse_history)
        # grafttrail: the indexed lifecycle ledger (per-attempt task FSM
        # + object provenance). Agents fold their node's worker batches
        # into report_trail_batch; the legacy task_events deque keeps
        # being fed with DERIVED rows so timeline()/list_task_events/
        # event export see the same stream they always did.
        from ray_tpu_torch.core._native.grafttrail import TrailLedger
        self.trail = TrailLedger(GlobalConfig.trail_task_cap,
                                 GlobalConfig.trail_object_cap)
        # graftprof: bounded per-node/per-task profile store. Agents
        # forward their workers' folded-stack deltas fire-and-forget
        # (report_prof_batch); merges are add-only so a lost batch
        # loses a window, never corrupts a fold.
        from ray_tpu_torch.core._native.graftprof import (ProfStore,
                                                          ShardedProfStore)
        prof_shards = max(1, GlobalConfig.prof_shards)
        if prof_shards > 1:
            self.prof = ShardedProfStore(
                shards=prof_shards, history=GlobalConfig.prof_history,
                task_cap=GlobalConfig.prof_task_cap,
                stack_cap=GlobalConfig.prof_stack_cap)
        else:
            self.prof = ProfStore(history=GlobalConfig.prof_history,
                                  task_cap=GlobalConfig.prof_task_cap,
                                  stack_cap=GlobalConfig.prof_stack_cap)
        # graftlog: bounded, indexed cluster log store. Agents tail
        # their workers' crash-persistent rings and ship coalesced
        # batches fire-and-forget (report_log_batch); a dead worker's
        # salvaged tail arrives via report_log_salvage and joins the
        # grafttrail attempt record as root-cause context. Dead nodes
        # are deliberately NOT forgotten — their last records are the
        # forensics payload.
        from ray_tpu_torch.core._native.graftlog import (LogStore,
                                                         ShardedLogStore)
        log_shards = max(1, GlobalConfig.log_shards)
        if log_shards > 1:
            self.logs = ShardedLogStore(
                shards=log_shards, cap=GlobalConfig.log_cap,
                rate_per_s=GlobalConfig.log_rate_per_s,
                dedup_window_s=GlobalConfig.log_dedup_window_s)
        else:
            self.logs = LogStore(
                cap=GlobalConfig.log_cap,
                rate_per_s=GlobalConfig.log_rate_per_s,
                dedup_window_s=GlobalConfig.log_dedup_window_s)
        # graftmeta: the controller self-meters every plane's ingest
        # path (fold latency, records/bytes per second, drops) plus its
        # own event-loop lag and RSS — the singleton-aggregator failure
        # mode is invisible from the outside until nodes start dying,
        # so the aggregator must carry its own gauge. None when off.
        from ray_tpu_torch.core._native import graftmeta
        self.meta = graftmeta.MetaPlane(GlobalConfig.meta_history) \
            if graftmeta.enabled() else None
        self._meta_span_min_ns = max(0, GlobalConfig.meta_span_min_us) \
            * 1000
        self._meta_task: Optional[asyncio.Task] = None
        # Salvage can outrun the trail: the agent ships a dead worker's
        # ring tail the instant waitpid fires, while the driver's trail
        # flush carrying the task's attempt record is still in flight.
        # Tails that found no record to join wait here and re-attach on
        # the next trail fold (or at query time).
        self._pending_task_logs: Dict[str, list] = {}
        # graftload: the live status blob a running soak pushes at 1 Hz
        # (report_soak). Rides the /api/cluster telemetry view so the
        # dashboard shows the soak while it hammers the cluster; staled
        # out after _SOAK_STALE_S so a crashed generator doesn't leave a
        # ghost panel.
        self._soak_status: Dict[str, Any] = {}
        self._soak_rx_mono: float = 0.0
        # Infeasible-demand signals, coalesced BY SHAPE (a parked lease
        # retries pick_node every ~250ms; raw per-attempt records would
        # multiply one pending task into dozens of demands and stampede
        # the autoscaler).
        self._infeasible: Dict[tuple, tuple] = {}
        # Persistence (reference: gcs/store_client/redis_store_client.cc +
        # gcs_init_data.cc rebuild-on-restart). A pluggable StoreClient
        # holds the durable tables: KV (function table!), actors, named
        # actors, PGs, jobs. Node entries are NOT persisted — agents
        # re-register via the heartbeat "unknown" signal. With the
        # sqlite backend on shared storage, a REPLACEMENT controller on
        # another node restores the whole cluster (head failover).
        from ray_tpu_torch.core.store_client import (MemoryStoreClient,
                                                     store_client_for)
        self._storage_path = GlobalConfig.gcs_storage_path
        self._store = None
        last_err: Optional[Exception] = None
        # Transient lock/contention on the shared file during head
        # failover heals in well under a second: retry before judging.
        for attempt in range(3):
            try:
                self._store = store_client_for(self._storage_path)
                break
            except Exception as e:
                last_err = e
                time.sleep(0.25 * (attempt + 1))
        if self._store is None:
            if self._storage_path \
                    and not GlobalConfig.gcs_storage_allow_empty_start:
                # An explicitly configured durable store that will not
                # open must FAIL FAST: silently "restoring" an empty
                # cluster while agents re-register is exactly the data
                # loss the durable store exists to prevent (r5 advisor;
                # the reference's redis-backed GCS also hard-fails).
                raise RuntimeError(
                    f"controller durable store {self._storage_path!r} "
                    f"failed to open: {last_err!r}. Repair the store, "
                    "or set gcs_storage_allow_empty_start=1 to "
                    "deliberately start with empty state.") from last_err
            logger.warning("could not open controller store %r: %r — "
                           "starting with empty state (override: "
                           "gcs_storage_allow_empty_start)",
                           self._storage_path, last_err)
            self._store = MemoryStoreClient()
        self._dirty = False
        if self._storage_path:
            self._restore_state()

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _mark_dirty(self) -> None:
        self._dirty = True

    def _restore_state(self) -> None:
        try:
            snap = self._store.load()
        except Exception as e:
            logger.warning("could not restore controller state: %r", e)
            return
        if snap is None:
            return
        self.kv = snap.get("kv", {})
        self.named_actors = snap.get("named_actors", {})
        self.jobs = snap.get("jobs", {})
        self._next_job = snap.get("next_job", 1)
        for a in snap.get("actors", []):
            entry = ActorEntry(a["actor_id"], a["spec_blob"], a["name"],
                               a["max_restarts"], a["resources"],
                               a["placement"], a["runtime_env"],
                               a.get("label_selector"))
            entry.state = a["state"]
            entry.addr = a["addr"]
            entry.node_id = a["node_id"]
            entry.restarts_used = a["restarts_used"]
            entry.death_reason = a["death_reason"]
            if entry.state in (ActorState.ALIVE, ActorState.DEAD):
                entry.event.set()
            self.actors[a["actor_id"]] = entry
        for p in snap.get("pgs", []):
            pg = PGEntry(p["pg_id"], p["bundles"], p["strategy"],
                         p.get("bundle_label_selector"))
            pg.state = p["state"]
            pg.bundle_nodes = p["bundle_nodes"]
            if pg.state != PGState.PENDING:
                pg.event.set()
            self.pgs[p["pg_id"]] = pg
        logger.info("restored controller state: %d actors, %d pgs, "
                    "%d kv namespaces", len(self.actors), len(self.pgs),
                    len(self.kv))

    def _snapshot_state(self) -> None:
        snap = {
            "kv": {ns: space for ns, space in self.kv.items()
                   if ns != "pkg"},  # pkg blobs live as side files
            "named_actors": self.named_actors,
            "jobs": self.jobs,
            "next_job": self._next_job,
            "actors": [{
                "actor_id": e.actor_id, "spec_blob": e.spec_blob,
                "name": e.name, "max_restarts": e.max_restarts,
                "resources": e.resources, "placement": e.placement,
                "runtime_env": e.runtime_env,
                "label_selector": e.label_selector, "state": e.state,
                "addr": e.addr, "node_id": e.node_id,
                "restarts_used": e.restarts_used,
                "death_reason": e.death_reason,
            } for e in self.actors.values()],
            "pgs": [{
                "pg_id": p.pg_id, "bundles": p.bundles,
                "strategy": p.strategy, "state": p.state,
                "bundle_nodes": p.bundle_nodes,
                "bundle_label_selector": p.bundle_label_selector,
            } for p in self.pgs.values()],
        }
        self._store.save(snap)

    async def _resume_restored(self) -> None:
        """After a restart: re-drive restored PENDING work and fail over
        restored-ALIVE actors whose nodes never re-register (their
        heartbeat-timeout path can't fire — the node table starts
        empty)."""
        for pg in self.pgs.values():
            if pg.state == PGState.PENDING:
                spawn(self._schedule_pg(pg))
        for actor in self.actors.values():
            if actor.state in (ActorState.PENDING, ActorState.RESTARTING):
                spawn(self._schedule_actor(actor))
        grace = GlobalConfig.health_check_timeout_ms / 1000
        await asyncio.sleep(grace)
        for actor in list(self.actors.values()):
            if actor.state == ActorState.ALIVE and (
                    actor.node_id not in self.nodes
                    or self.nodes[actor.node_id].state != NodeState.ALIVE):
                spawn(self._handle_actor_failure(
                    actor, "node did not return after controller restart"))

    async def _persist_loop(self) -> None:
        """Debounced snapshotting: flush dirty state every 500ms."""
        while True:
            await asyncio.sleep(0.5)
            if self._dirty:
                self._dirty = False
                try:
                    self._snapshot_state()
                except Exception as e:
                    self._dirty = True  # retry on the next tick
                    logger.warning("controller snapshot failed: %r", e)

    # ------------------------------------------------------------------
    # observability (metrics + task events + timeline)
    # ------------------------------------------------------------------
    def _meta_note(self, plane: str, records: int, nbytes: int,
                   t0_ns: int) -> None:
        """Meter one plane fold: t0_ns is the perf_counter_ns taken
        before the fold, so dur is exactly the event-loop time the
        fold held. Folds slower than meta_span_min_us additionally
        land as `meta.fold.<plane>` spans in the native timeline —
        the controller's own milliseconds become visible in
        `timeline --native` next to the work they delayed."""
        if self.meta is None:
            return
        dur_ns = time.perf_counter_ns() - t0_ns
        self.meta.note(plane, records, nbytes, dur_ns)
        if self._meta_span_min_ns and dur_ns >= self._meta_span_min_ns:
            now_us = time.time_ns() / 1e3
            self.native_spans.append({
                "name": "meta.fold.%s" % plane, "cat": "native",
                "ts": now_us - dur_ns / 1e3, "dur": dur_ns / 1e3,
                "pid": "controller", "tid": "meta",
                "args": {"records": records, "bytes": nbytes},
            })

    async def report_metrics(self, node_id: bytes, snapshot: dict) -> None:
        t0 = time.perf_counter_ns()
        self.node_metrics[node_id.hex()[:12]] = snapshot
        self._meta_note("metrics", 1, 0, t0)

    async def get_metrics(self) -> dict:
        # Shallow-copy: the reply must be a point-in-time snapshot even
        # if a report_metrics ingest lands between handler return and
        # serialisation (dashboard handlers poll this concurrently).
        return dict(self.node_metrics)

    async def metrics_text(self) -> str:
        """Prometheus text exposition over every node's registry."""
        from ray_tpu_torch.utils.metrics import render_prometheus
        return render_prometheus(self.node_metrics)

    async def report_pulse(self, node_id: bytes, blob: bytes) -> None:
        """graftpulse ingest: decode one fire-and-forget pulse frame into
        the node's ring-buffer series. Malformed frames are dropped (a
        version-skewed agent must not kill the controller); a good pulse
        also clears any suspect state the cadence FSM set."""
        t0 = time.perf_counter_ns()
        p = self.pulse.ingest(node_id.hex()[:12], blob)
        if p is None:
            if self.meta is not None:
                self.meta.drop("pulse")
            return
        self._meta_note("pulse", 1, len(blob), t0)

    _SOAK_STALE_S = 30.0

    async def report_soak(self, status: dict) -> None:
        """graftload ingest: the soak generator's 1 Hz status blob
        (phase, per-workload submit/complete counts, chaos log). Kept
        as one opaque dict — the soak owns its schema; the controller
        only stamps receipt time for staleness."""
        self._soak_status = dict(status)
        self._soak_rx_mono = time.monotonic()

    async def cluster_telemetry(self, window: int = 30) -> dict:
        """The cluster SLO view: per-op p50/p99 + throughput folded over
        every node's recent pulses, per-node occupancy/health, plus the
        controller's own membership and actor state. One call feeds the
        dashboard /api/cluster, `ray_tpu status --live` and state.py."""
        from ray_tpu_torch.core.common import ActorState
        snap = self.pulse.snapshot(window)
        snap["cluster"] = {
            "nodes_alive": sum(1 for n in self.nodes.values()
                               if n.state == NodeState.ALIVE),
            "nodes_dead": sum(1 for n in self.nodes.values()
                              if n.state == NodeState.DEAD),
            "actors_alive": sum(1 for a in self.actors.values()
                                if a.state == ActorState.ALIVE),
            "actors_pending": sum(1 for a in self.actors.values()
                                  if a.state in (ActorState.PENDING,
                                                 ActorState.RESTARTING)),
            "pulse_enabled": bool(GlobalConfig.graftpulse),
        }
        # Attach address/state for nodes the pulse plane knows about and
        # list registered nodes that never pulsed (pulse disabled or
        # version-skewed agents) so the view is complete.
        by_hex = {n.node_id.hex()[:12]: n for n in self.nodes.values()}
        for hex_id, info in snap["nodes"].items():
            n = by_hex.get(hex_id)
            if n is not None:
                info["addr"] = list(n.addr)
                info["state"] = str(n.state)
        for hex_id, n in by_hex.items():
            if hex_id not in snap["nodes"] \
                    and n.state == NodeState.ALIVE:
                snap["nodes"][hex_id] = {
                    "health": "no-pulse", "addr": list(n.addr),
                    "state": str(n.state),
                }
        if self._soak_status and (time.monotonic() - self._soak_rx_mono
                                  <= self._SOAK_STALE_S):
            snap["soak"] = dict(self._soak_status)
        return snap

    async def cluster_metrics_text(self) -> str:
        """Federated Prometheus exposition for /metrics/cluster: every
        node's pushed registry plus the pulse-derived cluster
        aggregates (raytpu_cluster_*)."""
        from ray_tpu_torch.utils.metrics import render_prometheus
        snap = self.pulse.snapshot()
        lines = []

        def gauge(name, desc, value, tags=""):
            lines.append(f"# HELP {name} {desc}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{tags} {value}")

        tot = snap["totals"]
        gauge("raytpu_cluster_store_used_bytes",
              "Object store bytes in use across the cluster.",
              tot["store_used"])
        gauge("raytpu_cluster_store_objects",
              "Objects resident across the cluster.",
              tot["store_objects"])
        gauge("raytpu_cluster_queue_depth",
              "Worker leases queued + running across the cluster.",
              tot["queue_depth"])
        gauge("raytpu_cluster_workers",
              "Worker processes across the cluster.",
              tot["num_workers"])
        gauge("raytpu_cluster_events_dropped",
              "Lifecycle events dropped across the cluster.",
              tot["events_dropped"])
        for name, o in sorted(snap["ops"].items()):
            for metric, desc in (
                    ("p50_ns", "p50 native-op latency (pulse window)"),
                    ("p99_ns", "p99 native-op latency (pulse window)"),
                    ("bytes_per_s", "native-plane throughput "
                                    "(pulse window)")):
                mname = f"raytpu_cluster_{metric}"
                if not any(ln.startswith(f"# HELP {mname} ")
                           for ln in lines):
                    lines.append(f"# HELP {mname} {desc}")
                    lines.append(f"# TYPE {mname} gauge")
                lines.append(f'{mname}{{op="{name}"}} {o[metric]}')
        if self.meta is not None:
            m = self.meta.snapshot()
            gauge("raytpu_meta_rss_bytes",
                  "Controller resident set size.", m["rss_bytes"])
            gauge("raytpu_meta_loop_lag_p99_ns",
                  "Controller event-loop lag p99 (meta window).",
                  m["loop_lag"]["p99_ns"])
            for metric, desc in (
                    ("records_per_s", "Plane ingest records/s "
                                      "(meta window)"),
                    ("bytes_per_s", "Plane ingest bytes/s "
                                    "(meta window)"),
                    ("fold_p99_ns", "Plane fold latency p99 "
                                    "(meta window)"),
                    ("drops", "Plane frames/records dropped "
                              "(cumulative)")):
                mname = f"raytpu_meta_{metric}"
                lines.append(f"# HELP {mname} {desc}")
                lines.append(f"# TYPE {mname} gauge")
                for plane, row in sorted(m["planes"].items()):
                    lines.append(
                        f'{mname}{{plane="{plane}"}} {row[metric]}')
        return render_prometheus(self.node_metrics) + "\n" \
            + "\n".join(lines) + "\n"

    async def publish_logs(self, events: list) -> None:
        for ev in events:
            self.pubsub.publish("log_events", ev)

    async def report_task_events(self, events: list) -> None:
        """Legacy worker stream (trail emission disabled). The rows go
        to the deque/export unchanged, and fold into the trail ledger
        with what the legacy vocabulary knows (no LEASED/RUNNING)."""
        legacy = {"submitted": "SUBMITTED", "finished": "FINISHED",
                  "failed": "FAILED", "cancelled": "CANCELLED"}
        for ev in events:
            state = legacy.get(ev.get("event"))
            if state is None:
                continue
            self.trail.fold_task((
                ev.get("task_id", ""), int(ev.get("attempt", 0)), state,
                float(ev.get("ts", 0.0)),
                {"name": ev.get("name", ""), "owner": ev.get("owner", ""),
                 "trace": ev.get("trace_id", ""),
                 "pspan": ev.get("parent_span", ""),
                 "parent": ev.get("parent_span", ""),
                 "err": ev.get("error", "")}))
        self.task_events.extend(events)
        if self._event_exporter is not None:
            for ev in events:
                self._event_exporter.emit("task_events", ev)
            self._event_exporter.flush()

    async def report_trail_batch(self, node_id: bytes, task_events: list,
                                 object_events: list) -> None:
        """grafttrail ingest: one fire-and-forget batch per node per
        flush tick. Folding returns legacy-shaped rows for the
        transitions the old pipeline knew about — those keep feeding
        the task_events deque and the event exporter so every derived
        view (timeline, export JSONL, list_task_events) is unchanged."""
        t0 = time.perf_counter_ns()
        derived = []
        for ev in task_events:
            try:
                row = self.trail.fold_task(tuple(ev))
            except Exception:
                continue
            if row is not None:
                derived.append(row)
        for ev in object_events:
            try:
                self.trail.fold_object(tuple(ev))
            except Exception:
                continue
        self._retry_pending_task_logs()
        n = len(task_events) + len(object_events)
        # Nominal ~96B per wire event: trail batches arrive as tuples,
        # so the meter estimates bytes instead of re-serializing.
        self._meta_note("trail", n, 96 * n, t0)
        if derived:
            self.task_events.extend(derived)
            if self._event_exporter is not None:
                for row in derived:
                    self._event_exporter.emit("task_events", row)
                self._event_exporter.flush()

    async def list_task_events(self, limit: int = 1000) -> list:
        return list(self.task_events)[-limit:]

    # -- trail queries (the `ray_tpu list/summary/get/audit` backends) --
    async def trail_tasks(self, state=None, node=None, name=None,
                          actor=None, limit: int = 100) -> list:
        return self.trail.list_tasks(state=state, node=node, name=name,
                                     actor=actor, limit=limit)

    async def trail_task(self, task_id: str):
        self._retry_pending_task_logs()
        return self.trail.get_task(task_id)

    async def trail_summary(self) -> list:
        return self.trail.summary()

    async def trail_objects(self, node=None, plane=None, live=None,
                            limit: int = 100) -> list:
        return self.trail.list_objects(node=node, plane=plane, live=live,
                                       limit=limit)

    async def trail_stats(self) -> dict:
        return self.trail.stats()

    async def trail_audit(self, grace_s: Optional[float] = None) -> dict:
        """Conservation audit: every non-terminal task live on an alive
        node, every sealed object freed or still resident where the
        ledger says. Resident oid sets come from the alive agents
        (best-effort — an unreachable agent's node is skipped rather
        than reported as a mass leak).

        Consistency: the resident RPCs fan out CONCURRENTLY and the
        alive-node set is computed AFTER they land, in the same event-
        loop slice as the ledger walk. The old shape (alive set first,
        then serial 2s-timeout awaits per node) let membership fold
        mid-audit under chaos: a node going DEAD between the snapshot
        and the walk surfaced as a raft of phantom "lost" tasks."""
        nodes = self._alive_nodes()
        results = await asyncio.gather(
            *(asyncio.wait_for(n.client.call("trail_residents"),
                               timeout=2.0) for n in nodes),
            return_exceptions=True)
        residents: Dict[str, set] = {}
        for node, oids in zip(nodes, results):
            if isinstance(oids, BaseException):
                continue  # skip: absence of ground truth is not a leak
            residents[node.node_id.hex()[:12]] = set(oids)
        if grace_s is None:
            grace_s = GlobalConfig.trail_audit_grace_s
        # No awaits below: alive set + ledger walk see one point-in-
        # time membership table.
        alive = {n.node_id.hex()[:12] for n in self.nodes.values()
                 if n.state == NodeState.ALIVE}
        return self.trail.audit(alive, residents=residents,
                                grace_s=grace_s)

    # -- graftprof (the `ray_tpu prof` + /api/prof backends) ----------
    async def report_prof_batch(self, node_id: bytes, payloads: list
                                ) -> None:
        """graftprof ingest: one fire-and-forget batch per node per
        flush tick — each payload is one process's folded-stack delta
        for its last ~2s window. Malformed payloads are dropped."""
        t0 = time.perf_counter_ns()
        hex_id = node_id.hex()[:12]
        nbytes = 0
        for payload in payloads:
            try:
                nbytes += (len(payload.get("frames") or ()) * 32
                           + len(payload.get("stacks") or ()) * 48
                           + len(payload.get("tasks") or ()) * 48)
                self.prof.ingest(hex_id, payload)
            except Exception:
                if self.meta is not None:
                    self.meta.drop("prof")
                continue
        self._meta_note("prof", len(payloads), nbytes, t0)

    async def prof_top(self, task=None, actor=None, node=None,
                       seconds=None, limit: int = 30) -> dict:
        return self.prof.top(task=task or "", actor=actor or "",
                             node=node or "",
                             seconds=float(seconds or 0.0), limit=limit)

    async def prof_flame(self, task=None, actor=None, node=None,
                         seconds=None) -> dict:
        return self.prof.flame(task=task or "", actor=actor or "",
                               node=node or "",
                               seconds=float(seconds or 0.0))

    async def prof_collapsed(self, task=None, actor=None, node=None,
                             seconds=None) -> list:
        return self.prof.collapsed(task=task or "", actor=actor or "",
                                   node=node or "",
                                   seconds=float(seconds or 0.0))

    async def prof_task_stats(self, task_id: str):
        """On-CPU / GIL-wait accounting for one task id (prefix ok) —
        the `ray_tpu get task` join against the trail ledger."""
        return self.prof.task_stats(task_id)

    async def prof_stats(self) -> dict:
        return self.prof.stats()

    # -- graftlog (the `ray_tpu logs` + /api/logs backends) -----------
    async def report_log_batch(self, node_id: bytes, records: list
                               ) -> None:
        """graftlog ingest: one fire-and-forget coalesced batch per
        node per log tick — records tailed from the workers' (and the
        agent's own) crash-persistent rings. Dedup/rate caps apply
        inside the store."""
        t0 = time.perf_counter_ns()
        self.logs.ingest_batch(node_id.hex()[:12], records)
        nbytes = sum(int(r.get("line_len") or 0) for r in records or ())
        self._meta_note("log", len(records or ()), nbytes, t0)

    @staticmethod
    def _format_log_line(rec: dict) -> str:
        t = time.strftime("%H:%M:%S",
                          time.localtime(int(rec.get("t_ns") or 0) / 1e9))
        level = logging.getLevelName(int(rec.get("level") or 0))
        return "%s %.1s [%s] %s" % (
            t, level or "?",
            {0: "log", 1: "out", 2: "err", 3: "agt"}.get(
                int(rec.get("source") or 0), "?"),
            rec.get("msg", ""))

    async def report_log_salvage(self, node_id: bytes, pid: int,
                                 meta: dict, records: list) -> None:
        """Postmortem forensics: a dead worker's ring tail. The rows
        join the LogStore (seq high-water drops what the live tail
        already shipped; the salvaged flag exempts them from eviction
        pressure), and each task mentioned in the tail gets its last
        lines pinned onto its grafttrail attempt record — `get task`
        on a SIGKILL'd task then shows its final words as root cause."""
        t0 = time.perf_counter_ns()
        hex_id = node_id.hex()[:12]
        self.logs.ingest_batch(hex_id, records, salvaged=True)
        self._meta_note("log", len(records or ()),
                        sum(int(r.get("line_len") or 0)
                            for r in records or ()), t0)
        by_task: Dict[str, list] = {}
        for rec in records or ():
            task = str(rec.get("task") or "")
            if task:
                by_task.setdefault(task, []).append(
                    self._format_log_line(rec))
        for task, lines in by_task.items():
            try:
                if not self.trail.attach_task_logs(task, lines[-20:]):
                    self._pending_task_logs[task] = lines[-20:]
            except Exception:
                continue
        logger.info("salvaged %d log records from dead pid %s on %s "
                    "(exit %s)", len(records or ()), pid, hex_id,
                    meta.get("exit_code"))

    def _retry_pending_task_logs(self) -> None:
        """Join parked salvage tails onto trail records that have since
        materialized (the salvage-outran-the-trail race)."""
        if not self._pending_task_logs:
            return
        for task in list(self._pending_task_logs):
            try:
                if self.trail.attach_task_logs(
                        task, self._pending_task_logs[task]):
                    del self._pending_task_logs[task]
            except Exception:
                del self._pending_task_logs[task]

    async def list_logs(self, task=None, actor=None, node=None,
                        level: int = 0, since_ns: int = 0,
                        after_id: int = 0, limit: int = 100) -> list:
        return self.logs.list(task=task or "", actor=actor or "",
                              node=node or "", level=int(level or 0),
                              since_ns=int(since_ns or 0),
                              after_id=int(after_id or 0), limit=limit)

    async def log_stats(self) -> dict:
        return self.logs.stats()

    # -- graftmeta (the /api/meta + `ray_tpu status --planes` backend) -
    async def meta_snapshot(self, window: int = 60) -> dict:
        """The controller's self-telemetry: per-plane ingest rates +
        fold-latency percentiles over the last `window` meta ticks,
        event-loop lag, controller RSS, and each store's occupancy
        (live caps/eviction/dedup counters straight from the stores)."""
        if self.meta is None:
            return {"enabled": False}
        stores = {
            "pulse": {"nodes": len(self.pulse.series),
                      "pulses": sum(len(s.pulses) for s in
                                    self.pulse.series.values()),
                      "cap_per_node": self.pulse.history},
            "trail": self.trail.stats(),
            "prof": self.prof.stats(),
            "log": self.logs.stats(),
            "scope": {"spans": len(self.native_spans),
                      "oid_trace": len(self._oid_trace)},
        }
        snap = self.meta.snapshot(int(window), stores=stores)
        snap["enabled"] = True
        return snap

    async def report_native_spans(self, spans: list) -> None:
        """graftscope spans from worker flushers / agent metric ticks.
        Put-side spans teach us oid64 -> trace context; sidecar-side
        spans for the same object arrive context-free from the agent
        and get parented at timeline() time."""
        t0 = time.perf_counter_ns()
        for s in spans:
            oid = s.get("oid64")
            if oid and s.get("trace_id"):
                self._oid_trace[oid] = (s["trace_id"],
                                        s.get("parent_span", ""))
        if len(self._oid_trace) > 100000:
            # Bounded, FIFO-ish: drop the older half (insertion order).
            for k in list(self._oid_trace)[:50000]:
                del self._oid_trace[k]
        self.native_spans.extend(spans)
        self._meta_note("scope", len(spans), 64 * len(spans), t0)

    async def native_latency(self) -> list:
        """Hot-path latency rollup over the retained native spans, for
        the dashboard table: per span name, count / mean / max µs."""
        agg: Dict[str, list] = {}
        for s in self.native_spans:
            a = agg.setdefault(s["name"], [0, 0.0, 0.0])
            d = float(s.get("dur", 0.0))
            a[0] += 1
            a[1] += d
            if d > a[2]:
                a[2] = d
        return [{"name": n, "count": c, "mean_us": (su / c if c else 0.0),
                 "max_us": mx}
                for n, (c, su, mx) in sorted(agg.items())]

    async def timeline(self, native: bool = True) -> list:
        """Chrome-trace events from the task ledger (reference:
        `ray timeline`, _private/profiling.py chrome://tracing dump),
        plus — when ``native`` — the graftscope spans (dispatch-queue,
        wire, sidecar-service, copy phases) re-homed onto the pid/tid
        of the task that submitted them so viewers nest them under
        that task's slice. Every event carries pid AND tid (Perfetto
        drops track-less events)."""
        starts: Dict[str, dict] = {}
        placed: Dict[str, tuple] = {}  # task_id -> (pid, tid)
        trace: list = []
        for ev in self.task_events:
            if ev["event"] == "submitted":
                starts[ev["task_id"]] = ev
            else:  # finished | failed
                s = starts.pop(ev["task_id"], None)
                if s is None:
                    continue
                pid = ev.get("owner", "driver")
                tid = ev["task_id"][:8]
                placed[ev["task_id"]] = (pid, tid)
                trace.append({
                    "name": ev.get("name", "task"),
                    "cat": "task",
                    "ph": "X",
                    "ts": s["ts"] * 1e6,
                    "dur": max(0.0, (ev["ts"] - s["ts"]) * 1e6),
                    "pid": pid,
                    "tid": tid,
                    "args": {"status": ev["event"],
                             "trace_id": ev.get("trace_id", ""),
                             "parent_span": ev.get("parent_span", "")},
                })
        if not native:
            return trace
        for s in self.native_spans:
            trace_id = s.get("trace_id", "")
            parent = s.get("parent_span", "")
            if not trace_id and s.get("oid64"):
                ctx = self._oid_trace.get(s["oid64"])
                if ctx is not None:
                    trace_id, parent = ctx
            # Home the span: the submitting task's track when we know
            # it, else the reporting process's own native track.
            home = placed.get(parent) or placed.get(trace_id)
            pid, tid = home if home is not None else (
                s.get("pid", "native"), s.get("tid", "native"))
            args = dict(s.get("args") or {})
            if trace_id:
                args["trace_id"] = trace_id
                args["parent_span"] = parent
            if s.get("oid64"):
                args["oid64"] = s["oid64"]
            trace.append({
                "name": s["name"], "cat": s.get("cat", "native"),
                "ph": "X", "ts": s["ts"], "dur": s.get("dur", 0.0),
                "pid": pid, "tid": tid, "args": args,
            })
        return trace

    # ------------------------------------------------------------------
    # pubsub
    # ------------------------------------------------------------------
    async def pubsub_publish(self, channel: str, event: Any) -> None:
        """Publish an event from anywhere in the cluster (reference: gcs
        pubsub handles external publishers; serve uses this for router
        push-invalidation, channel 'serve_events')."""
        self.pubsub.publish(channel, event)

    @long_poll
    async def pubsub_poll(self, channel: str, from_seq: int,
                          timeout: float = 30.0) -> dict:
        return await self.pubsub.poll(channel, from_seq, min(timeout, 60.0))

    def _publish_actor_event(self, e: "ActorEntry") -> None:
        self._mark_dirty()  # every actor state transition publishes
        self.pubsub.publish("actor_events", {
            "actor_id": e.actor_id, "state": e.state, "addr": e.addr,
            "death_reason": e.death_reason,
            "incarnation": e.restarts_used,
        })

    # ------------------------------------------------------------------
    # node management
    # ------------------------------------------------------------------
    async def register_node(self, node_id: bytes, addr, resources: dict,
                            labels: dict,
                            hosted_actors: Optional[list] = None) -> dict:
        addr = tuple(addr)
        self.nodes[node_id] = NodeEntry(node_id, addr, resources, labels)
        logger.info("node registered %s addr=%s resources=%s",
                    node_id.hex()[:8], addr, resources)
        self.pubsub.publish("node_events", {
            "type": "added", "node_id": node_id, "addr": addr})
        if hosted_actors is not None:
            # RE-registration after a controller restart: the agent tells
            # us which actors it still hosts — any restored-ALIVE actor
            # of this node that ISN'T among them died during the outage
            # (its death report was lost with the old controller).
            hosted = set(hosted_actors)
            for actor in list(self.actors.values()):
                if (actor.node_id == node_id
                        and actor.state == ActorState.ALIVE
                        and actor.actor_id not in hosted):
                    spawn(self._handle_actor_failure(
                        actor, "worker died while controller was down"))
        return {"num_nodes": len(self.nodes)}

    async def heartbeat(self, node_id: bytes, resources_available: dict):
        node = self.nodes.get(node_id)
        if node is None:
            # Fresh controller (restart) that never saw this node: tell
            # the agent to RE-REGISTER (reference: raylets resubscribe on
            # HandleNotifyGCSRestart, node_manager.cc:923).
            return "unknown"
        if node.state == NodeState.DEAD:
            return False  # tells a zombie agent to shut down
        node.last_heartbeat = time.monotonic()
        node.resources_available = resources_available
        return True

    async def report_sched_delta(self, node_id: bytes,
                                 resources_available: dict,
                                 num_leases: int) -> None:
        """graftsched scheduling-delta sync: agents push a coalesced,
        fire-and-forget view of their local resource ledger whenever
        they grant/reclaim leases locally (ray_syncer's shape: deltas
        flow one way, the periodic heartbeat remains the anti-entropy
        backstop). Keeps controller-side spillback picks honest between
        heartbeats without any awaited round-trip on the grant path."""
        t0 = time.perf_counter_ns()
        node = self.nodes.get(node_id)
        if node is None or node.state != NodeState.ALIVE:
            return
        node.resources_available = resources_available
        node.num_leases = num_leases
        self._meta_note("sched", 1, 0, t0)

    async def get_nodes(self) -> list:
        return [{
            "node_id": n.node_id, "addr": n.addr, "state": n.state,
            "resources_total": n.resources_total,
            "resources_available": n.resources_available,
            "labels": n.labels,
        } for n in self.nodes.values()]

    async def drain_node(self, node_id: bytes) -> None:
        await self._mark_node_dead(node_id, "drained")

    async def _mark_node_dead(self, node_id: bytes, reason: str) -> None:
        node = self.nodes.get(node_id)
        if node is None or node.state == NodeState.DEAD:
            return
        node.state = NodeState.DEAD
        self.node_metrics.pop(node_id.hex()[:12], None)  # stop reporting it
        self.pulse.forget(node_id.hex()[:12])
        self.prof.forget_node(node_id.hex()[:12])
        # Conservation fold: attempts open on the node fail with node-
        # death provenance, live objects homed there are freed — the
        # audit after a SIGKILL chaos pass must balance to zero.
        folded = self.trail.node_dead(node_id.hex()[:12], reason)
        logger.warning("node %s dead: %s (trail: %d attempts failed, "
                       "%d objects freed)", node_id.hex()[:8], reason,
                       len(folded["tasks_failed"]),
                       len(folded["objects_freed"]))
        # Actors on the node die (and maybe restart).
        for actor in list(self.actors.values()):
            if actor.node_id == node_id and actor.state in (
                    ActorState.ALIVE, ActorState.PENDING):
                spawn(self._handle_actor_failure(
                    actor, f"node died: {reason}"))
        # Remaining agents learn via their node_events subscription
        # (object copies on that node are gone).
        self.pubsub.publish("node_events", {
            "type": "dead", "node_id": node_id, "addr": node.addr,
            "reason": reason})

    def _pulse_health_pass(self) -> List[tuple]:
        """graftpulse cadence FSM: a node that HAS pulsed and then falls
        silent for pulse_suspect_ticks tick periods becomes *suspect*
        (published so dashboards/CLI surface it before the kill), and
        after pulse_dead_ms of silence it is declared dead — proactive
        detection that beats the heartbeat timeout (default 10s) by an
        order of magnitude. Nodes that never pulsed (pulse disabled or
        old agents) are left to the heartbeat path entirely.

        Returns [(node_id, reason)] to mark dead — the caller awaits
        _mark_node_dead outside this sync pass."""
        period_s = max(0.05, GlobalConfig.pulse_period_ms / 1000)
        suspect_after = GlobalConfig.pulse_suspect_ticks * period_s
        dead_after = GlobalConfig.pulse_dead_ms / 1000
        now = time.monotonic()
        dead: List[tuple] = []
        for node in list(self.nodes.values()):
            if node.state != NodeState.ALIVE:
                continue
            s = self.pulse.series.get(node.node_id.hex()[:12])
            if s is None or not s.pulses:
                continue
            silence = now - s.last_rx_mono
            missed = int(silence / period_s)
            s.missed_ticks = missed
            if silence >= dead_after:
                dead.append((node.node_id,
                             f"pulse silence {silence:.1f}s "
                             f"({missed} ticks missed)"))
            elif silence >= suspect_after:
                if s.health != "suspect":
                    s.health = "suspect"
                    logger.warning("node %s suspect: %d pulses missed",
                                   node.node_id.hex()[:8], missed)
                    self.pubsub.publish("node_events", {
                        "type": "suspect", "node_id": node.node_id,
                        "addr": node.addr, "missed_ticks": missed})
            else:
                s.health = "alive"
        return dead

    async def _health_loop(self) -> None:
        period = GlobalConfig.health_check_period_ms / 1000
        timeout = GlobalConfig.health_check_timeout_ms / 1000
        last_reconcile = time.monotonic()
        while True:
            await asyncio.sleep(period)
            cutoff = time.monotonic() - timeout
            for node in list(self.nodes.values()):
                if node.state == NodeState.ALIVE and node.last_heartbeat < cutoff:
                    await self._mark_node_dead(node.node_id,
                                               "health check timeout")
            for node_id, reason in self._pulse_health_pass():
                await self._mark_node_dead(node_id, reason)
            if time.monotonic() - last_reconcile > 10.0:
                last_reconcile = time.monotonic()
                await self._reconcile_bundles()
            if self._event_exporter is not None:
                self._event_exporter.flush()

    async def _meta_loop(self) -> None:
        """graftmeta tick: sample event-loop lag as this sleep's own
        overshoot (every handler that ran on the loop between two ticks
        is what delayed the wakeup — the exact number that predicts
        heartbeat/pulse starvation), then snapshot all plane meters +
        controller RSS into the bounded tick ring."""
        import os
        from ray_tpu_torch.core._native.graftpulse import proc_rss_bytes
        period = max(0.05, GlobalConfig.meta_tick_ms / 1000)
        pid = os.getpid()
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(period)
            lag_s = time.monotonic() - t0 - period
            self.meta.loop_lag(int(lag_s * 1e9))
            self.meta.tick(proc_rss_bytes(pid))

    async def _reconcile_bundles(self) -> None:
        """Release ORPHANED bundle reservations on agents: a controller
        death between prepare and commit leaves the agent holding
        resources for a PG placement the restored controller re-plans
        elsewhere (reference: gcs_placement_group_scheduler.cc handles
        this with leasing epochs; here the source of truth is the
        controller's CREATED bundle_nodes + in-flight PENDING ids)."""
        pending = {pg.pg_id for pg in self.pgs.values()
                   if pg.state == PGState.PENDING}
        valid: Dict[bytes, list] = {}
        for pg in self.pgs.values():
            for i, node_id in enumerate(pg.bundle_nodes):
                if node_id:
                    valid.setdefault(node_id, []).append((pg.pg_id, i))
        for node in self._alive_nodes():
            try:
                await node.client.call(
                    "reconcile_bundles", valid.get(node.node_id, []),
                    list(pending))
            except Exception:
                pass  # unreachable node: the health check handles it

    # ------------------------------------------------------------------
    # scheduling policy (hybrid pack-then-spread, reference:
    # src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.cc)
    # ------------------------------------------------------------------
    def _alive_nodes(self) -> List[NodeEntry]:
        return [n for n in self.nodes.values() if n.state == NodeState.ALIVE]

    def _pick(self, resources: Dict[str, float],
              exclude: Optional[set] = None,
              strategy: Optional[Any] = None,
              label_selector: Optional[dict] = None
              ) -> Optional[NodeEntry]:
        nodes = [n for n in self._alive_nodes()
                 if (not exclude or n.node_id not in exclude)
                 and labels_match(n.labels, label_selector)]
        if strategy is not None:
            kind = strategy.get("kind") if isinstance(strategy, dict) else None
            if kind == "node_affinity":
                target = strategy["node_id"]
                for n in nodes:
                    if n.node_id == target:
                        if resources_fit(n.resources_available, resources) or \
                                strategy.get("soft"):
                            return n
                return None if not strategy.get("soft") else (
                    self._pick(resources, exclude, None, label_selector))
            if kind == "spread":
                fitting = [n for n in nodes
                           if resources_fit(n.resources_available, resources)]
                if not fitting:
                    return None
                self._node_seq += 1
                return fitting[self._node_seq % len(fitting)]
        threshold = GlobalConfig.scheduler_spread_threshold
        fitting = [n for n in nodes
                   if resources_fit(n.resources_available, resources)]
        if not fitting:
            return None

        def utilization(n: NodeEntry) -> float:
            utils = []
            for k, total in n.resources_total.items():
                if total > 0:
                    utils.append(1 - n.resources_available.get(k, 0) / total)
            return max(utils) if utils else 0.0

        below = [n for n in fitting if utilization(n) < threshold]
        pool = below or fitting
        # Pack: highest utilization first among below-threshold nodes.
        return max(pool, key=utilization)

    async def pick_node(self, resources: dict, exclude=None,
                        strategy=None,
                        label_selector=None) -> Optional[dict]:
        exclude = set(exclude) if exclude else None
        node = self._pick(resources, exclude, strategy, label_selector)
        if node is None:
            # Unsatisfiable demand: the autoscaler's scale-up signal
            # (reference: gcs_autoscaler_state_manager.cc aggregates
            # pending demand for autoscaler v2).
            key = tuple(sorted(resources.items()))
            self._infeasible[key] = (time.time(), dict(resources))
            return None
        return {"node_id": node.node_id, "addr": node.addr}

    async def autoscaler_state(self) -> dict:
        """Demand + supply snapshot for the autoscaler (reference:
        autoscaler/v2 reads GCS autoscaler state)."""
        now = time.time()
        infeasible = [r for ts, r in self._infeasible.values()
                      if now - ts < 30.0]
        for key, (ts, _) in list(self._infeasible.items()):
            if now - ts >= 30.0:
                self._infeasible.pop(key, None)
        pending_actors = [a.resources for a in self.actors.values()
                          if a.state in (ActorState.PENDING,
                                         ActorState.RESTARTING)]
        pending_pg_bundles = [b for pg in self.pgs.values()
                              if pg.state == PGState.PENDING
                              for b in pg.bundles]
        return {
            "infeasible": infeasible,
            "pending_actors": pending_actors,
            "pending_pg_bundles": pending_pg_bundles,
            # graftpulse scaling signals: the slowest per-op p99 across
            # the cluster plus the summed lease queue depth — latency-
            # aware scale-up instead of request counting.
            "native_p99_ms": self.pulse.worst_p99_ns() / 1e6,
            "queue_depth": self.pulse.total_queue_depth(),
            "nodes": [{
                "node_id": n.node_id, "state": n.state,
                "total": n.resources_total,
                "available": n.resources_available,
            } for n in self.nodes.values()],
        }

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    async def create_actor(self, actor_id: bytes, spec_blob: bytes, name: str,
                           max_restarts: int, resources: dict,
                           placement=None, detached: bool = False,
                           runtime_env: Optional[dict] = None,
                           label_selector: Optional[dict] = None) -> dict:
        if name:
            if name in self.named_actors:
                raise ValueError(f"actor name already taken: {name!r}")
            self.named_actors[name] = actor_id
        entry = ActorEntry(actor_id, spec_blob, name, max_restarts, resources,
                           tuple(placement) if placement else None,
                           runtime_env, label_selector)
        self.actors[actor_id] = entry
        self._mark_dirty()
        spawn(self._schedule_actor(entry))
        return {"actor_id": actor_id}

    async def _schedule_actor(self, entry: ActorEntry) -> None:
        # Placement-group bundle affinity pins the target node.
        target: Optional[NodeEntry] = None
        if entry.placement:
            pg = self.pgs.get(entry.placement[0])
            if pg and pg.state == PGState.CREATED:
                node_id = pg.bundle_nodes[entry.placement[1]]
                target = self.nodes.get(node_id)
        attempts = 0
        while attempts < 60:
            node = target or self._pick(
                entry.resources, label_selector=entry.label_selector)
            if node is not None:
                try:
                    reply = await node.client.call(
                        "start_actor", entry.actor_id, entry.spec_blob,
                        entry.resources,
                        entry.placement[0] if entry.placement else None,
                        entry.placement[1] if entry.placement else -1,
                        env_vars=entry.runtime_env.get("env_vars"),
                        # REMAINING restarts: the agent's OOM picker must
                        # not kill an actor whose restart budget is spent.
                        max_restarts=(-1 if entry.max_restarts == -1 else
                                      max(0, entry.max_restarts
                                          - entry.restarts_used)),
                        pip=entry.runtime_env.get("pip"),
                        image_uri=entry.runtime_env.get("image_uri"))
                    entry.addr = tuple(reply["addr"])
                    entry.node_id = node.node_id
                    entry.state = ActorState.ALIVE
                    entry.event.set()
                    self._publish_actor_event(entry)
                    return
                except Exception as e:
                    logger.warning("actor %s failed to start on %s: %r",
                                   entry.actor_id.hex()[:8],
                                   node.node_id.hex()[:8], e)
            attempts += 1
            await asyncio.sleep(0.2)
        entry.state = ActorState.DEAD
        entry.death_reason = "could not schedule actor (no feasible node)"
        entry.event.set()
        self._publish_actor_event(entry)

    async def report_actor_death(self, actor_id: bytes, reason: str) -> None:
        entry = self.actors.get(actor_id)
        if entry is None:
            return
        await self._handle_actor_failure(entry, reason)

    async def _handle_actor_failure(self, entry: ActorEntry, reason: str) -> None:
        if entry.state == ActorState.DEAD:
            return
        if entry.max_restarts == -1 or entry.restarts_used < entry.max_restarts:
            entry.restarts_used += 1
            entry.state = ActorState.RESTARTING
            entry.event = asyncio.Event()
            entry.addr = None
            logger.info("restarting actor %s (%d/%s): %s",
                        entry.actor_id.hex()[:8], entry.restarts_used,
                        entry.max_restarts, reason)
            self._publish_actor_event(entry)
            await self._schedule_actor(entry)
        else:
            entry.state = ActorState.DEAD
            entry.death_reason = reason
            entry.event.set()
            self._publish_actor_event(entry)
            if entry.name:
                self.named_actors.pop(entry.name, None)

    async def kill_actor(self, actor_id: bytes, no_restart: bool = True) -> None:
        entry = self.actors.get(actor_id)
        if entry is None:
            return
        if no_restart:
            entry.max_restarts = entry.restarts_used  # exhaust restarts
        if entry.node_id and entry.addr:
            node = self.nodes.get(entry.node_id)
            if node:
                try:
                    await node.client.call("kill_actor_worker", actor_id)
                except Exception:
                    pass
        if no_restart:
            entry.state = ActorState.DEAD
            entry.death_reason = "killed via kill_actor"
            entry.event.set()
            self._publish_actor_event(entry)
            if entry.name:
                self.named_actors.pop(entry.name, None)

    async def get_actor_info(self, actor_id: bytes) -> Optional[dict]:
        e = self.actors.get(actor_id)
        if e is None:
            return None
        return {"state": e.state, "addr": e.addr, "node_id": e.node_id,
                "death_reason": e.death_reason, "name": e.name}

    @long_poll
    async def wait_actor_ready(self, actor_id: bytes,
                               timeout: float = 120.0) -> dict:
        e = self.actors.get(actor_id)
        if e is None:
            # Registration may be in flight (an owner on its io loop
            # registers asynchronously; borrowed handles can race it):
            # briefly wait for the actor to appear before declaring it
            # unknown.
            deadline = asyncio.get_running_loop().time() + 10.0
            while e is None and \
                    asyncio.get_running_loop().time() < deadline:
                await asyncio.sleep(0.1)
                e = self.actors.get(actor_id)
        if e is None:
            raise KeyError(f"no such actor {actor_id.hex()}")
        while e.state in (ActorState.PENDING, ActorState.RESTARTING):
            try:
                await asyncio.wait_for(e.event.wait(), timeout)
            except asyncio.TimeoutError:
                raise TimeoutError("actor not ready within timeout")
        return {"state": e.state, "addr": e.addr,
                "death_reason": e.death_reason,
                "incarnation": e.restarts_used}

    async def get_actor_by_name(self, name: str) -> Optional[dict]:
        actor_id = self.named_actors.get(name)
        if actor_id is None:
            return None
        info = await self.get_actor_info(actor_id)
        info["actor_id"] = actor_id
        spec = self.actors[actor_id]
        info["spec_blob"] = spec.spec_blob
        return info

    async def list_actors(self) -> list:
        return [{
            "actor_id": e.actor_id, "name": e.name, "state": e.state,
            "node_id": e.node_id, "restarts": e.restarts_used,
        } for e in self.actors.values()]

    # ------------------------------------------------------------------
    # placement groups (2-phase commit; reference:
    # gcs_placement_group_scheduler.cc prepare/commit)
    # ------------------------------------------------------------------
    async def create_placement_group(self, pg_id: bytes, bundles: list,
                                     strategy: str,
                                     bundle_label_selector=None) -> dict:
        # Validate eagerly: an error inside the fire-and-forget scheduler
        # would leave the PG silently PENDING forever.
        if bundle_label_selector is not None and \
                len(bundle_label_selector) != len(bundles):
            raise ValueError("bundle_label_selector must have one entry "
                             "per bundle")
        gang = {k for sel in (bundle_label_selector or []) if sel
                for k, v in sel.items() if v == "$same"}
        if len(gang) > 1:
            raise ValueError("at most one $same gang label per PG")
        pg = PGEntry(pg_id, bundles, strategy, bundle_label_selector)
        self.pgs[pg_id] = pg
        self._mark_dirty()
        if GlobalConfig.graftsched and await self._create_pg_oneop(pg):
            # graftsched fast path landed: the reply carries the state
            # so the caller's ready() resolves locally, no extra RPC.
            return {"pg_id": pg_id, "state": pg.state}
        spawn(self._schedule_pg(pg))
        return {"pg_id": pg_id, "state": pg.state}

    async def _create_pg_oneop(self, pg: PGEntry) -> bool:
        """graftsched one-op PG create: plan synchronously from the
        controller's (delta-synced) resource view, then fold prepare +
        commit into ONE batched agent round per node — the agent applies
        its node's bundles all-or-nothing and rolls back locally, so the
        cross-node 2-phase dance collapses to a single gather. Any
        wrinkle (infeasible plan, a node refusing, RPC failure) rolls
        back whatever committed and returns False so the retrying
        two-phase scheduler takes over unchanged."""
        plan = self._plan_pg(pg)
        if plan is None:
            return False
        per_node: Dict[bytes, list] = {}
        order: List[NodeEntry] = []
        for i, node in enumerate(plan):
            if node.node_id not in per_node:
                per_node[node.node_id] = []
                order.append(node)
            per_node[node.node_id].append((i, pg.bundles[i]))

        async def _one(node: NodeEntry) -> bool:
            try:
                return bool(await node.client.call(
                    "prepare_commit_bundles", pg.pg_id,
                    per_node[node.node_id]))
            except Exception:
                return False

        results = await asyncio.gather(*[_one(n) for n in order])
        removed = self.pgs.get(pg.pg_id) is not pg  # raced a remove
        if all(results) and not removed:
            for node in order:
                for i, _ in per_node[node.node_id]:
                    pg.bundle_nodes[i] = node.node_id
            pg.state = PGState.CREATED
            pg.event.set()
            self._mark_dirty()
            return True
        for node, ok in zip(order, results):  # rollback committed nodes
            if ok:
                try:
                    await node.client.call(
                        "return_bundles", pg.pg_id,
                        [i for i, _ in per_node[node.node_id]])
                except Exception:
                    pass
        if removed:
            pg.state = PGState.REMOVED
            pg.event.set()
            return True  # don't hand a removed PG to the scheduler
        return False

    def _plan_pg(self, pg: PGEntry) -> Optional[List[NodeEntry]]:
        """Choose a node per bundle respecting the strategy and per-bundle
        label selectors; None if infeasible. Selector values of "$same"
        gang all such bundles onto nodes sharing ONE value of that label
        (all-or-nothing — the slice-atomic reservation primitive,
        reference: python/ray/_private/accelerators/tpu.py:145)."""
        selectors = pg.bundle_label_selector or [None] * len(pg.bundles)
        gang_keys = {k for sel in selectors if sel
                     for k, v in sel.items() if v == "$same"}
        if not gang_keys:
            return self._plan_pg_with(pg, selectors)
        key = next(iter(gang_keys))  # validated single at creation
        # Try each concrete value of the ganged label (e.g. each TPU
        # slice name), most total free capacity first.
        free: Dict[str, float] = {}
        for n in self._alive_nodes():
            v = n.labels.get(key)
            if v is not None:
                free[v] = free.get(v, 0.0) + sum(
                    n.resources_available.values())
        values = sorted(free, key=lambda v: -free[v])
        for value in values:
            bound = [dict(sel, **{key: value}) if sel and sel.get(key)
                     == "$same" else sel for sel in selectors]
            plan = self._plan_pg_with(pg, bound)
            if plan is not None:
                return plan
        return None

    def _plan_pg_with(self, pg: PGEntry,
                      selectors: List[Optional[dict]]
                      ) -> Optional[List[NodeEntry]]:
        nodes = self._alive_nodes()
        if not nodes:
            return None
        avail = {n.node_id: dict(n.resources_available) for n in nodes}
        by_id = {n.node_id: n for n in nodes}
        plan: List[NodeEntry] = []
        if pg.strategy in ("STRICT_PACK", "PACK"):
            # Try to fit everything on one node first.
            for n in nodes:
                if not all(labels_match(n.labels, sel)
                           for sel in selectors):
                    continue
                trial = dict(avail[n.node_id])
                if all(resources_fit(trial, b) and
                       (resources_sub(trial, b) or True)
                       for b in pg.bundles):
                    return [n] * len(pg.bundles)
            if pg.strategy == "STRICT_PACK":
                return None
        if pg.strategy == "STRICT_SPREAD" and len(pg.bundles) > len(nodes):
            return None
        used_nodes: set = set()
        for i, bundle in enumerate(pg.bundles):
            placed = None
            candidates = sorted(nodes, key=lambda n: len(
                [p for p in plan if p.node_id == n.node_id]))
            for n in candidates:
                if pg.strategy == "STRICT_SPREAD" and n.node_id in used_nodes:
                    continue
                if not labels_match(n.labels, selectors[i]):
                    continue
                if resources_fit(avail[n.node_id], bundle):
                    resources_sub(avail[n.node_id], bundle)
                    placed = n
                    used_nodes.add(n.node_id)
                    break
            if placed is None:
                return None
            plan.append(placed)
        return [by_id[n.node_id] for n in plan]

    async def _schedule_pg(self, pg: PGEntry) -> None:
        for _ in range(150):  # keep trying while cluster changes
            plan = self._plan_pg(pg)
            if plan is not None:
                # Phase 1: prepare all bundles.
                prepared = []
                ok = True
                for i, node in enumerate(plan):
                    try:
                        got = await node.client.call(
                            "prepare_bundle", pg.pg_id, i, pg.bundles[i])
                        if got:
                            prepared.append((node, i))
                        else:
                            ok = False
                            break
                    except Exception:
                        ok = False
                        break
                if ok:
                    # Phase 2: commit.
                    for node, i in prepared:
                        await node.client.call("commit_bundle", pg.pg_id, i)
                        pg.bundle_nodes[i] = node.node_id
                    pg.state = PGState.CREATED
                    pg.event.set()
                    self._mark_dirty()
                    return
                for node, i in prepared:  # rollback
                    try:
                        await node.client.call("return_bundle", pg.pg_id, i)
                    except Exception:
                        pass
            await asyncio.sleep(0.2)
        pg.state = PGState.REMOVED
        pg.event.set()
        self._mark_dirty()

    @long_poll
    async def wait_pg_ready(self, pg_id: bytes, timeout: float = 60.0) -> str:
        pg = self.pgs.get(pg_id)
        if pg is None:
            raise KeyError("no such placement group")
        if pg.state == PGState.PENDING:
            try:
                await asyncio.wait_for(pg.event.wait(), timeout)
            except asyncio.TimeoutError:
                pass
        return pg.state

    async def remove_placement_group(self, pg_id: bytes) -> None:
        pg = self.pgs.pop(pg_id, None)
        if pg is None:
            return
        self._mark_dirty()
        if GlobalConfig.graftsched:
            # One batched return per node instead of one RPC per bundle.
            per_node: Dict[bytes, list] = {}
            for i, node_id in enumerate(pg.bundle_nodes):
                if node_id:
                    per_node.setdefault(node_id, []).append(i)
            for node_id, indices in per_node.items():
                node = self.nodes.get(node_id)
                if node and node.state == NodeState.ALIVE:
                    try:
                        await node.client.call("return_bundles", pg_id,
                                               indices)
                    except Exception:
                        pass
        else:
            for i, node_id in enumerate(pg.bundle_nodes):
                node = self.nodes.get(node_id) if node_id else None
                if node and node.state == NodeState.ALIVE:
                    try:
                        await node.client.call("return_bundle", pg_id, i)
                    except Exception:
                        pass
        pg.state = PGState.REMOVED

    async def get_pg_info(self, pg_id: bytes) -> Optional[dict]:
        pg = self.pgs.get(pg_id)
        if pg is None:
            return None
        return {"state": pg.state, "bundles": pg.bundles,
                "strategy": pg.strategy, "bundle_nodes": pg.bundle_nodes}

    # ------------------------------------------------------------------
    # KV store (reference: gcs_kv_manager.cc; function table in ns "fn")
    # ------------------------------------------------------------------
    async def kv_put(self, ns: str, key: str, value: bytes,
                     overwrite: bool = True) -> bool:
        space = self.kv.setdefault(ns, {})
        if not overwrite and key in space:
            return False
        space[key] = value
        if ns == "pkg" and self._storage_path:
            # Content-addressed package blobs (up to 100MB) persist as
            # write-once side files — re-pickling them into every 500ms
            # snapshot would swamp the loop.
            self._persist_pkg(key, value)
        else:
            self._mark_dirty()
        return True

    def _pkg_dir(self) -> str:
        return self._storage_path + ".pkgs"

    @staticmethod
    def _valid_pkg_key(key: str) -> bool:
        # Content-addressed sha1 hex only: the key becomes a FILENAME, so
        # anything else (e.g. '../..' traversal) must be rejected.
        return (len(key) == 40
                and all(c in "0123456789abcdef" for c in key))

    def _persist_pkg(self, key: str, value: bytes) -> None:
        import os
        if not self._valid_pkg_key(key):
            logger.warning("rejecting non-sha pkg key %r", key[:64])
            return
        try:
            os.makedirs(self._pkg_dir(), exist_ok=True)
            path = os.path.join(self._pkg_dir(), key)
            if not os.path.exists(path):
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(value)
                os.replace(tmp, path)
        except Exception as e:
            logger.warning("pkg persist failed: %r", e)

    async def kv_get(self, ns: str, key: str) -> Optional[bytes]:
        val = self.kv.get(ns, {}).get(key)
        if val is None and ns == "pkg" and self._storage_path \
                and self._valid_pkg_key(key):
            import os
            path = os.path.join(self._pkg_dir(), key)
            if os.path.exists(path):
                # Package blobs run to many MBs: read off the loop.
                val = await asyncio.get_running_loop().run_in_executor(
                    None, self._read_file_or_none, path)
                if val is not None:
                    self.kv.setdefault(ns, {})[key] = val
        return val

    @staticmethod
    def _read_file_or_none(path: str) -> Optional[bytes]:
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    async def kv_del(self, ns: str, key: str) -> bool:
        self._mark_dirty()
        if ns == "pkg" and self._storage_path and self._valid_pkg_key(key):
            import os
            try:  # the side file must die too or kv_get resurrects it
                os.unlink(os.path.join(self._pkg_dir(), key))
            except OSError:
                pass
        return self.kv.get(ns, {}).pop(key, None) is not None

    async def kv_keys(self, ns: str, prefix: str = "") -> list:
        return [k for k in self.kv.get(ns, {}) if k.startswith(prefix)]

    # ------------------------------------------------------------------
    # jobs / misc
    # ------------------------------------------------------------------
    async def register_job(self, driver_addr) -> bytes:
        job_id = self._next_job.to_bytes(4, "big")
        self._next_job += 1
        self._mark_dirty()
        self.jobs[job_id] = {"driver_addr": tuple(driver_addr),
                             "start_time": time.time(), "state": "RUNNING"}
        return job_id

    async def finish_job(self, job_id: bytes) -> None:
        if job_id in self.jobs:
            self.jobs[job_id]["state"] = "FINISHED"
            self._mark_dirty()

    async def cluster_resources(self) -> dict:
        total: Dict[str, float] = {}
        avail: Dict[str, float] = {}
        for n in self._alive_nodes():
            resources_add(total, n.resources_total)
            resources_add(avail, n.resources_available)
        return {"total": total, "available": avail}

    async def ping(self) -> str:
        return "pong"

    async def shutdown_controller(self) -> None:
        """Terminate the controller process (cli stop's final step)."""
        import sys
        try:
            if self._event_exporter is not None:
                self._event_exporter.flush()  # tail of the JSONL export
        except Exception:
            pass
        try:
            if self._dirty:
                self._snapshot_state()
            self._store.close()
        except Exception:
            pass
        asyncio.get_running_loop().call_later(0.2, sys.exit, 0)

    # ------------------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        server = RpcServer("controller")
        server.register_object(self)
        port = await server.start_tcp(host, port)
        self._server = server
        self._health_task = spawn(self._health_loop())
        if self.meta is not None:
            self._meta_task = spawn(self._meta_loop())
        if self._storage_path:
            spawn(self._persist_loop())
            spawn(self._resume_restored())
        logger.info("controller listening on %s:%d", host, port)
        return port


def main() -> None:
    """Entry point: `python -m ray_tpu_torch.core.controller --port N`."""
    import argparse
    import sys

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args()

    async def run():
        c = Controller()
        port = await c.start(args.host, args.port)
        print(f"CONTROLLER_PORT={port}", flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        sys.exit(0)


if __name__ == "__main__":
    main()
