"""Flag/config system for ray_tpu_torch (a copy of ray_tpu's).

Analogue of the reference's X-macro ``RAY_CONFIG`` system
(reference: src/ray/common/ray_config_def.h — 223 flags, each overridable via a
``RAY_<name>`` env var) and the Python-side constants
(python/ray/_private/ray_constants.py).

Here a single declarative registry defines every flag with a type and default;
every flag is overridable via ``RAY_TPU_TORCH_<NAME>`` environment variables, and a
serialized config dict can be passed down to spawned node processes (the
reference passes ``--config-list`` at process spawn; we pass a JSON blob).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_TORCH_"


def _parse_bool(v: str) -> bool:
    return v.lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
}


@dataclass
class _Flag:
    name: str
    type: type
    default: Any
    doc: str = ""


_REGISTRY: Dict[str, _Flag] = {}


def _flag(name: str, typ: type, default: Any, doc: str = "") -> None:
    _REGISTRY[name] = _Flag(name, typ, default, doc)


# ---------------------------------------------------------------------------
# Flag definitions (mirrors the spirit of ray_config_def.h; grouped by area).
# ---------------------------------------------------------------------------

# --- core timeouts / intervals ---
_flag("health_check_period_ms", int, 1000, "Controller->node health-check period.")
_flag("health_check_timeout_ms", int, 10000, "Mark node dead after this long without a heartbeat.")
_flag("resource_broadcast_period_ms", int, 100, "Node resource gossip period.")
_flag("handler_warning_timeout_ms", int, 1000, "Warn on event-loop handlers slower than this.")
_flag("worker_register_timeout_s", int, 30, "Worker must register with its node agent within this.")
_flag("task_retry_delay_ms", int, 100, "Delay before retrying a failed task.")

# --- object store ---
_flag("object_store_memory_bytes", int, 2 * 1024**3, "Default shm arena size per node.")
_flag("store_fastpath", bool, True, "Native store sidecar: workers do put/get over a C unix-socket path (no event loop); falls back to agent RPC when off or unavailable.")
_flag("data_memory_budget_bytes", int, 0, "Streaming Data executor byte budget for in-flight blocks; 0 = auto (object store / 4).")
_flag("container_run_template", str, '["podman", "run", "--rm", "--network=host", "-v", "{session_dir}:{session_dir}", "-v", "/dev/shm:/dev/shm", "{memory_flags}", "{env_flags}", "{image}", "python3", "-m", "ray_tpu_torch.core.worker_main"]', "JSON argv template for image_uri runtime envs ({image}/{session_dir}/{env_flags}/{memory_flags} placeholders); swap for docker or a test stub.")
_flag("runtime_env_cache_bytes", int, 10 * 1024**3, "LRU size cap for cached runtime-env venvs per session; oldest unused evict first.")
_flag("object_store_min_spill_bytes", int, 100 * 1024**2, "Batch spills until this many bytes.")
_flag("max_direct_call_object_size", int, 100 * 1024, "Inline results smaller than this in-process.")
_flag("object_transfer_chunk_bytes", int, 5 * 1024**2, "Chunk size for node-to-node object transfer.")
_flag("max_concurrent_object_pulls", int, 4, "Active inbound object transfers per node; excess pulls queue by priority (reference: pull_manager.cc bandwidth-bounded active pulls).")
_flag("object_spill_dir", str, "", "Directory for spilled objects (default: session dir).")

# --- dispatch plane (graftrpc) ---
_flag("graftrpc", bool, True, "Native dispatch plane for the actor-call hot path: co-located workers exchange push_task_batch frames over the C reactor (csrc/rpc_core.cc) instead of the asyncio RpcServer; falls back to the asyncio path when off or the native library is unavailable.")

# --- copy plane (graftcopy) ---
_flag("graftcopy", bool, True, "Native put plane: fused sidecar OP_PUT (O_TMPFILE+linkat staging, oid-derived names) with large copies routed through the csrc/copy_core.cc scatter engine; falls back to the pwritev + OP_INGEST path when off or the native library is unavailable.")
_flag("graftcopy_threads", int, 0, "Copy-engine worker threads for scatter writes; 0 = auto (host cores - 1, so 1-core hosts run sequentially on the calling thread).")
_flag("graftcopy_min_bytes", int, 16 * 1024**2, "Route puts at least this large through the native scatter engine; smaller payloads use one os.pwritev (a pool handoff costs more than it saves).")
_flag("put_executor_offload_bytes", int, 4 * 1024**2, "Loop-path puts larger than this copy on the default executor instead of the event loop; the same knob caps the legacy (graftcopy-off) synchronous fast-put path.")
_flag("graftcopy_scratch_max_bytes", int, 2 * 1024**3, "Per-worker staging-inode recycling cap: the put plane keeps one private hardlink ('scratch-<pid>') to its last staging file so a delete drops only the store's name and the next put of at most this size rewrites the same hot tmpfs pages (cold page allocation halves write bandwidth); 0 disables recycling.")
_flag("graftcopy_deferred_ack", bool, True, "Deferred-ack small puts: sub-graftshm_min_bytes graftcopy puts send their OP_PUT and return without reading the reply (the sidecar processes in order, so the object is visible to every later op); the ack rides the next client op and a failed adoption is repaired through the spill-capable agent path. Off = every put blocks on its reply.")

# --- shared-memory object plane (graftshm) ---
_flag("graftshm", bool, True, "Store-owned shared-memory put plane: OP_CREATE hands the worker a slab fd over SCM_RIGHTS, SerializedValue serializes in place through the mapping, OP_SEAL publishes — no staging file, no bulk copy phase. Falls back to the graftcopy path when off, the native library is unavailable, fd-passing fails, or the allocation cannot fit (ENOSPC).")
_flag("graftshm_min_bytes", int, 1024**2, "Route puts at least this large through the shm create/seal plane; smaller payloads keep the single-round-trip OP_PUT (create+seal costs two round-trips, which dominates below ~1 MiB).")

# --- scheduling ---
_flag("scheduler_spread_threshold", float, 0.5, "Hybrid policy: pack below this utilization, then spread.")
_flag("max_pending_lease_requests_per_class", int, 8, "Pipelined lease requests per scheduling class (aligned with worker_pool_max_idle_workers so steady-state bursts cause no worker churn).")
_flag("lease_queue_wait_ms", int, 1000, "Server-side park time for an unsatisfiable lease request before the client must re-request (kills client-side poll loops).")
_flag("worker_lease_pipeline_depth", int, 16, "Task pushes kept in flight per leased worker (hides RPC latency; execution on the worker stays serial).")
_flag("worker_pool_max_idle_workers", int, 8, "Idle workers kept warm per node.")
_flag("worker_prestart", int, 0, "Workers to spawn at agent startup (reference: worker_pool.cc PrestartWorkers) — warm pools make burst workloads spawn-free.")
_flag("locality_min_bytes", int, 128 * 1024, "Stored-arg bytes on a node before a task prefers leasing there (reference: lease_policy.cc locality-aware scheduling).")
_flag("worker_pool_idle_ttl_s", int, 300, "Kill idle workers after this long.")
_flag("graftsched", bool, True, "Lease-based scheduling fast path (graftsched): lease waves are granted in ONE batched agent RPC per wave (reference: cluster_lease_manager.cc grants locally, ray_syncer broadcasts the delta), drained lease runners park on a keep-alive TTL instead of returning the lease per burst, the agent syncs the controller with coalesced fire-and-forget resource deltas, and one-round placement-group create/remove folds prepare+commit into a single agent op per node. RAY_TPU_TORCH_GRAFTSCHED=0 restores the per-op legacy paths.")
_flag("graftsched_inline_bytes", int, 8192, "Small-object provenance threshold: results/puts at or under this size that ride inline in the reply frame (never touching the store) get owner-attested grafttrail object events on the 'inline' plane so `audit` still balances; larger inline objects stay untracked as before.")
_flag("graftsched_keepalive_ms", int, 250, "Lease keep-alive: a drained lease runner holds its leased worker this long waiting for new same-class tasks before returning the lease (kills the request/return round-trip pair between bursts). 0 returns leases eagerly (legacy).")
_flag("sched_delta_ms", int, 20, "Coalescing window for the agent's fire-and-forget scheduling-delta sync to the controller (lease grants/returns between heartbeats); keeps spillback picks fresh without per-grant RPCs.")

# --- streaming generators ---
_flag("streaming_generator_backpressure_items", int, 16, "Yielded-but-unconsumed items before the producer stalls (reference: generator_waiter.cc backpressure).")

# --- fault tolerance ---
_flag("reply_ref_grace_s", int, 600, "Fallback window for proxy borrows on refs forwarded in task replies; a live receiver acks long before this, so it only bounds leaks when the receiver died.")
_flag("max_task_retries_default", int, 3, "Default retries for retriable tasks.")
_flag("actor_max_restarts_default", int, 0, "Default actor restarts.")
_flag("lineage_pinning_enabled", bool, True, "Pin lineage for object reconstruction.")
_flag("gcs_storage_path", str, "", "Controller durable-state path: empty = in-memory; *.db/*.sqlite = sqlite store (put on shared storage for head failover); else a pickle snapshot file (the reference's Redis-backed GCS fault tolerance analogue).")
_flag("gcs_storage_allow_empty_start", bool, False, "Override: let the controller start with EMPTY in-memory state when the configured gcs_storage_path fails to open. Default off — an unopenable durable store fails fast instead of silently 'restoring' an empty cluster (the reference's redis-backed GCS does the same).")

# --- worker isolation (reference: src/ray/common/cgroup2/) ---
_flag("cgroup_isolation", bool, True, "Put dedicated actor workers with memory/CPU requests into cgroup v2 scopes when the unified hierarchy is writable.")
_flag("worker_rlimit_memory", bool, False, "Fallback when cgroups are unavailable: cap a dedicated worker's heap (RLIMIT_DATA) at its 'memory' resource request.")

# --- memory monitor / OOM (reference: src/ray/common/memory_monitor.h + raylet/worker_killing_policy.cc) ---
_flag("memory_monitor_refresh_ms", int, 500, "Node memory poll period; 0 disables OOM killing.")
_flag("memory_usage_threshold", float, 0.95, "Kill a worker when node memory use exceeds this fraction.")
_flag("memory_monitor_test_file", str, "", "Test seam: read memory usage fraction from this file instead of /proc/meminfo.")

# --- chaos / testing (reference: src/ray/rpc/rpc_chaos.cc, RAY_testing_rpc_failure) ---
_flag("testing_rpc_failure", str, "", "Comma list 'method=prob' to randomly fail RPCs.")
_flag("testing_event_loop_delay_us", int, 0, "Inject delay into event-loop handlers (asio-delay analogue).")

# --- GPU / accelerator plane ---
_flag("gpus_per_host", int, 0, "Explicit GPU count (0 = auto-detect from CUDA_VISIBLE_DEVICES, then /dev/nvidia*).")
_flag("gpu_visible_ids", str, "", "Comma list of device ordinals the agent may hand out (CUDA_VISIBLE_DEVICES-style filter).")
_flag("collective_cpu_fallback", bool, True, "Allow CPU fallback collectives when no GPU present.")
_flag("cross_slice_device_dma", bool, False, "Let the PJRT transfer plane pull device objects ACROSS slice boundaries. Off (default): cross-slice device_get host-relays through the object plane (device->host->DCN RPC->device), the safe path when slices share no ICI/DMA domain.")

# --- logging / observability ---
_flag("event_export_path", str, "", "JSONL sink for structured lifecycle events (node/actor/job/serve pubsub + task transitions); empty disables (reference: export-API aggregator pipeline).")
_flag("log_to_driver", bool, True, "Stream worker stdout/stderr lines to the driver via the controller log_events channel. NOTE: the channel is cluster-global (no per-job scoping yet); multiple concurrent drivers see each other's worker output.")
_flag("event_stats_enabled", bool, True, "Record per-handler event-loop stats.")
_flag("task_events_batch_size", int, 1000, "Task events per batch sent to controller.")
_flag("metrics_report_period_ms", int, 5000, "Metrics push period.")
_flag("graftscope", bool, True, "Native-plane flight recorder (graftscope): per-thread ring buffers in the graftrpc/graftcopy/sidecar hot paths, drained into metrics and the stitched timeline. RAY_TPU_TORCH_GRAFTSCOPE=0 disables recording everywhere (Python seam and C planes read the same env).")
_flag("graftpulse", bool, True, "Cluster telemetry plane (graftpulse): each node agent ships a fixed-schema pulse (scope counter deltas + log2 latency histograms + store/shm/worker stats) to the controller every tick; the controller folds them into SLO time series, health state and autoscaling signals. RAY_TPU_TORCH_GRAFTPULSE=0 disables assembly and shipping.")
_flag("pulse_period_ms", int, 1000, "graftpulse tick period: one pulse per node per tick.")
_flag("pulse_suspect_ticks", int, 2, "Missed pulses before the controller marks a node suspect.")
_flag("pulse_dead_ms", int, 8000, "Pulse silence before a suspect node is declared dead (actors restarted, owned objects re-resolved). Heartbeat liveness still applies independently.")
_flag("pulse_history", int, 300, "Pulse samples retained per node in the controller ring buffer.")
_flag("event_buffer_max", int, 4096, "Max buffered (unflushed) events in the exporter; beyond this the oldest are dropped and counted in the events_dropped gauge.")
_flag("grafttrail", bool, True, "State-observability plane (grafttrail): workers emit per-attempt task lifecycle transitions (SUBMITTED/LEASED/RUNNING/FINISHED/FAILED/CANCELLED) and agents export the store journal as object provenance; batches ride the worker flush tick and a fire-and-forget agent->controller path into the indexed controller ledger behind `ray_tpu list/summary/get/audit`. RAY_TPU_TORCH_GRAFTTRAIL=0 falls back to the legacy submitted/finished/failed pipeline.")
_flag("trail_flush_ms", int, 1000, "grafttrail agent->controller batch period.")
_flag("trail_task_cap", int, 20000, "Task records retained in the controller trail ledger (terminal records evict first; drops are counted).")
_flag("trail_object_cap", int, 50000, "Object records retained in the controller trail ledger (freed records evict first; drops are counted).")
_flag("trail_audit_grace_s", float, 300.0, "Audit grace: a non-terminal task with no transition for this long counts as lost.")
_flag("autoscale_p99_ms", float, 0.0, "Scale up when the cluster-wide native op p99 (from graftpulse histograms) exceeds this many milliseconds while work is queued; 0 disables the latency signal.")
_flag("graftprof", bool, True, "Continuous profiling plane (graftprof): a native per-process sampler snapshots registered-thread CPU time and GIL-acquire latency while a Python wall-stack sampler folds task-attributed flamegraph profiles; deltas ride the worker flush tick to the controller store behind `ray_tpu prof top/flame`. RAY_TPU_TORCH_GRAFTPROF=0 disables both samplers (Python seam and C sampler read the same env).")
_flag("prof_hz", int, 67, "graftprof sampling rate (ticks/s) for both the native CPU/GIL sampler and the Python wall-stack sampler. Off-round by default so the tick train can't alias the 2 s flush or the 1 s pulse.")
_flag("prof_history", int, 120, "Profile flush windows retained per node in the controller ProfStore (the `prof top --seconds` query window).")
_flag("prof_task_cap", int, 512, "Distinct (task, actor) merged profiles retained in the controller ProfStore (LRU eviction).")
_flag("prof_stack_cap", int, 256, "Distinct folded stacks retained per task profile (coldest evicted on merge).")
_flag("graftlog", bool, True, "Crash-persistent log plane (graftlog): every worker and agent appends task-attributed log records (logger calls + captured stdout/stderr) to a MAP_SHARED logring-<pid> file in the store dir; agents tail the rings into the controller LogStore and salvage a dead worker's final lines into its grafttrail attempt record. RAY_TPU_TORCH_GRAFTLOG=0 disables emit, tailing and salvage (Python seam and C emit path read the same env).")
_flag("log_flush_ms", int, 1000, "graftlog agent tick: ring-tail and batch-ship period.")
_flag("log_cap", int, 20000, "Log records retained in the controller LogStore (oldest sub-WARNING records evict first; salvaged records last).")
_flag("log_rate_per_s", float, 200.0, "Per-worker sustained ingest cap at the controller LogStore (token bucket, 2x burst); suppressed records are counted, salvage bypasses.")
_flag("log_dedup_window_s", float, 5.0, "Error-storm dedup: an identical (node, pid, task, message) inside this window bumps a repeats counter instead of storing a new record.")
_flag("log_tail_lines", int, 200, "Ring records salvaged from a dead worker's logring file and attached (last 20) to its grafttrail attempt record.")
_flag("log_file_max_bytes", int, 16 << 20, "Rotation threshold for session logs/<component>-<pid>.log files (0 = unbounded legacy behavior).")
_flag("log_file_backups", int, 3, "Rotated session log files kept per component.")
_flag("graftmeta", bool, True, "Plane self-telemetry (graftmeta): the controller meters every observability plane's own fold path — per-plane ingest records/s and bytes/s, fold-latency log2 histograms, store occupancy/eviction/dedup counters, event-loop lag, controller RSS — in a bounded ring behind /api/meta, /metrics/cluster gauges and `ray_tpu status --planes`. RAY_TPU_TORCH_GRAFTMETA=0 disables the meter (handlers skip the timing wrap).")
_flag("meta_history", int, 600, "Meta-plane ticks retained in the controller self-telemetry ring (one tick per meta_tick_ms).")
_flag("meta_tick_ms", int, 1000, "graftmeta tick period: loop-lag probe + RSS sample + counter snapshot per tick.")
_flag("meta_span_min_us", int, 1000, "Plane folds at least this slow emit a controller-side 'meta.fold.<plane>' span into the native timeline (`timeline --native`); 0 disables span emission.")
_flag("log_shards", int, 8, "Controller LogStore shards (node-hash partitioned, per-shard lock and eviction); 1 restores the single-store layout.")
_flag("prof_shards", int, 8, "Controller ProfStore shards (node-hash partitioned ingest, merged on query); 1 restores the single-store layout.")


class Config:
    """Process-global config singleton (thread-safe lazy resolution).

    Resolution order: explicit overrides (``initialize``) > ``RAY_TPU_TORCH_*`` env
    var > registered default.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._overrides: Dict[str, Any] = {}
        self._cache: Dict[str, Any] = {}

    def initialize(self, overrides: Dict[str, Any] | None = None) -> None:
        with self._lock:
            if overrides:
                unknown = set(overrides) - set(_REGISTRY)
                if unknown:
                    raise ValueError(f"Unknown config flags: {sorted(unknown)}")
                self._overrides.update(overrides)
            self._cache.clear()

    def get(self, name: str) -> Any:
        try:
            return self._cache[name]
        except KeyError:
            pass
        flag = _REGISTRY[name]
        with self._lock:
            if name in self._overrides:
                val = self._overrides[name]
            else:
                env = os.environ.get(_ENV_PREFIX + name.upper())
                val = _PARSERS[flag.type](env) if env is not None else flag.default
            self._cache[name] = val
            return val

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in _REGISTRY:
            raise AttributeError(f"No such config flag: {name}")
        return self.get(name)

    # --- serialization for spawned processes ---
    def serialize(self) -> str:
        with self._lock:
            return json.dumps(self._overrides)

    @staticmethod
    def deserialize_into_env(blob: str) -> Dict[str, str]:
        """Return env-var dict encoding the overrides for a child process."""
        overrides = json.loads(blob) if blob else {}
        return {
            _ENV_PREFIX + k.upper(): str(int(v) if isinstance(v, bool) else v)
            for k, v in overrides.items()
        }

    def all_flags(self) -> Dict[str, Any]:
        return {name: self.get(name) for name in _REGISTRY}


GlobalConfig = Config()
