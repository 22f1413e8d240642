"""State API: programmatic cluster introspection.

Analogue of the reference's state API (reference: python/ray/util/state/
api.py list_nodes/list_actors/list_tasks + dashboard/state_aggregator.py;
`ray list ...` CLI). Sources: controller tables + per-agent stats RPCs.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from ray_tpu_torch import api as _api


def _ctl(method: str, *args, timeout: float = 30.0):
    cw = _api._cw()
    return cw._run(cw.controller.call(method, *args)).result(timeout)


def list_nodes() -> List[dict]:
    out = []
    for n in _ctl("get_nodes"):
        out.append({
            "node_id": n["node_id"].hex()[:12],
            "state": n["state"],
            "addr": f"{n['addr'][0]}:{n['addr'][1]}",
            "resources_total": n["resources_total"],
            "resources_available": n["resources_available"],
            "labels": n["labels"],
        })
    return out


def list_actors() -> List[dict]:
    return [{
        "actor_id": a["actor_id"].hex()[:12],
        "name": a["name"],
        "state": a["state"],
        "node_id": a["node_id"].hex()[:12] if a["node_id"] else "",
        "restarts": a["restarts"],
    } for a in _ctl("list_actors")]


def list_tasks(state: Optional[str] = None, node: Optional[str] = None,
               name: Optional[str] = None, actor: Optional[str] = None,
               limit: int = 100) -> List[dict]:
    """grafttrail task records (one row per task, newest first), filtered
    by FSM state (SUBMITTED/LEASED/RUNNING/FINISHED/FAILED/CANCELLED),
    home node (hex12), function name, or actor id — index intersections
    on the controller, not scans (reference: `ray list tasks`)."""
    return _ctl("trail_tasks", state, node, name, actor, limit)


def list_task_events(limit: int = 1000) -> List[dict]:
    """The raw legacy event stream (submitted/finished/... rows) the
    timeline and event export are derived from."""
    return _ctl("list_task_events", limit)


def get_task(task_id: str) -> Optional[dict]:
    """One task's full trail: attempt chain (per-attempt state, node,
    worker, transition timestamps), root-cause error across retries,
    trace linkage. Accepts a unique task-id hex prefix."""
    return _ctl("trail_task", task_id)


def summary_tasks() -> List[dict]:
    """Per-function rollup: totals, attempts, and per-state counts
    (reference: `ray summary tasks`)."""
    return _ctl("trail_summary")


def list_objects(node: Optional[str] = None, plane: Optional[str] = None,
                 live: Optional[bool] = None,
                 limit: int = 100) -> List[dict]:
    """grafttrail object records with provenance: plane (shm/copy/
    fallback), home node, owner, created/sealed/freed timestamps and
    the freed reason (reference: `ray memory`)."""
    return _ctl("trail_objects", node, plane, live, limit)


def audit(grace_s: Optional[float] = None) -> dict:
    """Machine-checked conservation audit over the trail ledger: every
    non-terminal task live on an alive node, every sealed object freed
    or still resident where the ledger says. Returns {"ok", "lost_tasks",
    "leaked_objects", "complete", "stats"} with per-finding provenance."""
    return _ctl("trail_audit", grace_s)


def list_workers() -> List[dict]:
    """Per-node agent stats (workers, store, spill, event stats). A node
    whose agent can't be reached yields an {"node_id", "error"} row
    instead of silently vanishing from the listing."""
    cw = _api._cw()
    out = []
    for n in _ctl("get_nodes"):
        if n["state"] != "ALIVE":
            continue
        try:
            stats = cw._run(cw._client_for_worker(
                tuple(n["addr"])).call("agent_stats")).result(15)
            stats["node_id"] = stats["node_id"].hex()[:12]
            out.append(stats)
        except Exception as e:
            out.append({"node_id": n["node_id"].hex()[:12],
                        "error": repr(e)})
    return out


def cluster_summary() -> dict:
    res = _ctl("cluster_resources")
    nodes = list_nodes()
    actors = list_actors()
    return {
        "nodes_alive": sum(1 for n in nodes if n["state"] == "ALIVE"),
        "nodes_total": len(nodes),
        "resources_total": res["total"],
        "resources_available": res["available"],
        "actors": sum(1 for a in actors if a["state"] == "ALIVE"),
        "actors_total": len(actors),
    }


def metrics_text() -> str:
    return _ctl("metrics_text")


def cluster_telemetry(window: int = 30) -> dict:
    """The graftpulse cluster SLO view: per-op p50/p99 + throughput
    folded over every node's recent pulses, per-node occupancy and
    pulse health (alive/suspect/no-pulse), resident totals, and the
    controller's membership/actor counts. `window` bounds how many
    recent pulses per node feed the aggregates."""
    return _ctl("cluster_telemetry", window)


def meta_snapshot(window: int = 60) -> dict:
    """The graftmeta self-telemetry view: per-plane ingest records/s +
    bytes/s and fold-latency p50/p99 over the last `window` meta ticks,
    controller event-loop lag, controller RSS, and per-store occupancy
    (caps, evictions, dedup hits). {"enabled": False} when the meter is
    off (RAY_TPU_TORCH_GRAFTMETA=0)."""
    return _ctl("meta_snapshot", window)


def report_soak(status: dict) -> None:
    """Push a running soak's status blob to the controller (graftload's
    1 Hz reporter). Shows up as `soak` in cluster_telemetry() / the
    dashboard /api/cluster view while fresh."""
    _ctl("report_soak", status)


def cluster_metrics_text() -> str:
    """Federated Prometheus exposition: every node's registry plus the
    pulse-derived raytpu_cluster_* aggregates (served at
    /metrics/cluster on the dashboard)."""
    return _ctl("cluster_metrics_text")


def native_latency() -> List[dict]:
    """Hot-path latency rollup over the graftscope native spans the
    controller retains: per span name (rpc.wire, sidecar.put, ...),
    count / mean µs / max µs."""
    return _ctl("native_latency")


def timeline(filename: Optional[str] = None,
             native: bool = True, fmt: str = "events") -> List[dict]:
    """Chrome-trace events for every recorded task — plus, with
    ``native`` (default), the graftscope native-plane spans (dispatch,
    wire, sidecar service, copy) nested under the submitting task. Pass
    filename to dump JSON loadable in chrome://tracing / Perfetto
    (reference: `ray timeline`). The dump is atomic (tmp + rename): a
    crash or concurrent reader never sees a torn file.

    fmt="chrome" writes the Chrome trace-event FORMAT object
    ({"traceEvents": [...]} with integer pid/tid plus process_name/
    thread_name metadata) instead of the raw event array — the shape
    Perfetto's UI ingests directly. The returned value is always the
    raw event list."""
    trace = _ctl("timeline", native)
    if filename:
        payload = to_chrome_trace(trace) if fmt == "chrome" else trace
        tmp = filename + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, filename)
    return trace


def to_chrome_trace(events: List[dict]) -> dict:
    """Convert the raw timeline event array to Chrome trace-event
    format: integer pid/tid (the controller emits string track names),
    "M" metadata events naming each process/thread, and the
    {"traceEvents": ...} envelope chrome://tracing and Perfetto expect.
    Pure function — unit-testable without a cluster."""
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    out: List[dict] = []
    meta: List[dict] = []
    for ev in events:
        pname, tname = str(ev.get("pid", "?")), str(ev.get("tid", "?"))
        if pname not in pids:
            pids[pname] = len(pids) + 1
            meta.append({"name": "process_name", "ph": "M",
                         "pid": pids[pname], "tid": 0,
                         "args": {"name": pname}})
        pid = pids[pname]
        tkey = (pname, tname)
        if tkey not in tids:
            tids[tkey] = len(tids) + 1
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": pid, "tid": tids[tkey],
                         "args": {"name": tname}})
        row = dict(ev)
        row["pid"] = pid
        row["tid"] = tids[tkey]
        out.append(row)
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def stack(node_id: Optional[str] = None,
          profile_s: float = 0.0) -> dict:
    """Python stack traces of every worker on every (or one) node — the
    hung-worker debugger (reference: `ray stack`, scripts.py:2706 via
    py-spy; here the worker's own stacks RPC with a SIGUSR1/faulthandler
    fallback for wedged event loops). Returns
    {node_id_hex: {pid: {stacks, via, worker_id, actor}}}.

    profile_s > 0 folds that many seconds of graftprof samples per
    worker instead of taking a single snapshot (`ray_tpu stack
    --profile N`) and attaches per-thread native CPU times (the
    sidecar threads included)."""
    from ray_tpu_torch import api
    cw = api._cw()
    profile_s = min(max(0.0, float(profile_s or 0.0)), 30.0)
    out = {}
    for n in list_nodes():
        nid = n["node_id"]
        if node_id and not nid.startswith(node_id):
            continue
        if n.get("state") != "ALIVE":
            continue
        host, port = n["addr"].rsplit(":", 1)
        try:
            agent = cw._client_for_worker((host, int(port)))
            out[nid] = cw._run(agent.call(
                "dump_stacks", profile_s)).result(30 + profile_s)
        except Exception as e:
            out[nid] = {"error": repr(e)}
    return out


# ---------------------------------------------------------------------------
# graftprof (continuous profiling)
# ---------------------------------------------------------------------------

def prof_top(task: Optional[str] = None, actor: Optional[str] = None,
             node: Optional[str] = None, seconds: Optional[float] = None,
             limit: int = 30) -> dict:
    """Hottest frames from the always-on graftprof plane: per frame,
    self samples (leaf) and cumulative samples (anywhere on stack).
    Filters: task id prefix OR exact task name, actor id prefix, node
    hex12; `seconds` restricts to recent windows instead of the merged
    per-task folds (reference contrast: Ray attaches py-spy on demand;
    here profiles are already on the controller)."""
    return _ctl("prof_top", task, actor, node, seconds, limit)


def prof_flame(task: Optional[str] = None, actor: Optional[str] = None,
               node: Optional[str] = None,
               seconds: Optional[float] = None) -> dict:
    """d3-flamegraph nested JSON ({name, value, children}) for the
    selected profiles (same filters as prof_top)."""
    return _ctl("prof_flame", task, actor, node, seconds)


def prof_collapsed(task: Optional[str] = None,
                   actor: Optional[str] = None,
                   node: Optional[str] = None,
                   seconds: Optional[float] = None) -> List[str]:
    """Brendan-Gregg collapsed stacks ("a;b;c N" lines) — feed to any
    external flamegraph.pl-compatible tool."""
    return _ctl("prof_collapsed", task, actor, node, seconds)


def prof_task_stats(task_id: str) -> Optional[dict]:
    """One task's profile accounting: samples, on-CPU ns, GIL-wait ns
    (the `ray_tpu get task` join). Accepts a task-id hex prefix."""
    return _ctl("prof_task_stats", task_id)


def prof_stats() -> dict:
    """ProfStore occupancy: nodes, tracked tasks, total samples,
    drops reported by worker rings."""
    return _ctl("prof_stats")


def list_logs(task: Optional[str] = None, actor: Optional[str] = None,
              node: Optional[str] = None, level: int = 0,
              since_ns: int = 0, after_id: int = 0,
              limit: int = 100) -> List[dict]:
    """Cluster log records from the graftlog plane, time-ordered.
    Filters: task id hex prefix, actor id prefix, node hex12, minimum
    logging level (e.g. 30 for WARNING+), wall-clock floor (ns).
    ``after_id`` is the follow cursor: pass the last row's ``id`` to
    fetch only newer records (the `ray_tpu logs -f` loop). Salvaged
    rows (``salvaged: true``) are a dead worker's final lines,
    recovered from its crash-persistent ring."""
    return _ctl("list_logs", task, actor, node, level, since_ns,
                after_id, limit)


def log_stats() -> dict:
    """LogStore occupancy and storm-control counters: records, cap,
    ingested/suppressed/deduped/evicted/salvaged, per-level mix."""
    return _ctl("log_stats")
