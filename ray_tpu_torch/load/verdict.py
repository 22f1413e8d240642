"""The verdict engine: machine-checked SLOs read from the planes.

This is the observability payoff — after a soak the run is judged
entirely from what the five native planes recorded, not from generator-
side bookkeeping alone:

    graftpulse  — bounded worst-op p99 over the recent pulse window; no
                  silent nodes (every ALIVE node pulsing; every DEAD
                  node one chaos killed on purpose)
    grafttrail  — conservation audit: zero lost tasks, zero leaked
                  objects, across every injected kill
    graftlog    — a salvaged crash tail surfaced for every killed
                  worker AND attached to the killed task's trail record
    graftscope  — the timeline reconstructs every failure window (events
                  overlap each kill's [kill, recovery] interval)

Each check emits one JSON-able row with an explicit `ok` plus the
numbers it judged, so BENCH_LOAD.json diffs like BENCH_CORE.json does.
"""

from __future__ import annotations

from typing import List

from ray_tpu_torch.load.chaos import ChaosRecord
from ray_tpu_torch.load.scenario import SLOSpec, SoakSpec


def workload_verdict(summary: dict, slo: SLOSpec) -> dict:
    """Fold SLO pass/fail into one workload summary row."""
    reasons = []
    n = summary["requests"]
    frac = summary["completed"] / n if n else 1.0
    if frac < slo.min_completion_frac:
        reasons.append(f"completion {frac:.2f} < "
                       f"{slo.min_completion_frac}")
    if summary["error_frac"] > slo.max_error_frac:
        reasons.append(f"error_frac {summary['error_frac']} > "
                       f"{slo.max_error_frac}")
    p99 = summary["p99_ms"]
    if p99 == p99 and p99 > slo.workload_p99_ms:  # NaN-safe
        reasons.append(f"p99 {p99}ms > {slo.workload_p99_ms}ms")
    return dict(summary, row="workload", slo_ok=not reasons,
                slo_fail_reasons=reasons)


def chaos_rows(records: List[ChaosRecord], slo: SLOSpec) -> List[dict]:
    """One row per injected fault: what it hit and how fast the planes
    reacted (salvage latency for worker kills, pulse-silence detection
    for node kills)."""
    rows = []
    for r in records:
        ok = r.ok and (r.recovery_s < 0
                       or r.recovery_s <= slo.recovery_s)
        rows.append({
            "row": "chaos", "kind": r.kind, "at_s": round(r.at_s, 2),
            "pid": r.pid, "node": r.node,
            "recovery_s": round(r.recovery_s, 3),
            "salvaged_tasks": r.salvaged_tasks,
            "ok": ok, "detail": r.detail,
        })
    return rows


def _pulse_verdicts(spec: SoakSpec, records: List[ChaosRecord]
                    ) -> List[dict]:
    from ray_tpu_torch import state
    slo = spec.slo
    t = state.cluster_telemetry(window=slo.pulse_window)
    worst_op, worst_p99 = "", 0.0
    for op, v in (t.get("ops") or {}).items():
        if v.get("p99_ns", 0) > worst_p99:
            worst_op, worst_p99 = op, v["p99_ns"]
    p99_ms = worst_p99 / 1e6
    rows = [{
        "row": "verdict", "check": "pulse_p99_bounded",
        "ok": p99_ms <= slo.pulse_p99_ms,
        "worst_op": worst_op, "p99_ms": round(p99_ms, 3),
        "budget_ms": slo.pulse_p99_ms, "window": slo.pulse_window,
    }]
    # Silent-node check: ALIVE but not pulsing is a gap; DEAD is only
    # acceptable when a chaos action owns that node.
    killed = {r.node for r in records
              if r.kind == "kill_node" and r.node}
    silent, orphan_dead = [], []
    for hex_id, n in (t.get("nodes") or {}).items():
        node_state = str(n.get("state", ""))
        if "ALIVE" in node_state and n.get("health") != "alive":
            silent.append({"node": hex_id, "health": n.get("health")})
        if "DEAD" in node_state and hex_id not in killed:
            orphan_dead.append(hex_id)
    rows.append({
        "row": "verdict", "check": "no_silent_nodes",
        "ok": not silent and not orphan_dead,
        "silent": silent, "unexplained_dead": orphan_dead,
        "intentionally_killed": sorted(killed),
    })
    return rows


def _audit_verdict() -> dict:
    from ray_tpu_torch import state
    report = state.audit()
    return {
        "row": "verdict", "check": "trail_audit_clean",
        "ok": bool(report["ok"]),
        "lost_tasks": len(report["lost_tasks"]),
        "leaked_objects": len(report["leaked_objects"]),
        "complete": report["complete"],
        "stats": report["stats"],
    }


def _salvage_verdict(records: List[ChaosRecord]) -> dict:
    """Every worker kill must have produced salvaged rows (checked at
    kill time by the scheduler) AND the killed task's trail record must
    carry the salvaged tail — the cross-plane join (graftlog x
    grafttrail) that makes a kill post-mortemable."""
    from ray_tpu_torch import state
    kills = [r for r in records if r.kind == "kill_worker"]
    missing_tails, checked = [], 0
    for r in kills:
        for tid in r.salvaged_tasks:
            checked += 1
            try:
                detail = state.get_task(tid)
            except Exception:
                detail = None
            if not detail or not detail.get("log_tail"):
                missing_tails.append({"pid": r.pid, "task": tid})
    ok = (all(r.ok and r.salvaged_tasks for r in kills)
          and not missing_tails)
    return {
        "row": "verdict", "check": "salvage_tails_attached",
        "ok": ok if kills else True, "worker_kills": len(kills),
        "tasks_with_tails": checked - len(missing_tails),
        "missing_tails": missing_tails,
        "kills_without_salvage": [r.pid for r in kills
                                  if not r.salvaged_tasks],
    }


def _timeline_verdict(records: List[ChaosRecord],
                      slo: SLOSpec) -> dict:
    """graftscope must reconstruct each failure window: at least one
    timeline event (task slice or native span, ts in wall-clock µs)
    overlapping [kill - 2s, kill + recovery + 2s]."""
    from ray_tpu_torch import state
    events = state.timeline(native=True)
    kills = [r for r in records
             if r.kind in ("kill_worker", "kill_node") and r.t_wall_ns]
    windows = []
    for r in kills:
        t_us = r.t_wall_ns / 1e3
        rec = r.recovery_s if r.recovery_s > 0 else slo.recovery_s
        lo, hi = t_us - 2e6, t_us + (rec + 2.0) * 1e6
        n = sum(1 for ev in events
                if lo <= ev.get("ts", 0) <= hi
                or lo <= ev.get("ts", 0) + ev.get("dur", 0) <= hi)
        windows.append({"kind": r.kind, "at_s": round(r.at_s, 2),
                        "events_in_window": n})
    return {
        "row": "verdict", "check": "timeline_covers_failures",
        "ok": all(w["events_in_window"] > 0 for w in windows),
        "total_events": len(events), "windows": windows,
    }


def evaluate(spec: SoakSpec, records: List[ChaosRecord],
             summaries: List[dict]) -> List[dict]:
    """All rows for BENCH_LOAD.json: per-workload summaries with SLO
    fields, per-chaos-action recovery rows, and the plane verdicts.
    Reads the live cluster's planes — call before teardown."""
    rows = [workload_verdict(s, spec.slo) for s in summaries]
    rows += chaos_rows(records, spec.slo)
    # A chaos action that never produced a record (scheduler wedged,
    # exec swallowed) must fail the run, not silently pass it.
    rows.append({
        "row": "verdict", "check": "chaos_schedule_executed",
        "ok": len(records) == len(spec.chaos),
        "scheduled": len(spec.chaos), "executed": len(records),
    })
    rows += _pulse_verdicts(spec, records)
    rows.append(_audit_verdict())
    rows.append(_salvage_verdict(records))
    rows.append(_timeline_verdict(records, spec.slo))
    return rows


def passed(rows: List[dict]) -> bool:
    return all(r.get("ok", True) for r in rows
               if r["row"] in ("chaos", "verdict")) and \
        all(r.get("slo_ok", True) for r in rows
            if r["row"] == "workload")
