"""CLI: cluster lifecycle + introspection (counterpart of ``ray_tpu/cli.py``).

Analogue of the reference's CLI (reference: python/ray/scripts/scripts.py
— `ray start/stop/status/list/timeline`, registrations at :2688-2749).

    python -m ray_tpu_torch.cli start --head [--resources '{"CPU": 8}']
    python -m ray_tpu_torch.cli start --address HOST:PORT  # join as a node
    python -m ray_tpu_torch.cli status --address HOST:PORT [--live|--planes]
    python -m ray_tpu_torch.cli list actors|nodes|tasks|workers|objects ...
    python -m ray_tpu_torch.cli list tasks --state FAILED --node ID ...
    python -m ray_tpu_torch.cli summary tasks --address ...
    python -m ray_tpu_torch.cli get task ID --address ...
    python -m ray_tpu_torch.cli audit --address ... [--json]
    python -m ray_tpu_torch.cli timeline --address ... --out trace.json
    python -m ray_tpu_torch.cli timeline --address ... --native --format chrome
    python -m ray_tpu_torch.cli soak --profile smoke|bench|full
    python -m ray_tpu_torch.cli stack --address ... [--profile N]
    python -m ray_tpu_torch.cli prof top --address ... [--task F] [--seconds N]
    python -m ray_tpu_torch.cli prof flame --address ... \
        -o out.json|out.collapsed
    python -m ray_tpu_torch.cli logs --address ... [--task P] [--level WARNING]
    python -m ray_tpu_torch.cli logs --address ... --tail 50 -f
    python -m ray_tpu_torch.cli metrics --address ...
    python -m ray_tpu_torch.cli stop --address ...
"""

from __future__ import annotations

import argparse
import json
import sys


def _connect(address: str) -> None:
    import ray_tpu_torch
    ray_tpu_torch.init(address=address)


def cmd_start(args) -> int:
    import ray_tpu_torch
    if args.head:
        resources = json.loads(args.resources) if args.resources else None
        info = ray_tpu_torch.init(resources=resources)
        host, port = info["controller_address"]
        print(f"ray_tpu_torch head started. Controller at {host}:{port}")
        print(f"Join more nodes:  python -m ray_tpu_torch.cli start "
              f"--address {host}:{port}")
        print(f"Connect a driver: "
              f"ray_tpu_torch.init(address=\"{host}:{port}\")")
        if args.block:
            import signal
            print("--block: serving until interrupted.")
            try:
                signal.pause()
            except KeyboardInterrupt:
                pass
            ray_tpu_torch.shutdown()
        else:
            # Detach: the spawned controller/agent keep running.
            import atexit

            from ray_tpu_torch import api as _api
            if _api._global_node is not None:
                atexit.unregister(_api._global_node.stop)
        return 0
    if not args.address:
        print("start needs --head or --address", file=sys.stderr)
        return 2
    host, port_s = args.address.rsplit(":", 1)
    from ray_tpu_torch.core.node import make_session_dir, start_agent
    resources = json.loads(args.resources) if args.resources else {}
    proc, port = start_agent((host, int(port_s)), make_session_dir(),
                             resources or None)
    print(f"node agent joined {args.address} (agent port {port})")
    if args.block:
        proc.wait()
    return 0


def cmd_status(args) -> int:
    _connect(args.address)
    from ray_tpu_torch import state
    if getattr(args, "live", False):
        return _status_live(args.interval)
    if getattr(args, "planes", False):
        return _status_planes()
    s = state.cluster_summary()
    print(f"nodes: {s['nodes_alive']}/{s['nodes_total']} alive; "
          f"actors: {s['actors']}")
    print("resources:")
    for k, total in sorted(s["resources_total"].items()):
        avail = s["resources_available"].get(k, 0)
        print(f"  {k}: {avail:g}/{total:g} available")
    return 0


def _status_planes() -> int:
    """graftmeta one-shot: how the observability planes themselves are
    doing at the controller — ingest rates, fold-latency percentiles,
    store occupancy, event-loop lag and RSS. The singleton-aggregator
    failure mode (Ray's GCS under cardinality) is invisible from the
    outside until nodes start dying; this is the gauge for it."""
    from ray_tpu_torch import state
    m = state.meta_snapshot()
    if not m.get("enabled"):
        print("graftmeta is disabled (RAY_TPU_TORCH_GRAFTMETA=0)")
        return 1
    lag = m.get("loop_lag", {})
    print(f"controller — up {m.get('uptime_s', 0):.0f}s · "
          f"rss {m.get('rss_bytes', 0) / 2**20:.1f} MiB · "
          f"loop lag p50 {lag.get('p50_ns', 0) / 1e6:.2f}ms "
          f"p99 {lag.get('p99_ns', 0) / 1e6:.2f}ms "
          f"max {lag.get('max_ns', 0) / 1e6:.2f}ms   "
          f"(window {m.get('window_s', 0):.0f}s)")
    print(f"{'plane':<10}{'rec/s':>9}{'KiB/s':>9}{'batches':>9}"
          f"{'drops':>7}{'fold p50':>10}{'fold p99':>10}"
          f"{'fold total':>12}")
    for plane, row in m.get("planes", {}).items():
        print(f"{plane:<10}{row.get('records_per_s', 0):>9.1f}"
              f"{row.get('bytes_per_s', 0) / 1024:>9.1f}"
              f"{row.get('batches', 0):>9}"
              f"{row.get('drops', 0):>7}"
              f"{row.get('fold_p50_ns', 0) / 1e3:>9.0f}u"
              f"{row.get('fold_p99_ns', 0) / 1e3:>9.0f}u"
              f"{row.get('fold_ms_total', 0):>10.1f}ms")
    stores = m.get("stores", {})
    if stores:
        print("\nstore occupancy:")
        pulse = stores.get("pulse", {})
        print(f"  pulse: {pulse.get('nodes', 0)} nodes · "
              f"{pulse.get('pulses', 0)} pulses retained")
        trail = stores.get("trail", {})
        print(f"  trail: {trail.get('tasks', 0)} tasks · "
              f"{trail.get('objects', 0)} objects · "
              f"dropped {trail.get('dropped_tasks', 0)}/"
              f"{trail.get('dropped_objects', 0)}")
        prof = stores.get("prof", {})
        print(f"  prof:  {prof.get('tasks', 0)} tasks · "
              f"{prof.get('windows', 0)} windows · "
              f"{prof.get('nodes', 0)} nodes"
              + (f" · {prof['shards']} shards"
                 if prof.get("shards") else ""))
        log = stores.get("log", {})
        print(f"  log:   {log.get('records', 0)}/{log.get('cap', 0)} "
              f"records · evicted {log.get('evicted', 0)} · "
              f"deduped {log.get('deduped', 0)} · "
              f"suppressed {log.get('suppressed', 0)}"
              + (f" · {log['shards']} shards"
                 if log.get("shards") else ""))
        scope = stores.get("scope", {})
        print(f"  scope: {scope.get('spans', 0)} spans retained")
    return 0


def _status_live(interval: float) -> int:
    """Refreshing cluster view from the graftpulse telemetry plane —
    plain ANSI clear-and-redraw, no curses (reference: `ray status`
    is one-shot; the live view rides our pulse time series instead)."""
    import time

    from ray_tpu_torch import state

    def render(t: dict) -> str:
        c, tot = t.get("cluster", {}), t.get("totals", {})
        lines = [
            f"ray_tpu_torch cluster — {time.strftime('%H:%M:%S')}   "
            f"(window {t.get('window_s', 0):.0f}s, "
            f"pulse {'on' if c.get('pulse_enabled') else 'off'})",
            f"nodes {c.get('nodes_alive', 0)} alive / "
            f"{c.get('nodes_dead', 0)} dead · "
            f"actors {c.get('actors_alive', 0)} alive / "
            f"{c.get('actors_pending', 0)} pending",
            f"objects {tot.get('store_objects', 0)} · "
            f"store {tot.get('store_used', 0) / 2**20:.1f}/"
            f"{tot.get('store_capacity', 0) / 2**20:.1f} MiB · "
            f"queue {tot.get('queue_depth', 0)} · "
            f"workers {tot.get('num_workers', 0)} · "
            f"rss {tot.get('rss_bytes', 0) / 2**20:.0f} MiB",
            "",
            f"{'node':<14}{'health':<10}{'seq':>6}{'queue':>7}"
            f"{'objects':>9}{'store MiB':>11}{'rss MiB':>9}"
            f"{'cpu%':>7}{'gil%':>7}",
        ]
        for nid, n in sorted(t.get("nodes", {}).items()):
            # graftprof gauges ride the pulse: worker on-CPU share and
            # GIL-wait share (permille) make hot nodes stand out.
            lines.append(
                f"{nid:<14}{n.get('health', '?'):<10}"
                f"{n.get('seq', 0):>6}{n.get('queue_depth', 0):>7}"
                f"{n.get('store_objects', 0):>9}"
                f"{n.get('store_used', 0) / 2**20:>11.1f}"
                f"{n.get('rss_bytes', 0) / 2**20:>9.0f}"
                f"{n.get('prof_oncpu_permille', 0) / 10:>7.1f}"
                f"{n.get('prof_gil_permille', 0) / 10:>7.1f}")
        ops = t.get("ops", {})
        if ops:
            lines += ["", f"{'native op':<22}{'calls':>9}{'p50 us':>9}"
                          f"{'p99 us':>9}{'MiB/s':>9}"]
            for op, v in sorted(ops.items()):
                lines.append(
                    f"{op:<22}{v.get('calls', 0):>9}"
                    f"{v.get('p50_ns', 0) / 1e3:>9.0f}"
                    f"{v.get('p99_ns', 0) / 1e3:>9.0f}"
                    f"{v.get('bytes_per_s', 0) / 2**20:>9.1f}")
        return "\n".join(lines)

    try:
        while True:
            try:
                text = render(state.cluster_telemetry())
            except Exception as e:
                text = f"telemetry fetch failed: {e!r}"
            sys.stdout.write("\x1b[2J\x1b[H" + text + "\n")
            sys.stdout.flush()
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def cmd_list(args) -> int:
    _connect(args.address)
    from ray_tpu_torch import state
    kind = args.kind
    if kind == "tasks":
        rows = state.list_tasks(state=args.state, node=args.node,
                                name=args.task_name, actor=args.actor,
                                limit=args.limit)
    elif kind == "objects":
        rows = state.list_objects(node=args.node, plane=args.plane,
                                  limit=args.limit)
    else:
        rows = {"actors": state.list_actors, "nodes": state.list_nodes,
                "workers": state.list_workers}[kind]()
    print(json.dumps(rows, indent=2, default=str))
    return 0


def cmd_summary(args) -> int:
    """Per-function task rollup from the grafttrail ledger (reference:
    `ray summary tasks`)."""
    _connect(args.address)
    from ray_tpu_torch import state
    rows = state.summary_tasks()
    if not rows:
        print("no tasks recorded")
        return 0
    states = ["SUBMITTED", "LEASED", "RUNNING",
              "FINISHED", "FAILED", "CANCELLED"]
    hdr = f"{'function':<32}{'total':>7}{'attempts':>9}"
    hdr += "".join(f"{s[:6]:>8}" for s in states)
    print(hdr)
    for r in rows:
        line = f"{r['name'][:31]:<32}{r['total']:>7}{r['attempts']:>9}"
        line += "".join(f"{r.get(s, 0):>8}" for s in states)
        print(line)
    return 0


def cmd_get(args) -> int:
    """Full trail for one task: attempt chain + root cause, joined with
    the task's graftprof accounting (on-CPU% / GIL-wait% of sampled
    wall time) when the profiling plane has seen it."""
    _connect(args.address)
    from ray_tpu_torch import state
    detail = state.get_task(args.id)
    if detail is None:
        print(f"no task matching {args.id!r} (need a unique id prefix)",
              file=sys.stderr)
        return 1
    try:
        prof = state.prof_task_stats(args.id)
    except Exception:
        prof = None
    if prof:
        wall = max(1, int(prof.get("wall_ns") or 0))
        detail["prof"] = {
            "samples": prof.get("samples", 0),
            "oncpu_pct": round(100.0 * prof.get("oncpu_ns", 0) / wall, 1),
            "gil_wait_pct": round(100.0 * prof.get("gil_ns", 0) / wall, 1),
        }
    print(json.dumps(detail, indent=2, default=str))
    return 0


def cmd_audit(args) -> int:
    """Conservation audit over the trail ledger: exit 0 when every
    non-terminal task is live on an alive node and every sealed object
    is freed or resident; exit 1 with provenance otherwise."""
    _connect(args.address)
    from ray_tpu_torch import state
    report = state.audit(args.grace)
    if getattr(args, "json", False):
        # Machine surface: the full report, one JSON object — what the
        # graftload verdict engine and external harnesses consume
        # (exit code still carries pass/fail).
        print(json.dumps(report, default=str))
        return 0 if report["ok"] else 1
    s = report["stats"]
    print(f"tasks {s['tasks']} ({s.get('tasks_by_state', {})}) · "
          f"objects {s['objects']} ({s['objects_live']} live) · "
          f"events folded {s['events_folded']}")
    if not report["complete"]:
        print(f"ledger bounded: dropped {s['dropped_tasks']} tasks / "
              f"{s['dropped_objects']} objects — audit covers what it saw")
    for t in report["lost_tasks"]:
        print(f"LOST task {t['task_id']} [{t['name']}] attempt "
              f"{t['attempt']}: {t['audit_reason']}")
    for o in report["leaked_objects"]:
        print(f"LEAKED object {o['object_id']} ({o['size']}B, "
              f"{o['plane']}, node {o['node']}): {o['audit_reason']}")
    if report["ok"]:
        print("audit OK: zero lost tasks, zero leaked objects")
        return 0
    print(f"audit FAILED: {len(report['lost_tasks'])} lost task(s), "
          f"{len(report['leaked_objects'])} leaked object(s)")
    return 1


def cmd_timeline(args) -> int:
    _connect(args.address)
    from ray_tpu_torch import state
    fmt = getattr(args, "format", "events")
    trace = state.timeline(args.out, native=args.native, fmt=fmt)
    n_native = sum(1 for ev in trace if ev.get("cat") == "native")
    extra = f" ({n_native} native spans)" if args.native else ""
    shape = " [chrome trace-event format]" if fmt == "chrome" else ""
    print(f"wrote {len(trace)} trace events to {args.out}{extra}{shape}")
    return 0


def cmd_soak(args) -> int:
    """graftload: open-loop macro-load + chaos soak with machine-
    checked SLO verdicts from the observability planes. Spins up its
    own multi-node-in-one-box cluster (no --address), drives Serve +
    Data + Train concurrently while the chaos schedule kills workers/
    nodes, then prints one JSON row per workload/chaos-action/verdict
    (`make bench-load` tees stdout into BENCH_LOAD.json). Exit 0 only
    if every SLO verdict passed."""
    raise NotImplementedError(
        "soak needs ray_tpu_torch.load, which is not ported yet")


def _print_folded(folded: dict, indent: str = "  ") -> None:
    """Render a graftprof capture ({frames, stacks, samples,
    thread_cpu_ns}) as collapsed stacks sorted hottest-first, plus the
    per-thread native CPU table (sidecar threads included)."""
    frames = folded.get("frames") or []
    rows = []
    for row in folded.get("stacks") or []:
        try:
            task, actor, name, idxs, n = row
            stack = ";".join(frames[i] for i in idxs)
        except Exception:
            continue
        rows.append((int(n), name or task[:12] or "-", stack))
    total = folded.get("samples") or sum(n for n, _, _ in rows) or 1
    print(f"{indent}{len(rows)} distinct stacks, {total} samples")
    for n, who, stack in sorted(rows, key=lambda r: -r[0]):
        print(f"{indent}{n:>6} {100.0 * n / total:5.1f}%  "
              f"[{who}] {stack}")
    cpu = folded.get("thread_cpu_ns") or []
    if cpu:
        print(f"{indent}-- native thread CPU --")
        for name, ns in sorted(cpu, key=lambda r: -r[1]):
            print(f"{indent}{ns / 1e6:>10.1f} ms  {name}")


def cmd_stack(args) -> int:
    """Dump every worker's Python stacks (reference: `ray stack`).
    --profile N folds N seconds of graftprof samples per worker instead
    of a single snapshot and appends native thread CPU times."""
    _connect(args.address)
    from ray_tpu_torch import state
    profile_s = getattr(args, "profile", 0.0) or 0.0
    dump = state.stack(args.node, profile_s=profile_s)
    for nid, workers in dump.items():
        print(f"=== node {nid} ===")
        if "error" in workers:
            print(f"  <unreachable: {workers['error']}>")
            continue
        for pid, entry in workers.items():
            who = f"actor {entry['actor']}" if entry.get("actor") \
                else f"worker {entry.get('worker_id', '?')}"
            print(f"--- pid {pid} ({who}, via {entry.get('via', '?')}) ---")
            stacks = entry.get("stacks", {})
            if isinstance(stacks, dict) and "frames" in stacks:
                _print_folded(stacks)
            else:
                for name, text in stacks.items():
                    print(f"  [{name}]")
                    for line in text.splitlines():
                        print(f"    {line}")
            if entry.get("error"):
                print(f"  <error: {entry['error']}>")
    return 0


def cmd_prof(args) -> int:
    """The graftprof surfaces: `prof top` (hottest frames with self/cum
    sample counts) and `prof flame -o out.json|out.collapsed`
    (d3-flamegraph JSON or Brendan-Gregg collapsed stacks). Profiles
    are already on the controller — no attach step, no target pid
    (reference contrast: `ray stack`/py-spy attach on demand)."""
    _connect(args.address)
    from ray_tpu_torch import state
    filt = dict(task=args.task, actor=args.actor, node=args.node,
                seconds=args.seconds)
    if args.action == "top":
        top = state.prof_top(limit=args.limit, **filt)
        total = top.get("total_samples", 0)
        if getattr(args, "json", False):
            print(json.dumps(top, default=str))
            return 0 if total else 1
        if not total:
            print("no profile samples matched (is graftprof on? "
                  "RAY_TPU_TORCH_GRAFTPROF=0 disables it)")
            return 1
        print(f"{'self%':>7}{'cum%':>7}{'self':>8}{'cum':>8}  function "
              f"({total} samples)")
        for r in top["rows"]:
            print(f"{r['self_pct']:>6.1f}%{r['cum_pct']:>6.1f}%"
                  f"{r['self']:>8}{r['cum']:>8}  {r['func']}")
        native = top.get("native_threads") or []
        if native:
            print("-- native thread CPU (process-wide) --")
            for name, ns in native:
                print(f"{ns / 1e6:>10.1f} ms  {name}")
        return 0
    # flame
    out = args.out or "flame.json"
    if out.endswith(".collapsed"):
        lines = state.prof_collapsed(**filt)
        if not lines:
            print("no profile samples matched", file=sys.stderr)
            return 1
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {len(lines)} collapsed stacks to {out}")
    else:
        flame = state.prof_flame(**filt)
        if not flame.get("value"):
            print("no profile samples matched", file=sys.stderr)
            return 1
        with open(out, "w") as f:
            json.dump(flame, f)
        print(f"wrote d3-flamegraph JSON ({flame['value']} samples) "
              f"to {out}")
    return 0


def _parse_level(s) -> int:
    """A logging level by number ("30") or name ("WARNING")."""
    if not s:
        return 0
    import logging
    try:
        return int(s)
    except ValueError:
        lv = logging.getLevelName(str(s).upper())
        return lv if isinstance(lv, int) else 0


def _fmt_log_row(r: dict) -> str:
    import logging
    import time as _t
    ts = _t.strftime("%H:%M:%S",
                     _t.localtime(int(r.get("t_ns") or 0) / 1e9))
    lvl = logging.getLevelName(int(r.get("level") or 0))
    src = {0: "log", 1: "out", 2: "err", 3: "agt"}.get(
        int(r.get("source") or 0), "?")
    task = r.get("task") or ""
    where = f"pid={r.get('pid')} node={r.get('node', '')[:8]}"
    if task:
        where += f" task={task[:8]}"
    rep = f" (x{r['repeats'] + 1})" if r.get("repeats") else ""
    sal = " [salvaged]" if r.get("salvaged") else ""
    return f"{ts} {str(lvl)[:1]} [{src}] ({where}){sal} " \
           f"{r.get('msg', '')}{rep}"


def cmd_logs(args) -> int:
    """The graftlog surface: time-ordered cluster log records from the
    controller LogStore — every worker's logger calls and captured
    stdout/stderr, task-attributed, including a dead worker's salvaged
    final lines ([salvaged]). Filters compose; `-f` follows with an id
    cursor (reference contrast: `ray logs` reads per-node log FILES;
    here one indexed store answers task/actor/level queries)."""
    _connect(args.address)
    import time as _t

    from ray_tpu_torch import state
    level = _parse_level(args.level)

    def fetch(after_id: int, limit: int):
        return state.list_logs(task=args.task, actor=args.actor,
                               node=args.node, level=level,
                               after_id=after_id, limit=limit)

    as_json = getattr(args, "json", False)

    def emit(r: dict) -> None:
        # --json: one JSON object per line (JSONL) — follow mode
        # streams machine-parseable rows too.
        print(json.dumps(r, default=str) if as_json
              else _fmt_log_row(r), flush=args.follow)

    rows = fetch(0, args.tail)
    for r in rows:
        emit(r)
    if not args.follow:
        if not rows:
            print("no log records matched (is graftlog on? "
                  "RAY_TPU_TORCH_GRAFTLOG=0 disables it)", file=sys.stderr)
            return 1
        return 0
    last = rows[-1]["id"] if rows else 0
    try:
        while True:
            _t.sleep(max(0.1, args.interval))
            new = fetch(last, 1000)
            for r in new:
                emit(r)
            if new:
                last = new[-1]["id"]
    except KeyboardInterrupt:
        return 0


def cmd_metrics(args) -> int:
    _connect(args.address)
    from ray_tpu_torch import state
    print(state.metrics_text())
    return 0


def cmd_stop(args) -> int:
    _connect(args.address)
    from ray_tpu_torch import api as _api
    cw = _api._cw()
    for n in cw._run(cw.controller.call("get_nodes")).result(30):
        if n["state"] != "ALIVE":
            continue
        try:
            cw._run(cw._client_for_worker(
                tuple(n["addr"])).call("shutdown_node")).result(10)
        except Exception:
            pass
    try:
        cw._run(cw.controller.call("shutdown_controller")).result(10)
    except Exception:
        pass
    print("stop requested on all nodes + controller")
    return 0


def cmd_dashboard(args) -> int:
    _connect(args.address)
    import signal

    from ray_tpu_torch.dashboard import start_dashboard
    dash = start_dashboard(port=args.port)
    print(f"dashboard at http://127.0.0.1:{dash.port}/")
    try:
        signal.pause()
    except KeyboardInterrupt:
        dash.stop()
    return 0


def cmd_job(args) -> int:
    _connect(args.address)
    from ray_tpu_torch import job_submission as jobs
    if args.action == "submit":
        import shlex
        job_id = jobs.submit_job(shlex.join(args.entrypoint))
        print(f"submitted: {job_id}")
        if args.wait:
            status = jobs.wait_job(job_id, timeout=args.timeout)
            print(f"{job_id}: {status}")
            print(jobs.get_job_logs(job_id, tail=50), end="")
            return 0 if status == "SUCCEEDED" else 1
    elif args.action == "status":
        print(jobs.get_job_status(args.job_id))
    elif args.action == "logs":
        if args.follow:
            import time as _time
            seen = ""
            while True:
                text = jobs.get_job_logs(args.job_id)
                if len(text) > len(seen):
                    sys.stdout.write(text[len(seen):])
                    sys.stdout.flush()
                    seen = text
                status = jobs.get_job_status(args.job_id)
                if status in ("SUCCEEDED", "FAILED", "STOPPED"):
                    break
                _time.sleep(args.interval)
        else:
            print(jobs.get_job_logs(args.job_id, tail=args.tail), end="")
    elif args.action == "stop":
        print(jobs.stop_job(args.job_id))
    elif args.action == "list":
        print(json.dumps(jobs.list_jobs(), indent=2, default=str))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="start a head or join a cluster")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", default="")
    sp.add_argument("--resources", default="")
    sp.add_argument("--block", action="store_true")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("status")
    sp.add_argument("--address", required=True)
    sp.add_argument("--live", action="store_true",
                    help="refreshing view over the graftpulse telemetry "
                         "plane (Ctrl-C to exit)")
    sp.add_argument("--interval", type=float, default=2.0,
                    help="refresh period for --live, seconds")
    sp.add_argument("--planes", action="store_true",
                    help="graftmeta self-telemetry: per-plane ingest "
                         "rates, fold latency, store occupancy, "
                         "controller loop lag + RSS")
    sp.set_defaults(fn=cmd_status)

    for name, fn in (("metrics", cmd_metrics), ("stop", cmd_stop)):
        sp = sub.add_parser(name)
        sp.add_argument("--address", required=True)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("list")
    sp.add_argument("kind",
                    choices=["actors", "nodes", "tasks", "workers",
                             "objects"])
    sp.add_argument("--address", required=True)
    sp.add_argument("--state", default=None,
                    help="tasks: filter by FSM state (e.g. FAILED)")
    sp.add_argument("--node", default=None,
                    help="tasks/objects: filter by node id (hex12)")
    sp.add_argument("--task-name", default=None,
                    help="tasks: filter by function name")
    sp.add_argument("--actor", default=None,
                    help="tasks: filter by actor id (hex12)")
    sp.add_argument("--plane", default=None,
                    help="objects: filter by plane (shm/copy/fallback)")
    sp.add_argument("--limit", type=int, default=100)
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("summary", help="per-function task rollup from "
                        "the grafttrail ledger")
    sp.add_argument("kind", choices=["tasks"])
    sp.add_argument("--address", required=True)
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("get", help="one task's full attempt chain + "
                        "root-cause error")
    sp.add_argument("kind", choices=["task"])
    sp.add_argument("id", help="task id (or unique hex prefix)")
    sp.add_argument("--address", required=True)
    sp.set_defaults(fn=cmd_get)

    sp = sub.add_parser("audit", help="conservation audit: zero lost "
                        "tasks, zero leaked objects")
    sp.add_argument("--address", required=True)
    sp.add_argument("--grace", type=float, default=None,
                    help="seconds a non-terminal task may sit without a "
                         "transition before it counts as lost")
    sp.add_argument("--json", action="store_true",
                    help="emit the full report as one JSON object "
                         "(machine surface; exit code still pass/fail)")
    sp.set_defaults(fn=cmd_audit)

    sp = sub.add_parser("stack", help="dump worker Python stacks "
                        "(hung-worker debugger)")
    sp.add_argument("--address", required=True)
    sp.add_argument("--node", default=None,
                    help="node id prefix (default: all nodes)")
    sp.add_argument("--profile", type=float, default=0.0, metavar="N",
                    help="fold N seconds of graftprof samples per "
                         "worker instead of one snapshot")
    sp.set_defaults(fn=cmd_stack)

    sp = sub.add_parser("prof", help="continuous-profiling surfaces "
                        "(always-on graftprof plane)")
    sp.add_argument("action", choices=["top", "flame"])
    sp.add_argument("--address", required=True)
    sp.add_argument("--task", default=None,
                    help="task id prefix or exact task/function name")
    sp.add_argument("--actor", default=None, help="actor id prefix")
    sp.add_argument("--node", default=None, help="node id (hex12)")
    sp.add_argument("--seconds", type=float, default=None,
                    help="only samples from the last N seconds "
                         "(default: merged per-task history)")
    sp.add_argument("--limit", type=int, default=30,
                    help="top: max rows")
    sp.add_argument("--json", action="store_true",
                    help="top: emit rows as one JSON object instead of "
                         "the ANSI table")
    sp.add_argument("-o", "--out", default=None,
                    help="flame: output path — .json (d3-flamegraph) "
                         "or .collapsed (flamegraph.pl input)")
    sp.set_defaults(fn=cmd_prof)

    sp = sub.add_parser("logs", help="cluster log records (crash-"
                        "persistent graftlog plane)")
    sp.add_argument("--address", required=True)
    sp.add_argument("--task", default=None, help="task id hex prefix")
    sp.add_argument("--actor", default=None, help="actor id prefix")
    sp.add_argument("--node", default=None, help="node id (hex12)")
    sp.add_argument("--level", default=None,
                    help="minimum level, name or number "
                         "(WARNING, 30, ...)")
    sp.add_argument("--tail", type=int, default=100,
                    help="last N matching records (default 100)")
    sp.add_argument("-f", "--follow", action="store_true",
                    help="keep polling for new records")
    sp.add_argument("--interval", type=float, default=1.0,
                    help="poll period for --follow, seconds")
    sp.add_argument("--json", action="store_true",
                    help="emit records as JSONL (one JSON object per "
                         "line; works with -f)")
    sp.set_defaults(fn=cmd_logs)

    sp = sub.add_parser("timeline")
    sp.add_argument("--address", required=True)
    sp.add_argument("--out", default="timeline.json")
    sp.add_argument("--native", action="store_true",
                    help="include graftscope native-plane spans "
                         "(dispatch/wire/sidecar/copy) stitched under "
                         "their submitting tasks")
    sp.add_argument("--format", choices=["events", "chrome"],
                    default="events",
                    help="chrome: Chrome trace-event JSON "
                         "({traceEvents: [...]} with integer pid/tid + "
                         "name metadata) — opens directly in Perfetto")
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("soak", help="open-loop macro-load + chaos "
                        "soak with SLO verdicts from the planes "
                        "(graftload; spins up its own cluster)")
    sp.add_argument("--profile", choices=["smoke", "bench", "full"],
                    default="smoke")
    sp.add_argument("--duration", type=float, default=None,
                    help="load window seconds (default: per profile)")
    sp.add_argument("--seed", type=int, default=None,
                    help="arrival-schedule seed (default: per profile)")
    sp.add_argument("--nodes", type=int, default=0,
                    help="override node count")
    sp.add_argument("-o", "--out", default=None,
                    help="also write the JSON rows to this file "
                         "(rows always stream to stdout)")
    sp.set_defaults(fn=cmd_soak)

    sp = sub.add_parser("dashboard", help="serve the HTTP dashboard")
    sp.add_argument("--address", required=True)
    sp.add_argument("--port", type=int, default=8265)
    sp.set_defaults(fn=cmd_dashboard)

    sp = sub.add_parser("job", help="submit/inspect cluster jobs")
    sp.add_argument("action",
                    choices=["submit", "status", "logs", "stop", "list"])
    sp.add_argument("--address", required=True)
    sp.add_argument("--job-id", default="")
    sp.add_argument("--wait", action="store_true")
    sp.add_argument("--timeout", type=float, default=600.0)
    sp.add_argument("--tail", type=int, default=None,
                    help="logs: only the last N lines")
    sp.add_argument("-f", "--follow", action="store_true",
                    help="logs: poll for new output until the job ends")
    sp.add_argument("--interval", type=float, default=1.0,
                    help="poll period for --follow, seconds")
    sp.add_argument("entrypoint", nargs="*",
                    help="for submit: the shell command to run")
    sp.set_defaults(fn=cmd_job)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
