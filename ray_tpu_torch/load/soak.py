"""Soak orchestration: cluster up -> warm -> load + chaos -> verdict.

One call runs the whole experiment the spec describes:

    spec = scenario.profile("smoke")
    result = run_soak(spec)          # rows on stdout, narration stderr

Phases: build the in-box cluster (fast-pulse config so kills surface
inside the run), warm every workload (actor spawn + first torch import +
one end-to-end request stay out of the measured window), then start
the open-loop runners and the chaos scheduler against the same t0.
While running, a reporter thread pushes a 1 Hz status blob to the
controller (`report_soak`) so the dashboard's /api/cluster view shows
the soak live. After the load window the run drains (poll the trail
audit until conservation holds), the verdict engine reads the planes,
and the rows print as JSON lines — `make bench-load` tees them into
BENCH_LOAD.json next to BENCH_CORE.json.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import List, Optional

from ray_tpu_torch.load import verdict as verdict_mod
from ray_tpu_torch.load.arrivals import generate_schedule
from ray_tpu_torch.load.chaos import ChaosScheduler
from ray_tpu_torch.load.generator import (OpenLoopRunner, WorkloadCtx,
                                    make_workload, summarize)
from ray_tpu_torch.load.scenario import SoakSpec


def _status_reporter(stop: threading.Event, spec: SoakSpec,
                     runners: List[OpenLoopRunner],
                     chaos: ChaosScheduler, t0: float,
                     phase: List[str]) -> None:
    """1 Hz soak status -> controller -> dashboard /api/cluster."""
    import math

    from ray_tpu_torch import state
    while not stop.wait(1.0):
        try:
            wl = {}
            for r in runners:
                recs = r.requests
                wl[r.workload.name] = {
                    "requests": len(recs),
                    "submitted": sum(1 for x in recs
                                     if not math.isnan(x.t_submit)),
                    "completed": sum(1 for x in recs if x.ok),
                    "errors": sum(1 for x in recs if x.err),
                }
            state.report_soak({
                "profile": spec.name, "phase": phase[0],
                "elapsed_s": round(time.monotonic() - t0, 1),
                "duration_s": spec.duration_s,
                "workloads": wl,
                "chaos": [{"kind": c.kind, "at_s": c.at_s,
                           "ok": c.ok, "detail": c.detail}
                          for c in chaos.records],
            })
        except Exception:
            pass  # reporting is best-effort; the soak is the workload


def run_soak(spec: SoakSpec, out=None, log=None,
             keep_cluster: bool = False) -> dict:
    """Run one soak end to end. Returns {"ok", "rows"}; rows also
    stream to `out` (default stdout) as JSON lines."""
    out = out or sys.stdout
    log = log or sys.stderr

    def say(msg: str) -> None:
        print(f"[soak:{spec.name}] {msg}", file=log, flush=True)

    from ray_tpu_torch.core.cluster_utils import Cluster
    from ray_tpu_torch.utils.config import GlobalConfig

    saved_overrides = dict(GlobalConfig._overrides)
    GlobalConfig.initialize(dict(spec.config_overrides))
    run_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_soak_")
    cluster = None
    rows: List[dict] = []
    runners: List[OpenLoopRunner] = []
    stop = threading.Event()
    try:
        say(f"cluster up: {spec.nodes} nodes x {spec.node_cpus} CPU")
        cluster = Cluster(num_nodes=spec.nodes,
                          resources={"CPU": spec.node_cpus})
        cluster.connect()

        ctx = WorkloadCtx(run_dir=run_dir, seed=spec.seed)
        for i, w in enumerate(spec.workloads):
            workload = make_workload(w.kind)
            say(f"warmup: {w.kind}")
            workload.setup(ctx)
            schedule = generate_schedule(w.rate_hz, spec.duration_s,
                                         spec.seed + 1000 * i, w.mix)
            runners.append(OpenLoopRunner(workload, schedule,
                                          timeout_s=w.timeout_s,
                                          waiters=w.waiters))
        chaos = ChaosScheduler(cluster, spec, log=say)

        phase = ["load"]
        t0 = time.monotonic()
        reporter = threading.Thread(
            target=_status_reporter,
            args=(stop, spec, runners, chaos, t0, phase),
            name="soak-status", daemon=True)
        reporter.start()

        say(f"load: {spec.duration_s:.0f}s open-loop window, "
            f"{len(spec.chaos)} chaos action(s)")
        for r in runners:
            r.start(t0)
        chaos.start(t0)

        # The load window plus the straggler budget: every runner stops
        # submitting at duration_s; waiters then drain at most one
        # timeout deeper.
        drain_by = (spec.duration_s
                    + max((w.timeout_s for w in spec.workloads),
                          default=30.0) + 10.0)
        for r in runners:
            if not r.join(max(0.0, drain_by
                              - (time.monotonic() - t0))):
                say(f"warning: {r.workload.name} runner still "
                    f"draining at deadline")
        # Chaos deadline: the last action fires at max(at_s) and may
        # then poll the planes for a full recovery budget.
        chaos_by = (max((c.at_s for c in spec.chaos), default=0.0)
                    + spec.slo.recovery_s + 5.0)
        chaos.join(max(0.0, chaos_by - (time.monotonic() - t0)))

        # Settle: retries from the kills finish, freed objects fold,
        # then conservation must hold (the audit poll IS the test —
        # a lost task or leaked object keeps ok false).
        phase[0] = "settle"
        from ray_tpu_torch import state
        say(f"settle: polling trail audit (<= {spec.settle_s:.0f}s)")
        settle_deadline = time.monotonic() + spec.settle_s
        while time.monotonic() < settle_deadline:
            try:
                if state.audit()["ok"]:
                    break
            except Exception:
                pass
            time.sleep(1.0)

        phase[0] = "verdict"
        duration = spec.duration_s
        summaries = [summarize(r.workload.name, r.requests, duration)
                     for r in runners]
        rows = verdict_mod.evaluate(spec, chaos.records, summaries)
        ok = verdict_mod.passed(rows)
        rows.append({
            "row": "meta", "profile": spec.name, "seed": spec.seed,
            "duration_s": spec.duration_s, "nodes": spec.nodes,
            "chaos_actions": len(spec.chaos),
            "host_cores": os.cpu_count(), "passed": ok,
        })
        for row in rows:
            print(json.dumps(row, default=str), file=out, flush=True)
        say("PASS" if ok else "FAIL: see verdict rows")
        return {"ok": ok, "rows": rows}
    finally:
        stop.set()
        try:
            if cluster is not None and not keep_cluster:
                # Teardown while the cluster is still up: workloads
                # release the driver-process globals they planted
                # (serve's cached controller handle would otherwise
                # poison the next cluster in this interpreter).
                for r in runners:
                    td = getattr(r.workload, "teardown", None)
                    if td is not None:
                        try:
                            td()
                        except Exception:
                            pass  # best-effort; cluster dies next
                cluster.shutdown()
        finally:
            GlobalConfig._overrides.clear()
            GlobalConfig._overrides.update(saved_overrides)
            GlobalConfig._cache.clear()
            shutil.rmtree(run_dir, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    """`python -m ray_tpu_torch.load.soak --profile smoke` convenience."""
    from ray_tpu_torch.cli import main as cli_main
    return cli_main(["soak"] + list(argv or sys.argv[1:]))


if __name__ == "__main__":
    sys.exit(main())
