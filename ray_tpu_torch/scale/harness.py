"""graftscale harness: ramp simulated nodes against a real controller.

The controller runs as a REAL subprocess (`python -m
ray_tpu_torch.core.controller --port 0`) with its production event loop,
stores and planes; the harness multiplexes ``SimNode`` agents onto one
``SimHost`` in this process and ramps the population level by level.
At each level it holds, then reads the controller's OWN graftmeta
snapshot — per-plane ingest rates, fold-latency p50/p99, event-loop
lag, RSS — and emits one JSONL ``level`` row. After the ramp it emits
graftload-style machine-checked ``verdict`` rows:

  * pulse_fold_p99_bounded   — worst per-level pulse fold p99 < budget
  * loop_lag_bounded         — controller loop-lag p99 < budget
  * rss_per_node_bounded     — controller RSS growth per node < budget
  * rss_growth_sublinear     — marginal RSS per node-SECOND flat across
    levels (isolates cardinality cost from per-node ring fill, which
    grows with time alive, not membership)
  * no_unintended_deaths     — every registered sim node still ALIVE
  * (with kill_nodes > 0) kill_detected / meta_ingest_drop /
    audit_clean_after_kill   — the SIGKILL story, machine-checked

``passed(rows)`` (graftload's gate) decides the exit code; the ``meta``
row records ``max_nodes_sustained`` — the largest level whose fold/lag
bounds held, the headline number of BENCH_SCALE.json.
"""

from __future__ import annotations

import asyncio
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core.rpc import RpcClient
from ray_tpu_torch.load.verdict import passed
from ray_tpu_torch.scale.simnode import SimHost, SimNode
from ray_tpu_torch.utils import get_logger
from ray_tpu_torch.utils.aio import spawn

logger = get_logger("graftscale")


@dataclass
class ScaleSpec:
    """One scale run. ``smoke()`` is the CI shape (one small level,
    well under a minute); the default is the bench ramp."""

    levels: Tuple[int, ...] = (64, 128, 192, 256)
    hold_s: float = 8.0
    tick_s: float = 1.0
    seed: int = 20260807
    fold_p99_budget_ms: float = 50.0
    loop_lag_p99_budget_ms: float = 250.0
    rss_per_node_budget_bytes: int = 1_500_000
    kill_nodes: int = 0
    v1_nodes: int = 0  # first N nodes ship v1 pulse frames (skew)
    env: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def smoke(cls) -> "ScaleSpec":
        return cls(levels=(64,), hold_s=10.0)


class ScaleHarness:
    """Async driver — tests compose the phases (start / add_nodes /
    sample / kill_some / stop) directly; ``run_scale`` is the
    all-in-one ramp."""

    def __init__(self, spec: ScaleSpec):
        self.spec = spec
        self.proc: Optional[asyncio.subprocess.Process] = None
        self.ctl: Optional[RpcClient] = None
        self.ctl_addr: Optional[Tuple[str, int]] = None
        self.simhost = SimHost()
        self.killed: List[SimNode] = []
        self._drain_task = None

    @property
    def nodes(self) -> List[SimNode]:
        return self.simhost.nodes

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        env = dict(os.environ)
        for k, v in self.spec.env.items():
            env[f"RAY_TPU_TORCH_{k.upper()}"] = str(v)
        self.proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "ray_tpu_torch.core.controller",
            "--port", "0", env=env,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL)
        assert self.proc.stdout is not None
        line = await asyncio.wait_for(self.proc.stdout.readline(), 30.0)
        if not line.startswith(b"CONTROLLER_PORT="):
            raise RuntimeError(f"controller did not start: {line!r}")
        port = int(line.split(b"=", 1)[1])
        self.ctl_addr = ("127.0.0.1", port)
        self.ctl = RpcClient(self.ctl_addr, timeout=30.0)
        self._drain_task = spawn(self._drain_stdout())
        await self.simhost.start()
        # Wait for the meta plane's first tick so RSS baselines exist.
        for _ in range(100):
            snap = await self.ctl.call("meta_snapshot", 2)
            if not snap.get("enabled") or snap.get("ticks"):
                break
            await asyncio.sleep(0.2)

    async def _drain_stdout(self) -> None:
        assert self.proc is not None and self.proc.stdout is not None
        try:
            while await self.proc.stdout.readline():
                pass
        except Exception:
            pass

    async def stop(self) -> None:
        try:
            await self.simhost.stop()
        finally:
            if self.ctl is not None:
                await self.ctl.close()
            if self.proc is not None and self.proc.returncode is None:
                self.proc.kill()
                try:
                    await asyncio.wait_for(self.proc.wait(), 10.0)
                except asyncio.TimeoutError:
                    pass

    # -- phases ------------------------------------------------------------

    async def add_nodes(self, upto: int) -> None:
        """Grow the population to ``upto`` sim nodes, staggered so the
        registration burst itself doesn't become the measurement."""
        assert self.ctl_addr is not None and self.simhost.addr
        spec = self.spec
        while len(self.nodes) < upto:
            i = len(self.nodes)
            node = SimNode(
                i, spec.seed, self.ctl_addr, self.simhost.addr,
                tick_s=spec.tick_s,
                wire_version=1 if i < spec.v1_nodes else 2)
            await node.start()
            self.simhost.nodes.append(node)
            if i % 16 == 15:
                await asyncio.sleep(0.05)

    async def sample(self, window_ticks: int) -> dict:
        assert self.ctl is not None
        return await self.ctl.call("meta_snapshot",
                                   max(2, int(window_ticks)))

    async def node_states(self) -> Dict[str, str]:
        assert self.ctl is not None
        return {n["node_id"].hex()[:12]: str(n["state"])
                for n in await self.ctl.call("get_nodes")}

    def node_seconds(self) -> float:
        """Integrated alive-time across the population. Per-node rings
        (pulse history, prof windows, trail/log rows) fill with TIME
        alive, not with membership — so until the caps bite, controller
        RSS is proportional to node-seconds, and node-seconds (not node
        count) is the denominator that isolates cardinality cost from
        ring fill."""
        now = time.monotonic()
        total = 0.0
        for n in self.nodes:
            if n.t_start is not None:
                total += (n.t_end if n.t_end is not None else now) \
                    - n.t_start
        return total

    async def kill_some(self, k: int,
                        timeout_s: float = 30.0) -> List[dict]:
        """Abruptly silence ``k`` live nodes and wait for the
        controller's cadence FSM to declare them DEAD. Returns kill/
        verdict rows; the trail audit must stay clean afterwards."""
        assert self.ctl is not None
        before = await self.sample(max(2, int(self.spec.hold_s)))
        victims = [n for n in self.nodes if not n.killed][-k:]
        t0 = time.monotonic()
        for n in victims:
            n.kill()
        self.killed.extend(victims)
        want = {n.hex12 for n in victims}
        detect_s = None
        while time.monotonic() - t0 < timeout_s:
            states = await self.node_states()
            if all(states.get(h) == "DEAD" for h in want):
                detect_s = time.monotonic() - t0
                break
            await asyncio.sleep(0.5)
        # Post-kill window: only ticks after the deaths, so the meter
        # shows the ingest drop rather than averaging over the kill.
        await asyncio.sleep(3.0)
        after = await self.sample(3)
        audit = await self.ctl.call("trail_audit", None)
        rate = lambda s: (s.get("planes", {}).get("pulse", {})  # noqa: E731
                          .get("records_per_s", 0.0))
        live = len(self.nodes) - len(self.killed)
        expect = rate(before) * (1 - 0.5 * k / max(1, live + k))
        return [
            {"row": "verdict", "check": "kill_detected",
             "ok": detect_s is not None, "killed": k,
             "detect_s": (round(detect_s, 2)
                          if detect_s is not None else None),
             "timeout_s": timeout_s},
            {"row": "verdict", "check": "meta_ingest_drop",
             "ok": rate(after) <= expect or detect_s is None,
             "pulse_rps_before": round(rate(before), 2),
             "pulse_rps_after": round(rate(after), 2),
             "expected_max": round(expect, 2)},
            {"row": "verdict", "check": "audit_clean_after_kill",
             "ok": bool(audit.get("ok")),
             "lost_tasks": len(audit.get("lost_tasks", [])),
             "leaked_objects": len(audit.get("leaked_objects", []))},
        ]


def _level_row(level: int, snap: dict, states: Dict[str, str],
               rss_base: int, node_seconds: float) -> dict:
    planes = snap.get("planes", {})
    pulse = planes.get("pulse", {})
    lag = snap.get("loop_lag", {})
    alive = sum(1 for s in states.values() if s == "ALIVE")
    rss = int(snap.get("rss_bytes") or 0)
    return {
        "row": "level", "nodes": level, "alive": alive,
        "dead": len(states) - alive,
        "node_seconds": round(node_seconds, 1),
        "pulse_fold_p50_us": round(pulse.get("fold_p50_ns", 0) / 1e3, 1),
        "pulse_fold_p99_us": round(pulse.get("fold_p99_ns", 0) / 1e3, 1),
        "pulse_records_per_s": round(pulse.get("records_per_s", 0.0), 1),
        "loop_lag_p50_ms": round(lag.get("p50_ns", 0) / 1e6, 2),
        "loop_lag_p99_ms": round(lag.get("p99_ns", 0) / 1e6, 2),
        "rss_bytes": rss,
        "rss_growth_per_node": (rss - rss_base) // max(1, level),
        "planes": {
            p: {"records_per_s": round(d.get("records_per_s", 0.0), 1),
                "bytes_per_s": round(d.get("bytes_per_s", 0.0), 1),
                "fold_p99_us": round(d.get("fold_p99_ns", 0) / 1e3, 1),
                "drops": d.get("drops", 0)}
            for p, d in planes.items()},
    }


def _verdicts(spec: ScaleSpec, rows: List[dict],
              rss_base: int) -> List[dict]:
    levels = [r for r in rows if r["row"] == "level"]
    worst_fold = max((r["pulse_fold_p99_us"] for r in levels),
                     default=0.0)
    worst_lag = max((r["loop_lag_p99_ms"] for r in levels), default=0.0)
    out = [
        {"row": "verdict", "check": "pulse_fold_p99_bounded",
         "ok": worst_fold < spec.fold_p99_budget_ms * 1000,
         "worst_p99_us": worst_fold,
         "budget_ms": spec.fold_p99_budget_ms},
        {"row": "verdict", "check": "loop_lag_bounded",
         "ok": worst_lag < spec.loop_lag_p99_budget_ms,
         "worst_p99_ms": worst_lag,
         "budget_ms": spec.loop_lag_p99_budget_ms},
    ]
    if levels:
        last = levels[-1]
        per_node = (last["rss_bytes"] - rss_base) / max(1, last["nodes"])
        out.append({"row": "verdict", "check": "rss_per_node_bounded",
                    "ok": per_node < spec.rss_per_node_budget_bytes,
                    "rss_base_bytes": rss_base,
                    "rss_final_bytes": last["rss_bytes"],
                    "per_node_bytes": int(per_node),
                    "budget_bytes": spec.rss_per_node_budget_bytes})
        out.append({"row": "verdict", "check": "no_unintended_deaths",
                    "ok": last["dead"] == 0, "dead": last["dead"],
                    "nodes": last["nodes"]})
    if len(levels) >= 3:
        # Sub-linearity in CARDINALITY, controlling for time: per-node
        # rings fill with seconds alive, so raw per-level RSS deltas
        # grow with wall time even when every store is bounded (levels
        # are sampled sequentially — by level 4 the level-1 nodes have
        # 4x the ring fill). Normalize each level's RSS delta by its
        # node-seconds delta: bytes per node-second is flat for bounded
        # per-node state, and a superlinear cardinality cost (eviction
        # scans, cross-node index churn) still shows as a rising slope.
        slopes = []
        prev_rss, prev_ns = rss_base, 0.0
        for r in levels:
            dns = r["node_seconds"] - prev_ns
            if dns > 0:
                slopes.append((r["rss_bytes"] - prev_rss) / dns)
            prev_rss, prev_ns = r["rss_bytes"], r["node_seconds"]
        ok = len(slopes) < 2 or slopes[-1] <= max(slopes[0] * 2.0,
                                                  16 * 1024)
        out.append({"row": "verdict", "check": "rss_growth_sublinear",
                    "ok": ok,
                    "marginal_bytes_per_node_second":
                        [int(s) for s in slopes]})
    return out


async def _run(spec: ScaleSpec) -> List[dict]:
    h = ScaleHarness(spec)
    rows: List[dict] = []
    await h.start()
    try:
        base = await h.sample(2)
        rss_base = int(base.get("rss_bytes") or 0)
        for level in spec.levels:
            await h.add_nodes(level)
            await asyncio.sleep(spec.hold_s)
            snap = await h.sample(int(spec.hold_s / max(
                0.05, _meta_tick_s(spec))))
            states = await h.node_states()
            rows.append(_level_row(level, snap, states, rss_base,
                                   h.node_seconds()))
        rows.extend(_verdicts(spec, rows, rss_base))
        if spec.kill_nodes > 0:
            rows.extend(await h.kill_some(spec.kill_nodes))
        # Per-plane ingest-ceiling rows at the max level: what each
        # plane was actually sustaining, from the plane's own meter.
        final = [r for r in rows if r["row"] == "level"][-1]
        for p, d in final["planes"].items():
            rows.append({"row": "plane", "plane": p, "nodes":
                         final["nodes"], **d})
        level_ok = [r["nodes"] for r in rows if r["row"] == "level"
                    and r["pulse_fold_p99_us"]
                    < spec.fold_p99_budget_ms * 1000
                    and r["loop_lag_p99_ms"]
                    < spec.loop_lag_p99_budget_ms]
        rows.append({"row": "meta", "seed": spec.seed,
                     "levels": list(spec.levels),
                     "tick_s": spec.tick_s, "hold_s": spec.hold_s,
                     "v1_nodes": spec.v1_nodes,
                     "kill_nodes": spec.kill_nodes,
                     "max_nodes_sustained": max(level_ok, default=0),
                     "host_cores": os.cpu_count(),
                     "passed": passed(rows)})
    finally:
        await h.stop()
    return rows


def _meta_tick_s(spec: ScaleSpec) -> float:
    try:
        return max(0.05, float(spec.env.get("meta_tick_ms", 1000))
                   / 1000.0)
    except (TypeError, ValueError):
        return 1.0


def run_scale(spec: Optional[ScaleSpec] = None) -> List[dict]:
    """Run the full ramp; returns the JSONL row list (see module
    docstring). ``passed(rows)`` gates the caller's exit code."""
    return asyncio.run(_run(spec or ScaleSpec()))
