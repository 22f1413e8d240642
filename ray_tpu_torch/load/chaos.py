"""Declarative chaos schedule executor for soak runs.

Replays a list of ChaosActions at fixed offsets from load start against
a cluster_utils.Cluster (the multi-node-in-one-box harness): SIGKILL a
busy worker process, SIGKILL a node agent (workers fate-share; the
graftpulse cadence FSM drives suspect -> dead), or add replacement
capacity mid-run — the kill_random_node pattern from the reference's
chaos suites (reference: release/.../chaos_test.py; in-repo pattern:
tests/test_graftpulse.py, tests/test_graftlog.py).

Victim selection is observability-driven: kill_worker picks a pid that
recently produced task-attributed graftlog rows, so every injected kill
is one the salvage verdict can later hold the planes accountable for
(a salvaged tail must surface and attach to the killed task's trail).
The driver's own process, the controller, node agents, node[0] (it
hosts the driver's RPC agent) and the serve control plane are never
victims — chaos aims at the data plane.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ray_tpu_torch.load.scenario import ChaosAction, SoakSpec


@dataclass
class ChaosRecord:
    """What one executed action did, plus what the planes showed."""
    kind: str
    at_s: float                 # scheduled offset
    t_exec_s: float = 0.0       # actual offset from t0
    t_wall_ns: int = 0          # wall clock at execution (ns)
    pid: int = 0                # kill_worker victim
    node: str = ""              # node hex12 (victim or added)
    ok: bool = True
    detail: str = ""
    recovery_s: float = -1.0    # kill -> salvage/dead-detect latency
    salvaged_tasks: List[str] = field(default_factory=list)


class ChaosScheduler:
    """Runs the schedule on its own thread; `records` holds the outcome
    of every action for the verdict engine."""

    def __init__(self, cluster, spec: SoakSpec, log=None):
        self.cluster = cluster
        self.spec = spec
        self.records: List[ChaosRecord] = []
        self._log = log or (lambda *_: None)
        self._thread: Optional[threading.Thread] = None

    # -- victim selection ------------------------------------------------
    def _protected_pids(self) -> set:
        pids = {os.getpid(), self.cluster.controller_proc.pid}
        pids |= {n.proc.pid for n in self.cluster.nodes}
        return pids

    def _pick_worker_victim(self) -> Optional[tuple]:
        """A pid with recent task-attributed log rows — guaranteed to
        have a non-empty crash ring for the salvage verdict — that is
        not the driver, an agent, the controller, or the serve control
        plane. Returns (pid, recent_task_ids): those tasks' lines sit
        in the victim's ring tail, so after the kill their trail
        records must grow a salvaged log_tail."""
        from ray_tpu_torch import state
        protected = self._protected_pids()
        control_pids = set()
        try:
            for workers in state.stack().values():
                if not isinstance(workers, dict):
                    continue
                for pid, entry in workers.items():
                    actor = str((entry or {}).get("actor") or "")
                    if "controller" in actor.lower():
                        control_pids.add(int(pid))
        except Exception:
            pass  # stack dump is advisory; log rows still gate below
        by_pid: dict = {}
        for r in state.list_logs(limit=500):
            try:
                pid = int(r.get("pid") or 0)
            except (TypeError, ValueError):
                continue
            if (not pid or pid in protected or pid in control_pids
                    or not r.get("task")
                    or int(r.get("source") or 0) == 3):
                continue
            by_pid.setdefault(pid, []).append(
                (int(r.get("id") or 0), str(r["task"])))
        for pid, rows in sorted(by_pid.items(),
                                key=lambda kv: -max(i for i, _ in kv[1])):
            try:
                os.kill(pid, 0)  # still alive?
            except OSError:
                continue
            # Newest-first distinct task ids — the ring tail's likely
            # contents at kill time.
            tasks, seen = [], set()
            for _, tid in sorted(rows, reverse=True):
                if tid not in seen:
                    seen.add(tid)
                    tasks.append(tid)
                if len(tasks) >= 8:
                    break
            return pid, tasks
        return None

    def _pick_node_victim(self):
        """Last alive agent that isn't node[0] (the driver's agent)."""
        for node in reversed(self.cluster.nodes[1:]):
            if node.proc.poll() is None:
                return node
        return None

    @staticmethod
    def _node_hex_by_port(port: int) -> str:
        from ray_tpu_torch import state
        for n in state.list_nodes():
            if n["addr"].endswith(f":{port}"):
                return n["node_id"]
        return ""

    # -- action execution ------------------------------------------------
    def _exec(self, action: ChaosAction, t0: float) -> ChaosRecord:
        from ray_tpu_torch import state
        rec = ChaosRecord(kind=action.kind, at_s=action.at_s,
                          t_exec_s=time.monotonic() - t0,
                          t_wall_ns=time.time_ns())
        budget = self.spec.slo.recovery_s
        if action.kind == "kill_worker":
            victim = self._pick_worker_victim()
            if victim is None:
                rec.ok = False
                rec.detail = "no task-attributed worker pid to kill"
                return rec
            pid, candidates = victim
            rec.pid = pid
            os.kill(pid, signal.SIGKILL)
            self._log(f"chaos: SIGKILL worker pid {pid}")
            kill_mono = time.monotonic()
            # Recovery = the salvage latency: dead-worker detection +
            # crash-ring recovery + controller ingest + trail attach.
            # The store itself dedups salvaged rows the live tail
            # already shipped (graftlog seq high-water), so the durable
            # artifact is the cross-plane join: the victim's recent
            # tasks' trail records grow a `log_tail`.
            deadline = kill_mono + budget
            while time.monotonic() < deadline:
                got = []
                for tid in candidates:
                    try:
                        task = state.get_task(tid)
                    except Exception:
                        continue
                    if task and task.get("log_tail"):
                        got.append(tid)
                if got:
                    rec.recovery_s = time.monotonic() - kill_mono
                    rec.salvaged_tasks = sorted(got)
                    break
                time.sleep(0.2)
            else:
                rec.ok = False
                rec.detail = (f"no trail log_tail for pid {pid} tasks "
                              f"{candidates[:3]} within {budget:.0f}s")
        elif action.kind == "kill_node":
            node = self._pick_node_victim()
            if node is None:
                rec.ok = False
                rec.detail = "no chaos-eligible node alive"
                return rec
            rec.node = self._node_hex_by_port(node.port)
            self.cluster.kill_node(node)
            self._log(f"chaos: SIGKILL node agent {rec.node} "
                      f"(port {node.port})")
            kill_mono = time.monotonic()
            # Recovery = pulse-silence detection: suspect -> DEAD in the
            # controller's membership table.
            deadline = kill_mono + budget
            while time.monotonic() < deadline:
                states = {n["node_id"]: n["state"]
                          for n in state.list_nodes()}
                if "DEAD" in str(states.get(rec.node)):
                    rec.recovery_s = time.monotonic() - kill_mono
                    break
                time.sleep(0.1)
            else:
                rec.ok = False
                rec.detail = (f"node {rec.node} never marked DEAD "
                              f"within {budget:.0f}s")
        elif action.kind == "add_node":
            node = self.cluster.add_node(
                {"CPU": self.spec.node_cpus})
            deadline = time.monotonic() + budget
            while time.monotonic() < deadline:
                rec.node = self._node_hex_by_port(node.port)
                if rec.node:
                    rec.recovery_s = 0.0
                    break
                time.sleep(0.1)
            else:
                rec.ok = False
                rec.detail = "added node never registered"
            self._log(f"chaos: added node {rec.node or '?'} "
                      f"(port {node.port})")
        else:
            rec.ok = False
            rec.detail = f"unknown chaos kind {action.kind!r}"
        return rec

    def _run(self, t0: float) -> None:
        for action in sorted(self.spec.chaos, key=lambda a: a.at_s):
            now = time.monotonic() - t0
            if action.at_s > now:
                time.sleep(action.at_s - now)
            try:
                self.records.append(self._exec(action, t0))
            except Exception as e:
                self.records.append(ChaosRecord(
                    kind=action.kind, at_s=action.at_s, ok=False,
                    t_exec_s=time.monotonic() - t0,
                    t_wall_ns=time.time_ns(), detail=repr(e)))

    def start(self, t0: float) -> None:
        self._thread = threading.Thread(target=self._run, args=(t0,),
                                        name="soak-chaos", daemon=True)
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
