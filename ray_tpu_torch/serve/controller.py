"""ServeController — reconciles deployments to their target replica sets.

Analogue of the reference's control plane (reference:
serve/_private/controller.py ServeController:103 + deployment_state.py
replica FSMs + autoscaling_state.py). One named actor:

  * deploy(name, config) records the target; a reconcile loop creates or
    removes Replica actors to match num_replicas
  * routing table (replica handles per deployment) served to routers;
    routers refresh on a version bump (cheap poll, reference long-poll)
  * autoscaling: average ongoing requests per replica vs
    target_ongoing_requests resizes within [min_replicas, max_replicas]
  * health checks replace dead replicas
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.serve.replica import Replica


class _DeploymentState:
    def __init__(self, name: str, config: dict):
        self.name = name
        self.config = config
        self.replicas: List[Any] = []  # ActorHandles
        self.born: Dict[bytes, float] = {}     # actor_id -> creation time
        self.healthy: Dict[bytes, bool] = {}   # ever passed a health check
        self.last_scale = 0.0
        # Autoscaler's replica target, kept OUT of the user-supplied
        # config (reference keeps the autoscaled target in deployment
        # state, never mutating the submitted config).
        self.autoscale_target: Optional[int] = None


class ServeController:
    CONTROLLER_NAME = "SERVE_CONTROLLER"

    def __init__(self):
        import threading
        self._deployments: Dict[str, _DeploymentState] = {}
        self._version = 0
        self._running = True
        # One lock covers all state transitions: actor-task methods
        # (deploy/delete) and the control-loop thread (health/autoscale)
        # mutate the same _DeploymentStates.
        self._lock = threading.RLock()
        self._thread = threading.Thread(target=self._control_loop,
                                        daemon=True, name="serve-ctrl")
        self._thread.start()

    # -- API (called via actor handle) ---------------------------------
    def deploy(self, name: str, config_blob: bytes) -> None:
        config = cloudpickle.loads(config_blob)
        with self._lock:
            old = self._deployments.get(name)
            if old is not None:
                # Upsert = replace: the old replicas run the OLD class
                # blob; drain and retire them (leaking them would double
                # resident replicas per redeploy).
                for r in old.replicas:
                    self._drain_and_kill(r)
            self._deployments[name] = _DeploymentState(name, config)
            self._reconcile_one(self._deployments[name])
            self._bump_version()

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            st = self._deployments.pop(name, None)
            if st is not None:
                for r in st.replicas:
                    self._drain_and_kill(r, drain_s=5.0)
                self._bump_version()

    def _drain_and_kill(self, replica, drain_s: float = 30.0) -> None:
        """Best-effort drain: let in-flight requests finish before the
        kill (reference: replica graceful shutdown drain)."""
        import threading

        def drain():
            deadline = time.time() + drain_s
            while time.time() < deadline:
                try:
                    if ray_tpu_torch.get(replica.queue_len.remote(),
                                   timeout=5) == 0:
                        break
                except Exception:
                    break
                time.sleep(0.25)
            try:
                ray_tpu_torch.kill(replica)
            except Exception:
                pass

        threading.Thread(target=drain, daemon=True).start()

    def _bump_version(self) -> None:
        self._version += 1
        # Push-invalidate routers via the core pubsub hub (reference:
        # serve long_poll.py:228 LongPollHost — ours rides the runtime's
        # existing hub instead of a serve-private one).
        try:
            from ray_tpu_torch.core.ref import get_core_worker
            cw = get_core_worker()
            cw._spawn(cw.controller.call(
                "pubsub_publish", "serve_events",
                {"version": self._version}))
        except Exception:
            pass

    def routing_table(self) -> dict:
        """{deployment: [replica handles]} + version for router caching."""
        with self._lock:
            return {
                "version": self._version,
                "deployments": {name: list(st.replicas)
                                for name, st in self._deployments.items()},
            }

    def routing_version(self) -> int:
        return self._version

    def list_deployments(self) -> dict:
        with self._lock:
            return {
                name: {"num_replicas": len(st.replicas),
                       "config": {k: v for k, v in st.config.items()
                                  if k not in ("cls_blob",
                                               "init_args_blob")}}
                for name, st in self._deployments.items()}

    def shutdown_serve(self) -> None:
        """Full teardown: kill replicas SYNCHRONOUSLY — drain threads
        would die with the controller process, leaking replicas."""
        self._running = False
        with self._lock:
            for name in list(self._deployments):
                st = self._deployments.pop(name)
                for r in st.replicas:
                    try:
                        ray_tpu_torch.kill(r)
                    except Exception:
                        pass
            self._bump_version()

    # -- reconciliation -------------------------------------------------
    def _make_replica(self, st: _DeploymentState):
        cfg = st.config
        opts: Dict[str, Any] = {"max_restarts": 0}
        if cfg.get("num_gpus"):
            # Whole cards, pinned to the replica by CUDA_VISIBLE_DEVICES; a
            # replica with none sets no CUDA_VISIBLE_DEVICES and sees every
            # card of its node.
            opts["num_gpus"] = cfg["num_gpus"]
        if cfg.get("num_cpus") is not None:
            opts["num_cpus"] = cfg["num_cpus"]
        actor_cls = ray_tpu_torch.remote(Replica)
        return actor_cls.options(**opts).remote(
            cfg["cls_blob"], cfg["init_args_blob"], st.name,
            cfg.get("max_ongoing_requests", 100))

    def _reconcile_one(self, st: _DeploymentState) -> None:
        target = (st.autoscale_target if st.autoscale_target is not None
                  else int(st.config.get("num_replicas", 1)))
        changed = False
        while len(st.replicas) < target:
            r = self._make_replica(st)
            st.replicas.append(r)
            st.born[r.actor_id.binary()] = time.time()
            changed = True
        while len(st.replicas) > target:
            victim = st.replicas.pop()
            st.born.pop(victim.actor_id.binary(), None)
            st.healthy.pop(victim.actor_id.binary(), None)
            self._drain_and_kill(victim)  # don't cut in-flight requests
            changed = True
        if changed:
            self._bump_version()

    def _control_loop(self) -> None:
        """Health checks + autoscaling (runs in the controller actor)."""
        while self._running:
            time.sleep(1.0)
            try:
                with self._lock:
                    states = list(self._deployments.values())
                # One graftpulse fetch per pass, shared by every
                # deployment — and only when some deployment actually
                # scales on native latency.
                p99_ms = 0.0
                if any((st.config.get("autoscaling_config") or {})
                       .get("target_native_p99_ms")
                       for st in states):
                    p99_ms = self._native_p99_ms()
                for st in states:
                    # Probe replicas WITHOUT the lock (blocking RPCs must
                    # not starve deploy/routing_table), then mutate under
                    # it, skipping states deleted/replaced mid-pass.
                    with self._lock:
                        replicas = list(st.replicas)
                    health = self._probe(replicas, "health")
                    loads = self._probe(replicas, "queue_len")
                    with self._lock:
                        if self._deployments.get(st.name) is not st:
                            continue
                        self._health_pass(st, health)
                        self._autoscale_pass(st, loads, p99_ms)
            except Exception:
                pass

    @staticmethod
    def _probe(replicas: List[Any], method: str) -> Dict[bytes, Any]:
        """Probe all replicas CONCURRENTLY (submit everything, then
        collect against one shared deadline) — one hung replica must not
        serialize the whole control loop at 10s per probe."""
        refs = {}
        for r in replicas:
            try:
                refs[r.actor_id.binary()] = getattr(r, method).remote()
            except Exception:
                refs[r.actor_id.binary()] = None
        out: Dict[bytes, Any] = {}
        deadline = time.monotonic() + 10.0
        for aid, ref in refs.items():
            if ref is None:
                out[aid] = None
                continue
            try:
                out[aid] = ray_tpu_torch.get(
                    ref, timeout=max(0.1, deadline - time.monotonic()))
            except Exception:
                out[aid] = None
        return out

    # Replicas doing heavy init (weights + CUDA start) must not be
    # culled before they ever come up (reference: deployment_state.py
    # initialization-timeout vs health-check distinction).
    STARTUP_GRACE_S = 300.0

    def _health_pass(self, st: _DeploymentState,
                     health: Dict[bytes, Any]) -> None:
        alive = []
        for r in st.replicas:
            aid = r.actor_id.binary()
            h = health.get(aid)
            if h is not None and h["healthy"]:
                st.healthy[aid] = True
                alive.append(r)
                continue
            if h is None and not st.healthy.get(aid) and \
                    time.time() - st.born.get(aid, 0) < \
                    self.STARTUP_GRACE_S:
                alive.append(r)  # still starting: give it time
                continue
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
            st.born.pop(aid, None)
            st.healthy.pop(aid, None)
        if len(alive) != len(st.replicas):
            st.replicas = alive
            self._bump_version()
            self._reconcile_one(st)  # replace the dead

    def ready_replicas(self, name: str) -> int:
        """Replicas that have passed a health check (serve.run blocks on
        this going positive)."""
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                return 0
            return sum(1 for r in st.replicas
                       if st.healthy.get(r.actor_id.binary()))

    def _native_p99_ms(self) -> float:
        """Cluster-wide native-op p99 from the graftpulse aggregates
        (0.0 when the pulse plane is unavailable)."""
        try:
            from ray_tpu_torch.core.ref import get_core_worker
            cw = get_core_worker()
            st = cw._run(cw.controller.call("autoscaler_state")).result(5)
            return float(st.get("native_p99_ms") or 0.0)
        except Exception:
            return 0.0

    def _autoscale_pass(self, st: _DeploymentState,
                        load_map: Dict[bytes, Any],
                        native_p99_ms: float = 0.0) -> None:
        cfg = st.config
        auto = cfg.get("autoscaling_config")
        if not auto or not st.replicas:
            return
        loads = [load_map.get(r.actor_id.binary()) for r in st.replicas]
        loads = [v for v in loads if v is not None]
        if not loads:
            return
        avg = sum(loads) / max(1, len(loads))
        target_ongoing = auto.get("target_ongoing_requests", 2.0)
        # graftpulse latency signal: with target_native_p99_ms set, a
        # cluster-wide native-op p99 above the budget counts as upscale
        # pressure even while per-replica queue lengths (request counts)
        # look fine — replicas waiting on a saturated native plane queue
        # invisibly (reference scales on ongoing requests only;
        # ROADMAP 4c wants the native latency table as the signal).
        p99_budget = float(auto.get("target_native_p99_ms") or 0.0)
        latency_pressure = (p99_budget > 0
                            and native_p99_ms > p99_budget
                            and avg > 0)
        n = len(st.replicas)
        since_scale = time.time() - st.last_scale
        want = n
        # Upscale reacts fast; downscale waits much longer so a brief load
        # dip doesn't drop replicas (reference: upscale_delay_s=30 vs
        # downscale_delay_s=600 defaults, autoscaling_policy.py).
        if avg > target_ongoing or latency_pressure:
            if since_scale < auto.get("upscale_delay_s", 3.0):
                return
            want = min(auto.get("max_replicas", 4), n + 1)
        elif avg < target_ongoing / 2:
            if since_scale < auto.get("downscale_delay_s", 30.0):
                return
            want = max(auto.get("min_replicas", 1), n - 1)
        if want != n:
            st.autoscale_target = want
            st.last_scale = time.time()
            self._reconcile_one(st)
