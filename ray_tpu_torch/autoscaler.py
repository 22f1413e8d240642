"""Autoscaler — demand-driven node scale-up/down over a NodeProvider.

Analogue of the reference's autoscaler v2 (reference: python/ray/
autoscaler/v2/autoscaler.py Autoscaler.update -> scheduler.py
ResourceDemandScheduler.schedule bin-packing -> instance_manager/
reconciling cloud instances; demand aggregated GCS-side by
gcs_autoscaler_state_manager.cc). Slimmed loop:

  demand  = pending actors + pending PG bundles + recent infeasible leases
  supply  = alive nodes' total resources
  scale UP when demand doesn't bin-pack into idle supply (one node per
  tick, up to max_nodes); scale DOWN nodes fully idle past
  idle_timeout_s (down to min_nodes).

NodeProvider is the cloud seam (reference: autoscaler node providers);
LocalNodeProvider spawns agent processes on this host — the fake-multinode
analogue used by tests and single-host elasticity.
"""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.common import resources_fit, resources_sub
from ray_tpu_torch.utils import get_logger

logger = get_logger("autoscaler")


class NodeProvider:
    """Cloud seam: create/terminate worker nodes.

    node_port(handle) is the scale-down correlation key: the agent RPC
    port of the launched node (the autoscaler only terminates nodes it
    can correlate to a handle; returning None opts a node out of
    scale-down)."""

    def create_node(self, resources: Dict[str, float]) -> Any:
        raise NotImplementedError

    def terminate_node(self, handle: Any) -> None:
        raise NotImplementedError

    def node_port(self, handle: Any) -> Optional[int]:
        return None

    def handle_failed(self, handle: Any) -> bool:
        """True if this launch is known-dead (will never register) — the
        autoscaler drops such handles and can retry the scale-up."""
        return False


class LocalNodeProvider(NodeProvider):
    """Spawns node agents on this host (reference:
    autoscaler/_private/fake_multi_node)."""

    def __init__(self, controller_addr, session_dir: Optional[str] = None):
        from ray_tpu_torch.core.node import make_session_dir
        self._controller_addr = tuple(controller_addr)
        self._session_dir = session_dir or make_session_dir()

    def create_node(self, resources: Dict[str, float]):
        from ray_tpu_torch.core.node import start_agent
        proc, port = start_agent(self._controller_addr, self._session_dir,
                                 dict(resources))
        return {"proc": proc, "port": port}

    def node_port(self, handle) -> Optional[int]:
        return handle["port"]

    def terminate_node(self, handle) -> None:
        proc = handle["proc"] if isinstance(handle, dict) else handle
        if isinstance(proc, subprocess.Popen) and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()


class GPUVMProvider(NodeProvider):
    """GPU-VM provider: launches whole GPU VMs as cluster nodes — the
    counterpart of the JAX package's ``TPUPodProvider`` (reference:
    python/ray/autoscaler/_private/gcp/ node provider).

    Cloud access rides COMMAND TEMPLATES (gcloud by default) instead of
    a baked-in SDK — the same seam the reference fills per cloud. Each
    template is a list of argv strings formatted with {name},
    {accelerator_type}, {zone}, plus {controller} and {agent_port} for
    the startup script. Defaults target `gcloud compute instances` with
    an H100 VM (`a3-highgpu-8g`: 8 cards); tests substitute stub
    commands.

        provider = GPUVMProvider(
            zone="us-central1-a", accelerator_type="nvidia-h100-80gb",
            controller_addr=("10.0.0.2", 7001))
        Autoscaler(provider, node_resources={"GPU": 8, "CPU": 208}, ...)
    """

    AGENT_PORT = 7011  # fixed agent port on every VM (correlation key)

    def __init__(self, *, zone: str, accelerator_type: str,
                 controller_addr, machine_type: str = "a3-highgpu-8g",
                 accelerator_count: int = 8,
                 image_family: str = "common-cu124",
                 name_prefix: str = "raytpu",
                 create_cmd: Optional[List[str]] = None,
                 delete_cmd: Optional[List[str]] = None):
        self._zone = zone
        self._acc = accelerator_type
        self._controller = tuple(controller_addr)
        self._prefix = name_prefix
        self._seq = 0
        self._create_cmd = create_cmd or [
            "gcloud", "compute", "instances", "create", "{name}",
            "--zone", "{zone}", "--machine-type", machine_type,
            "--accelerator",
            f"type={{accelerator_type}},count={accelerator_count}",
            "--maintenance-policy", "TERMINATE",
            "--image-family", image_family,
            "--image-project", "deeplearning-platform-release",
            "--metadata", ("install-nvidia-driver=True,"
                           "startup-script=pip install ray_tpu_torch && "
                           "python -m ray_tpu_torch.cli start "
                           "--address {controller} --port {agent_port}"),
        ]
        self._delete_cmd = delete_cmd or [
            "gcloud", "compute", "instances", "delete", "{name}",
            "--zone", "{zone}", "--quiet",
        ]

    def _fmt(self, template: List[str], name: str) -> List[str]:
        # Placeholder-only substitution (str.replace, NOT str.format):
        # user templates legitimately carry literal braces (inline JSON,
        # bash ${VAR} in startup scripts).
        subs = {
            "{name}": name, "{zone}": self._zone,
            "{accelerator_type}": self._acc,
            "{controller}": f"{self._controller[0]}:{self._controller[1]}",
            "{agent_port}": str(self.AGENT_PORT),
        }
        out = []
        for part in template:
            for token, value in subs.items():
                part = part.replace(token, value)
            out.append(part)
        return out

    def _launch(self, cmd: List[str], what: str,
                handle: Optional[dict] = None):
        """Start the cloud CLI WITHOUT blocking the reconcile thread
        (VM create/delete takes minutes; the reference's instance
        manager is similarly asynchronous). An immediately-failing
        command (bad binary/flags) still raises here; a background
        reaper wait()s the child (no zombies), drops the log on success,
        and marks `handle['failed']` on a late nonzero exit (quota,
        capacity, auth) so the autoscaler's reconcile can drop the
        handle and retry instead of waiting forever on a node that will
        never register."""
        import tempfile
        import threading
        log = tempfile.NamedTemporaryFile(
            mode="w+", prefix=f"raytpu-{what}-", suffix=".log",
            delete=False)
        try:
            proc = subprocess.Popen(cmd, stdout=log,
                                    stderr=subprocess.STDOUT)
            time.sleep(0.2)
            rc = proc.poll()
            if rc is not None and rc != 0:
                log.seek(0)
                tail = log.read()[-500:]
                proc.wait()
                raise RuntimeError(
                    f"GPU VM {what} failed fast "
                    f"({' '.join(cmd[:6])}...): {tail}")
        finally:
            log.close()

        def reap():
            rc = proc.wait()
            if rc == 0:
                try:
                    import os
                    os.unlink(log.name)
                except OSError:
                    pass
            else:
                if handle is not None:
                    handle["failed"] = True
                logger.warning("GPU VM %s exited rc=%d (log: %s)",
                               what, rc, log.name)

        threading.Thread(target=reap, daemon=True,
                         name=f"gpuvm-{what}-reaper").start()
        return proc

    def create_node(self, resources: Dict[str, float]):
        self._seq += 1
        name = f"{self._prefix}-{self._seq}"
        handle = {"name": name, "port": self.AGENT_PORT, "failed": False}
        handle["proc"] = self._launch(self._fmt(self._create_cmd, name),
                                      "create", handle=handle)
        logger.info("creating GPU VM %s (%s in %s)", name, self._acc,
                    self._zone)
        return handle

    def node_port(self, handle) -> Optional[int]:
        return handle.get("port")

    def handle_failed(self, handle) -> bool:
        return bool(handle.get("failed"))

    def terminate_node(self, handle) -> None:
        try:
            self._launch(self._fmt(self._delete_cmd, handle["name"]),
                         "delete")
        except RuntimeError as e:
            logger.warning("%s", e)


class Autoscaler:
    def __init__(self, provider: NodeProvider, *,
                 node_resources: Dict[str, float],
                 min_nodes: int = 0, max_nodes: int = 4,
                 idle_timeout_s: float = 30.0,
                 update_period_s: float = 1.0,
                 p99_scale_up_ms: Optional[float] = None):
        """node_resources: the shape of one launchable node (homogeneous
        node groups; the reference's multi-node-type scheduler is the
        extension point).

        p99_scale_up_ms: graftpulse latency signal — scale up when the
        cluster-wide native-op p99 exceeds this many milliseconds while
        leases are queued, even with zero pending demand (the reference
        scales on request counts only). Default from the
        autoscale_p99_ms config flag; 0/None disables."""
        from ray_tpu_torch import api
        from ray_tpu_torch.utils.config import GlobalConfig
        self._cw = api._cw()
        self._provider = provider
        self._node_resources = dict(node_resources)
        self._min = min_nodes
        self._max = max_nodes
        self._idle_timeout = idle_timeout_s
        self._period = update_period_s
        if p99_scale_up_ms is None:
            p99_scale_up_ms = float(GlobalConfig.autoscale_p99_ms)
        self._p99_ms = float(p99_scale_up_ms or 0.0)
        self._launched: List[Any] = []   # provider handles
        self._idle_since: Dict[bytes, float] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # Exponential backoff after failed launches, so a persistent
        # cloud failure (quota exhausted) doesn't become an endless
        # create+delete CLI pair every tick.
        self._failure_backoff_s = 0.0
        self._next_launch_at = 0.0

    # -- scheduling math -------------------------------------------------
    @staticmethod
    def _bin_packs(demands: List[Dict[str, float]],
                   free: List[Dict[str, float]]) -> List[Dict[str, float]]:
        """First-fit-decreasing: returns the demands that DON'T fit."""
        free = [dict(f) for f in free]
        unmet = []
        for d in sorted(demands, key=lambda d: -sum(d.values())):
            for f in free:
                if resources_fit(f, d):
                    resources_sub(f, d)
                    break
            else:
                unmet.append(d)
        return unmet

    def _state(self) -> dict:
        return self._cw._run(self._cw.controller.call(
            "autoscaler_state")).result(30)

    def update(self) -> Optional[str]:
        """One reconcile tick; returns the action taken (for tests)."""
        # Drop launches the provider knows are dead (create failed after
        # the fail-fast window) so their capacity doesn't suppress the
        # next scale-up forever.
        dead = [h for h in self._launched
                if self._provider.handle_failed(h)]
        for h in dead:
            logger.warning("dropping failed node launch %s",
                           h.get("name", h) if isinstance(h, dict) else h)
            self._launched.remove(h)
            # Best-effort terminate: a late create failure may still have
            # provisioned the cloud resource (e.g. the VM came up but the
            # startup script failed) — never leak it. Providers treat
            # deleting a nonexistent node as a quiet no-op.
            try:
                self._provider.terminate_node(h)
            except Exception as e:
                logger.warning("terminate of failed launch: %r", e)
        if dead:
            self._failure_backoff_s = min(
                300.0, max(2.0, self._failure_backoff_s * 2))
            self._next_launch_at = time.time() + self._failure_backoff_s
            logger.warning("launch backoff %.0fs after failure",
                           self._failure_backoff_s)
        st = self._state()
        alive = [n for n in st["nodes"] if n["state"] == "ALIVE"]
        # Correlate launched handles with registered nodes by agent port
        # so scale-down terminates the node it drained, never a random
        # launch (and never a node someone else started).
        node_addr_ports = {}
        full = self._cw._run(
            self._cw.controller.call("get_nodes")).result(30)
        for n in full:
            node_addr_ports[n["node_id"]] = n["addr"][1]
        handles_by_port = {}
        for h in self._launched:
            port = self._provider.node_port(h)
            if port is not None:
                handles_by_port[port] = h
        # A launched node registering ALIVE proves the provider works
        # again: clear the failure backoff.
        if self._failure_backoff_s and any(
                node_addr_ports.get(n["node_id"]) in handles_by_port
                for n in alive):
            self._failure_backoff_s = 0.0
            self._next_launch_at = 0.0
        demands = (st["pending_actors"] + st["pending_pg_bundles"]
                   + st["infeasible"])
        demands = [d for d in demands if d]
        unmet = self._bin_packs(demands, [n["available"] for n in alive])
        # graftpulse latency signal: the controller folds every node's
        # pulse histograms into a cluster p99 per native op; when the
        # worst op's p99 blows the budget WHILE leases are queued, the
        # cluster is saturated even if nothing is pending-infeasible —
        # scale up on latency alone (request counts can be flat).
        p99_budget_ms = getattr(self, "_p99_ms", 0.0)
        p99_ms = float(st.get("native_p99_ms") or 0.0)
        queue_depth = int(st.get("queue_depth") or 0)
        latency_pressure = (p99_budget_ms > 0 and p99_ms > p99_budget_ms
                            and queue_depth > 0)
        if (unmet or latency_pressure) and len(alive) < self._max \
                and time.time() >= self._next_launch_at:
            # One node per tick (the reference batches; conservative here).
            fits_new = self._bin_packs(unmet, [self._node_resources])
            if len(fits_new) < len(unmet) or (latency_pressure
                                              and not unmet):
                if unmet:
                    logger.info("scaling UP (+1 node) for %d unmet "
                                "demands", len(unmet))
                else:
                    logger.info("scaling UP (+1 node): native p99 "
                                "%.1fms > %.1fms with %d leases queued",
                                p99_ms, p99_budget_ms, queue_depth)
                self._launched.append(
                    self._provider.create_node(self._node_resources))
                return "up"
            logger.warning("demand %s does not fit node shape %s",
                           unmet[:3], self._node_resources)
        # Scale down: nodes with zero usage for idle_timeout_s.
        if len(alive) > self._min and len(self._launched) > 0:
            now = time.time()
            for n in alive:
                nid = n["node_id"]
                busy = any(n["available"].get(k, 0) < v - 1e-9
                           for k, v in n["total"].items())
                if busy or demands or latency_pressure:
                    self._idle_since.pop(nid, None)
                    continue
                handle = handles_by_port.get(node_addr_ports.get(nid))
                if handle is None:
                    continue  # not one of ours: never terminate it
                first = self._idle_since.setdefault(nid, now)
                if now - first > self._idle_timeout:
                    # Drain via the controller, terminate via provider.
                    try:
                        self._cw._run(self._cw.controller.call(
                            "drain_node", nid)).result(30)
                    except Exception:
                        pass
                    self._launched.remove(handle)
                    self._provider.terminate_node(handle)
                    self._idle_since.pop(nid, None)
                    logger.info("scaled DOWN one idle node")
                    return "down"
        return None

    # -- loop ------------------------------------------------------------
    def start(self) -> "Autoscaler":
        self._running = True

        def loop():
            while self._running:
                try:
                    self.update()
                except Exception as e:
                    logger.debug("autoscaler tick failed: %r", e)
                time.sleep(self._period)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)
        for handle in self._launched:
            self._provider.terminate_node(handle)
        self._launched.clear()
