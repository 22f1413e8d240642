"""Multi-node-in-one-box test harness.

Analogue of the reference's cluster_utils.Cluster (reference:
python/ray/cluster_utils.py:135): one controller plus N node agents as local
subprocesses, with node kill/add for failure testing (reference test pattern:
python/ray/tests/test_multi_node*.py, test_object_reconstruction*.py).
"""

from __future__ import annotations

import signal
import subprocess
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core.node import make_session_dir, start_agent, start_controller


class ClusterNode:
    def __init__(self, proc: subprocess.Popen, port: int,
                 resources: Dict[str, float]):
        self.proc = proc
        self.port = port
        self.resources = resources

    @property
    def addr(self) -> Tuple[str, int]:
        return ("127.0.0.1", self.port)


class Cluster:
    def __init__(self, num_nodes: int = 1,
                 resources: Optional[Dict[str, float]] = None):
        self.session_dir = make_session_dir()
        self.controller_proc, self.controller_port = start_controller(
            self.session_dir)
        self.nodes: List[ClusterNode] = []
        for _ in range(num_nodes):
            self.add_node(resources)

    @property
    def controller_addr(self) -> Tuple[str, int]:
        return ("127.0.0.1", self.controller_port)

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.controller_port}"

    def add_node(self, resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None) -> ClusterNode:
        resources = dict(resources or {"CPU": 4})
        proc, port = start_agent(self.controller_addr, self.session_dir,
                                 resources, labels)
        node = ClusterNode(proc, port, resources)
        self.nodes.append(node)
        return node

    def kill_node(self, node: ClusterNode) -> None:
        """SIGKILL the agent (simulates node failure; workers fate-share)."""
        node.proc.send_signal(signal.SIGKILL)
        node.proc.wait()

    def connect(self, **kw):
        import ray_tpu_torch
        return ray_tpu_torch.init(address=self.address,
                                  agent_address=f"127.0.0.1:{self.nodes[0].port}",
                                  **kw)

    def shutdown(self) -> None:
        import ray_tpu_torch
        try:
            if ray_tpu_torch.is_initialized():
                ray_tpu_torch.shutdown()
        except Exception:
            pass
        for n in self.nodes:
            if n.proc.poll() is None:
                n.proc.terminate()
        for n in self.nodes:
            try:
                n.proc.wait(timeout=3)
            except subprocess.TimeoutExpired:
                n.proc.kill()
        if self.controller_proc.poll() is None:
            self.controller_proc.terminate()
            try:
                self.controller_proc.wait(timeout=3)
            except subprocess.TimeoutExpired:
                self.controller_proc.kill()
