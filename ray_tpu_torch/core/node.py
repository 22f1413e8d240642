"""Node bootstrap: spawn/stop controller and node-agent processes.

Analogue of the reference's node bootstrap (reference: python/ray/_private/
node.py start_head_processes + services.py subprocess spawners): the head runs
a controller process and a node agent process; additional nodes run one agent
each. Ports are handed back over stdout pipes.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Tuple

from ray_tpu_torch.utils import get_logger

logger = get_logger("node")


def _wait_port_line(proc: subprocess.Popen, prefix: str,
                    timeout: float = 30.0) -> int:
    deadline = time.time() + timeout
    assert proc.stdout is not None
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"process exited ({proc.returncode}) before printing "
                    f"{prefix}")
            time.sleep(0.05)
            continue
        line = line.decode() if isinstance(line, bytes) else line
        if line.startswith(prefix):
            return int(line.strip().split("=", 1)[1])
    raise TimeoutError(f"timed out waiting for {prefix}")


def make_session_dir() -> str:
    base = tempfile.mkdtemp(prefix="ray_tpu_torch_session_")
    os.makedirs(os.path.join(base, "logs"), exist_ok=True)
    return base


def _child_env() -> Dict[str, str]:
    """Propagate config overrides to spawned processes as RAY_TPU_TORCH_* env
    vars (the reference's GCS serializes --config-list to every process,
    reference: python/ray/_private/services.py)."""
    from ray_tpu_torch.utils.config import Config, GlobalConfig
    env = dict(os.environ)
    env.update(Config.deserialize_into_env(GlobalConfig.serialize()))
    return env


def start_controller(session_dir: str) -> Tuple[subprocess.Popen, int]:
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.core.controller", "--port", "0"],
        stdout=subprocess.PIPE, cwd=os.getcwd(), env=_child_env())
    port = _wait_port_line(proc, "CONTROLLER_PORT=")
    return proc, port


def start_agent(controller_addr: Tuple[str, int], session_dir: str,
                resources: Optional[Dict[str, float]] = None,
                labels: Optional[Dict[str, str]] = None
                ) -> Tuple[subprocess.Popen, int]:
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.core.node_agent",
         "--controller", f"{controller_addr[0]}:{controller_addr[1]}",
         "--resources", json.dumps(resources or {}),
         "--labels", json.dumps(labels or {}),
         "--session-dir", session_dir],
        stdout=subprocess.PIPE, cwd=os.getcwd(), env=_child_env())
    port = _wait_port_line(proc, "AGENT_PORT=")
    return proc, port


class LocalNode:
    """Head bring-up: controller + one agent (+ cleanup)."""

    def __init__(self, resources: Optional[Dict[str, float]] = None,
                 session_dir: Optional[str] = None):
        self.session_dir = session_dir or make_session_dir()
        self.controller_proc, self.controller_port = start_controller(
            self.session_dir)
        self.agent_proc, self.agent_port = start_agent(
            ("127.0.0.1", self.controller_port), self.session_dir, resources)
        atexit.register(self.stop)

    @property
    def controller_addr(self) -> Tuple[str, int]:
        return ("127.0.0.1", self.controller_port)

    @property
    def agent_addr(self) -> Tuple[str, int]:
        return ("127.0.0.1", self.agent_port)

    def stop(self) -> None:
        for proc in (self.agent_proc, self.controller_proc):
            if proc and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=3)
                except subprocess.TimeoutExpired:
                    proc.kill()
        shm = os.path.join("/dev/shm", "ray_tpu_torch",
                           os.path.basename(self.session_dir))
        shutil.rmtree(shm, ignore_errors=True)
