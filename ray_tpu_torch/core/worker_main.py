"""Worker process entry point (spawned by the node agent).

Analogue of the reference's default_worker.py (reference:
python/ray/_private/workers/default_worker.py): connects the CoreWorker in
worker mode and serves pushed tasks until the parent agent disappears.
"""

from __future__ import annotations

import os
import sys
import time


def main() -> None:
    agent_host, agent_port = os.environ["RAY_TPU_TORCH_AGENT_ADDR"].rsplit(":", 1)
    ctrl_host, ctrl_port = os.environ["RAY_TPU_TORCH_CONTROLLER_ADDR"].rsplit(":", 1)
    session_dir = os.environ.get("RAY_TPU_TORCH_SESSION_DIR", "/tmp")

    from ray_tpu_torch.utils.logging import configure
    configure("worker", session_dir)

    # Signal-path stack dumps (reference: `ray stack` via py-spy,
    # scripts.py:2706): SIGUSR1 makes faulthandler write every thread's
    # Python stack to a per-pid file the agent reads — works even when
    # the worker's event loop is wedged (the RPC stack path cannot).
    import faulthandler
    import signal
    stacks_dir = os.path.join(session_dir, "stacks")
    os.makedirs(stacks_dir, exist_ok=True)
    # Named by an agent-assigned token, not os.getpid(): a containerized
    # worker's in-namespace pid differs from the host pid the agent
    # knows. Appends accumulate; the agent reads only the bytes written
    # after each signal it sends.
    token = os.environ.get("RAY_TPU_TORCH_STACK_TOKEN", str(os.getpid()))
    _stack_file = open(os.path.join(stacks_dir, f"{token}.txt"), "a")
    faulthandler.register(signal.SIGUSR1, file=_stack_file,
                          all_threads=True)

    from ray_tpu_torch.core.core_worker import CoreWorker

    cw = CoreWorker("worker", (agent_host, int(agent_port)),
                    (ctrl_host, int(ctrl_port)), session_dir)
    # Bind the public API to this worker's CoreWorker so user task code can
    # call ray_tpu.get/put/remote inside workers (reference analogue:
    # python/ray/_private/worker.py global worker in WORKER mode).
    import ray_tpu_torch.api as _api
    _api._core_worker = cw
    parent = os.getppid()
    try:
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:  # agent died; fate-share
                break
    finally:
        cw.shutdown()
        sys.exit(0)


if __name__ == "__main__":
    main()
