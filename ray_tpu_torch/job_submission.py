"""Job submission: run driver scripts on the cluster with captured logs
(counterpart of ``ray_tpu/job_submission.py``).

Analogue of the reference's job layer (reference: python/ray/dashboard/
modules/job/ — JobManager:job_manager.py spawns a JobSupervisor detached
actor per job which runs the entrypoint as a subprocess, streams its logs
to files, and reports status; `ray job submit/status/logs/stop` CLI).
The supervisor actor here pipes the driver subprocess's output into an
in-actor buffer; job metadata lives in the controller KV (ns "job").
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch

PENDING, RUNNING, SUCCEEDED, FAILED, STOPPED = (
    "PENDING", "RUNNING", "SUCCEEDED", "FAILED", "STOPPED")


class JobSupervisor:
    """One per job: owns the driver subprocess (reference:
    job_supervisor.py)."""

    def __init__(self, entrypoint: str, controller_addr: str,
                 env_vars: Optional[Dict[str, str]] = None):
        import subprocess
        import threading

        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = controller_addr
        # The driver must be able to import the framework (python <script>
        # puts the SCRIPT's dir on sys.path, not ours) and whatever the
        # supervisor's worker can import.
        import ray_tpu_torch as _pkg
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(_pkg.__file__)))
        extra = [pkg_root, os.getcwd(), env.get("PYTHONPATH", "")]
        env["PYTHONPATH"] = os.pathsep.join(p for p in extra if p)
        env.update(env_vars or {})
        self._status = RUNNING
        self._logs: List[str] = []
        self._started = time.time()
        self._ended: Optional[float] = None
        # New session => own process group: stop_job must kill the whole
        # entrypoint tree, not just the shell (reference: job_supervisor
        # start_new_session + group kill).
        self._proc = subprocess.Popen(
            entrypoint, shell=True, env=env, start_new_session=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._job_id = env_vars.get("_JOB_ID", "") if env_vars else ""

        def pump():
            assert self._proc.stdout is not None
            for line in self._proc.stdout:
                self._logs.append(line)
                if len(self._logs) > 100_000:  # bounded
                    del self._logs[:50_000]
            rc = self._proc.wait()
            self._ended = time.time()
            if self._status != STOPPED:
                self._status = SUCCEEDED if rc == 0 else FAILED
            self._persist_final()

        threading.Thread(target=pump, daemon=True, name="job-logs").start()

    def _persist_final(self) -> None:
        """Record the terminal status + a log tail in the controller KV
        so job info outlives this supervisor actor."""
        try:
            import json as _json

            from ray_tpu_torch import api
            cw = api._cw()
            cw._run(cw.controller.call(
                "kv_put", "job_status", self._job_id or "unknown",
                _json.dumps({
                    "status": self._status,
                    "start_time": self._started,
                    "end_time": self._ended,
                }).encode(), True)).result(30)
            tail = "".join(self._logs[-2000:])[-1_000_000:]
            cw._run(cw.controller.call(
                "kv_put", "job_logs", self._job_id or "unknown",
                tail.encode(errors="replace"), True)).result(30)
        except Exception:
            pass

    async def status(self) -> dict:
        return {"status": self._status,
                "start_time": self._started,
                "end_time": self._ended}

    async def logs(self, tail: Optional[int] = None) -> str:
        lines = self._logs if tail is None else self._logs[-tail:]
        return "".join(lines)

    async def stop_job(self) -> str:
        if self._proc.poll() is None:
            self._status = STOPPED
            import signal
            try:  # kill the whole process group (shell + children)
                os.killpg(os.getpgid(self._proc.pid), signal.SIGTERM)
            except Exception:
                self._proc.terminate()
        return self._status


def _controller_addr_str() -> str:
    from ray_tpu_torch import api
    host, port = api._cw().controller_addr
    return f"{host}:{port}"


def _kv(method: str, *args):
    from ray_tpu_torch import api
    cw = api._cw()
    return cw._run(cw.controller.call(method, *args)).result(30)


def submit_job(entrypoint: str, *,
               submission_id: Optional[str] = None,
               env_vars: Optional[Dict[str, str]] = None) -> str:
    """Start `entrypoint` (a shell command) as a cluster job; returns the
    submission id (reference: JobSubmissionClient.submit_job)."""
    job_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
    env_vars = dict(env_vars or {})
    env_vars["_JOB_ID"] = job_id
    supervisor = ray_tpu_torch.remote(JobSupervisor).options(
        name=f"_job_supervisor:{job_id}").remote(
        entrypoint, _controller_addr_str(), env_vars)
    # Surface immediate spawn failures before recording the job.
    ray_tpu_torch.get(supervisor.status.remote(), timeout=60)
    _kv("kv_put", "job", job_id, json.dumps({
        "entrypoint": entrypoint, "submitted_at": time.time()}).encode(),
        True)
    return job_id


def _supervisor(job_id: str):
    return ray_tpu_torch.get_actor(f"_job_supervisor:{job_id}")


def get_job_status(job_id: str) -> str:
    try:
        return ray_tpu_torch.get(_supervisor(job_id).status.remote(),
                           timeout=30)["status"]
    except ValueError:
        # Supervisor gone: the terminal status was persisted to the KV.
        final = _kv("kv_get", "job_status", job_id)
        if final is not None:
            return json.loads(final)["status"]
        meta = _kv("kv_get", "job", job_id)
        if meta is None:
            raise ValueError(f"no such job {job_id!r}") from None
        return FAILED  # died before reaching a terminal state


def get_job_info(job_id: str) -> dict:
    meta_raw = _kv("kv_get", "job", job_id)
    meta = json.loads(meta_raw) if meta_raw else {}
    try:
        meta.update(ray_tpu_torch.get(_supervisor(job_id).status.remote(),
                                timeout=30))
    except ValueError:
        final = _kv("kv_get", "job_status", job_id)
        meta.update(json.loads(final) if final else {"status": FAILED})
    meta["submission_id"] = job_id
    return meta


def get_job_logs(job_id: str, tail: Optional[int] = None) -> str:
    try:
        return ray_tpu_torch.get(_supervisor(job_id).logs.remote(tail),
                           timeout=30)
    except ValueError:
        blob = _kv("kv_get", "job_logs", job_id)
        if blob is None:
            raise ValueError(f"no logs for job {job_id!r}") from None
        text = blob.decode(errors="replace")
        if tail is not None:
            text = "".join(text.splitlines(keepends=True)[-tail:])
        return text


def delete_job(job_id: str) -> None:
    """Tear down a finished job's supervisor + metadata (supervisors
    otherwise stay resident to serve live logs)."""
    try:
        ray_tpu_torch.kill(_supervisor(job_id))
    except Exception:
        pass
    for ns in ("job", "job_status", "job_logs"):
        try:
            _kv("kv_del", ns, job_id)
        except Exception:
            pass


def stop_job(job_id: str) -> str:
    return ray_tpu_torch.get(_supervisor(job_id).stop_job.remote(), timeout=30)


def list_jobs() -> List[dict]:
    return [get_job_info(job_id) for job_id in _kv("kv_keys", "job")]


def wait_job(job_id: str, timeout: float = 300.0) -> str:
    """Block until the job reaches a terminal state."""
    deadline = time.monotonic() + timeout
    status = get_job_status(job_id)
    while True:
        if status in (SUCCEEDED, FAILED, STOPPED):
            return status
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"job {job_id} still {status} after {timeout}s")
        time.sleep(0.5)
        status = get_job_status(job_id)
