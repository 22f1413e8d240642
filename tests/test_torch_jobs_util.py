"""The port's job submission, ``ActorPool`` and ``Queue``
(``ray_tpu_torch.job_submission``, ``ray_tpu_torch.util``): the cases of
``tests/test_jobs_util.py`` with the same inputs and assertions on the
port's runtime, and the supervisor's environment for a driver of the
port (its address variable, the port's package root on ``PYTHONPATH``).
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.cluster_utils import Cluster


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(num_nodes=1, resources={"CPU": 8})
    c.connect()
    yield c
    c.shutdown()


def test_job_submit_runs_driver_against_cluster(cluster, tmp_path):
    from ray_tpu_torch import job_submission as jobs

    out = tmp_path / "out.txt"
    script = tmp_path / "driver.py"
    script.write_text(f"""
import ray_tpu_torch
ray_tpu_torch.init()  # connects via RAY_TPU_TORCH_ADDRESS (supervisor)

@ray_tpu_torch.remote
def add(a, b):
    return a + b

result = ray_tpu_torch.get(add.remote(20, 22))
print("driver result:", result)
open({str(out)!r}, "w").write(str(result))
""")
    job_id = jobs.submit_job(f"python {script}")
    status = jobs.wait_job(job_id, timeout=180)
    logs = jobs.get_job_logs(job_id)
    assert status == "SUCCEEDED", logs
    assert "driver result: 42" in logs
    assert out.read_text() == "42"
    assert any(j["submission_id"] == job_id for j in jobs.list_jobs())


def test_job_failure_and_stop(cluster):
    from ray_tpu_torch import job_submission as jobs

    bad = jobs.submit_job("python -c 'raise SystemExit(3)'")
    assert jobs.wait_job(bad, timeout=120) == "FAILED"

    slow = jobs.submit_job("sleep 60")
    time.sleep(0.5)
    jobs.stop_job(slow)
    assert jobs.wait_job(slow, timeout=60) == "STOPPED"


def test_actor_pool(cluster):
    @ray_tpu_torch.remote
    class Doubler:
        def double(self, x):
            return 2 * x

    from ray_tpu_torch.util import ActorPool
    pool = ActorPool([Doubler.remote() for _ in range(3)])
    out = list(pool.map(lambda a, v: a.double.remote(v), range(10)))
    assert out == [2 * i for i in range(10)]  # submission order
    out = sorted(pool.map_unordered(lambda a, v: a.double.remote(v),
                                    range(10)))
    assert out == [2 * i for i in range(10)]


def test_queue_blocking_and_timeout(cluster):
    from ray_tpu_torch.util import Empty, Queue
    q = Queue(maxsize=4)
    for i in range(4):
        q.put(i)
    assert q.qsize() == 4 and q.full()
    assert [q.get() for _ in range(4)] == [0, 1, 2, 3]
    with pytest.raises(Empty):
        q.get(timeout=0.3)

    # A consumer task long-polls until a producer arrives.
    @ray_tpu_torch.remote
    def consume(q):
        return q.get(timeout=30)

    ref = consume.remote(q)
    time.sleep(0.3)
    q.put("hello")
    assert ray_tpu_torch.get(ref, timeout=60) == "hello"
    q.shutdown()


def test_job_logs_tail_and_follow_cli(cluster, tmp_path):
    """`job logs --tail N` prints only the last N lines; `-f` streams
    until the job reaches a terminal status (here: already finished, so
    it prints everything and exits)."""
    import os
    import subprocess
    import sys

    from ray_tpu_torch import api
    from ray_tpu_torch import job_submission as jobs

    script = tmp_path / "chatty.py"
    script.write_text(
        "for i in range(6):\n"
        "    print(f'line-{i}')\n")
    job_id = jobs.submit_job(f"python {script}")
    assert jobs.wait_job(job_id, timeout=120) == "SUCCEEDED"

    host, port = api._cw().controller_addr
    addr = f"{host}:{port}"
    env = dict(os.environ)

    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.cli", "job", "logs",
         "--job-id", job_id, "--tail", "2", "--address", addr],
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("line-")]
    assert lines == ["line-4", "line-5"], out.stdout

    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.cli", "job", "logs",
         "--job-id", job_id, "-f", "--interval", "0.2",
         "--address", addr],
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    for i in range(6):
        assert f"line-{i}" in out.stdout, out.stdout


def test_job_driver_env_names_the_port(cluster):
    """The supervisor hands its driver the port's address variable and
    puts the port's package root first on ``PYTHONPATH``."""
    import os
    import sys

    import ray_tpu_torch as pkg
    from ray_tpu_torch import api
    from ray_tpu_torch import job_submission as jobs

    job_id = jobs.submit_job(
        f"{sys.executable} -c \"import os; "
        f"print('addr=' + os.environ['RAY_TPU_TORCH_ADDRESS']); "
        f"print('path=' + os.environ['PYTHONPATH'])\"")
    assert jobs.wait_job(job_id, timeout=120) == "SUCCEEDED"
    logs = jobs.get_job_logs(job_id)
    host, port = api._cw().controller_addr
    assert f"addr={host}:{port}" in logs, logs
    root = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    path = next(ln for ln in logs.splitlines() if ln.startswith("path="))
    assert path[len("path="):].split(os.pathsep)[0] == root, path
