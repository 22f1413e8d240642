"""The port's dashboard (``ray_tpu_torch.dashboard``): the cases of
``tests/test_dashboard.py`` with the same assertions on the port's
runtime (its page names the port's package)."""

import json
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.cluster_utils import Cluster
from ray_tpu_torch.dashboard import start_dashboard


@pytest.fixture(scope="module")
def dash():
    c = Cluster(num_nodes=1, resources={"CPU": 4})
    c.connect()
    d = start_dashboard(port=0)
    yield d
    d.stop()
    c.shutdown()


def _get(dash, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{dash.port}{path}", timeout=30) as r:
        return r.status, r.read()


def test_endpoints(dash):
    @ray_tpu_torch.remote
    class Marker:
        def ping(self):
            return 1

    m = Marker.remote()
    ray_tpu_torch.get(m.ping.remote())

    status, body = _get(dash, "/api/summary")
    assert status == 200
    assert json.loads(body)["nodes_alive"] == 1

    status, body = _get(dash, "/api/nodes")
    assert json.loads(body)[0]["state"] == "ALIVE"

    status, body = _get(dash, "/api/actors")
    assert any(a["state"] == "ALIVE" for a in json.loads(body))

    status, body = _get(dash, "/")
    assert status == 200 and b"ray_tpu_torch cluster" in body

    status, body = _get(dash, "/metrics")
    assert status == 200

    try:
        _get(dash, "/api/nope")
        raise AssertionError("expected 404")
    except urllib.error.HTTPError as e:
        assert e.code == 404


def test_tasks_workers_jobs_endpoints(dash):
    """The remaining API routes return well-formed JSON (reference:
    dashboard modules for tasks/jobs)."""
    @ray_tpu_torch.remote
    def traced():
        return 7

    assert ray_tpu_torch.get(traced.remote()) == 7

    # Trail records ride the worker flush tick -> agent tick -> ledger;
    # poll briefly instead of racing the pipeline.
    import time
    deadline = time.monotonic() + 20
    tasks = []
    while time.monotonic() < deadline:
        status, body = _get(dash, "/api/tasks")
        assert status == 200
        tasks = json.loads(body)
        if any(t.get("state") == "FINISHED" or t.get("event")
               for t in tasks):
            break
        time.sleep(0.25)
    assert isinstance(tasks, list) and tasks
    assert any(t.get("state") == "FINISHED" or t.get("event")
               for t in tasks), tasks[:3]

    status, body = _get(dash, "/api/workers")
    assert status == 200
    assert isinstance(json.loads(body), list)

    status, body = _get(dash, "/api/jobs")
    assert status == 200
    assert isinstance(json.loads(body), list)


def test_summary_tracks_actor_lifecycle(dash):
    """Summary counts respond to actor churn."""
    import time

    @ray_tpu_torch.remote
    class Churn:
        def ping(self):
            return 1

    a = Churn.options(name="churn-dash").remote()
    ray_tpu_torch.get(a.ping.remote())
    s1 = json.loads(_get(dash, "/api/summary")[1])
    assert s1["actors"] >= 1
    ray_tpu_torch.kill(a)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        actors = json.loads(_get(dash, "/api/actors")[1])
        dead = [x for x in actors if x.get("name") == "churn-dash"
                and x["state"] == "DEAD"]
        if dead:
            break
        time.sleep(0.2)
    assert dead, actors
