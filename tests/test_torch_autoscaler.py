"""The port's autoscaler: demand-driven scale-up, idle scale-down,
bin-packing.

The cases of ``tests/test_autoscaler.py`` with the same inputs and
assertions on the port's runtime (its ``TPUPodProvider`` cases become
``GPUVMProvider`` cases, with stub commands and no cloud access), and a
``num_gpus=1`` actor, pending on a head that advertises no GPU, placed on
the node the autoscaler launched with ``{"GPU": 1}`` and pinned to its
card through ``CUDA_VISIBLE_DEVICES`` (no CUDA is touched).
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider
from ray_tpu_torch.core.cluster_utils import Cluster


def test_bin_packing():
    unmet = Autoscaler._bin_packs(
        [{"CPU": 2.0}, {"CPU": 2.0}, {"CPU": 1.0}],
        [{"CPU": 2.0}, {"CPU": 2.0}])
    assert unmet == [{"CPU": 1.0}]
    assert Autoscaler._bin_packs([{"CPU": 1.0}], [{"CPU": 4.0}]) == []


@pytest.fixture()
def cluster():
    c = Cluster(num_nodes=1, resources={"CPU": 2})
    c.connect()
    yield c
    c.shutdown()


@pytest.mark.timeout(170)
def test_scale_up_then_down(cluster):
    from ray_tpu_torch import api
    cw = api._cw()
    provider = LocalNodeProvider(cw.controller_addr)
    scaler = Autoscaler(provider, node_resources={"CPU": 2},
                        min_nodes=1, max_nodes=3, idle_timeout_s=3.0,
                        update_period_s=0.5)

    @ray_tpu_torch.remote(num_cpus=2)
    class Big:
        def where(self):
            import os
            return os.getpid()

    try:
        # 3 two-CPU actors cannot fit on the single 2-CPU node.
        actors = [Big.remote() for _ in range(3)]
        scaler.start()
        deadline = time.monotonic() + 120
        pids = None
        while time.monotonic() < deadline:
            try:
                pids = ray_tpu_torch.get([a.where.remote() for a in actors],
                                   timeout=10)
                break
            except Exception:
                time.sleep(1.0)
        assert pids is not None, "actors never all scheduled (no scale-up)"
        assert len(set(pids)) == 3
        alive = [n for n in ray_tpu_torch.nodes() if n["state"] == "ALIVE"]
        assert len(alive) >= 2, "autoscaler never added nodes"

        # Free the demand; launched nodes become idle and are culled.
        for a in actors:
            ray_tpu_torch.kill(a)
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            alive = [n for n in ray_tpu_torch.nodes() if n["state"] == "ALIVE"]
            if len(alive) == 1:
                break
            time.sleep(1.0)
        assert len(alive) == 1, f"never scaled back down: {len(alive)}"
    finally:
        scaler.stop()


def test_gpu_vm_provider_command_templates(tmp_path):
    """GPUVMProvider drives VM create/delete through its command
    templates (the cloud seam; reference: gcp node provider) — stub
    commands record the exact invocations."""
    import json
    import os

    from ray_tpu_torch.autoscaler import GPUVMProvider

    log = str(tmp_path / "calls.log")
    rec = ["python", "-c",
           "import sys, json; open(sys.argv[1], 'a').write("
           "json.dumps(sys.argv[2:]) + '\\n')", log]
    provider = GPUVMProvider(
        zone="us-central1-a", accelerator_type="nvidia-h100-80gb",
        controller_addr=("10.0.0.2", 7001), name_prefix="t",
        create_cmd=rec + ["create", "{name}", "{zone}",
                          "{accelerator_type}",
                          "{controller}", "{agent_port}"],
        delete_cmd=rec + ["delete", "{name}", "{zone}"])

    h1 = provider.create_node({"GPU": 8.0, "CPU": 208.0})
    h2 = provider.create_node({"GPU": 8.0, "CPU": 208.0})
    assert provider.node_port(h1) == GPUVMProvider.AGENT_PORT
    assert h1["name"] == "t-1" and h2["name"] == "t-2"
    provider.terminate_node(h1)

    deadline = time.monotonic() + 15  # launches are async
    calls = []
    while time.monotonic() < deadline and len(calls) < 3:
        calls = [json.loads(line) for line in open(log)] \
            if os.path.exists(log) else []
        time.sleep(0.1)
    assert calls[0] == ["create", "t-1", "us-central1-a", "nvidia-h100-80gb",
                       "10.0.0.2:7001", str(GPUVMProvider.AGENT_PORT)]
    assert calls[2] == ["delete", "t-1", "us-central1-a"]

    # A failing create surfaces loudly (never a silent half-launch).
    bad = GPUVMProvider(
        zone="z", accelerator_type="a", controller_addr=("h", 1),
        create_cmd=["false"], delete_cmd=["true"])
    with pytest.raises(RuntimeError):
        bad.create_node({})


def test_gpu_vm_provider_default_templates():
    """The default templates create and delete an H100 VM with `gcloud
    compute instances`, and its startup script joins the port's
    runtime through ``python -m ray_tpu_torch.cli start``."""
    from ray_tpu_torch.autoscaler import GPUVMProvider

    provider = GPUVMProvider(
        zone="us-central1-a", accelerator_type="nvidia-h100-80gb",
        controller_addr=("10.0.0.2", 7001), name_prefix="t")
    create = provider._fmt(provider._create_cmd, "t-1")
    assert create[:5] == ["gcloud", "compute", "instances", "create", "t-1"]
    assert create[create.index("--zone") + 1] == "us-central1-a"
    assert create[create.index("--machine-type") + 1] == "a3-highgpu-8g"
    assert create[create.index("--accelerator") + 1] == \
        "type=nvidia-h100-80gb,count=8"
    script = create[create.index("--metadata") + 1]
    assert ("python -m ray_tpu_torch.cli start --address 10.0.0.2:7001 "
            f"--port {GPUVMProvider.AGENT_PORT}") in script
    assert "{" not in " ".join(create)
    assert provider._fmt(provider._delete_cmd, "t-1") == [
        "gcloud", "compute", "instances", "delete", "t-1",
        "--zone", "us-central1-a", "--quiet"]


def test_gpu_vm_provider_late_failure_marks_handle():
    """A create that fails AFTER the fail-fast window (quota/capacity/auth)
    must mark the handle failed so the autoscaler can drop it and retry
    — otherwise the phantom launch suppresses scale-up forever."""
    from ray_tpu_torch.autoscaler import GPUVMProvider

    provider = GPUVMProvider(
        zone="z", accelerator_type="a", controller_addr=("h", 1),
        create_cmd=["python", "-c", "import time; time.sleep(0.5); "
                                    "raise SystemExit(1)"],
        delete_cmd=["true"])
    h = provider.create_node({})
    assert not provider.handle_failed(h)  # still in flight
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and not provider.handle_failed(h):
        time.sleep(0.05)
    assert provider.handle_failed(h)


def test_gpu_vm_provider_delete_gone_vm_is_quiet():
    """Deleting an already-gone VM (cloud returns nonzero) must not
    raise — termination is idempotent from the autoscaler's view."""
    from ray_tpu_torch.autoscaler import GPUVMProvider

    provider = GPUVMProvider(
        zone="z", accelerator_type="a", controller_addr=("h", 1),
        create_cmd=["true"], delete_cmd=["false"])
    provider.terminate_node({"name": "gone", "port": 1})  # no raise


def test_autoscaler_drops_failed_launches():
    """Autoscaler.update() prunes handles the provider marks failed, so
    the failed launch's capacity stops suppressing the next scale-up."""
    from ray_tpu_torch.autoscaler import Autoscaler, NodeProvider

    class P(NodeProvider):
        def __init__(self):
            self.created = 0

        def create_node(self, resources):
            self.created += 1
            return {"name": f"n{self.created}", "failed": self.created == 1}

        def handle_failed(self, handle):
            return handle.get("failed", False)

        def terminate_node(self, handle):
            pass

    class _FakeFut:
        def __init__(self, v):
            self._v = v

        def result(self, timeout=None):
            return self._v

    class _FakeCW:
        """Stub core worker: one alive node with zero capacity + one
        pending actor demand -> always wants a scale-up."""

        class controller:
            @staticmethod
            def call(method, *a):
                return method

        def _run(self, method):
            if method == "autoscaler_state":
                return _FakeFut({
                    "nodes": [{"node_id": "head", "state": "ALIVE",
                               "available": {"CPU": 0.0},
                               "total": {"CPU": 1.0}}],
                    "pending_actors": [{"CPU": 1.0}],
                    "pending_pg_bundles": [], "infeasible": []})
            return _FakeFut([{"node_id": "head", "addr": ("h", 1)}])

    scaler = Autoscaler.__new__(Autoscaler)
    provider = P()
    scaler._cw = _FakeCW()
    scaler._provider = provider
    scaler._node_resources = {"CPU": 4.0}
    scaler._min, scaler._max = 0, 4
    scaler._idle_timeout, scaler._period = 30.0, 1.0
    scaler._launched, scaler._idle_since = [], {}

    scaler._failure_backoff_s, scaler._next_launch_at = 0.0, 0.0

    assert scaler.update() == "up"        # launch 1 (will fail)
    assert len(scaler._launched) == 1
    assert scaler.update() is None        # prunes failed, enters backoff
    assert scaler._failure_backoff_s > 0
    assert not scaler._launched
    scaler._next_launch_at = 0.0          # backoff elapsed
    assert scaler.update() == "up"        # retries
    assert provider.created == 2
    assert [h["name"] for h in scaler._launched] == ["n2"]


@pytest.mark.timeout(170)
def test_pending_gpu_actor_lands_on_the_launched_gpu_node():
    """A ``num_gpus=1`` actor parks on a head with ``GPU: 0``; the
    autoscaler launches one ``{"GPU": 1}`` node, the actor lands there
    with the node's card pinned, and the node is culled once the actor
    is killed."""
    from ray_tpu_torch import accelerators, api, state

    c = Cluster(num_nodes=1, resources={"CPU": 2, "GPU": 0})
    c.connect()
    head = {n["node_id"] for n in state.list_nodes()}
    provider = LocalNodeProvider(api._cw().controller_addr)
    created = []
    create = provider.create_node
    provider.create_node = lambda r: created.append(dict(r)) or create(r)
    scaler = Autoscaler(provider, node_resources={"CPU": 2, "GPU": 1},
                        min_nodes=1, max_nodes=2, idle_timeout_s=3.0,
                        update_period_s=0.5)

    @ray_tpu_torch.remote(num_gpus=1)
    class OnCard:
        def where(self):
            import os
            import sys
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "torch" in sys.modules)

    try:
        a = OnCard.remote()
        ref = a.where.remote()
        ready, _ = ray_tpu_torch.wait([ref], timeout=2)
        assert ready == [], "placed with no GPU in the cluster"
        scaler.start()
        cvd, torch_loaded = ray_tpu_torch.get(ref, timeout=60)
        assert created == [{"CPU": 2, "GPU": 1}]
        assert cvd == accelerators.worker_env_for_gpus(
            [0])["CUDA_VISIBLE_DEVICES"]
        assert not torch_loaded
        (row,) = [x for x in state.list_actors() if x["state"] == "ALIVE"]
        assert row["node_id"] not in head
        launched = {n["node_id"]: n for n in state.list_nodes()}[
            row["node_id"]]
        assert launched["resources_total"]["GPU"] == 1.0
        assert launched["addr"].endswith(
            f":{provider.node_port(scaler._launched[0])}")

        ray_tpu_torch.kill(a)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            alive = [n for n in ray_tpu_torch.nodes()
                     if n["state"] == "ALIVE"]
            if len(alive) == 1:
                break
            time.sleep(0.5)
        assert len(alive) == 1, f"never scaled back down: {len(alive)}"
        assert not scaler._launched and len(created) == 1
    finally:
        scaler.stop()
        c.shutdown()
