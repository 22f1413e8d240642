"""The port's GPU accelerator manager and label-selector scheduling.

GPUs as a first-class scheduler resource: discovery (the config flag,
then CUDA_VISIBLE_DEVICES, then /dev/nvidia*), whole-device pinning through
CUDA_VISIBLE_DEVICES, release on actor death; the cases of
``tests/test_accelerators.py`` with ``GPU`` and ``num_gpus`` and those of
``tests/test_labels.py`` with the same assertions, on one cluster: a head
node with ``{"CPU": 4, "GPU": 2}`` and three labeled CPU nodes.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import accelerators
from ray_tpu_torch.core.cluster_utils import Cluster
from ray_tpu_torch.core.common import labels_match
from ray_tpu_torch.utils.config import GlobalConfig

SLICE = "ray_tpu_torch.io/slice-name"


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(num_nodes=1, resources={"CPU": 4, "GPU": 2})
    c.add_node(resources={"CPU": 2}, labels={SLICE: "slice-a", "zone": "z1"})
    c.add_node(resources={"CPU": 2}, labels={SLICE: "slice-a", "zone": "z2"})
    c.add_node(resources={"CPU": 2}, labels={SLICE: "slice-b", "zone": "z1"})
    c.connect()
    deadline = time.time() + 30
    while time.time() < deadline and len(ray_tpu_torch.nodes()) < 4:
        time.sleep(0.2)
    assert len(ray_tpu_torch.nodes()) == 4
    yield c
    c.shutdown()


@pytest.fixture
def env(monkeypatch):
    """Set or unset env vars for discovery; the config re-reads them."""
    def set_env(**kv):
        for k, v in kv.items():
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        GlobalConfig.initialize()  # drop cached flag values

    yield set_env
    monkeypatch.undo()
    GlobalConfig.initialize()


# ----------------------------------------------------------------------
# discovery and pinning (no cluster)
# ----------------------------------------------------------------------

def test_gpus_from_visible_devices(env, monkeypatch):
    env(RAY_TPU_TORCH_GPUS_PER_HOST=None, NVIDIA_VISIBLE_DEVICES=None,
        CUDA_VISIBLE_DEVICES="0,1,2")
    assert accelerators.num_gpus() == 3
    env(CUDA_VISIBLE_DEVICES="GPU-8a1c,GPU-77e0")
    assert accelerators.num_gpus() == 2
    # "" and -1 hide every device; CUDA stops at the first -1
    for spec, n in (("", 0), ("-1", 0), ("4,-1,5", 1)):
        env(CUDA_VISIBLE_DEVICES=spec)
        assert accelerators.num_gpus() == n, spec
    env(CUDA_VISIBLE_DEVICES=None)
    monkeypatch.setattr(accelerators.glob, "glob", lambda pat: [
        "/dev/nvidia0", "/dev/nvidia1"] if pat == "/dev/nvidia[0-9]*" else [])
    assert accelerators.num_gpus() == 2
    # A container's own selection counts before device files it may hold
    # for cards it was not given.
    for spec, n in (("0", 1), ("GPU-8a1c", 1), ("none", 0), ("void", 0),
                    ("", 0), ("all", 2)):
        env(NVIDIA_VISIBLE_DEVICES=spec)
        assert accelerators.num_gpus() == n, spec
    env(NVIDIA_VISIBLE_DEVICES=None)
    monkeypatch.setattr(accelerators.glob, "glob", lambda pat: [])
    assert accelerators.num_gpus() == 0


def test_gpus_from_config_flag(env):
    env(RAY_TPU_TORCH_GPUS_PER_HOST="4", CUDA_VISIBLE_DEVICES="0")
    assert accelerators.num_gpus() == 4
    assert accelerators.visible_gpu_ids() == [0, 1, 2, 3]
    env(RAY_TPU_TORCH_GPU_VISIBLE_IDS="3,1,9")
    assert accelerators.visible_gpu_ids() == [1, 3]


def test_worker_env_for_gpus(env):
    env(RAY_TPU_TORCH_GPUS_PER_HOST=None, CUDA_VISIBLE_DEVICES=None,
        NVIDIA_VISIBLE_DEVICES=None)
    assert accelerators.worker_env_for_gpus([1, 3]) == {
        "CUDA_VISIBLE_DEVICES": "1,3"}
    # Under an agent pinned to devices 4 and 6, ordinal 1 is device 6.
    env(CUDA_VISIBLE_DEVICES="4,6")
    assert accelerators.worker_env_for_gpus([1]) == {
        "CUDA_VISIBLE_DEVICES": "6"}


# ----------------------------------------------------------------------
# GPUs as a scheduler resource
# ----------------------------------------------------------------------

@ray_tpu_torch.remote
class GpuUser:
    def gpus(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def test_gpu_resource_advertised(cluster):
    assert ray_tpu_torch.cluster_resources().get("GPU") == 2.0


def test_actor_gets_visible_gpus(cluster):
    a = GpuUser.options(num_gpus=1).remote()
    gpus_a = ray_tpu_torch.get(a.gpus.remote())
    b = GpuUser.options(num_gpus=1).remote()
    gpus_b = ray_tpu_torch.get(b.gpus.remote())
    # Distinct devices, one each, out of 0..1.
    assert {gpus_a, gpus_b} == {"0", "1"}
    assert ray_tpu_torch.available_resources().get("GPU", 0) == 0
    # A third stays pending while both live...
    c = GpuUser.options(num_gpus=1).remote()
    pending = c.gpus.remote()
    ready, _ = ray_tpu_torch.wait([pending], timeout=3)
    assert ready == []
    # ...and is placed on the freed device once one dies.
    ray_tpu_torch.kill(a)
    assert ray_tpu_torch.get(pending, timeout=30) == gpus_a
    ray_tpu_torch.kill(b)
    ray_tpu_torch.kill(c)
    deadline = time.time() + 15
    while time.time() < deadline:
        if ray_tpu_torch.available_resources().get("GPU", 0) == 2:
            break
        time.sleep(0.2)
    assert ray_tpu_torch.available_resources().get("GPU", 0) == 2


def test_fractional_gpu_raises(cluster):
    with pytest.raises(ValueError, match="whole number of GPUs"):
        GpuUser.options(num_gpus=0.5).remote()


def test_env_vars_runtime_env(cluster):
    @ray_tpu_torch.remote
    class EnvActor:
        def get(self, k):
            return os.environ.get(k)

    a = EnvActor.options(
        runtime_env={"env_vars": {"MY_FLAG": "42", "PATH2": None}}).remote()
    assert ray_tpu_torch.get(a.get.remote("MY_FLAG")) == "42"
    ray_tpu_torch.kill(a)


def test_gpu_on_a_cpu_node_stays_pending(cluster):
    """num_gpus=1 on a node that advertises no GPU parks, as num_tpus
    does in the reference; nothing runs in its place."""
    a = GpuUser.options(num_gpus=1,
                        label_selector={SLICE: "slice-b"}).remote()
    ready, _ = ray_tpu_torch.wait([a.gpus.remote()], timeout=2)
    assert ready == []
    ray_tpu_torch.kill(a)


# ----------------------------------------------------------------------
# label selectors (the cases of tests/test_labels.py)
# ----------------------------------------------------------------------

def test_labels_match_operators():
    labels = {"zone": "us1", "type": "h100"}
    assert labels_match(labels, None)
    assert labels_match(labels, {"zone": "us1"})
    assert not labels_match(labels, {"zone": "us2"})
    assert labels_match(labels, {"zone": "!us2"})
    assert not labels_match(labels, {"zone": "!us1"})
    assert labels_match(labels, {"zone": "in(us1,us2)"})
    assert not labels_match(labels, {"zone": "in(us2,us3)"})
    assert labels_match(labels, {"zone": "!in(us2,us3)"})
    assert not labels_match(labels, {"zone": "!in(us1,us2)"})
    # missing label: positive never matches, negative always does
    assert not labels_match(labels, {"rack": "a"})
    assert labels_match(labels, {"rack": "!a"})
    assert not labels_match(labels, {"rack": "in(a,b)"})
    assert labels_match(labels, {"zone": "us1", "type": "h100"})
    assert not labels_match(labels, {"zone": "us1", "type": "a100"})


@ray_tpu_torch.remote
def where():
    return os.environ["RAY_TPU_TORCH_NODE_ID"]


def _pg_info(pg):
    from ray_tpu_torch.api import _cw
    cw = _cw()
    return cw._run(cw.controller.call("get_pg_info",
                                      pg.id.binary())).result()


def _nodes_by_label(key, value):
    return {n["node_id"].hex() for n in ray_tpu_torch.nodes()
            if n["labels"].get(key) == value}


def test_task_label_selector(cluster):
    slice_a = _nodes_by_label(SLICE, "slice-a")
    slice_b = _nodes_by_label(SLICE, "slice-b")
    for _ in range(4):
        nid = ray_tpu_torch.get(where.options(
            label_selector={SLICE: "slice-a"}).remote())
        assert nid in slice_a and nid not in slice_b
    nid = ray_tpu_torch.get(where.options(
        label_selector={SLICE: "slice-b"}).remote())
    assert nid in slice_b


def test_task_label_selector_negation(cluster):
    unlabeled_or_b = {n["node_id"].hex() for n in ray_tpu_torch.nodes()
                      if n["labels"].get(SLICE) != "slice-a"}
    for _ in range(3):
        nid = ray_tpu_torch.get(where.options(
            label_selector={SLICE: "!slice-a"}).remote())
        assert nid in unlabeled_or_b


@ray_tpu_torch.remote
class Locator:
    def where(self):
        return os.environ["RAY_TPU_TORCH_NODE_ID"]


def test_actor_label_selector(cluster):
    slice_b = _nodes_by_label(SLICE, "slice-b")
    a = Locator.options(num_cpus=1,
                        label_selector={SLICE: "slice-b"}).remote()
    nid = ray_tpu_torch.get(a.where.remote())
    assert nid in slice_b
    ray_tpu_torch.kill(a)


def test_pg_bundle_label_selector(cluster):
    """Each bundle individually constrained."""
    pg = ray_tpu_torch.placement_group(
        [{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD",
        bundle_label_selector=[{"zone": "z1"}, {"zone": "z2"}])
    assert pg.ready(timeout=30)
    info = _pg_info(pg)
    zone_of = {n["node_id"]: n["labels"].get("zone")
               for n in ray_tpu_torch.nodes()}
    zones = [zone_of[nid] for nid in info["bundle_nodes"]]
    assert zones == ["z1", "z2"], zones
    ray_tpu_torch.remove_placement_group(pg)


def test_pg_gang_label_reservation(cluster):
    """$same gang: both bundles land on nodes sharing ONE slice label; the
    mismatched slice-b node is never mixed in."""
    pg = ray_tpu_torch.placement_group(
        [{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD",
        bundle_label_selector=[{SLICE: "$same"}, {SLICE: "$same"}])
    assert pg.ready(timeout=30)
    info = _pg_info(pg)
    slice_of = {n["node_id"]: n["labels"].get(SLICE)
                for n in ray_tpu_torch.nodes()}
    slices = {slice_of[nid] for nid in info["bundle_nodes"]}
    assert slices == {"slice-a"}, slices
    ray_tpu_torch.remove_placement_group(pg)


def test_pg_gang_reservation_infeasible_stays_pending(cluster):
    """3 gang bundles fit no single slice (2 nodes at most): the PG stays
    PENDING, never partly placed across slices."""
    pg = ray_tpu_torch.placement_group(
        [{"CPU": 1}] * 3, strategy="STRICT_SPREAD",
        bundle_label_selector=[{SLICE: "$same"}] * 3)
    assert not pg.ready(timeout=3)
    info = _pg_info(pg)
    assert all(n is None for n in info["bundle_nodes"])
    ray_tpu_torch.remove_placement_group(pg)


# ----------------------------------------------------------------------
# an agent's own discovery (last: it adds a GPU node to the cluster)
# ----------------------------------------------------------------------

def test_agent_discovers_and_pins_gpus_from_its_env(cluster, env):
    """A node started under CUDA_VISIBLE_DEVICES=3,5 with no GPU in its
    resources advertises GPU 2 by its own discovery, and pins the devices
    it was given, not its ordinals."""
    env(RAY_TPU_TORCH_GPUS_PER_HOST=None, CUDA_VISIBLE_DEVICES="3,5")
    cluster.add_node(resources={"CPU": 2}, labels={"pool": "disc"})
    deadline = time.time() + 30
    while time.time() < deadline and len(ray_tpu_torch.nodes()) < 5:
        time.sleep(0.2)
    node = next(n for n in ray_tpu_torch.nodes()
                if n["labels"].get("pool") == "disc")
    assert node["resources_total"].get("GPU") == 2.0
    a = GpuUser.options(num_gpus=1, label_selector={"pool": "disc"}).remote()
    assert ray_tpu_torch.get(a.gpus.remote(), timeout=60) == "3"
    ray_tpu_torch.kill(a)
