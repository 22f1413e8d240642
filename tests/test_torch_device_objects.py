"""The port's device objects (``ray_tpu_torch.device_objects``) and its
transfer plane (``ray_tpu_torch.experimental.device_plane``): the
DeviceRef cases of ``tests/test_device_plane.py`` — a local round trip,
auto-free on the last drop, a pull from another process, and the host
relay for a tensor owned on another node — with the route counters showing
which plane moved each tensor. On the CPU every pull is a host relay (a
CPU tensor); CUDA IPC between two processes of one node runs only on a
card (the ``cuda`` test, skipped without one).
"""

import gc
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core.cluster_utils import Cluster
from ray_tpu_torch.device_objects import (device_get, device_ingest,
                                          device_put_ref, free_ref)
from ray_tpu_torch.experimental import device_plane as dp

OTHER_NODE = "other_node_slot"


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(num_nodes=1, resources={"CPU": 8})
    c.add_node(resources={"CPU": 2, OTHER_NODE: 1})
    c.connect()
    deadline = time.time() + 30
    while time.time() < deadline and len(ray_tpu_torch.nodes()) < 2:
        time.sleep(0.2)
    assert len(ray_tpu_torch.nodes()) == 2
    yield c
    c.shutdown()


def _tensor_actor():
    """The actor class, made inside a function so that it is pickled by
    value (a test module's top-level class would be pickled by reference
    and fail to import in the worker)."""

    class TensorActor:
        """Holds torch tensors as device objects; reports the plane's
        counters and its node."""

        def make_ref(self, scale, device="cpu"):
            return device_put_ref(torch.arange(8.0, device=device) * scale)

        def table_size(self):
            from ray_tpu_torch.core.ref import get_core_worker
            return len(get_core_worker()._device_objects)

        def plane_stats(self):
            p = dp.DevicePlane.maybe()
            return p.stats() if p else None

        def pull(self, ref, device="cpu"):
            out = device_get(ref, device=device, timeout=60.0)
            free_ref(ref)
            return out.cpu().tolist(), dp.DevicePlane.get().stats()

    return TensorActor


def _actor(**opts):
    return ray_tpu_torch.remote(_tensor_actor()).options(**opts).remote()


def _local_stats() -> dict:
    return dp.DevicePlane.get().stats()


def _delta(after: dict, before: dict, key: str) -> dict:
    return {k: after[key][k] - before[key][k] for k in after[key]}


def test_choose_route_by_node_and_device():
    """CUDA IPC only for a CUDA tensor of the puller's node on a card it
    sees: a CPU tensor, any tensor owned on another node, or one on a card
    the puller does not see (pinned to another), goes as host bytes."""
    assert dp.choose_route("n1", "n1", "cuda", True) == (dp.ROUTE_IPC,
                                                         "same_node")
    assert dp.choose_route("n1", "n1", "cuda", False) == (
        dp.ROUTE_HOST, dp.RELAY_CARD_NOT_VISIBLE)
    assert dp.choose_route("n1", "n1", "cpu", False) == (dp.ROUTE_HOST,
                                                         dp.RELAY_CPU_TENSOR)
    for dev in ("cuda", "cpu"):
        assert dp.choose_route("n2", "n1", dev, True) == (
            dp.ROUTE_HOST, dp.RELAY_OTHER_NODE)


def test_stage_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        dp.DevicePlane.get().stage(torch.ones(4))


def test_device_ref_local_roundtrip(cluster):
    t = torch.ones(4)
    ref = device_put_ref(t)
    assert ref.device == "cpu" and ref.shape == (4,) and ref.dtype == \
        "float32"
    before = _local_stats()
    out = device_get(ref)
    assert out is t  # same process: the owner's tensor itself
    assert torch.equal(device_get(ref, device="cpu"), t)
    assert _local_stats()["pulls"] == before["pulls"]  # no plane involved
    free_ref(ref)
    with pytest.raises(KeyError, match="freed"):
        device_get(ref)


def test_device_get_pulls_a_cpu_tensor_by_host_relay(cluster):
    """A pull from another process of this node: the owner's tensor lies on
    the CPU, so it comes as host bytes, counted as such; nothing is staged
    for CUDA IPC on the owner."""
    a = _actor()
    ref = ray_tpu_torch.get(a.make_ref.remote(3.0))
    assert ref.device == "cpu"
    before = _local_stats()
    out = device_get(ref, device="cpu", timeout=60.0)
    assert out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), np.arange(8.0) * 3.0)
    after = _local_stats()
    assert _delta(after, before, "pulls_by_route") == {dp.ROUTE_IPC: 0,
                                                       dp.ROUTE_HOST: 1}
    assert _delta(after, before, "relays_by_reason") == {
        dp.RELAY_OTHER_NODE: 0, dp.RELAY_CPU_TENSOR: 1,
        dp.RELAY_CARD_NOT_VISIBLE: 0}
    assert _delta(after, before, "bytes_by_route")[dp.ROUTE_HOST] == 8 * 4
    owner = ray_tpu_torch.get(a.plane_stats.remote())
    assert owner is None or owner["staged"] == 0


def test_device_get_host_relays_across_nodes(cluster):
    """A DeviceRef owned on ANOTHER node routes through the host relay,
    decided by the node before anything is staged (CUDA IPC cannot cross
    hosts)."""
    a = _actor(resources={OTHER_NODE: 1})
    ref = ray_tpu_torch.get(a.make_ref.remote(5.0))
    from ray_tpu_torch.core.ref import get_core_worker
    assert ref.node and ref.node != get_core_worker().node_id.hex()
    before = _local_stats()
    out = device_get(ref, device="cpu", timeout=60.0)
    np.testing.assert_array_equal(out.numpy(), np.arange(8.0) * 5.0)
    after = _local_stats()
    assert _delta(after, before, "pulls_by_route") == {dp.ROUTE_IPC: 0,
                                                       dp.ROUTE_HOST: 1}
    assert _delta(after, before, "relays_by_reason") == {
        dp.RELAY_OTHER_NODE: 1, dp.RELAY_CPU_TENSOR: 0,
        dp.RELAY_CARD_NOT_VISIBLE: 0}
    owner = ray_tpu_torch.get(a.plane_stats.remote())
    assert owner is None or owner["staged"] == 0


def test_actor_pulls_a_tensor_made_here_and_frees_it(cluster):
    """A ref made here travels to an actor, which pulls it (host relay for
    a CPU tensor) and frees the owner's copy with free_ref."""
    ref = device_put_ref(torch.full((3,), 7.0))
    a = _actor()
    got, stats = ray_tpu_torch.get(a.pull.remote(ref), timeout=60)
    assert got == [7.0, 7.0, 7.0]
    assert stats["pulls_by_route"] == {dp.ROUTE_IPC: 0, dp.ROUTE_HOST: 1}
    from ray_tpu_torch.core.ref import get_core_worker
    assert get_core_worker().get_device_object_local(ref.key) is None


def test_device_get_defaults_to_the_card(cluster):
    """``device=None`` puts host-relayed bytes on the card, as the
    reference's ``jax.device_put`` puts them on the default accelerator:
    without a card it raises before anything is fetched or counted."""
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only default; the card case is the "
                    "cuda test below")
    a = _actor()
    ref = ray_tpu_torch.get(a.make_ref.remote(2.0))
    before = _local_stats()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_get(ref, timeout=60.0)
    assert _local_stats()["pulls"] == before["pulls"]
    out = device_get(ref, device="cpu", timeout=60.0)
    assert out.tolist() == (torch.arange(8.0) * 2.0).tolist()


def test_device_ref_autofree_on_last_drop(cluster):
    a = _actor()
    ref = ray_tpu_torch.get(a.make_ref.remote(1.0))
    assert ray_tpu_torch.get(a.table_size.remote()) >= 1
    del ref
    gc.collect()
    deadline = time.time() + 30
    while time.time() < deadline:
        if ray_tpu_torch.get(a.table_size.remote()) == 0:
            break
        time.sleep(0.2)
    assert ray_tpu_torch.get(a.table_size.remote()) == 0, \
        "tensor not freed after last DeviceRef dropped"


def test_device_ingest_zero_copy_on_the_cpu(cluster):
    """device_ingest hands the store's read-only numpy views to torch
    through the port's DLPack capsule (``torch.from_dlpack``): every array
    leaf becomes a tensor with its values and dtype, other leaves pass
    through."""
    arr = np.arange(262144, dtype=np.float32).reshape(512, 512)
    ids = np.arange(100, dtype=np.int64)
    ref = ray_tpu_torch.put({"x": arr, "ids": ids, "tag": "t"})
    out = device_ingest(ref, device="cpu")
    assert out["tag"] == "t"
    assert out["x"].dtype == torch.float32 and out["ids"].dtype == \
        torch.int64
    np.testing.assert_array_equal(out["x"].numpy(), arr)
    np.testing.assert_array_equal(out["ids"].numpy(), ids)


@pytest.mark.cuda
def test_cuda_ipc_pull_between_two_processes(cluster):
    """On a card: a bf16 CUDA tensor owned by one actor, pulled by another
    process of the node by CUDA IPC (counted as such, staged once on the
    owner), equal bit for bit, and freed on the owner by free_ref."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA IPC)")
    a = _actor()
    ref = ray_tpu_torch.get(a.make_ref.remote(2.0, "cuda"))
    assert ref.device == "cuda" and ref.card == dp.device_uuid(0)
    before = _local_stats()
    out = device_get(ref, timeout=60.0)
    assert out.is_cuda
    assert out.cpu().tolist() == (torch.arange(8.0) * 2.0).tolist()
    after = _local_stats()
    assert _delta(after, before, "pulls_by_route") == {dp.ROUTE_IPC: 1,
                                                       dp.ROUTE_HOST: 0}
    assert ray_tpu_torch.get(a.plane_stats.remote())["staged"] == 1
    free_ref(ref)
    assert ray_tpu_torch.get(a.table_size.remote()) == 0
