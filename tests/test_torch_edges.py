"""The port's device edges: host-plane collectives
(``ray_tpu_torch.collective``), device channels
(``ray_tpu_torch.experimental.channel``), the DAG's tensor transport and
in-DAG allreduce (``CoreWorker._builtin_dag_call`` /
``_builtin_dag_allreduce``), and the borrow registration of refs unpickled
from a result.

The cases of ``tests/test_collective.py`` and the channel and DAG cases of
``tests/test_device_plane.py``, with the same assertions. On the CPU every
tensor moves by the host relay, and the route counters show it; CUDA IPC
runs only on a card (the ``cuda`` test, skipped without one:
``pytest --noconftest -m cuda tests/test_torch_edges.py`` on the card).
"""

import asyncio
import types

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu import collective as jcol
from ray_tpu_torch import collective as tcol
from ray_tpu_torch.core.cluster_utils import Cluster
from ray_tpu_torch.dag import InputNode, MultiOutputNode, allreduce
from ray_tpu_torch.device_objects import (DeviceRef, device_get,
                                          device_put_ref)
from ray_tpu_torch.experimental import DeviceChannel
from ray_tpu_torch.experimental import device_plane as dp

BORROW_ROUNDS = 50


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(num_nodes=1, resources={"CPU": 16})
    c.connect()
    yield c
    c.shutdown()


def _member_cls():
    """The actor class, made inside a function so that it is pickled by
    value (a test module's top-level class would be pickled by reference
    and fail to import in the worker)."""

    class Member(tcol.CollectiveMixin):
        def do_allreduce(self, value):
            from ray_tpu_torch import collective as col
            out = col.allreduce(np.full(4, float(value)), "g")
            return out.tolist()

        def do_allgather(self, value):
            from ray_tpu_torch import collective as col
            return [np.asarray(x).tolist()
                    for x in col.allgather(np.array([value]), "g")]

        def do_broadcast(self, value):
            from ray_tpu_torch import collective as col
            return np.asarray(
                col.broadcast(np.array([value]), src_rank=0,
                              group_name="g")).tolist()

        def do_barrier_then_rank(self):
            from ray_tpu_torch import collective as col
            col.barrier("g")
            return col.get_rank("g")

        def torch_collectives(self, value, dtype, device="cpu"):
            """Every collective on a torch tensor: each result is a
            tensor on the caller's device; (dtype, device, values) per
            op."""
            from ray_tpu_torch import collective as col
            t = torch.full((6,), float(value), device=device).to(dtype)

            def row(x):
                return (str(x.dtype), x.device.type, x.float().tolist())

            return {
                "sum": row(col.allreduce(t, "g")),
                "mean": row(col.allreduce(t, "g", op="mean")),
                "max": row(col.allreduce(t, "g", op="max")),
                "gather": [row(x) for x in col.allgather(t, "g")],
                "bcast": row(col.broadcast(t, src_rank=1, group_name="g")),
                "scatter": row(col.reducescatter(t, "g")),
                "size": col.get_collective_group_size("g"),
            }

        def make_device_ref(self, n):
            return device_put_ref(torch.arange(float(n)))

        def read_device_ref(self, ref):
            return device_get(ref, device="cpu").tolist()

        # -- channels and DAGs --
        def make_array(self, scale):
            return torch.arange(8.0) * scale

        def make_int(self, scale):
            return torch.arange(1, 9, dtype=torch.int32) * int(scale)

        def consume(self, arr):
            return float(arr.sum())

        def table_size(self):
            from ray_tpu_torch.core.ref import get_core_worker
            return len(get_core_worker()._device_objects)

        def plane_stats(self):
            p = dp.DevicePlane.maybe()
            return p.stats() if p else None

        def read_channel(self, ch, timeout=30.0):
            return ch.read(timeout=timeout).tolist()

        def write_channel(self, ch, value, timeout=30.0):
            ch.write(torch.full((4,), float(value)), timeout=timeout)
            return True

        # -- the borrow race --
        def make_nested(self, i):
            return [device_put_ref(torch.full((4,), float(i)))]

        def read_nested(self, lst):
            return device_get(lst[0], device="cpu", timeout=30).tolist()

        def borrow_rounds(self, producer, reader, rounds):
            """Each round: a task returns a DeviceRef inside its result,
            this caller drops the outer result at once, and a third
            process reads the tensor. Returns the failed rounds."""
            failed = []
            for i in range(rounds):
                r = producer.make_nested.remote(i)
                val = ray_tpu_torch.get(r, timeout=60)
                del r
                try:
                    got = ray_tpu_torch.get(reader.read_nested.remote(val),
                                            timeout=60)
                    if got != [float(i)] * 4:
                        failed.append((i, got))
                except Exception as e:  # noqa: BLE001 - reported per round
                    failed.append((i, repr(e)[:200]))
            return failed

    return Member


def _actors(n, **opts):
    cls = ray_tpu_torch.remote(_member_cls())
    return [cls.options(**opts).remote() for _ in range(n)]


def _group(n):
    actors = _actors(n)
    tcol.init_collective_group(actors, "g")
    return actors


# ----------------------------------------------------------------------
# Collectives (tests/test_collective.py)
# ----------------------------------------------------------------------

def test_allreduce_and_allgather(cluster):
    actors = _group(3)
    outs = ray_tpu_torch.get([a.do_allreduce.remote(i + 1)
                              for i, a in enumerate(actors)], timeout=180)
    assert all(o == [6.0] * 4 for o in outs)  # 1+2+3
    gathers = ray_tpu_torch.get([a.do_allgather.remote(i * 10)
                                 for i, a in enumerate(actors)], timeout=180)
    assert all(g == [[0], [10], [20]] for g in gathers)


def test_broadcast_and_barrier(cluster):
    actors = _group(3)
    outs = ray_tpu_torch.get([a.do_broadcast.remote(i + 7)
                              for i, a in enumerate(actors)], timeout=180)
    assert all(o == [7] for o in outs)  # rank 0's value everywhere
    ranks = ray_tpu_torch.get([a.do_barrier_then_rank.remote()
                               for a in actors], timeout=180)
    assert sorted(ranks) == [0, 1, 2]


def test_device_ref_out_of_band(cluster):
    producer, consumer = _actors(2)
    ref = ray_tpu_torch.get(producer.make_device_ref.remote(8), timeout=180)
    assert isinstance(ref, DeviceRef)
    assert ref.shape == (8,)
    # The ref travels the control plane; the tensor moves out-of-band.
    out = ray_tpu_torch.get(consumer.read_device_ref.remote(ref),
                            timeout=180)
    assert out == [float(i) for i in range(8)]


def test_device_ref_free(cluster):
    producer, consumer = _actors(2)
    ref = ray_tpu_torch.get(producer.make_device_ref.remote(4), timeout=180)

    @ray_tpu_torch.remote
    def free_it(r):
        from ray_tpu_torch.device_objects import free_ref
        free_ref(r)
        return True

    assert ray_tpu_torch.get(free_it.remote(ref), timeout=180)
    with pytest.raises(Exception):
        ray_tpu_torch.get(consumer.read_device_ref.remote(ref), timeout=180)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16])
def test_collectives_on_torch_tensors(cluster, dtype):
    """A torch tensor in gives a torch tensor out, on the caller's device,
    in the reference's result dtype where numpy decides it (sum of int32
    is int64, mean of int32 float64) and in bf16 for bf16."""
    actors = _group(3)
    outs = ray_tpu_torch.get([a.torch_collectives.remote(i + 1, dtype)
                              for i, a in enumerate(actors)], timeout=180)
    name = str(dtype)
    sum_dt = {torch.int32: "torch.int64"}.get(dtype, name)
    mean_dt = {torch.int32: "torch.float64"}.get(dtype, name)
    for rank, o in enumerate(outs):
        assert o["sum"] == (sum_dt, "cpu", [6.0] * 6)
        assert o["mean"] == (mean_dt, "cpu", [2.0] * 6)
        assert o["max"] == (name, "cpu", [3.0] * 6)
        assert o["gather"] == [(name, "cpu", [float(v)] * 6)
                               for v in (1, 2, 3)]
        assert o["bcast"] == (name, "cpu", [2.0] * 6)
        assert o["scatter"] == (sum_dt, "cpu", [6.0] * 2)
        assert o["size"] == 3


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_reducers_match_the_jax_package(op, dtype):
    """The coordinator's reduction, on numpy payloads and on CPU torch
    tensors (what a rank ships for a torch tensor), against the JAX
    package's ``_REDUCERS`` on the same inputs: equal values and dtype."""
    rng = np.random.RandomState(0)
    parts = [(rng.randn(5, 3) * 100).astype(dtype) for _ in range(3)]
    want = jcol._REDUCERS[op](parts)
    for payload in (parts, [tcol._to_host(torch.from_numpy(p))
                            for p in parts]):
        got = _contribute_all(payload, op)
        got = np.asarray(got)
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)


def test_reducers_bf16_against_f32_reference():
    """bf16 (no numpy dtype): reduced by torch, summed in f32 and rounded
    once to bf16, i.e. the reference's f32 reducer on the bf16 inputs
    rounded to bf16."""
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(64, generator=gen).to(torch.bfloat16)
             for _ in range(3)]
    for op in ("sum", "mean", "max", "min"):
        got = _contribute_all([tcol._to_host(p) for p in parts], op)
        assert got.dtype == torch.bfloat16
        ref = jcol._REDUCERS[op]([p.float().numpy() for p in parts])
        want = torch.from_numpy(np.asarray(ref, np.float32)).to(
            torch.bfloat16)
        assert torch.equal(got, want), op


def _contribute_all(payloads, op):
    """Run one allreduce through a ``_Coordinator`` in this process."""
    coord = tcol._Coordinator(len(payloads))

    async def run():
        return await asyncio.gather(*[
            coord.contribute("allreduce", "g", 1, r, p, reduce_op=op)
            for r, p in enumerate(payloads)])

    outs = asyncio.run(run())
    return outs[0]


def test_init_collective_group_names_the_nccl_path(monkeypatch):
    monkeypatch.setattr(tcol, "GlobalConfig", types.SimpleNamespace(
        collective_cpu_fallback=False))
    with pytest.raises(RuntimeError, match="ray_tpu_torch.parallel"):
        tcol.init_collective_group([], "g")


# ----------------------------------------------------------------------
# Device channels (tests/test_device_plane.py)
# ----------------------------------------------------------------------

def test_channel_driver_to_actor(cluster):
    (a,) = _actors(1)
    ch = DeviceChannel.create([a], capacity=2)
    ch.write(torch.full((4,), 5.0))
    got = ray_tpu_torch.get(a.read_channel.remote(ch))
    assert got == [5.0] * 4
    ch.write(torch.full((4,), 7.0))
    got = ray_tpu_torch.get(a.read_channel.remote(ch))
    assert got == [7.0] * 4
    # Both reads were host relays of a CPU tensor; the writer (this
    # process) freed each item on its release.
    stats = ray_tpu_torch.get(a.plane_stats.remote())
    assert stats["pulls_by_route"][dp.ROUTE_HOST] >= 2
    assert stats["pulls_by_route"][dp.ROUTE_IPC] == 0
    from ray_tpu_torch.core.ref import get_core_worker
    assert not get_core_worker()._channel_items.get(ch.channel_id)
    ch.close()


def test_channel_actor_to_actor_frees_on_release(cluster):
    """Writer and reader are two actors: every read is one host relay
    (CPU tensors), and the writer's device table is empty once the reader
    has released the last item."""
    w, r = _actors(2)
    ch = DeviceChannel.create([r], capacity=2)
    for v in (1.0, 2.0, 3.0):
        assert ray_tpu_torch.get(w.write_channel.remote(ch, v))
        assert ray_tpu_torch.get(r.read_channel.remote(ch)) == [v] * 4
    stats = ray_tpu_torch.get(r.plane_stats.remote())
    assert stats["pulls_by_route"] == {dp.ROUTE_IPC: 0, dp.ROUTE_HOST: 3}
    assert stats["relays_by_reason"][dp.RELAY_CPU_TENSOR] == 3
    assert ray_tpu_torch.get(w.table_size.remote()) == 0


def test_channel_backpressure(cluster):
    (a,) = _actors(1)
    ch = DeviceChannel.create([a], capacity=1)
    ch.write(torch.zeros(2))
    # Ring full: the second write must block until the reader releases.
    with pytest.raises(Exception):
        ch.write(torch.ones(2), timeout=1.5)
    got = ray_tpu_torch.get(a.read_channel.remote(ch))  # releases slot 1
    assert got == [0.0, 0.0]
    ch.write(torch.ones(2), timeout=30.0)  # now succeeds
    got = ray_tpu_torch.get(a.read_channel.remote(ch))
    assert got == [1.0, 1.0]
    ch.close()


# ----------------------------------------------------------------------
# DAG tensor transport + in-DAG allreduce (tests/test_device_plane.py)
# ----------------------------------------------------------------------

def test_dag_tensor_transport_no_host_roundtrip(cluster):
    producer, consumer = _actors(2)
    with InputNode() as inp:
        t = producer.make_array.bind(inp).with_tensor_transport()
        out = consumer.consume.bind(t)
    compiled = out.experimental_compile()
    val = ray_tpu_torch.get(compiled.execute(2.0), timeout=120)
    assert val == float(np.arange(8.0).sum() * 2.0)
    # The tensor stayed in the producer and the consumer pulled it: on the
    # CPU by the host relay (nothing staged for CUDA IPC).
    consumer_stats = ray_tpu_torch.get(consumer.plane_stats.remote())
    assert consumer_stats["pulls_by_route"] == {dp.ROUTE_IPC: 0,
                                                dp.ROUTE_HOST: 1}
    producer_stats = ray_tpu_torch.get(producer.plane_stats.remote())
    assert producer_stats is None or producer_stats["staged"] == 0
    # Replay (compiled plans are reusable).
    val = ray_tpu_torch.get(compiled.execute(3.0), timeout=120)
    assert val == float(np.arange(8.0).sum() * 3.0)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "prod"])
def test_dag_allreduce(cluster, op):
    actors = _actors(3)
    with InputNode() as inp:
        parts = [a.make_array.bind(inp) for a in actors]
        outs = allreduce(parts, op=op)
        dag = MultiOutputNode(outs)
    compiled = dag.experimental_compile()
    refs = compiled.execute(1.0)
    device_refs = ray_tpu_torch.get(refs, timeout=120)
    x = torch.arange(8.0)
    expect = {"sum": x + x + x, "mean": (x + x + x) / 3, "max": x,
              "min": x, "prod": x * x * x}[op]
    for dref in device_refs:
        arr = device_get(dref, device="cpu", timeout=60.0)
        assert torch.equal(arr, expect), (op, arr)
    # Rank 0 pulled two peers, each other rank the result: host relays.
    relays = [ray_tpu_torch.get(a.plane_stats.remote())["pulls_by_route"]
              for a in actors]
    assert relays[0] == {dp.ROUTE_IPC: 0, dp.ROUTE_HOST: 2}
    assert relays[1] == relays[2] == {dp.ROUTE_IPC: 0, dp.ROUTE_HOST: 1}


def test_dag_allreduce_ints_in_rank_order(cluster):
    """An int32 allreduce reduces in rank order on rank 0's device and
    keeps the dtype (sum, max), as the reference's jnp ops do."""
    actors = _actors(3)
    with InputNode() as inp:
        parts = [a.make_int.bind(inp) for a in actors]
        dag = MultiOutputNode(allreduce(parts, op="sum")
                              + allreduce(parts, op="max"))
    refs = ray_tpu_torch.get(dag.experimental_compile().execute(2),
                             timeout=120)
    x = torch.arange(1, 9, dtype=torch.int32) * 2
    for dref in refs[:3]:
        got = device_get(dref, device="cpu", timeout=60.0)
        assert got.dtype == torch.int32 and torch.equal(got, 3 * x)
    for dref in refs[3:]:
        assert torch.equal(device_get(dref, device="cpu", timeout=60.0), x)


def test_dag_allreduce_mean_feeds_consumer(cluster):
    a1, a2, consumer = _actors(3)
    with InputNode() as inp:
        parts = [a.make_array.bind(inp) for a in (a1, a2)]
        outs = allreduce(parts, op="mean")
        final = consumer.consume.bind(outs[0])
    compiled = final.experimental_compile()
    val = ray_tpu_torch.get(compiled.execute(4.0), timeout=120)
    assert val == float((np.arange(8.0) * 4.0).sum())


def test_dag_device_call_refuses_async_methods(cluster):
    class AsyncActor:
        async def run(self, x):
            return x

    a = ray_tpu_torch.remote(AsyncActor).remote()
    with InputNode() as inp:
        dag = a.run.bind(inp).with_tensor_transport()
    with pytest.raises(Exception, match="sync methods"):
        ray_tpu_torch.get(dag.execute(torch.ones(2)), timeout=120)


# ----------------------------------------------------------------------
# Borrow registration of refs unpickled from a result
# ----------------------------------------------------------------------

@pytest.mark.parametrize("caller_env", [
    None,
    # The runtime's own RPC fault injection (``testing_rpc_failure``) on
    # the caller: each add_borrow it sends fails and is retried after a
    # short backoff with probability 1/2, so the borrow it registered by
    # unpickling the ref lands late at the owner.
    {"RAY_TPU_TORCH_TESTING_RPC_FAILURE": "add_borrow=0.5"},
], ids=["plain", "late_add_borrow"])
def test_borrow_of_an_unpickled_ref_outlives_the_dropped_result(
        cluster, caller_env):
    """A task returns a DeviceRef inside its result; the caller drops the
    outer result at once and hands the ref to a third process, which reads
    the tensor: every round must find it on the owner."""
    producer, reader = _actors(2)
    opts = {} if caller_env is None else {
        "runtime_env": {"env_vars": caller_env}}
    (caller,) = _actors(1, **opts)
    failed = ray_tpu_torch.get(caller.borrow_rounds.remote(
        producer, reader, BORROW_ROUNDS), timeout=170)
    assert failed == []


# ----------------------------------------------------------------------
# On a card: CUDA IPC for channels and the DAG's tensor transport
# ----------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_ipc_channel_and_dag_transport(cluster):
    """On a card: a bf16 CUDA tensor through a channel from this process to
    an actor and through a DAG edge between two actors; every pull is a
    CUDA IPC pull, equal bit for bit, and the writer's copy is freed on
    release."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA IPC)")

    class CudaActor:
        def make(self, scale):
            return (torch.arange(4096, device="cuda") * scale).to(
                torch.bfloat16)

        def checksum(self, t):
            assert t.is_cuda
            return t.float().sum().item(), t.cpu().view(
                torch.int16).tolist()[:8]

        def read(self, ch):
            t = ch.read(timeout=60)
            assert t.is_cuda
            return t.cpu().view(torch.int16).tolist()

        def stats(self):
            return dp.DevicePlane.get().stats()

    cls = ray_tpu_torch.remote(CudaActor)
    reader, producer, consumer = cls.remote(), cls.remote(), cls.remote()
    ch = DeviceChannel.create([reader], capacity=2)
    x = (torch.arange(4096, device="cuda") * 3).to(torch.bfloat16)
    ch.write(x)
    assert ray_tpu_torch.get(reader.read.remote(ch), timeout=120) == \
        x.cpu().view(torch.int16).tolist()
    st = ray_tpu_torch.get(reader.stats.remote())
    assert st["pulls_by_route"] == {dp.ROUTE_IPC: 1, dp.ROUTE_HOST: 0}
    from ray_tpu_torch.core.ref import get_core_worker
    assert not get_core_worker()._channel_items.get(ch.channel_id)
    ch.close()

    with InputNode() as inp:
        t = producer.make.bind(inp).with_tensor_transport()
        out = consumer.checksum.bind(t)
    compiled = out.experimental_compile()
    total, head = ray_tpu_torch.get(compiled.execute(2), timeout=120)
    want = (torch.arange(4096, device="cuda") * 2).to(torch.bfloat16)
    assert total == want.float().sum().item()
    assert head == want.cpu().view(torch.int16).tolist()[:8]
    assert ray_tpu_torch.get(producer.stats.remote())["staged"] >= 1
    st = ray_tpu_torch.get(consumer.stats.remote())
    assert st["pulls_by_route"] == {dp.ROUTE_IPC: 1, dp.ROUTE_HOST: 0}


# ----------------------------------------------------------------------
# chip_smoke.py's phase 14 on the CPU, small
# ----------------------------------------------------------------------

def test_chip_smoke_edges_phase_on_the_cpu(cluster):
    """chip_smoke.py's phase 14 (channels between this process and the
    actors and between two actors, capacity 1's backpressure, the DAG's
    transport and allreduce, the host-plane collectives) at small sizes on
    the CPU: every check of the phase holds, and every pull goes by the
    host relay."""
    import cloudpickle

    import chip_smoke

    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        out = chip_smoke._phase_edges(
            "cpu", "cpu", channel_bytes=(4096, 1 << 16), dag_bytes=1 << 16,
            coll_bytes=1 << 12, repeats=2)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    assert out["pulls_by_route"][dp.ROUTE_IPC] == 0
    assert out["pulls_by_route"][dp.ROUTE_HOST] == out["pulls_expected"]
    assert [(r["route"], r["bytes"]) for r in out["channels"]] == [
        ("driver->actor", 4096), ("driver->actor", 1 << 16),
        ("actor->actor", 4096), ("actor->actor", 1 << 16)]
    assert [(r["op"], r["dtype"]) for r in out["dag_allreduce"]] == [
        ("sum", "f32"), ("mean", "f32"), ("max", "f32"), ("min", "f32"),
        ("prod", "f32"), ("sum", "bf16")]
