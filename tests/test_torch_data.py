"""The port's Data layer (``ray_tpu_torch.data``): the cases of
``tests/test_data.py`` and ``tests/test_streaming_executor.py`` with the
same inputs and expected values on the port's copy, a parametrised
selection of ``tests/test_data_shuffle.py`` and
``tests/test_data_sources.py`` (groupby, join, the writers' round trips,
preprocessors), ``iter_torch_batches`` in place of ``iter_jax_batches``,
and import hygiene: the data layer loads no torch, and no module of the
port names jax or ray_tpu.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.data as rdata
from ray_tpu_torch.core.cluster_utils import Cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(num_nodes=1, resources={"CPU": 8})
    c.connect()
    yield c
    c.shutdown()


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def test_data_import_loads_no_torch_jax_or_ray_tpu():
    code = ("import sys, ray_tpu_torch.data\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'ray_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_name_no_jax_and_no_ray_tpu():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib)\b|"
                         r"\bray_tpu\.(?!_torch)|"
                         r"^\s*(import|from)\s+ray_tpu\b(?!_torch)")
    bad = []
    for root, _, files in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            for i, line in enumerate(open(path, encoding="utf-8"), 1):
                code = line.split("#", 1)[0]
                if re.search(r"^\s*(import|from)\s", code) and \
                        pattern.search(code):
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}: "
                               f"{line.strip()}")
    assert not bad, bad


def test_data_tasks_run_without_torch(cluster):
    def probe(batch):
        import sys as _sys
        return {"torch": np.array(["torch" in _sys.modules] * len(
            batch["id"]))}

    rows = rdata.range(8, num_blocks=2).map_batches(probe).take_all()
    assert [bool(r["torch"]) for r in rows] == [False] * 8


# ---------------------------------------------------------------------------
# tests/test_data.py
# ---------------------------------------------------------------------------

def test_range_count_take(cluster):
    ds = rdata.range(1000, num_blocks=4)
    assert ds.count() == 1000
    assert ds.num_blocks() == 4
    rows = ds.take(5)
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]


def test_map_batches_and_filter(cluster):
    ds = (rdata.range(100, num_blocks=4)
          .map_batches(lambda b: {"id": b["id"] * 2})
          .filter(lambda r: r["id"] % 4 == 0))
    got = sorted(r["id"] for r in ds.take_all())
    assert got == [i * 2 for i in range(100) if (i * 2) % 4 == 0]


def test_map_and_flat_map_rows(cluster):
    ds = rdata.from_items([1, 2, 3], num_blocks=2).map(lambda x: x + 10)
    assert sorted(ds.take_all()) == [11, 12, 13]
    ds2 = rdata.from_items([1, 2]).flat_map(lambda x: [x, x])
    assert sorted(ds2.take_all()) == [1, 1, 2, 2]


def test_iter_batches_exact_batching(cluster):
    ds = rdata.range(100, num_blocks=3)
    sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=32)]
    assert sum(sizes) == 100
    assert all(s == 32 for s in sizes[:-1])  # re-chunked across blocks


def test_streaming_overlap(cluster, tmp_path):
    """Blocks are consumable before the whole pipeline finishes: the
    last block's task waits for the consumer's receipt of the first."""
    marker = str(tmp_path / "first-batch-consumed")

    def slow_stage(batch, marker=marker):
        import os as _os
        import time as _t
        if int(batch["id"][0]) // 64 == 7:
            deadline = _t.monotonic() + 30.0
            while not _os.path.exists(marker):
                if _t.monotonic() > deadline:
                    raise RuntimeError(
                        "consumer never saw the first batch while the "
                        "last block was in flight: no streaming overlap")
                _t.sleep(0.05)
        else:
            _t.sleep(0.05)
        return batch

    rdata.range(8, num_blocks=8).map_batches(lambda b: b).take_all()

    ds = rdata.range(8 * 64, num_blocks=8).map_batches(slow_stage)
    it = iter(ds.iter_batches(batch_size=None))
    first = next(it)
    open(marker, "w").close()      # receipt: unblocks the final block
    n_rest = sum(1 for _ in it)
    assert len(first["id"]) == 64 and n_rest == 7


def test_materialize_and_split(cluster):
    ds = rdata.range(100, num_blocks=4).materialize()
    parts = ds.split(2)
    counts = [p.count() for p in parts]
    assert sum(counts) == 100
    assert all(c > 0 for c in counts)


def test_repartition_and_shuffle(cluster):
    ds = rdata.range(90, num_blocks=3).repartition(5)
    assert ds.num_blocks() == 5
    assert ds.count() == 90
    sh = rdata.range(50, num_blocks=2).random_shuffle(seed=0)
    ids = [r["id"] for r in sh.take_all()]
    assert sorted(ids) == list(range(50))
    assert ids != list(range(50))  # actually permuted


def test_streaming_split_equal(cluster):
    ds = rdata.range(96, num_blocks=8)
    its = ds.streaming_split(2, equal=True)
    out = [None, None]

    def consume(i):
        out[i] = [r["id"] for b in its[i].iter_batches(batch_size=None)
                  for r in rdata.BlockAccessor(b).to_rows()]

    ts = [threading.Thread(target=consume, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert sorted(out[0] + out[1]) == list(range(96))
    assert len(out[0]) == len(out[1]) == 48


def test_streaming_split_equal_nondivisible(cluster):
    ds = rdata.range(90, num_blocks=5)  # 5 blocks / 2 consumers
    its = ds.streaming_split(2, equal=True)
    rows = [[], []]
    for i in (0, 1):
        for b in its[i].iter_batches(batch_size=None):
            rows[i].extend(r["id"] for r in rdata.BlockAccessor(b).to_rows())
    assert len(rows[0]) == len(rows[1])  # strict row parity
    assert len(rows[0]) + len(rows[1]) >= 88  # at most n-1 dropped per block
    assert not set(rows[0]) & set(rows[1])  # disjoint shards


def test_streaming_split_equal_gives_consumer_i_slice_i(cluster):
    """What the trainer's parity rests on: with equal=True consumer i gets
    slice i of every block, in block order."""
    ds = rdata.range(24, num_blocks=3)  # blocks of 8 rows
    its = ds.streaming_split(2, equal=True)
    got = [[int(v) for b in its[i].iter_batches(batch_size=None)
            for v in b["id"]] for i in (0, 1)]
    assert got[0] == [0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19]
    assert got[1] == [4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]


def test_parquet_roundtrip(cluster, tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    table = pa.table({"x": np.arange(100), "y": np.arange(100) * 0.5})
    path = os.path.join(tmp_path, "t.parquet")
    pq.write_table(table, path)
    ds = rdata.read_parquet(path)
    assert ds.count() == 100
    batch = next(iter(ds.iter_batches(batch_size=None)))
    np.testing.assert_array_equal(batch["x"], np.arange(100))


def test_zero_copy_host_path(cluster):
    big = {"x": np.arange(200_000, dtype=np.float64)}  # 1.6MB: store path
    ds = rdata.from_numpy(big["x"])
    [ref] = list(ds.iter_block_refs())
    block = ray_tpu_torch.get(ref)
    arr = block["data"]
    assert not arr.flags["OWNDATA"], "block array was copied on the host path"
    np.testing.assert_array_equal(arr, big["x"])


def test_iter_torch_batches(cluster):
    """The counterpart of test_iter_jax_batches: 4 batches whose sums add
    up; on the CPU each is one copy of the store's read-only view, so it
    is writable, owns its memory and keeps the block's dtype."""
    ds = rdata.range(64, num_blocks=2)
    batches = list(ds.iter_torch_batches(batch_size=16, device="cpu"))
    assert len(batches) == 4
    t = batches[0]["id"]
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert t.dtype == torch.from_numpy(np.arange(1)).dtype
    total = sum(int(b["id"].sum()) for b in batches)
    assert total == sum(range(64))

    x = np.arange(200_000, dtype=np.float32)  # a store-backed view
    ds = rdata.from_numpy({"x": x}, num_blocks=1)
    [ref] = list(ds.iter_block_refs())
    view = ray_tpu_torch.get(ref)["x"]
    assert not view.flags["WRITEABLE"]
    [batch] = list(ds.iter_torch_batches(batch_size=None, device="cpu"))
    t = batch["x"]
    assert t.dtype == torch.float32
    assert t.data_ptr() != view.ctypes.data
    t += 1  # writable, and the block is untouched
    np.testing.assert_array_equal(view, x)
    np.testing.assert_array_equal(t.numpy(), x + 1)


def test_iter_torch_batches_dtypes_and_no_card(cluster):
    ds = rdata.from_numpy({"a": np.arange(8, dtype=np.int32),
                           "b": np.arange(8, dtype=np.float64)})
    [b] = list(ds.iter_torch_batches(batch_size=8, device="cpu",
                                     dtypes={"b": torch.float32}))
    assert b["a"].dtype == torch.int32 and b["b"].dtype == torch.float32
    [b] = list(ds.iter_torch_batches(batch_size=8, device="cpu",
                                     dtypes=torch.int64))
    assert b["a"].dtype == b["b"].dtype == torch.int64
    if not torch.cuda.is_available():
        # device=None is the card: without one it raises, never CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(iter(ds.iter_torch_batches(batch_size=8)))
    with pytest.raises(ValueError, match="needs the ParallelContext"):
        next(iter(ds.iter_torch_batches(batch_size=8, device="cpu",
                                        global_batch=True)))


def test_trainer_ingests_via_data(cluster):
    """TorchTrainer workers pull their shard through streaming_split and
    train on torch batches."""
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    ds = rdata.range(64, num_blocks=4).map_batches(
        lambda b: {"x": b["id"].astype(np.float32)})

    def loop(config):
        import ray_tpu_torch.train as rt
        it = rt.get_dataset_shard("train")
        total = 0.0
        n = 0
        for batch in it.iter_torch_batches(batch_size=8, device="cpu"):
            total += float(batch["x"].sum())
            n += 1
        rt.report({"sum": total, "batches": n})

    trainer = TorchTrainer(
        loop, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        datasets={"train": ds})
    result = trainer.fit()
    hist = result.metrics_history
    assert hist, "no metrics reported"
    assert hist[-1]["batches"] == 4  # 32 rows / batch 8 on rank 0's shard


def test_map_batches_actor_compute(cluster):
    class AddPid:
        def __init__(self, offset):
            self.offset = offset
            self.pid = os.getpid()

        def __call__(self, batch):
            return {"id": batch["id"] + self.offset,
                    "pid": np.full_like(batch["id"], self.pid)}

    ds = rdata.range(120, num_blocks=6).map_batches(
        AddPid, concurrency=2, fn_constructor_args=(1000,))
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == [1000 + i for i in range(120)]
    pids = {r["pid"] for r in rows}
    assert 1 <= len(pids) <= 2, pids  # exactly the pool's actors

    ds2 = (rdata.range(40, num_blocks=4)
           .map_batches(AddPid, concurrency=2, fn_constructor_args=(0,))
           .filter(lambda r: r["id"] % 2 == 0))
    got = sorted(r["id"] for r in ds2.take_all())
    assert got == [i for i in range(40) if i % 2 == 0]


def test_union_and_sort(cluster):
    a = rdata.range(10, num_blocks=2)
    b = rdata.range(10, num_blocks=2).map_batches(
        lambda x: {"id": x["id"] + 100})
    u = a.union(b)
    assert u.num_blocks() == 4
    ids = sorted(r["id"] for r in u.take_all())
    assert ids == list(range(10)) + [100 + i for i in range(10)]

    sh = rdata.range(30, num_blocks=3).random_shuffle(seed=1)
    asc = [r["id"] for r in sh.sort("id").take_all()]
    assert asc == list(range(30))
    desc = [r["id"] for r in sh.sort("id", descending=True).take_all()]
    assert desc == list(range(29, -1, -1))


def test_union_with_downstream_transform_and_empty_sort(cluster):
    u = rdata.range(6, num_blocks=2).union(rdata.range(6, num_blocks=2))
    doubled = sorted(r["id"] for r in u.map_batches(
        lambda b: {"id": b["id"] * 2}).take_all())
    assert doubled == sorted([2 * i for i in range(6)] * 2)
    assert rdata.from_items([]).sort("id").take_all() == []


def test_read_text_and_binary(cluster, tmp_path):
    p1 = tmp_path / "a.txt"
    p1.write_text("alpha\nbeta\ngamma\n")
    p2 = tmp_path / "b.bin"
    p2.write_bytes(b"\x00\x01payload")
    ds = rdata.read_text(str(p1))
    assert [r["text"] for r in ds.take_all()] == ["alpha", "beta", "gamma"]
    bs = rdata.read_binary_files(str(p2), include_paths=True)
    rows = bs.take_all()
    assert rows[0]["bytes"] == b"\x00\x01payload"
    assert rows[0]["path"].endswith("b.bin")


def test_read_images(cluster, tmp_path):
    from PIL import Image
    for i in range(3):
        Image.new("RGB", (8, 6), color=(i * 10, 0, 0)).save(
            tmp_path / f"img{i}.png")
    ds = rdata.read_images(str(tmp_path), size=(4, 4), mode="L")
    imgs = [r["image"] for r in ds.take_all()]
    assert len(imgs) == 3
    assert all(im.shape == (4, 4) for im in imgs)


def test_writers_roundtrip(cluster, tmp_path):
    ds = rdata.range(40, num_blocks=4).map_batches(
        lambda b: {"id": b["id"], "sq": b["id"] ** 2})

    pq_files = ds.write_parquet(str(tmp_path / "pq"))
    assert len(pq_files) == 4
    back = rdata.read_parquet(str(tmp_path / "pq"))
    assert sorted(r["id"] for r in back.take_all()) == list(range(40))

    csv_files = ds.write_csv(str(tmp_path / "csv"))
    assert len(csv_files) == 4
    back = rdata.read_csv(str(tmp_path / "csv"))
    assert sorted(r["sq"] for r in back.take_all()) == \
        [i ** 2 for i in range(40)]

    js_files = ds.write_json(str(tmp_path / "js"))
    rows = [json.loads(line) for f in js_files for line in open(f)]
    assert sorted(r["id"] for r in rows) == list(range(40))


def test_dataset_stats_exposes_operator_metrics(cluster):
    ds = rdata.range(40, num_blocks=4).map_batches(lambda b: b)
    assert ds.stats()["plan"] == ["_Read", "_Fused"]
    assert ds.count() == 40
    ops = ds.stats()["operators"]
    assert ops["read->map"]["tasks_launched"] == 4
    assert ops["read->map"]["blocks_out"] == 4


# ---------------------------------------------------------------------------
# tests/test_streaming_executor.py
# ---------------------------------------------------------------------------

def test_plan_lowering_shapes(cluster):
    ds = (rdata.range(10, num_blocks=2)
          .map_batches(lambda b: b)
          .filter(lambda r: True))
    names = [s.name for s in ds._build_states()]
    assert names == ["input", "read->map"]  # everything fused

    ds2 = ds.random_shuffle(seed=0).map_batches(lambda b: b)
    names2 = [s.name for s in ds2._build_states()]
    assert names2 == ["input", "read->map", "random_shuffle", "map"]

    class Ident:
        def __call__(self, b):
            return b

    ds3 = ds.map_batches(Ident, concurrency=2).filter(lambda r: True)
    names3 = [s.name for s in ds3._build_states()]
    assert names3 == ["input", "read->map", "map(actors)", "map"]


def test_shuffle_actor_map_streaming_split(cluster):
    class AddOffset:
        def __init__(self, off):
            self.off = off

        def __call__(self, batch):
            return {"id": batch["id"] + self.off}

    ds = (rdata.range(96, num_blocks=8)
          .random_shuffle(seed=0)
          .map_batches(AddOffset, concurrency=2,
                       fn_constructor_args=(1000,)))
    its = ds.streaming_split(2, equal=True)
    rows = [[], []]

    def consume(i):
        for b in its[i].iter_batches(batch_size=None):
            rows[i].extend(int(v) for v in b["id"])

    ts = [threading.Thread(target=consume, args=(i,)) for i in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=180)
    assert sorted(rows[0] + rows[1]) == [1000 + i for i in range(96)]
    assert len(rows[0]) == len(rows[1])


def test_union_through_concat_operator(cluster):
    a = rdata.range(6, num_blocks=2)
    b = rdata.range(6, num_blocks=2).map_batches(
        lambda x: {"id": x["id"] + 100})
    u = a.union(b).map_batches(lambda x: {"id": x["id"] * 2})
    got = [r["id"] for r in u.take_all()]
    assert got[:6] == [0, 2, 4, 6, 8, 10]
    assert sorted(got[6:]) == [200 + 2 * i for i in range(6)]


def test_slow_consumer_stalls_producer(cluster, tmp_path):
    marker = os.path.join(str(tmp_path), "ran.log")

    def counting(batch):
        with open(marker, "a") as f:
            f.write("x\n")
        return batch

    n_blocks = 24
    budget = 2
    ds = rdata.range(n_blocks * 4, num_blocks=n_blocks).map_batches(counting)
    it = ds.iter_block_refs(window=budget)
    first = next(it)
    assert ray_tpu_torch.get(first) is not None
    time.sleep(2.0)
    with open(marker) as f:
        ran = len(f.readlines())
    assert ran <= budget + 2, \
        f"{ran} of {n_blocks} source tasks ran during a consumer stall " \
        f"(budget {budget}: producers must stall, not run ahead)"
    rest = list(it)
    assert 1 + len(rest) == n_blocks
    with open(marker) as f:
        assert len(f.readlines()) == n_blocks


def test_executor_metrics_exposed(cluster):
    from ray_tpu_torch.data.streaming_executor import StreamingExecutor

    ds = rdata.range(20, num_blocks=4).map_batches(lambda b: b)
    ex = StreamingExecutor(ds._build_states(), task_budget=2)
    refs = list(ex.run())
    assert len(refs) == 4
    m = ex.metrics()
    assert m["read->map"].tasks_launched == 4
    assert m["read->map"].tasks_finished == 4
    assert m["read->map"].blocks_out == 4


def test_early_abandonment_shuts_down(cluster):
    class Ident:
        def __call__(self, b):
            return b

    ds = rdata.range(200, num_blocks=20).map_batches(Ident, concurrency=2)
    rows = ds.take(5)
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]


def test_byte_budget_bounds_inflight_memory(cluster):
    """The byte budget's property, asserted on what is really in flight:
    with blocks of 1.52 MB under a 4 MB budget, the tasks in flight plus
    the blocks waiting at the sink never hold more than budget + one
    block, far below the 8 tasks the slot budget alone would run. The
    reference's version reads ``peak_mem_used``, the executor's own
    estimate, which counts a finished task's bytes before its finish
    (up to 7.6 MB here for 2 tasks in flight) and so races; the count
    of tasks and blocks does not, since every sample must obey it."""
    from ray_tpu_torch.data.streaming_executor import StreamingExecutor

    def widen(batch):
        return {"big": [np.zeros(190_000, np.int64)
                        for _ in range(len(batch["id"]))]}

    n_blocks, block_bytes = 12, 190_000 * 8
    ds = rdata.range(n_blocks, num_blocks=n_blocks).map_batches(widen)
    budget = 4 * 1024 * 1024  # ~2-3 blocks of headroom
    ex = StreamingExecutor(ds._build_states(), task_budget=8,
                           memory_budget=budget)
    seen, most = 0, 0
    for _ in ex.run():  # the consumer takes one block per loop pass
        seen += 1
        m = ex.metrics()["read->map"]
        held = (m.tasks_launched - m.tasks_finished
                + len(ex._out_queue)) * block_bytes
        most = max(most, held)
        assert held <= budget + 1_700_000, (seen, m, len(ex._out_queue))
        time.sleep(0.05)
    assert seen == n_blocks
    assert most < 8 * 1_500_000


def test_byte_budget_does_not_throttle_small_blocks(cluster):
    from ray_tpu_torch.data.streaming_executor import StreamingExecutor

    ds = rdata.range(100, num_blocks=10).map_batches(lambda b: b)
    ex = StreamingExecutor(ds._build_states(), task_budget=4)
    refs = list(ex.run())
    assert len(refs) == 10
    assert ex.metrics()["read->map"].tasks_finished == 10


# ---------------------------------------------------------------------------
# a selection of tests/test_data_shuffle.py and tests/test_data_sources.py
# ---------------------------------------------------------------------------

def _groupby_sum(tmp_path):
    ds = rdata.from_items([{"k": i % 3, "v": float(i)} for i in range(30)],
                          num_blocks=4)
    got = {int(r["k"]): r["sum(v)"]
           for r in ds.groupby("k").sum("v").take_all()}
    assert got == {k: sum(float(i) for i in range(30) if i % 3 == k)
                   for k in range(3)}


def _groupby_count_mean_min_max(tmp_path):
    ds = rdata.from_items([{"k": "ab"[i % 2], "v": float(i)}
                           for i in range(20)], num_blocks=3)
    g = ds.groupby("k")
    assert {r["k"]: r["count()"] for r in g.count().take_all()} == \
        {"a": 10, "b": 10}
    mean = {r["k"]: r["mean(v)"] for r in g.mean("v").take_all()}
    assert mean["a"] == np.mean([i for i in range(20) if i % 2 == 0])
    assert mean["b"] == np.mean([i for i in range(20) if i % 2 == 1])
    assert {r["k"]: r["min(v)"] for r in g.min("v").take_all()} == \
        {"a": 0.0, "b": 1.0}
    assert {r["k"]: r["max(v)"] for r in g.max("v").take_all()} == \
        {"a": 18.0, "b": 19.0}


def _groupby_map_groups(tmp_path):
    ds = rdata.from_items([{"k": i % 2, "v": i} for i in range(8)],
                          num_blocks=2)

    def top_one(group):
        i = int(np.argmax(group["v"]))
        return [{"k": int(group["k"][i]), "best": int(group["v"][i])}]

    out = ds.groupby("k").map_groups(top_one).take_all()
    assert sorted((r["k"], r["best"]) for r in out) == [(0, 6), (1, 7)]


def _inner_join(tmp_path):
    left = rdata.from_items([{"id": i, "x": i * 10} for i in range(6)],
                            num_blocks=2)
    right = rdata.from_items([{"id": i, "y": i * 100} for i in range(3, 9)],
                             num_blocks=3)
    out = left.join(right, on="id").take_all()
    assert sorted((r["id"], r["x"], r["y"]) for r in out) == [
        (3, 30, 300), (4, 40, 400), (5, 50, 500)]


def _left_join_and_suffix(tmp_path):
    left = rdata.from_items([{"id": i, "v": i} for i in range(4)],
                            num_blocks=2)
    right = rdata.from_items([{"id": i, "v": -i} for i in range(2, 6)],
                             num_blocks=2)
    out = left.join(right, on="id", how="left").take_all()
    by_id = {r["id"]: r for r in out}
    assert len(out) == 4
    assert by_id[3]["v"] == 3 and by_id[3]["v_right"] == -3
    assert by_id[0]["v"] == 0 and by_id[0]["v_right"] is None


def _join_cross_dtype_keys(tmp_path):
    left = rdata.from_items([{"id": i, "x": i} for i in range(4)],
                            num_blocks=2)
    right = rdata.from_items([{"id": float(i), "y": i} for i in range(4)],
                             num_blocks=2)
    out = left.join(right, on="id", num_partitions=3).take_all()
    assert len(out) == 4, out


def _parquet_write_read(tmp_path):
    ds = rdata.from_numpy({"x": np.arange(30), "y": np.arange(30) * 0.5},
                          num_blocks=3)
    files = ds.write_parquet(str(tmp_path / "pq"))
    assert len(files) == 3
    rows = sorted(rdata.read_parquet(str(tmp_path / "pq")).take_all(),
                  key=lambda r: r["x"])
    assert [(r["x"], r["y"]) for r in rows] == \
        [(i, i * 0.5) for i in range(30)]


def _csv_write_read(tmp_path):
    ds = rdata.from_items([{"a": i, "b": f"s{i}"} for i in range(12)],
                          num_blocks=2)
    assert len(ds.write_csv(str(tmp_path / "csv"))) == 2
    rows = sorted(rdata.read_csv(str(tmp_path / "csv")).take_all(),
                  key=lambda r: r["a"])
    assert [(r["a"], r["b"]) for r in rows] == \
        [(i, f"s{i}") for i in range(12)]


def _standard_scaler(tmp_path):
    from ray_tpu_torch.data.preprocessors import StandardScaler

    x = np.random.RandomState(0).normal(5.0, 3.0, 200)
    ds = rdata.from_numpy({"x": x, "keep": np.arange(200.0)}, num_blocks=4)
    scaler = StandardScaler(["x"]).fit(ds)
    out = np.concatenate([b["x"] for b in
                          scaler.transform(ds).iter_batches()])
    np.testing.assert_allclose(out.mean(), 0.0, atol=1e-9)
    np.testing.assert_allclose(out.std(), 1.0, atol=1e-9)


def _concatenator_and_chain(tmp_path):
    from ray_tpu_torch.data.preprocessors import (Chain, Concatenator,
                                                  StandardScaler)

    ds = rdata.from_numpy({"a": np.arange(8.0), "b": np.arange(8.0) * 2},
                          num_blocks=2)
    chain = Chain(StandardScaler(["a", "b"]),
                  Concatenator(["a", "b"], "features"))
    chain.fit(ds)
    # the preprocessed features reach torch as float32
    [b] = list(chain.transform(ds).iter_torch_batches(batch_size=8,
                                                      device="cpu"))
    feats = b["features"]
    assert feats.shape == (8, 2) and feats.dtype == torch.float32
    np.testing.assert_allclose(feats.mean(dim=0).numpy(), 0.0, atol=1e-6)


SHUFFLE_AND_SOURCE_CASES = {
    "groupby_sum": _groupby_sum,
    "groupby_count_mean_min_max": _groupby_count_mean_min_max,
    "groupby_map_groups": _groupby_map_groups,
    "inner_join": _inner_join,
    "left_join_and_suffix": _left_join_and_suffix,
    "join_cross_dtype_keys": _join_cross_dtype_keys,
    "parquet_write_read": _parquet_write_read,
    "csv_write_read": _csv_write_read,
    "standard_scaler": _standard_scaler,
    "concatenator_and_chain": _concatenator_and_chain,
}


@pytest.mark.parametrize("case", sorted(SHUFFLE_AND_SOURCE_CASES))
def test_shuffle_and_source_cases(cluster, tmp_path, case):
    SHUFFLE_AND_SOURCE_CASES[case](tmp_path)
