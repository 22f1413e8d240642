"""The port's trainer path (``ray_tpu_torch.train``: ``TorchTrainer``, its
controller, worker and session, fed by ``ray_tpu_torch.data``): the cases
of ``tests/test_train.py`` and ``tests/test_train_elastic.py`` with the
same inputs and assertions, real worker processes on the port's runtime,
each a torch process joined into one gloo group; and the slice's parity:
2 gloo ranks train the tiny Llama under ``MeshConfig(dp=2)`` on shared
weights, fed through ``iter_torch_batches(ctx=..., global_batch=True)``,
and give the JAX package's ``make_train_fns`` losses on the same global
batches.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch.data as rdata
from ray_tpu.models import llama as jl
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import ParallelContext as JParallelContext
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.core.cluster_utils import Cluster
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                 TorchTrainer)

# tests/test_train.py:111-112's tiny Llama, f32
TINY = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
            d_ff=64, max_seq=32)
# Losses of the two packages on the same global batches: f32 on both
# sides; the sums over the two ranks and the AdamW formulas round in
# other orders.
PARITY_RTOL = 1e-5
PARITY_STEPS = 4
LOCAL_BATCH = 2


def test_elastic_resize_grows_mid_run(tmp_path):
    """The counterpart of tests/test_train_elastic.py (first in this file,
    before the module's cluster connects: it owns its own CPU-1 cluster):
    a node JOIN mid-run re-gangs the job at a larger world size, resuming
    from the latest committed checkpoint, never from step 0."""
    from ray_tpu_torch.train.scaling_policy import ElasticScalingPolicy

    c = Cluster(num_nodes=1, resources={"CPU": 1})
    c.connect()
    try:
        storage = str(tmp_path)

        def loop(config):
            import time as _t

            import torch

            import ray_tpu_torch.train as rt
            from ray_tpu_torch.parallel import MeshConfig, ParallelContext
            ctx = rt.get_context()
            pctx = ParallelContext.create(
                MeshConfig(dp=ctx.get_world_size()), device="cpu")
            start_step = 0
            w = torch.zeros(2)
            prev = ctx.get_checkpoint()
            if prev is not None:
                host = rt.load_checkpoint_host(prev)
                start_step = int(host["step"]) + 1
                w = torch.as_tensor(host["w"])
            for step in range(start_step, 20):
                w = w + 1.0
                _t.sleep(0.5)  # slow enough for the resize to land
                ckpt = rt.save_checkpoint({"w": w, "step": step}, step,
                                          ctx=pctx)
                rt.report({"step": step, "world": ctx.get_world_size(),
                           "resumed_from": start_step,
                           "w0": float(w[0])}, checkpoint=ckpt)

        trainer = TorchTrainer(
            loop, train_loop_config={},
            scaling_config=ScalingConfig(num_workers=1, max_workers=2),
            run_config=RunConfig(name="elastic", storage_path=storage))

        def join_later():
            run = os.path.join(storage, "elastic")
            deadline = time.time() + 60
            while time.time() < deadline:
                if os.path.exists(os.path.join(run, "step-0", "COMMIT")):
                    c.add_node(resources={"CPU": 1})
                    return
                time.sleep(0.05)

        t = threading.Thread(target=join_later)
        t.start()
        result = trainer.fit()
        t.join(timeout=10)

        assert result.error is None, result.error
        hist = result.metrics_history
        worlds = [m["world"] for m in hist]
        assert worlds[0] == 1, hist[:2]
        assert worlds[-1] == 2, f"never grew to 2 workers: {worlds}"
        resumed = [m for m in hist if m["world"] == 2]
        assert resumed[0]["resumed_from"] > 0, resumed[:2]
        assert hist[-1]["step"] == 19
        assert hist[-1]["w0"] == 20.0

        pol = ElasticScalingPolicy(1, 8)
        nodes = [{"state": "ALIVE", "resources_total": {"CPU": 3.0},
                  "resources_available": {"CPU": 2.0}},
                 {"state": "DEAD", "resources_total": {"CPU": 8.0},
                  "resources_available": {"CPU": 8.0}},
                 {"state": "ALIVE", "resources_total": {"CPU": 1.0},
                  "resources_available": {"CPU": 1.0}}]
        assert pol.target_workers(1, nodes, {"CPU": 1.0}) == 4
        assert pol.target_workers(4, nodes, {"CPU": 2.0, "GPU": 0}) == 1
        nodes[0]["resources_available"] = {"CPU": 0.0}
        assert pol.target_workers(1, nodes, {"CPU": 1.0}) == 2
    finally:
        c.shutdown()


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(num_nodes=1, resources={"CPU": 8})
    c.connect()
    yield c
    c.shutdown()


def test_slice_parity_two_gloo_ranks(cluster, tmp_path):
    """The slice as a whole: TorchTrainer, 2 gloo workers, the tiny Llama
    under MeshConfig(dp=2) for 4 steps from the JAX package's weights,
    batches from a numpy-seeded dataset through streaming_split and
    iter_torch_batches(global_batch=True); rank 0's losses are the JAX
    step's on the same global batches, and both ranks end with equal
    parameters."""
    jcfg = jl.LlamaConfig(**TINY, dtype=np.float32)
    jinit, jstep = jspmd.make_train_fns(
        jcfg, JParallelContext.create(JMeshConfig(dp=2),
                                      devices=jax.devices()[:2]))
    jstate = jinit(jax.random.PRNGKey(0))
    params = tl.params_from_jax(jax.tree.map(np.asarray, jstate["params"]),
                                device="cpu")
    params = jax.tree.map(lambda t: t.numpy(), params)

    def _parity_loop(config):
        """Rank r trains on slice r of every block, as iter_torch_batches
        marks it: its rows of the step's global batch."""
        import os

        import numpy as np
        import torch

        import ray_tpu_torch.train as rt
        from ray_tpu_torch.models.llama import LlamaConfig
        from ray_tpu_torch.parallel import MeshConfig, ParallelContext
        from ray_tpu_torch.train.worker import torch_info

        ctx = rt.get_context()
        world, rank = ctx.get_world_size(), ctx.get_world_rank()
        cfg = LlamaConfig(**config["cfg"], dtype=torch.float32)
        shard = rt.get_dataset_shard("train")
        # a tp mesh does not split the batch over its ranks: refused
        tp = ParallelContext.create(MeshConfig(tp=world), device="cpu")
        try:
            shard.iter_torch_batches(batch_size=config["local_batch"],
                                     ctx=tp, global_batch=True)
            tp_error = None
        except ValueError as e:
            tp_error = str(e)
        pctx = ParallelContext.create(MeshConfig(dp=world), device="cpu")
        init, step = rt.make_train_fns(cfg, pctx)
        state = init(config["params"])
        losses, rows = [], []
        for batch in shard.iter_torch_batches(
                batch_size=config["local_batch"], ctx=pctx,
                global_batch=True):
            rows.append(batch["tokens"].shape[0])
            state, m = step(state, batch["tokens"])
            losses.append(float(m["loss"]))

        def flat(tree, prefix=""):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out.update(flat(v, f"{prefix}{k}."))
                else:
                    out[prefix + k] = v.detach().numpy()
            return out

        np.savez(os.path.join(config["out"], f"rank{rank}.npz"),
                 **flat(state["params"]))
        rt.report({"losses": losses, "rows": rows, "tp_error": tp_error,
                   "info": torch_info()})

    world = 2
    toks = np.random.RandomState(0).randint(
        0, TINY["vocab_size"], (PARITY_STEPS * world * LOCAL_BATCH,
                                TINY["max_seq"])).astype(np.int32)
    # one block per step: rank r's slice of block i is its rows of global
    # batch i (streaming_split(equal=True), split.py)
    ds = rdata.from_items([{"tokens": t} for t in toks],
                          num_blocks=PARITY_STEPS)
    result = TorchTrainer(
        _parity_loop,
        train_loop_config=dict(cfg=TINY, params=params,
                               local_batch=LOCAL_BATCH, out=str(tmp_path)),
        scaling_config=ScalingConfig(num_workers=world),
        datasets={"train": ds}).fit()
    got = result.metrics_history[-1]

    want = []
    for i in range(PARITY_STEPS):
        glob = toks[i * world * LOCAL_BATCH:(i + 1) * world * LOCAL_BATCH]
        jstate, jm = jstep(jstate, jnp.asarray(glob))
        want.append(float(jm["loss"]))
    assert got["rows"] == [LOCAL_BATCH] * PARITY_STEPS
    np.testing.assert_allclose(got["losses"], want, rtol=PARITY_RTOL)
    assert got["info"]["backend"] == "gloo"
    assert got["info"]["world"] == world and got["info"]["device"] == "cpu"
    assert got["tp_error"] and "splits it 1 ways" in got["tp_error"]

    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    assert sorted(ranks[0].files) == sorted(ranks[1].files)
    for key in ranks[0].files:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key],
                                      err_msg=key)


def test_torch_trainer_multiprocess_dp(cluster):
    def _mlp_loop(config):
        """Tiny data-parallel MLP regression over the group: each rank
        its rows, gradients averaged over the ranks."""
        import numpy as np
        import torch
        import torch.distributed as dist

        import ray_tpu_torch.train as train

        ctx = train.get_context()
        world = ctx.get_world_size()
        rng = np.random.RandomState(0)
        w_true = rng.rand(8, 1).astype(np.float32)
        params = {
            "w1": torch.tensor(rng.rand(8, 16).astype(np.float32) * 0.1),
            "w2": torch.tensor(rng.rand(16, 1).astype(np.float32) * 0.1),
        }
        for p in params.values():
            p.requires_grad_(True)

        n_global = 64
        per_proc = n_global // world
        for it in range(config["steps"]):
            xs = rng.rand(per_proc, 8).astype(np.float32)
            ys = xs @ w_true
            x, y = torch.from_numpy(xs), torch.from_numpy(ys)
            pred = torch.tanh(x @ params["w1"]) @ params["w2"]
            loss = torch.mean((pred - y) ** 2)
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for p, g in zip(params.values(), grads):
                    dist.all_reduce(g)
                    p -= 0.05 * g / world
                dist.all_reduce(loss)
            train.report({"loss": float(loss) / world, "step": it,
                          "world": world,
                          "global_devices": dist.get_world_size()})

    trainer = TorchTrainer(
        _mlp_loop, train_loop_config={"steps": 12},
        scaling_config=ScalingConfig(num_workers=2))
    result = trainer.fit()
    hist = result.metrics_history
    assert len(hist) == 12
    # Two processes of one CPU device each: a 2-rank group.
    assert hist[0]["global_devices"] == 2
    assert hist[0]["world"] == 2
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.5, hist


def test_failure_policy_restarts_group(cluster, tmp_path):
    def _flaky_loop(config):
        import os

        import ray_tpu_torch.train as train

        ctx = train.get_context()
        marker = config["marker"]
        if ctx.get_world_rank() == 0 and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)  # hard crash: worker process dies mid-training
        for it in range(3):
            train.report({"loss": 1.0 / (it + 1), "restarted": True})

    marker = str(tmp_path / "crash_once")
    trainer = TorchTrainer(
        _flaky_loop, train_loop_config={"marker": marker},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=2)))
    result = trainer.fit()
    assert result.metrics_history, "no metrics after restart"
    assert result.metrics_history[-1]["restarted"]


def test_failure_policy_exhausted(cluster):
    def always_fail(config):
        raise RuntimeError("intentional boom")

    trainer = TorchTrainer(
        always_fail,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=1)))
    from ray_tpu_torch.train.controller import TrainingFailedError
    with pytest.raises(TrainingFailedError, match="intentional boom"):
        trainer.fit()


def test_profile_writes_a_chrome_trace(cluster, tmp_path):
    def loop(config):
        import torch

        import ray_tpu_torch.train as rt
        with rt.profile() as out:
            torch.ones(64, 64) @ torch.ones(64, 64)
        rt.report({"out": out})

    result = TorchTrainer(
        loop, train_loop_config={},
        run_config=RunConfig(name="prof", storage_path=str(tmp_path))).fit()
    out = result.metrics_history[-1]["out"]
    assert out == os.path.join(str(tmp_path), "prof", "profile-rank0")
    with open(os.path.join(out, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events), events[:5]
