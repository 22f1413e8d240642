"""One rank of the CPU gloo group that ``test_torch_parallel.py`` spawns.

Imports torch and the port only (no JAX), so each spawned child starts
quickly. For every job it builds the job's ``ParallelContext``, takes the
global parameters, keeps its blocks, and reports the loss, this rank's
gradient blocks, one ``make_train_fns`` step and whether
``state_from_jax`` keeps the same blocks back to the parent. A checkpoint job ("kind": "ckpt") takes one step
under its mesh, saves the state with ``save_checkpoint`` into the job's
directory, restores it into a fresh state, and, when the job names
another mesh's checkpoint ("cross"), checks that restoring either
checkpoint under the other mesh is refused.
"""

import os
import traceback
import types

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel import MeshConfig, ParallelContext, tree_shard
from ray_tpu_torch.train import checkpointing as tckpt
from ray_tpu_torch.train import spmd as tspmd


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _run_job(job):
    cfg = tl.LlamaConfig.tiny(**job["model"])
    ctx = ParallelContext.create(MeshConfig(**job["mesh"]), device="cpu")
    tokens = torch.from_numpy(job["tokens"])
    local = tree_shard(tl.params_from_jax(job["params"], device="cpu"),
                       tl.param_specs(cfg, ctx), ctx)
    params = _map(lambda t: t.clone().requires_grad_(True), local)
    leaves = _flat(params)
    loss, metrics = tl.loss_fn(params, tokens, cfg, ctx)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    init, step = tspmd.make_train_fns(cfg, ctx)
    state = init(job["params"])
    # a JAX state at step 0 whose Adam moments are the parameters: carried
    # across, every leaf must be the block init_fn keeps
    carried = tspmd.state_from_jax(dict(
        params=job["params"], step=np.int32(0),
        opt_state=(types.SimpleNamespace(count=np.int32(0), mu=job["params"],
                                         nu=job["params"]),)), cfg, ctx=ctx)
    mine = _flat(state["params"])
    from_jax_blocks_equal = all(
        torch.equal(a, mine[k]) for tree in (
            carried["params"], carried["opt_state"]["mu"],
            carried["opt_state"]["nu"]) for k, a in _flat(tree).items())
    state, m = step(state, tokens)
    return dict(
        coord={a: ctx.rank(a) for a in ("pp", "dp", "fsdp", "ep", "sp",
                                         "tp")},
        loss=float(loss.detach()), tokens=float(metrics["tokens"]),
        grads={k: g.numpy() for k, g in zip(leaves, grads)},
        step_loss=float(m["loss"]), step_grad_norm=float(m["grad_norm"]),
        from_jax_blocks_equal=from_jax_blocks_equal,
        step_params={k: v.detach().numpy()
                     for k, v in _flat(state["params"]).items()})


def _leaves(tree):
    return [leaf for _, leaf in tckpt._leaf_paths(tree)]


def _refused(path, cfg, ctx):
    """True when restoring ``path`` under ``ctx`` raises, as the JAX
    package does, for a block key that its manifest does not list."""
    init, _ = tspmd.make_train_fns(cfg, ctx)
    try:
        tckpt.restore_checkpoint(path, init(2), ctx=ctx,
                                 specs=tspmd.state_shardings(cfg, ctx))
    except FileNotFoundError as e:
        return "has no shard" in str(e)
    return False


def _run_ckpt_job(job):
    cfg = tl.LlamaConfig.tiny(**job["model"])
    ctx = ParallelContext.create(MeshConfig(**job["mesh"]), device="cpu")
    specs = tspmd.state_shardings(cfg, ctx)
    init, step = tspmd.make_train_fns(cfg, ctx)
    state, _ = step(init(job["params"]), torch.from_numpy(job["tokens"]))
    path = tckpt.save_checkpoint(job["dir"], state, 1, ctx=ctx,
                                 specs=specs).path
    restored = tckpt.restore_checkpoint(path, init(1), ctx=ctx, specs=specs)
    restored_equal = all(
        torch.equal(a, b) and a.requires_grad == b.requires_grad
        for a, b in zip(_leaves(restored), _leaves(state)))
    refused = []
    if job.get("cross"):
        other_mesh, other_dir = job["cross"]
        other = ParallelContext.create(MeshConfig(**other_mesh), device="cpu")
        refused = [_refused(os.path.join(other_dir, "step-1"), cfg, ctx),
                   _refused(path, cfg, other)]
    return dict(
        coord={a: ctx.rank(a) for a in ("pp", "dp", "fsdp", "ep", "sp",
                                         "tp")},
        path=path, restored_equal=restored_equal, refused=refused,
        blocks={name: leaf.detach().numpy()
                for name, leaf in tckpt._leaf_paths(state)})


def run(rank, world, store_file, jobs, results):
    """Entry of one spawned rank: every job in order, results (or the
    traceback of the first failure) into the ``results`` queue."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store_file}",
                                rank=rank, world_size=world)
        for job in jobs:
            fn = _run_ckpt_job if job.get("kind") == "ckpt" else _run_job
            results.put((rank, job["name"], fn(job)))
        dist.destroy_process_group()
    except Exception:  # report to the parent, which fails the test
        results.put((rank, "error", traceback.format_exc()))
