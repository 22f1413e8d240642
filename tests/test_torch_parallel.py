"""Parity of the PyTorch port's parallel layer (ray_tpu_torch.parallel and
the ``ctx`` paths of the model and the train step) with the JAX package's.

The pure parts (MeshConfig, the rules, the device layout) are compared
directly. Then 4 gloo processes on the CPU run every mesh configuration
below, each from the same global parameters and batch, and their loss,
every gradient leaf (reassembled from the ranks' blocks) and one
``make_train_fns`` step are held against the JAX package under the same
``MeshConfig`` on 4 of conftest's virtual CPU devices. Under two of
those meshes (fsdp 4, fsdp 2 x tp 2) the ranks also save and restore a
sharded checkpoint, held against what the JAX package writes and reads
under the same ``MeshConfig``."""

import concurrent.futures
import filecmp
import multiprocessing
import os
import queue
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import ParallelContext as JContext
from ray_tpu.parallel import build_mesh as jbuild_mesh
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import spec_for as jspec_for
from ray_tpu.parallel.sharding import DEFAULT_RULES as JAX_RULES
from ray_tpu.train import checkpointing as jckpt
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel import (AXIS_NAMES, DEFAULT_RULES, MeshConfig,
                                    shard_batch, spec_for, tree_specs)
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel.sharding import shard_index
from ray_tpu_torch.train import checkpointing as tckpt
from ray_tpu_torch.train import spmd as tspmd

import torch_parallel_worker

WORLD = 4
# f32 on both sides; only summation order differs (test_torch_llama.py)
RTOL_LOSS, ATOL_GRAD = 1e-5, 2e-5
RTOL_METRICS = 1e-4          # a train step (test_torch_train.py)
# Adam moves each element by about lr per step whatever the gradient's
# size, so an element whose gradient is near 0 and changes sign between the
# two sides can part by up to 2 * lr (test_torch_train.py).
ATOL_STEP_PARAMS = 2 * 3e-4
WORKER_TIMEOUT_S = 150

# name: (MeshConfig kwargs, LlamaConfig.tiny kwargs, batch, seq)
CONFIGS = {
    # __graft_entry__.py's dry run at 4 devices: A, B and C
    "A_tp2_sp2": (dict(tp=2, sp=2),
                  dict(vocab_size=512, n_layers=4, d_ff=256, max_seq=64),
                  2, 64),
    "B_pp2_ep2_moe": (dict(pp=2, ep=2),
                      dict(vocab_size=512, n_layers=4, n_experts=4,
                           max_seq=64), 4, 64),
    "C_dp4_dcn2": (dict(dp=4, dcn_dp=2),
                   dict(n_heads=2, n_kv_heads=1, max_seq=32), 8, 32),
    "dp2_fsdp2": (dict(dp=2, fsdp=2), dict(max_seq=32), 4, 32),
    "fsdp2_tp2": (dict(fsdp=2, tp=2), dict(max_seq=32), 4, 32),
    "pp2_fsdp2": (dict(pp=2, fsdp=2), dict(n_layers=4, max_seq=32), 4, 32),
    "ep2_dp2_moe": (dict(ep=2, dp=2), dict(n_experts=4, max_seq=32), 4, 32),
    "sp2_ep2_moe": (dict(sp=2, ep=2), dict(n_experts=4, max_seq=32), 2, 32),
}
# Checkpoint jobs of the same fixture: one step, then save_checkpoint and
# restore_checkpoint under the mesh (the second also restores each
# checkpoint under the other mesh, which must be refused).
CKPT_CONFIGS = {
    "ckpt_fsdp4": (dict(fsdp=4), dict(max_seq=32), 4, 32),
    "ckpt_fsdp2_tp2": (dict(fsdp=2, tp=2), dict(max_seq=32), 4, 32),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


class _Coords:
    """The size/rank interface of a ParallelContext at given coordinates."""

    rules = DEFAULT_RULES

    def __init__(self, mesh_kw, coord):
        self.sizes = dict(zip(AXIS_NAMES, MeshConfig(**mesh_kw).shape))
        self.coord = coord
        self.pp = self.sizes["pp"]

    def size(self, axis):
        return self.sizes[axis]

    def rank(self, axis):
        return self.coord[axis]


def _assemble(blocks, spec, shape, mesh_kw):
    """The global array from every rank's (coordinates, block); replicas
    of a block must agree."""
    out = np.full(shape, np.nan, np.float32)
    for coord, block in blocks:
        ctx = _Coords(mesh_kw, coord)
        idx = []
        for dim, entry in enumerate(spec):
            i, n = shard_index(entry, ctx)
            size = shape[dim] // n
            assert block.shape[dim] == size, (spec, block.shape, shape)
            idx.append(slice(i * size, (i + 1) * size))
        seen = out[tuple(idx)]
        if not np.isnan(seen).all():
            np.testing.assert_allclose(block, seen, atol=1e-6, rtol=0)
        out[tuple(idx)] = block
    assert not np.isnan(out).any()
    return out


# ---------------------------------------------------------------------------
# pure parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(dp=2, tp=4),
                                dict(pp=2, dp=4, tp=2, dcn_pp=2, dcn_dp=2),
                                dict(fsdp=6, dcn_fsdp=3)])
def test_mesh_config_matches_jax(kw):
    j, t = JMeshConfig(**kw), MeshConfig(**kw)
    for prop in ("shape", "num_devices", "num_slices", "dcn_shape",
                 "ici_shape"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.with_axes(sp=2).shape == j.with_axes(sp=2).shape
    assert MeshConfig.for_devices(8) == MeshConfig(fsdp=8)
    assert tmesh.AXIS_NAMES == jmesh.AXIS_NAMES == AXIS_NAMES
    assert (tmesh.BATCH_AXES, tmesh.PARAM_AXES) == (jmesh.BATCH_AXES,
                                                     jmesh.PARAM_AXES)


def test_mesh_config_errors_match_jax():
    for cls in (JMeshConfig, MeshConfig):
        with pytest.raises(ValueError, match="divisible"):
            cls(dp=3, dcn_dp=2).ici_shape


@pytest.mark.parametrize("n_experts", [0, 4])
def test_specs_of_every_parameter_match_jax(n_experts):
    jcfg = jl.LlamaConfig.tiny(n_experts=n_experts)
    axes = jl.logical_axes(jcfg)
    flat_specs = _flat_axes(tree_specs(axes))
    for key, logical in _flat_axes(axes).items():
        assert flat_specs[key] == tuple(jspec_for(logical)), key
        assert spec_for(logical) == tuple(jspec_for(logical)), key
    assert spec_for(("embed", "heads")) == ("fsdp", "tp")
    assert spec_for((None, "expert")) == (None, "ep")
    assert DEFAULT_RULES == dict(JAX_RULES)


def _flat_axes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_axes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


class _FakeDev:
    def __init__(self, i, slice_index):
        self.id = i
        self.slice_index = slice_index


LAYOUTS = {
    # test_mesh.py's cases of the hybrid layout
    "one_node_two_virtual": ([(i, 0) for i in range(8)],
                             dict(dp=4, tp=2, dcn_dp=2)),
    "round_robin": ([(i, i // 8) for i in range(16)],
                    dict(dp=4, tp=2, dcn_dp=2)),
    "pp_outermost": ([(i, i // 8) for i in range(16)],
                     dict(pp=2, dp=2, dcn_pp=2, dcn_dp=2)),
    "one_node_preferred": ([(i, 0) for i in range(4)]
                           + [(i, 1) for i in range(4, 12)], dict(dp=8)),
    "no_node": ([(i, None) for i in range(8)], dict(dp=4, tp=2, dcn_dp=2)),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_device_layout_matches_jax_build_mesh(name):
    devs, kw = LAYOUTS[name]
    fakes = [_FakeDev(i, s) for i, s in devs]
    if all(s is None for _, s in devs):
        fakes = [tmesh.RankDevice(i) for i, _ in devs]
    want = np.vectorize(lambda d: d.id)(
        jbuild_mesh(JMeshConfig(**kw), devices=fakes).devices)
    got = np.vectorize(lambda d: d.id)(
        tmesh.device_layout(MeshConfig(**kw), fakes))
    np.testing.assert_array_equal(got, want)


def test_device_layout_refusals_match_jax():
    with pytest.raises(ValueError, match="straddl"):
        tmesh._slice_groups([_FakeDev(i, i // 2) for i in range(6)], 2)
    with pytest.raises(ValueError, match="mixed"):
        tmesh._slice_groups([_FakeDev(0, 0), _FakeDev(1, 0), object(),
                             object()], 2)
    with pytest.raises(ValueError, match="divisible"):
        tmesh.device_layout(MeshConfig(dp=2, dcn_dp=4),
                            [_FakeDev(i, 0) for i in range(8)])
    with pytest.raises(ValueError, match="needs 16"):
        tmesh.device_layout(MeshConfig(dp=16),
                            [_FakeDev(i, 0) for i in range(8)])


def test_shard_batch_takes_this_ranks_rows_and_sequence_block():
    batch = torch.arange(8 * 6).reshape(8, 6)
    mesh = dict(dp=2, fsdp=2, sp=2)
    got = shard_batch(batch, _Coords(mesh, dict(pp=0, dp=1, fsdp=0, ep=0,
                                                sp=1, tp=0)))
    assert torch.equal(got, batch[4:6, 3:])
    # two microbatches: this rank's part of each global one
    got = shard_batch(batch, _Coords(mesh, dict(pp=0, dp=0, fsdp=1, ep=0,
                                                sp=0, tp=0)), 2)
    assert torch.equal(got, batch[[1, 5], :3])
    with pytest.raises(ValueError, match="microbatches"):
        shard_batch(batch[:6], _Coords(mesh, dict(pp=0, dp=0, fsdp=0, ep=0,
                                                  sp=0, tp=0)), 2)


# ---------------------------------------------------------------------------
# 4 gloo processes against the JAX package
# ---------------------------------------------------------------------------

def _jax_reference(name, devices):
    mesh_kw, model_kw, batch, seq = CONFIGS[name]
    cfg = jl.LlamaConfig.tiny(**model_kw)
    ctx = JContext.create(JMeshConfig(**mesh_kw), devices=devices)
    tokens = _tokens(name)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, t: jl.loss_fn(p, t, cfg, ctx), has_aux=True))(
        params, jnp.asarray(tokens))
    init, step = jspmd.make_train_fns(cfg, ctx)
    state = init(jax.random.PRNGKey(0))
    shard_shapes = {k: v.sharding.shard_shape(v.shape)
                    for k, v in _flat(state["params"]).items()}
    state, m = step(state, jnp.asarray(tokens))
    return dict(loss=float(loss), tokens=float(metrics["tokens"]),
                grads=_flat(jax.tree.map(np.asarray, grads)),
                step_loss=float(m["loss"]),
                step_grad_norm=float(m["grad_norm"]),
                step_params=_flat(jax.tree.map(np.asarray, state["params"])),
                shard_shapes=shard_shapes)


def _tokens(name):
    _, model_kw, batch, seq = {**CONFIGS, **CKPT_CONFIGS}[name]
    vocab = jl.LlamaConfig.tiny(**model_kw).vocab_size
    return np.random.default_rng(len(name)).integers(
        0, vocab, (batch, seq)).astype(np.int32)


@pytest.fixture(scope="module")
def runs(devices8):
    ckpt_dir = tempfile.mkdtemp()
    try:
        yield _run_all(list(CONFIGS), devices8[:WORLD], ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _run_all(names, devices, ckpt_dir):
    """{config: (the 4 ranks' results, the JAX reference)}, and
    {checkpoint job: (the 4 ranks' results, None)}. The ranks run while
    the parent computes the JAX side."""
    jobs = []
    for name in names + list(CKPT_CONFIGS):
        mesh_kw, model_kw, _, _ = {**CONFIGS, **CKPT_CONFIGS}[name]
        params = jl.init_params(jl.LlamaConfig.tiny(**model_kw),
                                jax.random.PRNGKey(0))
        jobs.append(dict(name=name, mesh=mesh_kw, model=model_kw,
                         tokens=_tokens(name),
                         params=jax.tree.map(np.asarray, params)))
        if name in CKPT_CONFIGS:
            jobs[-1].update(kind="ckpt", dir=os.path.join(ckpt_dir, name))
    first, second = (j for j in jobs if j.get("kind") == "ckpt")
    second["cross"] = (first["mesh"], first["dir"])
    mp = multiprocessing.get_context("spawn")
    results = mp.Queue()
    store = os.path.join(tempfile.mkdtemp(), "gloo_store")
    procs = [mp.Process(target=torch_parallel_worker.run,
                        args=(r, WORLD, store, jobs, results), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # the JAX side compiles 3 programs per config; compiles overlap in
        # threads
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            ref = dict(zip(names, pool.map(
                lambda name: _jax_reference(name, devices), names)))
        got = {job["name"]: [] for job in jobs}
        for _ in range(WORLD * len(jobs)):
            try:
                rank, name, payload = results.get(timeout=WORKER_TIMEOUT_S)
            except queue.Empty:
                raise AssertionError("gloo ranks timed out")
            assert name != "error", f"rank {rank} failed:\n{payload}"
            got[name].append(payload)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        if os.path.exists(store):
            os.remove(store)
        os.rmdir(os.path.dirname(store))
    assert not any(p.is_alive() for p in procs)
    return {job["name"]: (got[job["name"]], ref.get(job["name"]))
            for job in jobs}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_every_grad_leaf_match_jax_on_4_ranks(runs, name):
    ranks, ref = runs[name]
    mesh_kw, model_kw, _, _ = CONFIGS[name]
    tcfg = tl.LlamaConfig.tiny(**model_kw)
    specs = _flat_axes(tl.param_specs(tcfg, _Coords(mesh_kw, {})))
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=RTOL_LOSS)
        assert r["tokens"] == ref["tokens"]
    for key, want in ref["grads"].items():
        got = _assemble([(r["coord"], r["grads"][key]) for r in ranks],
                        specs[key], want.shape, mesh_kw)
        np.testing.assert_allclose(got, want, atol=ATOL_GRAD, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_step_matches_jax_on_4_ranks(runs, name):
    ranks, ref = runs[name]
    mesh_kw, model_kw, _, _ = CONFIGS[name]
    tcfg = tl.LlamaConfig.tiny(**model_kw)
    specs = _flat_axes(tl.param_specs(tcfg, _Coords(mesh_kw, {})))
    for r in ranks:
        np.testing.assert_allclose(r["step_loss"], ref["step_loss"],
                                   rtol=RTOL_METRICS)
        np.testing.assert_allclose(r["step_grad_norm"],
                                   ref["step_grad_norm"], rtol=RTOL_METRICS)
    for key, want in ref["step_params"].items():
        blocks = [(r["coord"], r["step_params"][key]) for r in ranks]
        got = _assemble(blocks, specs[key], want.shape, mesh_kw)
        np.testing.assert_allclose(got, want, atol=ATOL_STEP_PARAMS, rtol=0,
                                   err_msg=key)
        # each rank's block has the shape the JAX state's shard has; under
        # pp the port also splits the layer stack by stage
        local = blocks[0][1].shape
        jshape = ref["shard_shapes"][key]
        if key.startswith("layers.") and mesh_kw.get("pp", 1) > 1:
            jshape = (jshape[0] // mesh_kw["pp"],) + tuple(jshape[1:])
        assert local == tuple(jshape), (key, local, jshape)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_from_jax_keeps_the_blocks_init_fn_keeps_on_4_ranks(runs,
                                                                   name):
    ranks, _ = runs[name]
    assert all(r["from_jax_blocks_equal"] for r in ranks)


def test_fsdp2_tp2_local_shapes_follow_the_rules(runs):
    """wq is [L, D/fsdp, H*hd/tp], as tests/test_model_parallel.py checks
    in JAX; the embedding [V/tp, D/fsdp] and lm_head [D/fsdp, V/tp]."""
    ranks, _ = runs["fsdp2_tp2"]
    cfg = tl.LlamaConfig.tiny(max_seq=32)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    hd = cfg.head_dim
    for r in ranks:
        shapes = {k: v.shape for k, v in r["step_params"].items()}
        assert shapes["layers.wq"] == (L, D // 2, cfg.n_heads * hd // 2)
        assert shapes["layers.wk"] == (L, D // 2, cfg.n_kv_heads * hd // 2)
        assert shapes["layers.w_down"] == (L, cfg.d_ff // 2, D // 2)
        assert shapes["embed"] == (V // 2, D // 2)
        assert shapes["lm_head"] == (D // 2, V // 2)
        assert shapes["final_norm"] == (D // 2,)


# ---------------------------------------------------------------------------
# sharded checkpoints on 4 ranks against the JAX package
# ---------------------------------------------------------------------------

def _nest(flat):
    out = {}
    for key, value in flat.items():
        node = out
        *head, last = key.split(".")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = value
    return out


def _jax_checkpoint(name, port_path, devices, directory):
    """The JAX package's checkpoint of the port's saved state under the
    same MeshConfig: each global leaf (assembled by the port's
    load_checkpoint_host) put on the sharding of the JAX train state."""
    mesh_kw, model_kw, _, _ = CKPT_CONFIGS[name]
    ctx = JContext.create(JMeshConfig(**mesh_kw), devices=devices)
    init, _ = jspmd.make_train_fns(jl.LlamaConfig.tiny(**model_kw), ctx)
    target = init(jax.random.PRNGKey(1))
    host = tckpt.load_checkpoint_host(port_path)
    leaves = [jax.device_put(host[tckpt._port_name(n)].numpy(), leaf.sharding)
              for n, leaf in jckpt._leaf_paths(target)]
    state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(target), leaves)
    return jckpt.save_checkpoint(directory, state, step=1), target


@pytest.mark.parametrize("name", list(CKPT_CONFIGS))
def test_checkpoint_matches_jax_on_4_ranks(runs, devices8, name, tmp_path):
    """The ranks' union of files is, byte for byte, what the JAX package
    writes under the same MeshConfig on 4 virtual devices; each rank
    restores its own blocks, from its own checkpoint and from JAX's; JAX
    restores the port's checkpoint to the same bits."""
    ranks, _ = runs[name]
    mesh_kw, model_kw, _, _ = CKPT_CONFIGS[name]
    port_path = ranks[0]["path"]
    assert all(r["path"] == port_path and r["restored_equal"] for r in ranks)
    jax_ckpt, target = _jax_checkpoint(name, port_path, devices8[:WORLD],
                                       str(tmp_path))
    names = sorted(os.listdir(port_path))
    assert names == sorted(os.listdir(jax_ckpt.path))
    _, mismatch, errors = filecmp.cmpfiles(port_path, jax_ckpt.path, names,
                                           shallow=False)
    assert not mismatch and not errors
    # every rank's blocks from the JAX-written checkpoint
    cfg = tl.LlamaConfig.tiny(**model_kw)
    for r in ranks:
        coords = _Coords(mesh_kw, r["coord"])
        like = _nest({tckpt._port_name(n): torch.zeros(b.shape,
                                                       dtype=torch.float32
                                                       if b.dtype == np.float32
                                                       else torch.int32)
                      for n, b in r["blocks"].items()})
        got = tckpt.restore_checkpoint(jax_ckpt.path, like, ctx=coords,
                                       specs=tspmd.state_shardings(cfg,
                                                                   coords))
        for n, leaf in tckpt._leaf_paths(got):
            np.testing.assert_array_equal(leaf.numpy(), r["blocks"][n],
                                          err_msg=n)
    # and the JAX package restores the port's checkpoint
    restored = jckpt.restore_checkpoint(port_path, target)
    host = jckpt.load_checkpoint_host(jax_ckpt.path)
    for n, leaf in jckpt._leaf_paths(restored):
        np.testing.assert_array_equal(np.asarray(leaf), host[n], err_msg=n)
        assert leaf.sharding == dict(jckpt._leaf_paths(target))[n].sharding


def test_checkpoint_under_the_other_mesh_is_refused_on_4_ranks(runs):
    """fsdp 4's checkpoint under fsdp 2 x tp 2 and the reverse: the block
    keys are not in the manifest, and restore raises as the JAX package's
    does."""
    ranks, _ = runs["ckpt_fsdp2_tp2"]
    assert all(r["refused"] == [True, True] for r in ranks)
