"""Parity of the PyTorch port's checkpointing (ray_tpu_torch.train
.checkpointing) with the JAX package's, on the CPU at ``LlamaConfig.tiny``:
checkpoints cross between the two packages bit for bit in both directions,
the same state writes the same files in both, a JAX-written bf16 leaf reads
back by its bits, and the port's counterparts of
``tests/test_checkpointing.py``'s unit tests. Under a 4-rank mesh see
``tests/test_torch_parallel.py``."""

import filecmp
import json
import os
import threading
import time
import types

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu.models import llama as jl
from ray_tpu.parallel import MeshConfig, ParallelContext
from ray_tpu.serve import llm as jllm
from ray_tpu.train import checkpointing as jckpt
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.train import checkpointing as tckpt
from ray_tpu_torch.train import spmd as tspmd
from ray_tpu_torch.models import llama as tl


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _bits(x):
    """A tensor's or array's raw words, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _assert_same_bits(got, want, what=""):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _jax_state_after_one_step():
    """A JAX train state of default_optimizer() on tiny(), one step in
    (non-zero AdamW moments, count 1, step 1), as jax Arrays."""
    cfg = jl.LlamaConfig.tiny()
    ctx = ParallelContext.create(MeshConfig(), devices=jax.devices()[:1])
    init, step = jspmd.make_train_fns(cfg, ctx)
    state = init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    state, _ = step(state, jnp.asarray(tokens))
    return cfg, init, state


@pytest.fixture(scope="module")
def jax_state():
    return _jax_state_after_one_step()


def _port_state(jstate):
    return tspmd.state_from_jax(jax.tree.map(np.asarray, jstate),
                                tl.LlamaConfig.tiny(), device="cpu")


def test_jax_checkpoint_restores_in_the_port_bitwise(jax_state, tmp_path):
    _, _, jstate = jax_state
    ckpt = jckpt.save_checkpoint(str(tmp_path), jstate, step=1,
                                 metrics={"loss": 1.5})
    want = _port_state(jstate)
    init, _ = tspmd.make_train_fns(tl.LlamaConfig.tiny(), device="cpu")
    got = tckpt.restore_checkpoint(ckpt.path, init(0))
    assert _flat(got).keys() == _flat(want).keys()
    for key, w in _flat(want).items():
        g = _flat(got)[key]
        _assert_same_bits(g, w, key)
        assert g.requires_grad == w.requires_grad, key
    # load_checkpoint_host: the same leaves, the AdamW state renamed back
    jhost = jckpt.load_checkpoint_host(ckpt.path)
    thost = tckpt.load_checkpoint_host(ckpt.path)
    renamed = {k.replace("opt_state[1][0].", "opt_state."): v
               for k, v in jhost.items()}
    assert thost.keys() == renamed.keys() == _flat(want).keys()
    for key, v in renamed.items():
        _assert_same_bits(thost[key], v, key)


def test_port_checkpoint_restores_in_jax_bitwise(jax_state, tmp_path):
    _, jinit, jstate = jax_state
    state = _port_state(jstate)
    ckpt = tckpt.save_checkpoint(str(tmp_path), state, step=1)
    restored = jckpt.restore_checkpoint(ckpt.path,
                                        jinit(jax.random.PRNGKey(1)))
    want = jax.tree_util.tree_leaves(jstate)
    got = jax.tree_util.tree_leaves(restored)
    assert len(got) == len(want) == 38
    for g, w in zip(got, want):
        _assert_same_bits(np.asarray(g), np.asarray(w))
    assert jax.tree_util.tree_structure(restored) == \
        jax.tree_util.tree_structure(jstate)
    jhost = jckpt.load_checkpoint_host(ckpt.path)
    for key, w in _flat(state).items():
        name = key.replace("opt_state.", "opt_state[1][0].")
        _assert_same_bits(jhost[name], w, key)


def test_same_state_writes_the_same_files_in_both_packages(jax_state,
                                                           tmp_path):
    _, _, jstate = jax_state
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    j = jckpt.save_checkpoint(str(jdir), jstate, step=1,
                              metrics={"loss": 2.0})
    t = tckpt.save_checkpoint(str(tdir), _port_state(jstate), step=1,
                              metrics={"loss": 2.0})
    names = sorted(os.listdir(j.path))
    assert names == sorted(os.listdir(t.path))
    assert len([n for n in names if n.endswith(".npy")]) == 38
    with open(os.path.join(j.path, "_METADATA.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(t.path, "_METADATA.json")) as f:
        tmeta = json.load(f)
    assert jmeta == tmeta
    assert jmeta["leaves"][0]["name"] == "opt_state[1][0].count"
    _, mismatch, errors = filecmp.cmpfiles(j.path, t.path, names,
                                           shallow=False)
    assert not mismatch and not errors


def test_jax_bf16_leaf_reads_back_by_its_bits(tmp_path):
    x = jnp.asarray(np.random.default_rng(2).standard_normal((6, 10)),
                    jnp.bfloat16)
    ckpt = jckpt.save_checkpoint(str(tmp_path / "jax"),
                                 {"w": x, "b": x[0]}, step=0)
    want = np.asarray(x).view(np.uint16)
    host = tckpt.load_checkpoint_host(ckpt.path)
    assert host["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(host["w"]), want)
    target = {"w": torch.zeros(6, 10, dtype=torch.bfloat16),
              "b": torch.zeros(10, dtype=torch.bfloat16)}
    got = tckpt.restore_checkpoint(ckpt.path, target)
    np.testing.assert_array_equal(_bits(got["w"]), want)
    np.testing.assert_array_equal(_bits(got["b"]), want[0])
    # and the port writes the bf16 files byte for byte as JAX does
    mine = tckpt.save_checkpoint(str(tmp_path / "port"), got, step=0)
    for name in os.listdir(ckpt.path):
        assert filecmp.cmp(os.path.join(ckpt.path, name),
                           os.path.join(mine.path, name), shallow=False)


# ---------------------------------------------------------------------------
# counterparts of tests/test_checkpointing.py's unit tests
# ---------------------------------------------------------------------------

def _state():
    return {"layer": {"w": torch.arange(64.0).reshape(8, 8),
                      "b": torch.arange(8.0).to(torch.bfloat16)},
            "scale": torch.tensor(3.5), "step": 7}


def _zeros(state):
    return {"layer": {k: torch.zeros_like(v)
                      for k, v in state["layer"].items()},
            "scale": torch.zeros(()), "step": 0}


def _round_trip(d):
    state = _state()
    ckpt = tckpt.save_checkpoint(d, state, step=7)
    assert ckpt.is_valid()
    restored = tckpt.restore_checkpoint(ckpt, _zeros(state))
    assert torch.equal(restored["layer"]["w"], state["layer"]["w"])
    assert torch.equal(restored["layer"]["b"], state["layer"]["b"])
    assert restored["layer"]["b"].dtype == torch.bfloat16
    assert float(restored["scale"]) == 3.5
    assert restored["step"] == 7


def _host_assembly(d):
    ckpt = tckpt.save_checkpoint(d, _state(), step=1)
    host = tckpt.load_checkpoint_host(ckpt)
    assert torch.equal(host["layer.w"], torch.arange(64.0).reshape(8, 8))
    assert torch.equal(host["layer.b"], torch.arange(8.0).to(torch.bfloat16))
    assert int(host["step"]) == 7


def _uncommitted_rejected(d):
    state = _state()
    ckpt = tckpt.save_checkpoint(d, state, step=2)
    os.unlink(os.path.join(ckpt.path, "COMMIT"))
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(ckpt, state)
    assert tckpt.CheckpointManager(d).latest() is None


def _trash_recovery_after_swap_crash(d):
    """A crash between the two commit-swap renames leaves the committed
    step only in _trash-step-N; save/restore/discover rename it back."""
    state = _state()
    ckpt = tckpt.save_checkpoint(d, state, step=3)
    trash = os.path.join(d, "_trash-step-3")
    os.rename(ckpt.path, trash)
    assert tckpt.restore_checkpoint(ckpt.path, state)["step"] == 7
    os.rename(ckpt.path, trash)
    mgr = tckpt.CheckpointManager(d)
    assert mgr.latest() is not None and mgr.latest().step == 3
    os.rename(os.path.join(d, "step-3"), trash)
    tckpt.save_checkpoint(d, state, step=3)
    assert not os.path.isdir(trash)


def _manager_topk_by_metric(d):
    state = {"x": torch.arange(4.0)}
    mgr = tckpt.CheckpointManager(d, max_to_keep=2, metric="loss",
                                  mode="min")
    paths = []
    for step, loss in [(1, 5.0), (2, 2.0), (3, 9.0), (4, 1.0)]:
        c = tckpt.save_checkpoint(d, state, step, metrics={"loss": loss})
        mgr.register(c)
        paths.append(c.path)
    assert {c.step for c in mgr.checkpoints()} == {2, 4}
    assert mgr.best().step == 4
    assert not os.path.exists(paths[0])
    mgr2 = tckpt.CheckpointManager(d, max_to_keep=2)
    assert {c.step for c in mgr2.checkpoints()} == {2, 4}
    assert mgr2.latest().step == 4


def _kill_mid_async_save_keeps_previous_commit(d):
    state = _state()
    assert tckpt.save_checkpoint(d, state, step=1).is_valid()
    snap = tckpt._snapshot(state, 2, None)  # then a crash mid-write
    tmp2 = os.path.join(d, "_tmp-step-2")
    os.makedirs(tmp2)
    fname, arr = snap["writes"][0]
    tckpt._save_npy(os.path.join(tmp2, fname), arr)
    mgr = tckpt.CheckpointManager(d)
    assert mgr.latest().step == 1
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(os.path.join(d, "step-2"), state)
    assert tckpt.restore_checkpoint(mgr.latest(), state)["step"] == 7


def _async_marker_barrier(d):
    """Rank 0 commits only after EVERY rank's marker file is there."""
    snap = tckpt._snapshot(_state(), 3, {"loss": 1.0})
    snap0 = {**snap, "proc": 0, "nprocs": 2}
    snap1 = {**snap, "proc": 1, "nprocs": 2, "writes": []}
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "ckpt", tckpt._write_snapshot(d, snap0, barrier_timeout=60)))
    t.start()
    time.sleep(0.5)
    assert not os.path.exists(os.path.join(d, "step-3", "COMMIT"))
    assert t.is_alive()
    tckpt._write_snapshot(d, snap1)
    t.join(timeout=60)
    assert out["ckpt"].is_valid() and out["ckpt"].metrics == {"loss": 1.0}


def _async_save_overlaps_training(d):
    """save() returns after the snapshot; the write and the commit happen
    in the background, and the snapshot is a copy: the state changed in
    place after save() does not reach the files."""
    gate = threading.Event()
    save_npy = tckpt._save_npy

    def slow(*a):
        gate.wait(timeout=60)
        save_npy(*a)

    state = _state()
    ckptr = tckpt.AsyncCheckpointer()
    tckpt._save_npy = slow
    try:
        fut = ckptr.save(d, state, step=1)
        assert not fut.done()
        assert not os.path.exists(os.path.join(d, "step-1", "COMMIT"))
        state["layer"]["w"].add_(1.0)  # the next train step, in place
        gate.set()
        ckpt = fut.result(timeout=60)
        assert ckpt.is_valid()
    finally:
        gate.set()
        tckpt._save_npy = save_npy
        ckptr.close()
    restored = tckpt.restore_checkpoint(ckpt, _zeros(state))
    assert torch.equal(restored["layer"]["w"],
                       torch.arange(64.0).reshape(8, 8))


def _mesh_short_of_the_world_refused(d):
    """The barriers run over the whole world, so a context whose mesh
    leaves out a rank of it is refused before anything is written."""
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        ctx = types.SimpleNamespace(
            mesh=types.SimpleNamespace(mesh=torch.tensor([[0, 1]])))
        with pytest.raises(ValueError, match="every rank of the world"):
            tckpt.save_checkpoint(d, _state(), step=1, ctx=ctx)
        assert not os.listdir(d)
    finally:
        if made:
            dist.destroy_process_group()


UNIT_CASES = {f.__name__.lstrip("_"): f for f in (
    _round_trip, _host_assembly, _uncommitted_rejected,
    _trash_recovery_after_swap_crash, _manager_topk_by_metric,
    _kill_mid_async_save_keeps_previous_commit, _async_marker_barrier,
    _async_save_overlaps_training, _mesh_short_of_the_world_refused)}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_checkpointing_unit_cases(case, tmp_path):
    UNIT_CASES[case](str(tmp_path))


# ---------------------------------------------------------------------------
# params_path
# ---------------------------------------------------------------------------

def test_llm_server_params_path_matches_jax_greedy(tmp_path):
    """A JAX-saved params checkpoint: the port's LLMServer gives the JAX
    LLMServer's greedy completion from it."""
    kw = dict(vocab_size=256, d_model=64, n_layers=2, max_seq=64,
              decode_chunk=2, max_ongoing_requests=2)
    jcfg = jllm._model_from_cfg(jllm.LLMConfig(num_tpus=0, **kw))[0]
    params = jl.init_params(jcfg, jax.random.PRNGKey(3))
    ckpt = jckpt.save_checkpoint(str(tmp_path), params, step=0)
    body = {"prompt": [5, 17, 3, 99, 42, 7], "max_tokens": 12}
    js = jllm.LLMServer(cloudpickle.dumps(jllm.LLMConfig(
        num_tpus=0, params_path=ckpt.path, **kw)))
    ts = tllm.LLMServer(tllm.LLMConfig(params_path=ckpt.path, device="cpu",
                                       **kw))
    _, tparams = tllm._model_from_cfg(tllm.LLMConfig(
        params_path=ckpt.path, device="cpu", **kw))
    for key, w in _flat(jax.tree.map(np.asarray, params)).items():
        _assert_same_bits(_flat(tparams)[key], w, key)
    try:
        want = js.complete(dict(body))["choices"][0]["text"]
        got = ts.complete(dict(body))["choices"][0]["text"]
        assert got == want and len(got.split()) == 12
    finally:
        js.engine.stop()
        ts.stop()
