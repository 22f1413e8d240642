"""Parity of the PyTorch port's training step (ray_tpu_torch.train) with the
JAX package's ``make_train_fns`` and optax, on the CPU in f32, from shared
parameters and numpy-seeded tokens and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.parallel import MeshConfig, ParallelContext
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.train import spmd as tspmd

# Losses and grad norms: f32 on both sides through 3 steps; only summation
# order and the rounding of the two AdamW formulas differ.
RTOL_METRICS = 1e-4
STEPS = 3


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _tokens(cfg, seed=1, bs=2, seq=24):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (bs, seq)).astype(np.int32)


def _jax_fns(jcfg):
    ctx = ParallelContext.create(MeshConfig(), devices=jax.devices()[:1])
    return jspmd.make_train_fns(jcfg, ctx)


def _assert_params_close(tparams, jparams, atol):
    jf, tf = _flat(_numpy_tree(jparams)), _flat(tparams)
    assert jf.keys() == tf.keys()
    for key in jf:
        np.testing.assert_allclose(tf[key].detach().numpy(), jf[key],
                                   atol=atol, rtol=0, err_msg=key)


# ---------------------------------------------------------------------------
# the optimizer against optax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_scale,clipped", [(1e-3, False), (10.0, True)])
def test_default_optimizer_matches_optax(grad_scale, clipped):
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5, 2)}}

    def tree(scale):
        def leaf(shape):
            return (rng.standard_normal(shape) * scale).astype(np.float32)
        return {"a": leaf(shapes["a"]), "b": {"c": leaf(shapes["b"]["c"]),
                                              "d": leaf(shapes["b"]["d"])}}

    params = tree(1.0)
    grads = [tree(grad_scale) for _ in range(2)]
    jopt = jspmd.default_optimizer()
    jp, jstate = jax.tree.map(jnp.asarray, params), None
    jstate = jopt.init(jp)
    topt = tspmd.default_optimizer()
    tp = tl.params_from_jax(params, device="cpu")
    tstate = topt.init(tp)
    for g in grads:
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                      jp)
        jp = optax.apply_updates(jp, updates)
        norm = topt.update(tl.params_from_jax(g, device="cpu"), tstate, tp)
        want_norm = float(optax.global_norm(g))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        assert (want_norm >= 1.0) == clipped
    # f32 AdamW in two formula orders: a few ulps of |p| ~ 1 per step
    _assert_params_close(tp, jp, atol=1e-6)
    adam = jstate[1][0]
    assert int(tstate["count"]) == int(adam.count) == 2
    _assert_params_close(tstate["mu"], adam.mu, atol=1e-7)
    _assert_params_close(tstate["nu"], adam.nu, atol=1e-7)


# ---------------------------------------------------------------------------
# make_train_fns against the JAX step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(n_kv_heads=4),
                                dict(remat_policy="dots_nobatch")],
                         ids=["tiny", "mha", "dots_nobatch"])
def test_train_steps_match_jax(kw):
    jcfg, tcfg = jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)
    jinit, jstep = _jax_fns(jcfg)
    jstate = jinit(jax.random.PRNGKey(0))
    tinit, tstep = tspmd.make_train_fns(tcfg, device="cpu")
    tstate = tinit(_numpy_tree(jstate["params"]))
    toks = _tokens(tcfg)
    jl_, tl_ = [], []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, toks)
        for key in ("loss", "grad_norm", "tokens"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=RTOL_METRICS, err_msg=key)
        jl_.append(float(jm["loss"]))
        tl_.append(float(tm["loss"]))
    assert tl_[-1] < tl_[0], tl_
    assert int(tstate["step"]) == int(jstate["step"]) == STEPS
    # Adam moves each element by about lr per step whatever the gradient's
    # size, so an element whose gradient is near 0 and changes sign between
    # the two sides can part by up to 2 * lr * steps.
    _assert_params_close(tstate["params"], jstate["params"],
                         atol=2 * 3e-4 * STEPS)


def test_state_from_jax_continues_a_jax_run():
    jcfg, tcfg = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    jinit, jstep = _jax_fns(jcfg)
    jstate = jinit(jax.random.PRNGKey(1))
    toks = _tokens(tcfg, seed=2)
    jstate, _ = jstep(jstate, jnp.asarray(toks))
    tstate = tspmd.state_from_jax(_numpy_tree(jstate), tcfg,
                                   device="cpu")
    assert int(tstate["step"]) == 1 and int(tstate["opt_state"]["count"]) == 1
    _assert_params_close(tstate["opt_state"]["nu"], jstate["opt_state"][1][0].nu,
                         atol=0)
    _, tstep = tspmd.make_train_fns(tcfg, device="cpu")
    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, toks)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RTOL_METRICS)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL_METRICS)
    assert int(tstate["step"]) == 3


def test_init_fn_takes_a_seed_or_a_params_tree():
    cfg = tl.LlamaConfig.tiny()
    init, _ = tspmd.make_train_fns(cfg, device="cpu")
    a, b = init(5), init(5)
    assert torch.equal(a["params"]["layers"]["wq"], b["params"]["layers"]["wq"])
    tree = tl.init_params(cfg, 5, device="cpu")
    c = init(tree)
    assert torch.equal(c["params"]["embed"], tree["embed"])
    assert c["params"]["embed"] is not tree["embed"]  # the state owns a copy
    assert all(t.requires_grad for t in _flat(c["params"]).values())
    assert int(c["opt_state"]["count"]) == 0 and int(c["step"]) == 0


def test_step_keeps_metrics_on_the_device_as_tensors():
    cfg = tl.LlamaConfig.tiny()
    init, step = tspmd.make_train_fns(cfg, device="cpu")
    state, metrics = step(init(0), torch.from_numpy(_tokens(cfg)))
    assert set(metrics) == {"loss", "tokens", "grad_norm"}
    assert all(isinstance(v, torch.Tensor) and v.ndim == 0
               for v in metrics.values())
    assert float(metrics["tokens"]) == 2 * 23


def test_make_train_fns_needs_a_card_or_a_cpu_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspmd.make_train_fns(tl.LlamaConfig.tiny())
    with pytest.raises(TypeError, match="ParallelContext"):
        tspmd.make_train_fns(tl.LlamaConfig.tiny(), ctx=object(),
                             device="cpu")
