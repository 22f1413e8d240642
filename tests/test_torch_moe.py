"""Parity of the PyTorch port's MoE layer (ray_tpu_torch.ops.moe) and MoE
Llama with the JAX package's, on the CPU in f32, from numpy-seeded inputs
and shared weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops import moe as jmoe
from ray_tpu.parallel import MeshConfig, ParallelContext
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.train import spmd as tspmd

# f32 on both sides; only summation order differs (test_torch_llama.py)
RTOL_LOSS, ATOL_GRAD = 1e-5, 2e-5
RTOL_METRICS = 1e-4          # 3 train steps (test_torch_train.py)


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


def _moe_inputs(tokens, d, f, e, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * scale
            for s, scale in (((tokens, d), 1.0), ((d, e), 0.5),
                             ((e, d, f), 0.1), ((e, d, f), 0.1),
                             ((e, f, d), 0.1))]


def test_top_k_routing_matches_jax():
    logits = np.random.default_rng(0).standard_normal((32, 8)).astype(
        np.float32)
    jw, ji = jmoe.top_k_routing(jnp.asarray(logits), 2)
    tw, ti = tmoe.top_k_routing(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)


@pytest.mark.parametrize("top_k,capacity_factor", [(2, 0.5), (2, 1.25),
                                                   (1, 0.5)])
def test_moe_ffn_output_aux_and_grads_match_jax(top_k, capacity_factor):
    arrs = _moe_inputs(48, 16, 32, 4, seed=top_k)

    def jfn(*a):
        out, aux = jmoe.moe_ffn(*a, top_k=top_k,
                                capacity_factor=capacity_factor)
        return jnp.sum(out * out) + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jfn, argnums=tuple(range(5)), has_aux=True))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out, aux = tmoe.moe_ffn(*ts, top_k=top_k,
                            capacity_factor=capacity_factor)
    grads = torch.autograd.grad((out * out).sum() + aux, ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    for name, g, jg in zip(("x", "router", "w_up", "w_gate", "w_down"),
                           grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=ATOL_GRAD,
                                   rtol=0, err_msg=name)
    # the port routes these tokens as JAX does, and capacity 0.5 drops
    # assignments (an expert past its capacity) where 1.25 keeps them all
    jidx = np.asarray(jax.lax.top_k(
        jnp.asarray(arrs[0]) @ jnp.asarray(arrs[1]), top_k)[1])
    tidx = tmoe.top_k_routing(torch.from_numpy(arrs[0])
                              @ torch.from_numpy(arrs[1]), top_k)[1]
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    capacity = int(np.ceil(48 * top_k * capacity_factor / 4))
    dropped = np.maximum(np.bincount(jidx.ravel(), minlength=4) - capacity,
                         0).sum()
    assert (dropped > 0) == (capacity_factor < 1)


# ---------------------------------------------------------------------------
# the MoE Llama
# ---------------------------------------------------------------------------

def _pair(**kw):
    kw = dict(n_experts=4, **kw)
    return jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)


@pytest.mark.parametrize("kw", [dict(), dict(top_k_experts=1, n_layers=3)],
                         ids=["top2", "top1_l3"])
def test_moe_llama_loss_and_every_grad_leaf_match_jax(kw):
    jcfg, tcfg = _pair(**kw)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tl.params_from_jax(_numpy_tree(jp), device="cpu")
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jlogits, jaux = jax.jit(lambda p, t: jl.forward_with_aux(p, t, jcfg))(
        jp, jnp.asarray(tokens))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, t: jl.loss_fn(p, t, jcfg), has_aux=True))(
        jp, jnp.asarray(tokens))
    logits, aux = tl.forward_with_aux(tp, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL_LOSS)
    leaves = list(_flat(tp).values())
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = tl.loss_fn(tp, torch.from_numpy(tokens), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=RTOL_LOSS)
    jf = _flat(_numpy_tree(jgrads))
    for key, g in zip(_flat(tp), grads):
        np.testing.assert_allclose(g.numpy(), jf[key], atol=ATOL_GRAD,
                                   rtol=0, err_msg=key)


def test_moe_train_steps_match_jax():
    jcfg, tcfg = _pair()
    jctx = ParallelContext.create(MeshConfig(), devices=jax.devices()[:1])
    jinit, jstep = jspmd.make_train_fns(jcfg, jctx)
    jstate = jinit(jax.random.PRNGKey(0))
    tinit, tstep = tspmd.make_train_fns(tcfg, device="cpu")
    tstate = tinit(_numpy_tree(jstate["params"]))
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, toks)
        for key in ("loss", "grad_norm", "tokens"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=RTOL_METRICS, err_msg=key)
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0], losses
