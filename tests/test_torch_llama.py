"""Parity of the PyTorch port's Llama (ray_tpu_torch.models.llama) with the
JAX package's on shared weights, on the CPU in f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops.attention import attention_reference
from ray_tpu_torch.parallel import MeshConfig, ParallelContext

CONFIGS = {
    # tiny(): 4 heads over 2 kv heads
    "tiny": dict(),
    # plain multi-head attention
    "mha": dict(n_kv_heads=4),
    # groups of 4, as Llama-3-8B has
    "gqa4": dict(d_model=64, n_heads=8, n_kv_heads=2, n_layers=3),
}


def _pair(name):
    kw = CONFIGS[name]
    return jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)


def _jax_params(jcfg, seed=0):
    return jl.init_params(jcfg, jax.random.PRNGKey(seed))


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


@pytest.mark.parametrize("name", list(CONFIGS))
def test_params_from_jax_is_bit_exact(name):
    jcfg, _ = _pair(name)
    jp = _numpy_tree(_jax_params(jcfg))
    tp = tl.params_from_jax(jp, device="cpu")
    jf, tf = _flat(jp), _flat(tp)
    assert jf.keys() == tf.keys()
    for key in jf:
        assert tf[key].dtype == torch.float32
        np.testing.assert_array_equal(tf[key].numpy(), jf[key])


def test_params_from_jax_takes_bf16_leaves():
    x = np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3)
    t = tl.params_from_jax({"w": x}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_params_layout_matches_jax(name):
    jcfg, tcfg = _pair(name)
    jf = _flat(_numpy_tree(_jax_params(jcfg)))
    tf = _flat(tl.init_params(tcfg, 0, device="cpu"))
    assert jf.keys() == tf.keys()
    for key in jf:
        assert tuple(tf[key].shape) == jf[key].shape, key
        assert tf[key].dtype == torch.float32
    assert tl.logical_axes(tcfg) == jl.logical_axes(jcfg)


def test_init_params_is_seeded():
    cfg = tl.LlamaConfig.tiny()
    a = tl.init_params(cfg, 3, device="cpu")
    b = tl.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = tl.init_params(cfg, 4, device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])


@pytest.mark.parametrize("preset", ["llama2_7b", "llama3_8b", "tiny"])
def test_param_count_and_presets_match_jax(preset):
    jcfg = getattr(jl.LlamaConfig, preset)()
    tcfg = getattr(tl.LlamaConfig, preset)()
    assert tl.param_count(tcfg) == jl.param_count(jcfg)
    for f in dataclasses.fields(tcfg):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.head_dim == jcfg.head_dim
    if preset == "llama3_8b":
        assert tl.param_count(tcfg) == 8_030_261_248


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name):
    jcfg, tcfg = _pair(name)
    jp = _jax_params(jcfg)
    tp = tl.params_from_jax(_numpy_tree(jp), device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    want = jl.forward(jp, jnp.asarray(tokens), jcfg)
    got = tl.forward(tp, torch.from_numpy(tokens).long(), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    # f32 through a few layers; only summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    # the plain reference attention gives the same logits
    plain = tl.forward(tp, torch.from_numpy(tokens).long(), tcfg,
                       attn_fn=lambda q, k, v, causal: attention_reference(
                           q, k.repeat_interleave(q.shape[1] // k.shape[1], 1),
                           v.repeat_interleave(q.shape[1] // k.shape[1], 1),
                           causal=causal))
    np.testing.assert_allclose(plain.numpy(), got.numpy(), atol=1e-4, rtol=0)


def test_forward_with_aux_and_unported_paths(monkeypatch):
    cfg = tl.LlamaConfig.tiny()
    p = tl.init_params(cfg, 0, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    logits, aux = tl.forward_with_aux(p, tokens, cfg)
    assert logits.shape == (1, 4, 256) and float(aux) == 0.0
    # a one-device context runs the same arithmetic, over a world-1 gloo
    # group it creates; a group whose backend does not serve the device is
    # refused
    ctx = ParallelContext.create(MeshConfig(), device="cpu")
    try:
        assert torch.equal(tl.forward(p, tokens, cfg, ctx=ctx), logits)
        monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
        with pytest.raises(RuntimeError, match="needs gloo"):
            ParallelContext.create(MeshConfig(), device="cpu")
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()
    # the MoE family has the JAX package's parameter layout
    jcfg, mcfg = jl.LlamaConfig.tiny(n_experts=4), tl.LlamaConfig.tiny(
        n_experts=4)
    jf = _flat(_numpy_tree(_jax_params(jcfg)))
    tf = _flat(tl.init_params(mcfg, 0, device="cpu"))
    assert {k: v.shape for k, v in jf.items()} == {
        k: tuple(v.shape) for k, v in tf.items()}
    assert tl.logical_axes(mcfg) == jl.logical_axes(jcfg)
    assert tl.param_count(mcfg) == jl.param_count(jcfg)


# ---------------------------------------------------------------------------
# loss, gradients, remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_every_grad_leaf_match_jax(name):
    jcfg, tcfg = _pair(name)
    jp = _jax_params(jcfg)
    tp = tl.params_from_jax(_numpy_tree(jp), device="cpu")
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    (jloss, jm), jgrads = jax.value_and_grad(jl.loss_fn, has_aux=True)(
        jp, jnp.asarray(tokens), jcfg)
    leaves = list(_flat(tp).values())
    for t in leaves:
        t.requires_grad_(True)
    loss, m = tl.loss_fn(tp, torch.from_numpy(tokens), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    # f32 through a few layers and a log-sum-exp; only summation order
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(m["tokens"]) == float(jm["tokens"]) == 2 * 23
    jf = _flat(_numpy_tree(jgrads))
    for key, g in zip(_flat(tp), grads):
        np.testing.assert_allclose(g.numpy(), jf[key], atol=2e-5, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("policy", ["full", "none", "dots", "dots_nobatch"])
def test_every_remat_policy_gives_the_same_loss_and_grads(policy):
    cfg = tl.LlamaConfig.tiny(n_layers=3)
    tp = tl.init_params(cfg, 0, device="cpu")
    leaves = list(_flat(tp).values())
    for t in leaves:
        t.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)))
    ref_loss, _ = tl.loss_fn(tp, tokens, dataclasses.replace(cfg, remat=False))
    ref = torch.autograd.grad(ref_loss, leaves)

    calls = []

    def attn(q, k, v, causal):  # counts forward runs of the attention
        calls.append(torch.is_grad_enabled())
        return tl.flash_attention(q, k, v, causal)

    pcfg = dataclasses.replace(cfg, remat_policy=policy)
    loss, _ = tl.loss_fn(tp, tokens, pcfg, attn_fn=attn)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == float(ref_loss.detach())
    for g, r in zip(grads, ref):
        assert torch.equal(g, r)
    # "none" saves everything; the others recompute the attention (it is no
    # weight matmul) once per layer in the backward
    assert len(calls) == cfg.n_layers * (1 if policy == "none" else 2)


def test_dots_nobatch_saves_the_weight_matmuls():
    """Under "full" the backward recomputes each layer's weight matmuls up
    to the last one it needs, w_up (w_down's output feeds only the residual
    add, whose gradient needs no saved value, and non-reentrant checkpoint
    stops there): 6 per layer. Under "dots_nobatch" it reads them back."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                CountMM.n += 1
            return func(*args, **(kwargs or {}))

    cfg = tl.LlamaConfig.tiny(n_layers=2)
    tp = tl.init_params(cfg, 0, device="cpu")
    leaves = list(_flat(tp).values())
    for t in leaves:
        t.requires_grad_(True)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    counts = {}
    for policy in ("full", "dots_nobatch"):
        CountMM.n = 0
        with CountMM():
            loss, _ = tl.loss_fn(tp, tokens, dataclasses.replace(
                cfg, remat_policy=policy))
            torch.autograd.grad(loss, leaves)
        counts[policy] = CountMM.n
    assert counts["full"] - counts["dots_nobatch"] == 6 * cfg.n_layers


def test_remat_and_pipeline_options_are_checked():
    p = tl.init_params(tl.LlamaConfig.tiny(), 0, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    p["embed"].requires_grad_(True)
    with pytest.raises(ValueError, match="remat_policy"):
        tl.loss_fn(p, tokens, tl.LlamaConfig.tiny(remat_policy="dots_all"))
    # without pipeline parallelism num_microbatches is ignored, as in JAX
    jcfg = jl.LlamaConfig.tiny(num_microbatches=2)
    jp = _jax_params(jcfg)
    toks = np.random.default_rng(4).integers(0, 256, (2, 12)).astype(np.int32)
    want = jl.forward(jp, jnp.asarray(toks), jcfg)
    got = tl.forward(tl.params_from_jax(_numpy_tree(jp), device="cpu"),
                     torch.from_numpy(toks),
                     tl.LlamaConfig.tiny(num_microbatches=2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("preset,seq", [("tiny", 128), ("llama3_8b", 8192),
                                        ("llama2_7b", 2048)])
def test_flops_per_token_matches_jax(preset, seq):
    jcfg = getattr(jl.LlamaConfig, preset)()
    tcfg = getattr(tl.LlamaConfig, preset)()
    assert tl.flops_per_token(tcfg, seq) == jl.flops_per_token(jcfg, seq)
