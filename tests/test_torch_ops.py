"""Parity of the PyTorch port's ops (ray_tpu_torch.ops) with the JAX
package's, on the CPU, with inputs made from a numpy seed.

The port's flash forward on a CPU tensor runs its plain version
(``flash_fwd_plain``, the CUDA kernel's arithmetic); here it is held
against the real Pallas TPU kernel run in interpret mode, and against the
JAX reference at the small bucket widths the TPU kernel never took.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ray_tpu.ops import attention as jatt
from ray_tpu.ops import norms as jnorms
from ray_tpu_torch.ops import attention as tatt
from ray_tpu_torch.ops import norms as tnorms

ATOL = 1e-5  # f32 on both sides; only summation order differs


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(b, h, s, d, kvh=None, seed=0):
    kvh = h if kvh is None else kvh
    return (_rand((b, h, s, d), seed), _rand((b, kvh, s, d), seed + 1),
            _rand((b, kvh, s, d), seed + 2))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def test_rms_norm_matches_jax():
    x, w = _rand((4, 8, 64), 0), _rand((64,), 1)
    _close(tnorms.rms_norm(*_t(x, w)), jnorms.rms_norm(*_j(x, w)))


def test_rms_norm_casts_back_to_input_dtype():
    x = torch.from_numpy(_rand((3, 16), 2)).to(torch.bfloat16)
    out = tnorms.rms_norm(x, torch.ones(16))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_frequencies_match_jax(theta):
    cos, sin = tnorms.rope_frequencies(64, 256, theta)
    jcos, jsin = jnorms.rope_frequencies(64, 256, theta)
    _close(cos, jcos)
    _close(sin, jsin)


@pytest.mark.parametrize("offset", [None, 8])
def test_apply_rope_matches_jax(offset):
    x = _rand((2, 3, 16, 32), 3)
    cos, sin = tnorms.rope_frequencies(32, 64)
    jcos, jsin = jnorms.rope_frequencies(32, 64)
    pos = None if offset is None else np.arange(offset, offset + 16)
    got = tnorms.apply_rope(torch.from_numpy(x), cos, sin,
                            None if pos is None else torch.from_numpy(pos))
    want = jnorms.apply_rope(jnp.asarray(x), jcos, jsin,
                             None if pos is None else jnp.asarray(pos))
    _close(got, want)


# ---------------------------------------------------------------------------
# attention: references
# ---------------------------------------------------------------------------

def test_repeat_kv_matches_jax():
    x = _rand((2, 2, 5, 8), 4)
    _close(tatt.repeat_kv(torch.from_numpy(x), 3), jatt.repeat_kv(
        jnp.asarray(x), 3), atol=0)
    assert tatt.repeat_kv(torch.from_numpy(x), 1).shape == (2, 2, 5, 8)


def test_default_mask_value_matches_jax():
    assert tatt.DEFAULT_MASK_VALUE == jatt.DEFAULT_MASK_VALUE


@pytest.mark.parametrize("causal,q_offset,kv_offset", [
    (True, 0, 0), (False, 0, 0), (True, 16, 0), (True, 16, 8)])
def test_attention_reference_matches_jax(causal, q_offset, kv_offset):
    q, k, v = _qkv(2, 3, 16, 32, seed=5)
    got = tatt.attention_reference(*_t(q, k, v), causal=causal,
                                   q_offset=q_offset, kv_offset=kv_offset)
    want = jatt.attention_reference(*_j(q, k, v), causal=causal,
                                    q_offset=q_offset, kv_offset=kv_offset)
    _close(got, want)


# ---------------------------------------------------------------------------
# flash forward: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_plain_matches_pallas_kernel_interpret(causal):
    """B1 H2 S256 D128 through the real TPU kernel body
    (`_flash_fwd_pallas`, 128x128 blocks) in Pallas interpret mode."""
    q, k, v = _qkv(1, 2, 256, 128, seed=6)
    scale = 128 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jatt._flash_fwd_pallas(
            *_j(q, k, v), causal=causal, sm_scale=scale, block_q=128,
            block_k=128)
    o, lse = tatt.flash_fwd(*_t(q, k, v), causal)
    assert o.dtype == torch.float32 and lse.shape == (1, 2, 256)
    _close(o, want_o)
    _close(lse, want_lse)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [32, 64])
def test_flash_fwd_plain_small_buckets_match_reference(seq, causal):
    """Bucket widths 32 and 64, which the TPU kernel's 128-multiple gate
    sent to the JAX reference (and which the CUDA kernel takes)."""
    q, k, v = _qkv(1, 4, seq, 128, seed=7)
    scale = 128 ** -0.5
    want_o, want_lse = jatt._fwd_with_lse_reference(
        *_j(q, k, v), causal=causal, sm_scale=scale)
    o, lse = tatt.flash_fwd(*_t(q, k, v), causal)
    _close(o, want_o)
    _close(lse, want_lse)
    o2, lse2 = tatt._fwd_with_lse_reference(*_t(q, k, v), causal=causal,
                                            sm_scale=scale)
    _close(o2, want_o)
    _close(lse2, want_lse)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_gqa_matches_repeated_kv(causal):
    """KVH < H: q head h reads kv head h // (H // KVH), i.e. what the JAX
    path computes with repeat_kv."""
    q, k, v = _qkv(2, 8, 48, 128, kvh=2, seed=8)
    scale = 128 ** -0.5
    jq, jk, jv = _j(q, k, v)
    want_o, want_lse = jatt._fwd_with_lse_reference(
        jq, jatt.repeat_kv(jk, 4), jatt.repeat_kv(jv, 4), causal=causal,
        sm_scale=scale)
    o, lse = tatt.flash_fwd(*_t(q, k, v), causal)
    _close(o, want_o)
    _close(lse, want_lse)
    _close(tatt.flash_attention(*_t(q, k, v), causal), want_o)


def test_flash_fwd_bf16_plain_rounds_p_like_the_kernel():
    """bf16 inputs: O in bf16 within bf16 rounding of the f32 result, LSE
    in f32."""
    q, k, v = _qkv(1, 2, 64, 128, seed=9)
    o32, lse32 = tatt.flash_fwd(*_t(q, k, v), True)
    o16, lse16 = tatt.flash_fwd(*[t.to(torch.bfloat16) for t in _t(q, k, v)],
                                True)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    # inputs rounded to bf16 (8 bits of mantissa) move scores by ~1e-2
    np.testing.assert_allclose(o16.float().numpy(), o32.numpy(), atol=5e-2)
    np.testing.assert_allclose(lse16.numpy(), lse32.numpy(), atol=5e-2)


def test_flash_fwd_rejects_bad_inputs():
    q, k, v = _t(*_qkv(1, 3, 8, 128, kvh=2, seed=10))
    with pytest.raises(ValueError):
        tatt.flash_fwd(q, k, v)  # 3 q heads over 2 kv heads
    q, k, v = _t(*_qkv(1, 2, 8, 128, seed=10))
    with pytest.raises(TypeError):
        tatt.flash_fwd(q, k.double(), v)
    with pytest.raises(ValueError):  # neither cuda nor cpu: no fallback
        tatt.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"))


def test_flash_fwd_cpu_does_not_count_kernel_launches():
    before = tatt.flash_fwd.launches
    tatt.flash_fwd(*_t(*_qkv(1, 2, 16, 128, seed=11)))
    assert tatt.flash_fwd.launches == before


# ---------------------------------------------------------------------------
# the kernels' layout check (strides and alignment; runs on CPU tensors)
# ---------------------------------------------------------------------------

# Llama-shaped at head_dim 128 (the kernels' width), 2 query heads per KV
# head, one layer, bf16 compute.
_LAYOUT_KW = dict(vocab_size=64, d_model=512, n_layers=1, n_heads=4,
                  n_kv_heads=2, d_ff=64, max_seq=32)


def _capture(seen):
    def attn(q, k, v, causal):
        seen.append((q, k, v))
        return tatt.flash_fwd(q, k, v, causal)[0]
    return attn


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_layout_accepts_the_train_forward_layouts(dtype):
    """q/k from apply_rope are dense BHSD; v is the transpose of a
    [B, S, KVH, D] view (seq stride KVH*D, head stride D): the check passes
    it without a copy, and the strided v gives the dense v's result."""
    from ray_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig(dtype=dtype, **_LAYOUT_KW)
    params = tl.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 24)))
    seen = []
    tl.forward(params, tokens, cfg, attn_fn=_capture(seen))
    (q, k, v), = seen
    assert q.is_contiguous() and k.is_contiguous()
    assert not v.is_contiguous()
    assert v.stride() == (24 * 2 * 128, 128, 2 * 128, 1)
    tatt.check_kernel_layout("flash_fwd kernel", q=q, k=k, v=v)
    o, lse = tatt.flash_fwd(q, k, v)
    o2, lse2 = tatt.flash_fwd(q, k, v.contiguous())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_kernel_layout_accepts_the_engine_prefill_layouts(monkeypatch):
    """The engine's prefill core hands flash_attention the same layouts
    (B = 1, one prefill bucket)."""
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.serve import engine as teng

    cfg = tl.LlamaConfig(**_LAYOUT_KW)
    params = tl.init_params(cfg, 1, device="cpu")
    seen = []
    capture = _capture(seen)
    monkeypatch.setattr(teng, "flash_attention",
                        lambda q, k, v, causal: capture(q, k, v, causal))
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (1, 32)))
    teng._make_prefill_core(cfg)(params, tokens, 20)
    (q, k, v), = seen
    assert q.dtype == torch.bfloat16 and not v.is_contiguous()
    assert v.stride() == (32 * 2 * 128, 128, 2 * 128, 1)
    tatt.check_kernel_layout("flash_fwd kernel", q=q, k=k, v=v)


@pytest.mark.parametrize("remat_policy", ["full", "dots_nobatch"])
def test_kernel_layout_accepts_what_the_train_backward_receives(
        monkeypatch, remat_policy):
    """A train step's backward gets q and k dense from apply_rope, v as the
    transpose of a [B, S, KVH, D] view, and dO as the gradient of
    attn.transpose(1, 2).reshape(B, S, H * D): a dense [B, S, H, D] buffer
    seen as [B, H, S, D]. All four pass the kernels' layout check as they
    are (flash_bwd copies none of them), and the plain backward on those
    views equals it on dense copies."""
    from ray_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig(remat_policy=remat_policy, **_LAYOUT_KW)
    params = tl.init_params(cfg, 2, device="cpu")
    params["embed"].requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (2, 24)))
    seen = []
    flash_bwd = tatt.flash_bwd

    def capture(*args):
        seen.append(args)
        return flash_bwd(*args)

    monkeypatch.setattr(tatt, "flash_bwd", capture)
    loss, _ = tl.loss_fn(params, tokens, cfg)
    loss.backward()
    (q, k, v, out, lse, dout, causal, scale), = seen
    B, S, H, KVH, D = 2, 24, 4, 2, 128
    assert q.dtype == dout.dtype == torch.bfloat16 and causal
    assert q.is_contiguous() and k.is_contiguous()
    assert v.stride() == (S * KVH * D, D, KVH * D, 1)
    assert dout.shape == (B, H, S, D)
    assert dout.stride() == (S * H * D, D, H * D, 1)
    tatt.check_kernel_layout("the flash backward kernels", q=q, k=k, v=v,
                             dout=dout)
    got = flash_bwd(q, k, v, out, lse, dout, causal, scale)
    want = flash_bwd(*(t.contiguous() for t in (q, k, v, out, lse, dout)),
                     causal, scale)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_layout_refuses_misaligned_rows(dtype):
    """A row stride of 129 elements (258 bytes in bf16) and a base address
    2 bytes past a 16-byte boundary are not what TMA takes."""
    q, k, v = _t(*_qkv(1, 2, 8, 128, seed=14))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    tatt.check_kernel_layout("flash_fwd kernel", q=q, k=k, v=v)
    wide = torch.zeros(1, 2, 8, 129, dtype=dtype)[..., :128]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        tatt.check_kernel_layout("flash_fwd kernel", q=q, k=wide, v=v)
    flat = torch.zeros(1 + 2 * 8 * 128, dtype=dtype)
    shifted = flat[1:].view(1, 2, 8, 128)
    assert shifted.data_ptr() % 16 == shifted.element_size()
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        tatt.check_kernel_layout("flash_fwd kernel", q=q, k=k, v=shifted)


def test_kernel_layout_refuses_a_non_dense_last_dim():
    q, k, v = _t(*_qkv(1, 2, 8, 128, seed=15))
    q = q.to(torch.bfloat16)
    every_other = torch.zeros(1, 2, 8, 256, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="dense last dim"):
        tatt.check_kernel_layout("flash_fwd kernel", q=every_other, k=k,
                                 v=v)
    with pytest.raises(ValueError, match="dense last dim"):
        tatt.check_kernel_layout("the flash backward kernels", q=q, k=k,
                                 v=v, dout=q.transpose(2, 3))


# ---------------------------------------------------------------------------
# flash_attention gradients (plain backward, CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads_match_jax(causal):
    q, k, v = _qkv(1, 4, 32, 16, kvh=2, seed=12)
    g = _rand((1, 4, 32, 16), 13)
    tq, tk, tv = [t.requires_grad_() for t in _t(q, k, v)]
    (tatt.flash_attention(tq, tk, tv, causal) * torch.from_numpy(g)).sum() \
        .backward()

    def loss(q, k, v):
        out = jatt.attention_reference(q, jatt.repeat_kv(k, 2),
                                       jatt.repeat_kv(v, 2), causal=causal)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*_j(q, k, v))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w, atol=1e-4)


# ---------------------------------------------------------------------------
# flash backward: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _fwd_out(q, k, v, causal):
    """(O, LSE) of the JAX reference forward, as numpy, for both sides."""
    o, lse = jatt._fwd_with_lse_reference(*_j(q, k, v), causal=causal,
                                          sm_scale=128 ** -0.5)
    return np.array(o), np.array(lse)


def _pallas_bwd(q, k, v, o, lse, do, causal):
    with pltpu.force_tpu_interpret_mode():
        return jatt._flash_bwd_pallas(*_j(q, k, v, o, lse, do), causal=causal,
                                      sm_scale=128 ** -0.5, block_q=128,
                                      block_k=128)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_pallas_kernels_interpret(causal):
    """B1 H2 S256 D128 through the real TPU kernel bodies
    (`_flash_bwd_dkv_kernel`, `_flash_bwd_dq_kernel`, 128x128 blocks, two
    q and two kv blocks, so all three causal block classes) in Pallas
    interpret mode."""
    q, k, v = _qkv(1, 2, 256, 128, seed=14)
    do = _rand((1, 2, 256, 128), 15)
    o, lse = _fwd_out(q, k, v, causal)
    want = _pallas_bwd(q, k, v, o, lse, do, causal)
    got = tatt.flash_bwd(*_t(q, k, v, o, lse, do), causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_gqa_sums_query_heads_like_repeat_kv(causal):
    """KVH < H: dK/dV come back with KVH heads, equal to the Pallas kernels
    on repeat_kv'd K/V followed by the VJP of repeat_kv (a sum over each
    kv head's query heads)."""
    q, k, v = _qkv(1, 4, 256, 128, kvh=2, seed=16)
    do = _rand((1, 4, 256, 128), 17)
    kr, vr = (np.repeat(x, 2, axis=1) for x in (k, v))
    o, lse = _fwd_out(q, kr, vr, causal)
    wq, wk, wv = _pallas_bwd(q, kr, vr, o, lse, do, causal)
    dq, dk, dv = tatt.flash_bwd(*_t(q, k, v, o, lse, do), causal)
    assert dk.shape == dv.shape == (1, 2, 256, 128)
    _close(dq, wq)
    _close(dk, np.asarray(wk).reshape(1, 2, 2, 256, 128).sum(axis=2))
    _close(dv, np.asarray(wv).reshape(1, 2, 2, 256, 128).sum(axis=2))


def test_flash_bwd_plain_bf16_rounds_p_and_ds_like_the_kernels():
    """bf16 inputs: the Pallas kernels round P to v's dtype before Pᵀ·dO and
    dS to q's dtype before dSᵀ·Q and dS·K. The plain version rounds at the
    same places, so it matches them up to f32 summation order: a handful of
    outputs (under 0.2%) one bf16 step apart. Keeping P and dS in f32
    instead moves about 40% of the outputs."""
    q, k, v = _qkv(1, 2, 256, 128, seed=18)
    do = _rand((1, 2, 256, 128), 19)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    o, lse = jatt._fwd_with_lse_reference(jq, jk, jv, causal=True,
                                          sm_scale=128 ** -0.5)
    with pltpu.force_tpu_interpret_mode():
        want = jatt._flash_bwd_pallas(jq, jk, jv, o, lse, jdo, causal=True,
                                      sm_scale=128 ** -0.5, block_q=128,
                                      block_k=128)

    def bf16(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16)

    args = [bf16(x) for x in (jq, jk, jv, o)]
    tlse, tdo = torch.from_numpy(np.array(lse)), bf16(jdo)
    got = tatt.flash_bwd_plain(*args, tlse, tdo, True, 128 ** -0.5)
    unrounded = tatt.flash_bwd_plain(*[x.float() for x in args], tlse,
                                     tdo.float(), True, 128 ** -0.5)
    for g, u, w in zip(got, unrounded, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        g, u = g.float().numpy(), u.to(torch.bfloat16).float().numpy()
        step = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert np.abs(g - w).max() <= step
        assert (g != w).mean() < 2e-3
        assert (u != w).mean() > 0.2


def test_flash_bwd_kernel_wrappers_on_cpu_split_flash_bwd():
    """flash_bwd_dkv / flash_bwd_dq (the kernels' wrappers) run their plain
    halves on CPU tensors and count no launches."""
    q, k, v = _t(*_qkv(1, 4, 40, 128, kvh=2, seed=20))
    do = torch.from_numpy(_rand((1, 4, 40, 128), 21))
    o, lse = tatt.flash_fwd(q, k, v, True)
    before = (tatt.flash_bwd_dkv.launches, tatt.flash_bwd_dq.launches)
    dq, dk, dv = tatt.flash_bwd(q, k, v, o, lse, do, True)
    delta = (do * o).sum(-1)
    wk, wv = tatt.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    assert torch.equal(dk, wk) and torch.equal(dv, wv)
    assert torch.equal(dq, tatt.flash_bwd_dq(q, k, v, do, lse, delta, True))
    assert (tatt.flash_bwd_dkv.launches, tatt.flash_bwd_dq.launches) == before
    with pytest.raises(ValueError):  # neither cuda nor cpu: no fallback
        tatt.flash_bwd(*(t.to("meta") for t in (q, k, v, o, lse, do)))


# ---------------------------------------------------------------------------
# routing by head_dim, as the JAX package routes
# ---------------------------------------------------------------------------

def test_attention_route_follows_the_reference_dispatch():
    """head_dim 128, 256, 384 and 512 go to the kernels (the Pallas
    kernels' widths the port's kernels take), head_dims that are not
    multiples of 128 to the jnp branch; multiples of 128 from 640 up,
    which the Pallas kernels take and the port's kernels' tiles do not fit,
    raise before anything runs."""
    assert [tatt.attention_route(d) for d in (128, 256, 384, 512)] == \
        ["kernel"] * 4
    assert [tatt.attention_route(d) for d in (16, 64, 96)] == \
        ["reference"] * 3
    for d in (640, 1024):
        with pytest.raises(ValueError, match="shared memory"):
            tatt.attention_route(d)
    q, k, v = _t(*_qkv(1, 2, 8, 640, seed=30))
    with pytest.raises(ValueError, match="shared memory"):
        tatt.flash_attention(q, k, v)


# head_dim 384 (a generic instance; 512 is the same code at a wider D,
# checked on the card): the plain versions against the TPU kernel bodies
# in interpret mode at B1 H2 KVH1 S128 (one 128 block each way). The Pallas kernels take K and V
# at q's heads, so they get them repeated, and their dK and dV are summed
# over the group as the port sums its query heads.
D384 = 384


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_plain_d384_matches_pallas_kernel_interpret(causal):
    q, k, v = _qkv(1, 2, 128, D384, kvh=1, seed=40)
    scale = D384 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jatt._flash_fwd_pallas(
            *_j(q, np.repeat(k, 2, 1), np.repeat(v, 2, 1)), causal=causal,
            sm_scale=scale, block_q=128, block_k=128)
    o, lse = tatt.flash_fwd(*_t(q, k, v), causal)
    assert o.shape == (1, 2, 128, D384) and lse.shape == (1, 2, 128)
    _close(o, want_o)
    _close(lse, want_lse)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_d384_matches_pallas_kernels_interpret(causal):
    q, k, v = _qkv(1, 2, 128, D384, kvh=1, seed=42)
    do = _rand((1, 2, 128, D384), 45)
    scale = D384 ** -0.5
    kr, vr = np.repeat(k, 2, 1), np.repeat(v, 2, 1)
    o, lse = (np.array(x) for x in jatt._fwd_with_lse_reference(
        *_j(q, kr, vr), causal=causal, sm_scale=scale))
    with pltpu.force_tpu_interpret_mode():
        jdq, jdk, jdv = jatt._flash_bwd_pallas(
            *_j(q, kr, vr, o, lse, do), causal=causal, sm_scale=scale,
            block_q=128, block_k=128)
    want = (jdq, np.asarray(jdk).sum(1, keepdims=True),
            np.asarray(jdv).sum(1, keepdims=True))
    got = tatt.flash_bwd(*_t(q, k, v, o, lse, do), causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) <= 1e-4


# Relative to the largest element, by dtype and head_dim; for bf16 as (out
# and dq, dk and dv). f32 parts by summation order alone. bf16 at 256: the
# kernel route rounds P and dS to bf16 where the JAX branch keeps them in
# f32, so outputs part by a few bf16 steps. bf16 at 64 and 96 (the same f32
# arithmetic on both sides): out and dq part by summation order, so 1e-3
# catches P or dS rounded to bf16 (dq then parts by 4e-3 to 7e-3); dk and
# dv part by one bf16 step, 2**-7 of the largest element at most, because
# the JAX side rounds each repeated head's gradient to bf16 before it sums
# the group and the port sums in f32.
def _route_tol(dtype, d):
    if dtype == torch.float32:
        return 1e-5, 1e-5
    return (2e-2, 2e-2) if d == 256 else (1e-3, 2 ** -7)


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 96, 256])
def test_flash_attention_routes_match_jax_value_and_grad(d, dtype, causal):
    """Forward and backward at head_dim 64, 96 (the port's copy of the jnp
    branch) and 256 (the kernels' plain versions on the CPU) against the
    JAX package's flash_attention and jax.grad on the CPU (its jnp
    branch), grouped-query heads on the JAX side through repeat_kv."""
    q, k, v = _qkv(1, 4, 48, d, kvh=2, seed=31 + d)
    g = _rand((1, 4, 48, d), 32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def loss(q, k, v):
        out = jatt.flash_attention(q, jatt.repeat_kv(k, 2),
                                   jatt.repeat_kv(v, 2), causal)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), out

    (_, want_o), want = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *[jnp.asarray(x, jdt) for x in (q, k, v)])
    calls = (tatt.flash_fwd_reference.calls, tatt.flash_bwd_reference.calls)
    tq, tk, tv = [torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v)]
    out = tatt.flash_attention(tq, tk, tv, causal)
    (out.float() * torch.from_numpy(g)).sum().backward()
    ran = (tatt.flash_fwd_reference.calls - calls[0],
           tatt.flash_bwd_reference.calls - calls[1])
    assert ran == ((0, 0) if d == 256 else (1, 1))
    assert out.dtype == dtype and tk.grad.shape == (1, 2, 48, d)
    tol_q, tol_kv = _route_tol(dtype, d)
    assert _rel(out, want_o) <= tol_q
    for got, w, tol in zip((tq.grad, tk.grad, tv.grad), want,
                           (tol_q, tol_kv, tol_kv)):
        assert got.dtype == dtype
        assert _rel(got, w) <= tol


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bwd_f32_on_cpu_matches_the_jax_reference(d, causal):
    """flash_bwd on f32 CPU tensors (the jnp branch's copy at 64, the
    kernels' plain versions at 128 and 256) against the JAX package's
    blockwise jnp backward, to 1e-5; Skv 1024 is two of its 512-row
    blocks."""
    q, k, v = _qkv(1, 2, 1024, d, seed=40 + d)
    do = _rand((1, 2, 1024, d), 41)
    scale = d ** -0.5
    o, lse = jatt._fwd_with_lse_reference(*_j(q, k, v), causal=causal,
                                          sm_scale=scale)
    o, lse = np.array(o), np.array(lse)
    want = jatt._flash_vjp_bwd(causal, None, 512, tuple(_j(q, k, v, o, lse)),
                               jnp.asarray(do))
    got = tatt.flash_bwd(*_t(q, k, v, o, lse, do), causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)
