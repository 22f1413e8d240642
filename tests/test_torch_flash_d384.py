"""The port's plain flash forward and backward at head_dim 384 against the
Pallas TPU kernels, on the CPU, with inputs made from a numpy seed.

On the card, head_dim 384 runs all three kernels on 3-CTA cluster
kernels, one CTA per 128 columns of D, that sum the scores over D through
each other's shared memory: in f32 on the FMA units, the forward
``flash_fwd_f32_d384_cluster_kernel`` (``csrc/flash_fwd.cu``; its exchange
owns 42 or 43 of the 128 q rows in three row slots of 16),
``flash_bwd_dkv_f32_d384_cluster_kernel`` (``csrc/flash_bwd_dkv.cu``, the
f32 D512, D640 and D1024 dK/dV's body at 3 CTAs; each CTA's exchange owns
21 or 22 of the 64 KV rows, in two row slots of 16) and
``flash_bwd_dq_f32_d384_cluster_kernel`` (``csrc/flash_bwd_dq.cu``, the f32
dQ's body, its exchange owning 21 or 22 of the 64 q rows in two row
slots); in bf16 on wgmma in each CTA, the forward
``flash_fwd_bf16_d384_cluster_kernel`` (six row slots of 8),
``flash_bwd_dkv_bf16_d384_cluster_kernel`` (the bf16 D512, D640 and D1024
dK/dV's body at 3 CTAs, its exchange owning 21 or 22 of the 64 KV rows in
three row slots of 8) and ``flash_bwd_dq_bf16_d384_cluster_kernel`` (the
bf16 dQ's body, 21 or 22 of the 64 q rows in three row slots of 8).
``chip_smoke.py`` holds each against ``flash_fwd_plain``,
``flash_bwd_plain_dkv`` and ``flash_bwd_plain_dq``. Here those plain
versions are held against the real Pallas bodies (``_flash_fwd_kernel``,
``_flash_bwd_dkv_kernel``, ``_flash_bwd_dq_kernel``) run in interpret mode
at D384: two q and two kv blocks of 128, so every causal block class; the
backward on the Pallas forward's O and LSE (``tests/test_torch_ops.py``
has f32 at one block of 128 and a KV head shared by 2). The GQA cases take
the D384 parity runs' group of 2 (``llama3_8b(d_model=3072, n_heads=8,
n_kv_heads=4)``), and the whole ``flash_attention`` and its gradients, in
f32 and in bf16, are held against the JAX package's at those heads, at S40,
S104 and S200.

Tolerances as ``test_torch_flash_d256.py`` sets them: f32 is f32 on both
sides, only the summation order differs, so 1e-5 absolute (LSE too, in
both dtypes); in bf16 both round P before P·V (the Pallas forward against
its running max, the plain one against the final max) and P and dS before
the backward's products, so an output moves by a bf16 step where an f32
sum in another order lands on the other side of a rounding: 2 bf16 steps at
the output's magnitude, and for the backward at most 1% of the outputs not
bit-equal. A wrong mask, block or head moves an output by its own order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ray_tpu.ops import attention as jatt
from ray_tpu_torch.ops import attention as tatt

D = 384
S = 256
BLOCK = 128  # two q and two kv blocks: above, on and below the diagonal
SCALE = D ** -0.5
ATOL_F32 = 1e-5
BF16_STEPS = 2
BF16_BWD_DIFFER = 1e-2  # share of the backward's bf16 outputs not bit-equal
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(dt, h, kvh, seed):
    """q, k, v, dO in the JAX dtype (numpy f32 rounded by JAX)."""
    jdt = DTYPES[dt][0]
    return [jnp.asarray(_rand(shape, seed + i), jdt) for i, shape in enumerate(
        ((1, h, S, D), (1, kvh, S, D), (1, kvh, S, D), (1, h, S, D)))]


def _torch(x, dt):
    """The same values as a torch tensor of the dtype (bf16 exactly)."""
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(
        DTYPES[dt][1])


def _pallas_fwd(q, k, v, causal):
    with pltpu.force_tpu_interpret_mode():
        return jatt._flash_fwd_pallas(q, k, v, causal=causal, sm_scale=SCALE,
                                      block_q=BLOCK, block_k=BLOCK)


def _pallas_bwd(q, k, v, o, lse, do, causal):
    with pltpu.force_tpu_interpret_mode():
        return jatt._flash_bwd_pallas(q, k, v, o, lse, do, causal=causal,
                                      sm_scale=SCALE, block_q=BLOCK,
                                      block_k=BLOCK)


def _close(got, want, dt, differ=1.0):
    """f32: 1e-5 absolute; bf16: BF16_STEPS steps at want's magnitude, and
    at most a share ``differ`` of the elements not bit-equal."""
    assert got.dtype == DTYPES[dt][1]
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    if dt == "f32":
        np.testing.assert_allclose(g, w, atol=ATOL_F32, rtol=0)
        return
    step = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    err = np.abs(g - w).max()
    assert err <= BF16_STEPS * step, f"{err} > {BF16_STEPS} x {step}"
    assert (g != w).mean() <= differ, f"{(g != w).mean()} differ"


def _close_lse(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_fwd_plain_d384_matches_pallas_kernel_interpret(dt, causal):
    """B1 H2 S256 D384: ``flash_fwd_plain`` (and ``flash_fwd`` on CPU
    tensors, which runs it) against ``_flash_fwd_pallas``."""
    q, k, v, _ = _inputs(dt, 2, 2, seed=380)
    want_o, want_lse = _pallas_fwd(q, k, v, causal)
    tq, tk, tv = (_torch(x, dt) for x in (q, k, v))
    o, lse = tatt.flash_fwd_plain(tq, tk, tv, causal, SCALE)
    _close(o, want_o, dt)
    _close_lse(lse, want_lse)
    o2, lse2 = tatt.flash_fwd(tq, tk, tv, causal)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_fwd_d384_gqa_reads_kv_heads_like_repeat_kv(dt, causal):
    """H4 KVH2 S256 D384: the plain forward reads kv head h // 2 in place,
    equal to the Pallas kernel on repeat_kv'd K and V."""
    q, k, v, _ = _inputs(dt, 4, 2, seed=390)
    kr, vr = (jnp.repeat(x, 2, axis=1) for x in (k, v))
    want_o, want_lse = _pallas_fwd(q, kr, vr, causal)
    tq, tk, tv = (_torch(x, dt) for x in (q, k, v))
    o, lse = tatt.flash_fwd_plain(tq, tk, tv, causal, SCALE)
    assert o.shape == (1, 4, S, D) and lse.shape == (1, 4, S)
    _close(o, want_o, dt)
    _close_lse(lse, want_lse)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_bwd_plain_d384_matches_pallas_kernels_interpret(dt, causal):
    """B1 H2 S256 D384: ``flash_bwd_plain`` and its halves
    ``flash_bwd_plain_dkv`` and ``flash_bwd_plain_dq`` against
    ``_flash_bwd_pallas``, on the Pallas forward's O and LSE."""
    q, k, v, do = _inputs(dt, 2, 2, seed=360)
    o, lse = _pallas_fwd(q, k, v, causal)
    want_dq, want_dk, want_dv = _pallas_bwd(q, k, v, o, lse, do, causal)
    tq, tk, tv, to, tdo = (_torch(x, dt) for x in (q, k, v, o, do))
    tlse = torch.from_numpy(np.array(lse))
    dq, dk, dv = tatt.flash_bwd_plain(tq, tk, tv, to, tlse, tdo, causal,
                                      SCALE)
    delta = tatt._delta(to, tdo)
    dk2, dv2 = tatt.flash_bwd_plain_dkv(tq, tk, tv, tdo, tlse, delta, causal,
                                        SCALE)
    dq2 = tatt.flash_bwd_plain_dq(tq, tk, tv, tdo, tlse, delta, causal, SCALE)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv),
                      (dk2, want_dk), (dv2, want_dv), (dq2, want_dq)):
        _close(got, want, dt, BF16_BWD_DIFFER)
    # The CPU wrappers run the plain versions themselves.
    dk3, dv3 = tatt.flash_bwd_dkv(tq, tk, tv, tdo, tlse, delta, causal, SCALE)
    dq3 = tatt.flash_bwd_dq(tq, tk, tv, tdo, tlse, delta, causal, SCALE)
    assert torch.equal(dk3, dk2) and torch.equal(dv3, dv2)
    assert torch.equal(dq3, dq2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_bwd_d384_gqa_sums_query_heads_like_repeat_kv(dt, causal):
    """H4 KVH2 S256 D384, causal and not (the card's phases 2 and 5 run
    both through the 3-CTA f32 dK/dV clusters at GQA groups of 4): the
    plain backward reads kv head h // 2 in place and gives dK/dV with 2
    heads, equal to the Pallas kernels on repeat_kv'd K and V followed by
    the VJP of repeat_kv (each kv head's two query heads summed, here in
    f32)."""
    q, k, v, do = _inputs(dt, 4, 2, seed=370)
    kr, vr = (jnp.repeat(x, 2, axis=1) for x in (k, v))
    o, lse = _pallas_fwd(q, kr, vr, causal)
    want_dq, want_dk, want_dv = _pallas_bwd(q, kr, vr, o, lse, do, causal)
    tq, tk, tv, tdo = (_torch(x, dt) for x in (q, k, v, do))
    dq, dk, dv = tatt.flash_bwd_plain(tq, tk, tv, _torch(o, dt),
                                      torch.from_numpy(np.array(lse)), tdo,
                                      causal, SCALE)
    assert dk.shape == dv.shape == (1, 2, S, D)
    _close(dq, want_dq, dt)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        summed = np.asarray(jnp.asarray(want, jnp.float32)).reshape(
            1, 2, 2, S, D).sum(axis=2)
        _close(got, summed, dt)


@pytest.mark.parametrize("s", [40, 104, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_d384_matches_jax(dt, causal, s):
    """B1 H8 KVH4 D384, the D384 parity runs' heads: the whole
    ``flash_attention`` and its backward against the JAX package's
    ``flash_attention`` and ``jax.grad`` on the CPU (its jnp branch),
    grouped-query heads on the JAX side through ``repeat_kv``. On the card
    S200 ends in a ragged last 64-row q tile of the 3-CTA dQs (rows 8-63
    past Sq: all the first CTA's rows but 0-7, and the other two CTAs'
    wholly); S40 and S104 (both 40 mod 64) end the last 64-row KV tile of
    the 3-CTA dK/dVs and the last q tile of the 3-CTA dQs at row 40, so
    that the second CTA's rows 40-41 (in bf16 its third row slot, 37-41;
    in f32 its second) and all the third CTA's rows 42-63 lie past Skv or
    Sq. f32: output
    and dQ, dK, dV to
    1e-5 absolute, summation order alone. bf16: 2 bf16 steps at their
    magnitude (``_close``): the port rounds P and dS to bf16 before the
    products where the jnp branch keeps them in f32 (it rounds P / l in the
    forward), and the JAX side sums each kv head's query heads in bf16, the
    port in f32."""
    jdt = DTYPES[dt][0]
    q, k, v, g = (jnp.asarray(_rand(shape, 410 + i), jdt)
                  for i, shape in enumerate(((1, 8, s, D), (1, 4, s, D),
                                             (1, 4, s, D), (1, 8, s, D))))

    def loss(q, k, v):
        out = jatt.flash_attention(q, jatt.repeat_kv(k, 2),
                                   jatt.repeat_kv(v, 2), causal)
        return jnp.sum((out * g).astype(jnp.float32)), out

    (_, want_o), want = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (_torch(x, dt).requires_grad_() for x in (q, k, v))
    out = tatt.flash_attention(tq, tk, tv, causal)
    (out * _torch(g, dt)).float().sum().backward()
    assert out.shape == (1, 8, s, D) and tk.grad.shape == (1, 4, s, D)
    _close(out.detach(), want_o, dt)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w, dt)
