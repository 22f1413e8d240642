"""The port's plain flash versions at head_dim 256 against the Pallas TPU
kernels, on the CPU, with inputs made from a numpy seed.

On the card, bf16 at head_dim 256 runs the wgmma kernels of all three
(``csrc/flash_fwd.cu`` ``flash_fwd_bf16_kernel<256, 64>``,
``csrc/flash_bwd_dkv.cu`` ``flash_bwd_dkv_d256_kernel``,
``csrc/flash_bwd_dq.cu`` ``flash_bwd_dq_d256_kernel``); f32 runs all three
on 2-CTA cluster kernels, one CTA per 128 columns of D, that sum the scores
over D through the other's shared memory on the FMA units (the f32
D384-D1024 bodies at 2 CTAs): ``flash_fwd_f32_d256_cluster_kernel`` (128 q
rows a cluster; each CTA's exchange owns 64 of them, CTA 0 rows 0-63 and
CTA 1 rows 64-127, in four full row slots of 16),
``flash_bwd_dkv_f32_d256_cluster_kernel`` (64 KV rows a cluster; each
exchange owns 32, in two full row slots of 16) and
``flash_bwd_dq_f32_d256_cluster_kernel`` (64 q rows a cluster, split as the
dK/dV's KV rows). ``chip_smoke.py`` holds each against ``flash_fwd_plain``,
``flash_bwd_plain_dkv`` and ``flash_bwd_plain_dq``. Here those plain
versions are held against the real Pallas bodies (``_flash_fwd_kernel``,
``_flash_bwd_dkv_kernel``, ``_flash_bwd_dq_kernel``) run in interpret mode
at D256: two q and two kv blocks of 128, so every causal block class; and
the whole f32 ``flash_attention`` and its gradients are held against the
JAX package's at the D256 parity runs' heads (B1 H16 KVH8) at S88, S104,
S120 and S200: between them the cluster kernels' last tiles end ragged in
every row slot of the dK/dV's and dQ's two CTAs and of the forward's CTA 1
(``test_flash_attention_f32_d256_matches_jax`` says which).

Tolerances: f32 is f32 on both sides, only the summation order differs,
so 1e-5 absolute (measured: under 5e-6). In bf16 both round P to bf16
before P·V (the Pallas forward against its running max, block by block,
the plain one against the final max) and P and dS before the backward's
products, so an output moves by a bf16 step where an f32 sum in another
order lands on the other side of a rounding; the bound is 2 bf16 steps at
the output's magnitude (the step of its largest element, as
``test_torch_ops.py``'s bf16 backward test measures one; measured: under
one step). A wrong mask, block or head moves an output by its own
order. LSE is f32 in both dtypes: 1e-5. The backward's bf16 outputs are
also bit-equal but for at most 1% (measured: 0.53%), where keeping P and dS
in f32 would change about 40% of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ray_tpu.ops import attention as jatt
from ray_tpu_torch.ops import attention as tatt

D = 256
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
def test_flash_fwd_plain_d256_matches_pallas_kernel_interpret(dt, causal):
    """B1 H2 S256 D256: ``flash_fwd_plain`` (and ``flash_fwd`` on CPU
    tensors, which runs it) against ``_flash_fwd_pallas``."""
    q, k, v, _ = _inputs(dt, 2, 2, seed=30)
    want_o, want_lse = _pallas_fwd(q, k, v, causal)
    tq, tk, tv = (_torch(x, dt) for x in (q, k, v))
    o, lse = tatt.flash_fwd_plain(tq, tk, tv, causal, SCALE)
    _close(o, want_o, dt)
    _close_lse(lse, want_lse)
    o2, lse2 = tatt.flash_fwd(tq, tk, tv, causal)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_bwd_plain_d256_matches_pallas_kernels_interpret(dt, causal):
    """B1 H2 S256 D256: ``flash_bwd_plain`` and its halves
    ``flash_bwd_plain_dkv`` and ``flash_bwd_plain_dq`` against
    ``_flash_bwd_pallas``, on the Pallas forward's O and LSE."""
    q, k, v, do = _inputs(dt, 2, 2, seed=40)
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


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_d256_gqa_sums_query_heads_like_repeat_kv(dt):
    """H4 KVH2 S256 D256 causal: the plain forward and backward read kv head
    h // 2 in place and give dK/dV with 2 heads, equal to the Pallas kernels
    on repeat_kv'd K and V followed by the VJP of repeat_kv (each kv head's
    two query heads summed, here in f32)."""
    q, k, v, do = _inputs(dt, 4, 2, seed=50)
    kr, vr = (jnp.repeat(x, 2, axis=1) for x in (k, v))
    o, lse = _pallas_fwd(q, kr, vr, True)
    want_dq, want_dk, want_dv = _pallas_bwd(q, kr, vr, o, lse, do, True)
    tq, tk, tv, tdo = (_torch(x, dt) for x in (q, k, v, do))
    to, tlse = tatt.flash_fwd_plain(tq, tk, tv, True, SCALE)
    _close(to, o, dt)
    _close_lse(tlse, lse)
    dq, dk, dv = tatt.flash_bwd_plain(tq, tk, tv, _torch(o, dt),
                                      torch.from_numpy(np.array(lse)), tdo,
                                      True, SCALE)
    assert dk.shape == dv.shape == (1, 2, S, D)
    _close(dq, want_dq, dt)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        summed = np.asarray(jnp.asarray(want, jnp.float32)).reshape(
            1, 2, 2, S, D).sum(axis=2)
        _close(got, summed, dt)


@pytest.mark.parametrize("s", [88, 104, 120, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_d256_matches_jax(causal, s):
    """B1 H16 KVH8 D256 f32, the D256 parity runs' heads: the whole
    ``flash_attention`` and its backward against the JAX package's
    ``flash_attention`` and ``jax.grad`` on the CPU (its jnp branch),
    grouped-query heads on the JAX side through ``repeat_kv``. On the card
    all three run 2-CTA cluster kernels. The dK/dV's and dQ's CTA 0 owns
    rows 0-31 of a 64-row KV or q tile (slots 0-15 and 16-31) and CTA 1 rows
    32-63 (slots 32-47 and 48-63); the forward's CTA 0 owns rows 0-63 of a
    128-row q tile (four slots of 16) and CTA 1 rows 64-127 (slots 64-79,
    80-95, 96-111, 112-127). The last tiles end:

    * S88: dK/dV and dQ at row 24, inside CTA 0's second slot (CTA 1
      wholly past Skv or Sq); forward at row 88, inside CTA 1's second slot
      (its third and fourth wholly past Sq).
    * S104: dK/dV and dQ at row 40, inside CTA 1's first slot (its second
      wholly past); forward at row 104, inside CTA 1's third slot (its
      fourth wholly past).
    * S120: dK/dV and dQ at row 56, inside CTA 1's second slot; forward at
      row 120, inside CTA 1's fourth slot, the only length here that leaves
      it partly full.
    * S200: dK/dV and dQ at row 8, inside CTA 0's first slot (the rest
      past); forward at row 72, inside CTA 1's first slot (its other three
      wholly past Sq).

    Output and dQ, dK, dV to 1e-5 absolute: f32 on both sides, summation
    order alone."""
    jdt = DTYPES["f32"][0]
    q, k, v, g = (jnp.asarray(_rand(shape, 260 + i), jdt)
                  for i, shape in enumerate(((1, 16, s, D), (1, 8, s, D),
                                             (1, 8, s, D), (1, 16, s, D))))

    def loss(q, k, v):
        out = jatt.flash_attention(q, jatt.repeat_kv(k, 2),
                                   jatt.repeat_kv(v, 2), causal)
        return jnp.sum((out * g).astype(jnp.float32)), out

    (_, want_o), want = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (_torch(x, "f32").requires_grad_() for x in (q, k, v))
    out = tatt.flash_attention(tq, tk, tv, causal)
    (out * _torch(g, "f32")).sum().backward()
    assert out.shape == (1, 16, s, D) and tk.grad.shape == (1, 8, s, D)
    _close(out.detach(), want_o, "f32")
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w, "f32")
