"""The port's f32 ``flash_attention`` at head_dim 128 and its gradients
against the JAX package's, on the CPU, with inputs made from a numpy seed.

On the card f32 at head_dim 128 runs its dK/dV and dQ on the f32 cluster
bodies at one CTA a cluster (``csrc/flash_bwd_dkv.cu``
``flash_bwd_dkv_f32_d128_cluster_kernel``, ``f32c::dkv_cluster<1>``, and
``csrc/flash_bwd_dq.cu`` ``flash_bwd_dq_f32_d128_cluster_kernel``,
``f32c::dq_cluster<1>``): the one CTA holds all 128 columns of D, so its
exchange warpgroup sums no peer's partials; it owns all 64 rows of a KV
(dK/dV) or q (dQ) tile in four full row slots of 16 (rows 0-15, 16-31,
32-47, 48-63) and forms P^T and dS^T (dK/dV) or dS (dQ) from them in f32.
The forward runs its generic instance. ``chip_smoke.py`` holds the kernels
against ``flash_bwd_plain_dkv`` and ``flash_bwd_plain_dq``; here the whole
``flash_attention`` runs those plain versions on CPU tensors and is held
against the JAX package's ``flash_attention`` and ``jax.grad`` (its jnp
branch on the CPU), at the f32 D128 parity run's heads, B1 H32 KVH8: each
KV head sums the gradients of G = 4 query heads.

Tolerance: f32 on both sides, only the summation order differs, so 1e-5
absolute, as ``tests/test_torch_flash_d256.py`` states it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu_torch.ops import attention as tatt

D = 128
H, KVH = 32, 8
ATOL_F32 = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("s", [72, 88, 104, 120])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_d128_matches_jax(causal, s):
    """B1 H32 KVH8 D128 f32: the whole ``flash_attention`` and its
    backward against the JAX package's, grouped-query heads on the JAX side
    through ``repeat_kv``. With Sq = Skv = S the last 64-row KV tile (dK/dV)
    and q tile (dQ) hold S - 64 rows, so on the card they end inside the
    one CTA's exchange row slot 0 (S72: rows 0-7), 1 (S88: 0-23), 2 (S104:
    0-39) and 3 (S120: 0-55); the slots after it, and the rest of its own,
    lie past Skv or Sq. Output and dQ, dK, dV to 1e-5 absolute."""
    q, k, v, g = (jnp.asarray(_rand(shape, 128 + i), jnp.float32)
                  for i, shape in enumerate(((1, H, s, D), (1, KVH, s, D),
                                             (1, KVH, s, D), (1, H, s, D))))
    groups = H // KVH

    def loss(q, k, v):
        out = jatt.flash_attention(q, jatt.repeat_kv(k, groups),
                                   jatt.repeat_kv(v, groups), causal)
        return jnp.sum(out * g), out

    (_, want_o), want = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(np.array(x)).requires_grad_()
                  for x in (q, k, v))
    out = tatt.flash_attention(tq, tk, tv, causal)
    (out * torch.from_numpy(np.array(g))).sum().backward()
    assert out.shape == (1, H, s, D) and tk.grad.shape == (1, KVH, s, D)
    for got, w in zip((out.detach(), tq.grad, tk.grad, tv.grad),
                      (want_o, *want)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=ATOL_F32, rtol=0)
