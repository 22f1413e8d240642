"""Ring attention: blockwise causal attention over the sequence-parallel
(``sp``) group (counterpart of ``ray_tpu/ops/ring_attention.py``).

Each rank holds one contiguous block of the sequence. K/V blocks rotate
around the group's ring while an online-softmax accumulator folds in one
block per step, in f32. The rotation is an autograd function whose
backward is the inverse rotation, so the backward is a ring schedule too.
Plain PyTorch, as the JAX version is plain ``jnp``: it launches no flash
kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.attention import DEFAULT_MASK_VALUE
from ray_tpu_torch.parallel.comm import rotate


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group: dist.ProcessGroup, causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [b, h, s_local, d]; k, v: [b, kvh, s_local, d] (h a multiple of
    kvh: q head i reads kv head i // (h // kvh)) -> [b, h, s_local, d]."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    n, me = dist.get_world_size(group), dist.get_rank(group)
    B, H, S, Dh = q.shape
    KVH = k.shape[1]
    qg = q.float().view(B, KVH, H // KVH, S, Dh)
    ar = torch.arange(S, device=q.device)
    q_pos = me * S + ar[:, None]

    def fold(kv, i, acc, m, l):
        k_cur, v_cur = kv[0].float()[:, :, None], kv[1].float()[:, :, None]
        kv_idx = (me - i) % n      # whose block this rank holds at step i
        s = torch.matmul(qg, k_cur.transpose(-1, -2)) * scale
        if causal:
            k_pos = kv_idx * S + ar[None, :]
            s = s.masked_fill(q_pos < k_pos, DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1, keepdim=True)
        return acc * corr + torch.matmul(p, v_cur), m_new, l_new

    kv = torch.stack([k, v])
    acc = torch.zeros_like(qg)
    m = torch.full_like(qg[..., :1], -float("inf"))
    l = torch.zeros_like(qg[..., :1])
    acc, m, l = fold(kv, 0, acc, m, l)
    for i in range(1, n):
        kv = rotate(kv, group)
        acc, m, l = fold(kv, i, acc, m, l)
    out = acc / l.clamp_min(1e-30)
    return out.view(B, H, S, Dh).to(q.dtype)
