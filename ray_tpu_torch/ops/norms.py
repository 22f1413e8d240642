"""Normalization and rotary-embedding ops (plain PyTorch; counterpart of
``ray_tpu/ops/norms.py``). Shapes and the split-halves RoPE layout are the
JAX package's, so the two compare like with like."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32, cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [max_seq, head_dim // 2] f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [b, h, s, d]; cos/sin: [max_seq, d//2]; positions: [s] global
    positions (default 0..s-1)."""
    s = x.shape[2]
    if positions is None:
        c, si = cos[:s], sin[:s]
    else:
        c, si = cos[positions], sin[positions]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * si, x1 * si + x2 * c], dim=-1)
    return out.to(x.dtype)
