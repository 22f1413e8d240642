"""Mixture-of-experts routing and dispatch (counterpart of
``ray_tpu/ops/moe.py``).

Capacity-based dispatch (GShard/Switch style): each expert processes at
most ``capacity = ceil(tokens * top_k * capacity_factor / n_experts)``
assignments, taken in token-major order; the rest are dropped. Every
shape is static, as in the JAX package, and the arithmetic is its: f32
router logits from the compute-dtype inputs, an integer running count for
the slots, a trash slot for the overflow, an f32 combine.

Under a ``ParallelContext`` the semantics stay global over the batch
shards, as GSPMD keeps them: ``tokens`` is the token count of all
``(dp, fsdp)`` ranks, and a rank's slots start after the assignments of
the ranks before it (an all-gather of the per-expert counts). Experts
are split over ``ep``: every rank of an ep group holds the same tokens,
runs its own experts on them, and the group sums the results; the router
logits are gathered over ``ep`` before the top-k. The experts' ``mlp``
dim is split over ``tp`` like a dense FFN's.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel.comm import (all_gather_nograd, all_reduce_nograd,
                                         copy_to, gather_from, reduce_from)
from ray_tpu_torch.parallel.context import axis_group


def top_k_routing(gate_logits: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gate_logits: [tokens, n_experts] -> (weights [tokens, k] f32, idx
    [tokens, k]).

    Weights are softmaxed over the selected k (Mixtral-style). The choice
    is ``torch.topk(sorted=True)``, whose order of equal logits is its own
    (``jax.lax.top_k`` takes the lower index first); f32 logits of real
    inputs are never equal."""
    vals, idx = torch.topk(gate_logits, k, dim=-1, sorted=True)
    return torch.softmax(vals.float(), dim=-1), idx


def _batch_sum(x: torch.Tensor, ctx, grad: bool) -> torch.Tensor:
    """Sum over the (dp, fsdp) batch shards."""
    for axis in ("fsdp", "dp"):
        g = axis_group(ctx, axis)
        x = reduce_from(x, g) if grad else all_reduce_nograd(x, g)
    return x


def _ranks_before(counts: torch.Tensor, ctx) -> torch.Tensor:
    """Per expert, the assignments of the batch shards before this rank in
    (dp, fsdp) order."""
    if ctx is None:
        return torch.zeros_like(counts)
    per = all_gather_nograd(counts, axis_group(ctx, "fsdp"))   # [fsdp, E]
    per = all_gather_nograd(per, axis_group(ctx, "dp"))        # [dp, fsdp, E]
    mine = ctx.rank("dp") * ctx.size("fsdp") + ctx.rank("fsdp")
    return per.reshape(-1, counts.shape[0])[:mine].sum(0)


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor, w_up: torch.Tensor,
            w_gate: torch.Tensor, w_down: torch.Tensor, *, top_k: int = 2,
            capacity_factor: float = 1.25, ctx=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SwiGLU MoE feed-forward with capacity-based dispatch.

    x: [tokens, d_model], this rank's tokens
    gate_w: [d_model, n_experts] router weights (this rank's experts)
    w_up/w_gate: [n_experts, d_model, d_ff]; w_down: [n_experts, d_ff,
      d_model] (this rank's experts and d_ff block)
    Returns (out [tokens, d_model], aux_loss scalar f32)."""
    T, D = x.shape
    g_ep, g_tp = axis_group(ctx, "ep"), axis_group(ctx, "tp")
    x_ep = copy_to(x, g_ep)
    logits = gather_from(torch.matmul(x_ep.float(), gate_w.float()), -1, g_ep)
    E = logits.shape[-1]
    E_local = gate_w.shape[-1]
    e0 = 0 if ctx is None else ctx.rank("ep") * E_local
    weights, idx = top_k_routing(logits, top_k)                # [T,k], [T,k]
    n_batch = 1 if ctx is None else ctx.size("dp") * ctx.size("fsdp")
    capacity = max(1, math.ceil(T * n_batch * top_k * capacity_factor / E))

    # Token-major slot of each assignment within its expert: a running
    # count, offset by the shards before this one (no sort needed).
    flat_expert = idx.reshape(-1)                                  # [T*k]
    flat_weight = weights.reshape(-1)
    flat_token = torch.arange(T, device=x.device).repeat_interleave(top_k)
    one_hot = F.one_hot(flat_expert, E)                            # [T*k, E]
    before = torch.cumsum(one_hot, 0) - one_hot
    prefix = _ranks_before(one_hot.sum(0), ctx)
    pos = before.gather(1, flat_expert[:, None])[:, 0] + prefix[flat_expert]
    keep = pos < capacity
    mine = keep & (flat_expert >= e0) & (flat_expert < e0 + E_local)
    # Overflow and other ranks' experts land in a trash slot past the
    # real buffer.
    trash = E_local * capacity
    slot = torch.where(mine, (flat_expert - e0) * capacity + pos,
                       torch.full_like(pos, trash))

    x_ex = copy_to(x_ep, g_tp)
    buf = x_ex.new_zeros(trash + 1, D).index_put((slot,), x_ex[flat_token])
    xe = buf[:trash].view(E_local, capacity, D)
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    expert_out = torch.bmm(h, w_down)                              # [e, c, d]
    flat_out = torch.cat([expert_out.reshape(trash, D),
                          expert_out.new_zeros(1, D)])             # trash -> 0
    # Each rank combines only its experts' (and d_ff block's) outputs, so
    # its gradient of the routing weights is partial: sum it over tp and
    # ep, after which every rank of both groups holds the same, as for the
    # rest of the routing.
    weight = copy_to(copy_to(flat_weight, g_tp), g_ep)
    contrib = flat_out[slot].float() * (weight * mine)[:, None]
    out = torch.zeros(T, D, dtype=torch.float32, device=x.device).index_add(
        0, flat_token, contrib)
    out = reduce_from(reduce_from(out, g_ep), g_tp)

    # Load-balancing aux loss (Switch-style): mean prob * mean assignment
    # fraction, both over every batch shard's tokens.
    n_tokens = T * n_batch
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = _batch_sum(one_hot.sum(0).float(), ctx, False) / n_tokens
    frac_prob = _batch_sum(probs.sum(0), ctx, True) / n_tokens
    aux = E * torch.sum(frac_tokens * frac_prob)
    return out.to(x.dtype), aux
