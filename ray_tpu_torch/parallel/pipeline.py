"""Pipeline parallelism over the ``pp`` group (counterpart of
``ray_tpu/parallel/pipeline.py``).

A GPipe schedule: at step t the stage s runs microbatch t - s, takes its
input from stage s - 1 and hands its output to stage s + 1. Where the JAX
package scans every stage over every step (the bubble steps compute
garbage and are masked), here a stage runs only its real microbatches and
the hops are point-to-point sends. The backward is the same schedule
reversed: activation gradients travel back stage by stage, each
microbatch's gradient taken from its own saved graph.

As in the JAX package, the final stage's outputs reach every stage and the
aux loss is summed over stages and averaged over microbatches. The
microbatches' gradient reaches every stage too (stage 0's, the only one
that reads them), so every stage computes the same gradient for what feeds
the pipeline.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.comm import all_reduce_nograd, exchange, peer

StageFn = Callable[[Dict[str, torch.Tensor], torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor]]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, names, group, microbatches, *leaves):
        pp, s = dist.get_world_size(group), dist.get_rank(group)
        M = microbatches.shape[0]
        ranks = dist.get_process_group_ranks(group)
        first, last = ranks[0], ranks[-1]
        # fresh leaves: each microbatch's graph ends at them, not at the
        # caller's tensors, so backward can take their gradients by hand
        params = {n: p.detach().requires_grad_(p.requires_grad)
                  for n, p in zip(names, leaves)}
        outputs = torch.zeros_like(microbatches)
        aux_acc = torch.zeros((), dtype=torch.float32,
                              device=microbatches.device)
        saved: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
        for i in range(M):
            if s == 0:
                x = microbatches[i]
            else:
                x = torch.empty_like(microbatches[i])
                exchange(None, None, x, peer(group, -1), group)
            x = x.detach().requires_grad_(s > 0 or microbatches.requires_grad)
            with torch.enable_grad():
                y, aux = stage_fn(params, x)
            saved.append((x, y, aux))
            if s < pp - 1:
                exchange(y.detach(), peer(group, 1), None, None, group)
            else:
                outputs[i] = y.detach()
            aux_acc += aux.detach()
        dist.broadcast(outputs, src=last, group=group)
        ctx.stage = (pp, s, M, first)
        ctx.group, ctx.params, ctx.saved = group, params, saved
        ctx.leaf_grad = [p.requires_grad for p in leaves]
        ctx.mb_shape = microbatches.shape
        return outputs, all_reduce_nograd(aux_acc, group) / M

    @staticmethod
    def backward(ctx, d_out, d_aux):
        pp, s, M, first = ctx.stage
        group = ctx.group
        params = [p for p in ctx.params.values()]
        grads: List[Any] = [None] * len(params)
        d_mb = d_out.new_zeros(ctx.mb_shape)
        for i in reversed(range(M)):
            x, y, aux = ctx.saved[i]
            if s == pp - 1:
                dy = d_out[i]
            else:
                dy = torch.empty_like(y)
                exchange(None, None, dy, peer(group, 1), group)
            outs, douts = [y], [dy]
            if aux.requires_grad:
                outs.append(aux)
                douts.append(d_aux / M)
            wrt = ([x] if x.requires_grad else []) + [
                p for p in params if p.requires_grad]
            got = list(torch.autograd.grad(outs, wrt, douts,
                                           allow_unused=True))
            dx = got.pop(0) if x.requires_grad else None
            for j, p in enumerate(params):
                if p.requires_grad:
                    g = got.pop(0)
                    if g is not None:
                        grads[j] = g if grads[j] is None else grads[j] + g
            if s > 0:
                exchange(dx, peer(group, -1), None, None, group)
            elif dx is not None:
                d_mb[i] = dx
            ctx.saved[i] = None
        dist.broadcast(d_mb, src=first, group=group)
        grads = [g if (g is not None or not need) else torch.zeros_like(p)
                 for g, p, need in zip(grads, params, ctx.leaf_grad)]
        return (None, None, None, d_mb, *grads)


def gpipe_spmd(stage_fn: StageFn, stage_params: Dict[str, torch.Tensor],
               microbatches: torch.Tensor, *,
               group: dist.ProcessGroup
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GPipe forward over ``group`` (the pp line of this rank).

    stage_fn(params, x) -> (y, aux scalar) for one microbatch, y of x's
      shape.
    stage_params: this stage's parameters.
    microbatches: [M, mb, ...], the same on every stage.
    Returns ([M, mb, ...] outputs of the final stage, on every stage; the
    aux summed over stages and averaged over the M microbatches)."""
    names = list(stage_params)
    return _GPipe.apply(stage_fn, names, group, microbatches,
                        *stage_params.values())
