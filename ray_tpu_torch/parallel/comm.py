"""Autograd-aware collectives over one mesh axis's process group.

GSPMD inserts a collective and its transpose wherever a layout needs one;
here each pair is an explicit ``torch.autograd.Function``. Every rank of a
tp or ep group computes the same loss, so the pairs are Megatron's: a
gradient is summed only where the forward split the work.

  * ``copy_to``      identity forward, all-reduce backward: the input of a
                     product whose weight is split over the group.
  * ``reduce_from``  all-reduce forward, identity backward: the partial
                     sums after such a product; also a global sum over
                     batch shards, each rank owning its own part.
  * ``gather_from``  all-gather forward, this rank's block backward.
  * ``gather_param`` all-gather forward, reduce-scatter backward: an
                     fsdp-sharded parameter used by every rank's batch.
  * ``rotate``       send to the next rank, receive from the previous one;
                     the backward is the inverse rotation.

A ``group`` of None stands for an axis of size 1, where each of these is
the identity.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def _all_reduce(x: torch.Tensor, group: Group,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def _all_gather(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _my_block(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    size = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * size, size)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _my_block(g, ctx.dim, ctx.group).contiguous(), None, None


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = g.movedim(ctx.dim, 0).contiguous()
        out = g.new_empty((g.shape[0] // dist.get_world_size(ctx.group),
                           *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, dim, group)


def gather_param(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    return x if group is None else _GatherParam.apply(x, dim, group)


def all_gather_nograd(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` in group-rank order."""
    if group is None:
        return x[None]
    return _all_gather(x[None], 0, group)


def all_reduce_nograd(x: torch.Tensor, group: Group,
                      op=dist.ReduceOp.SUM) -> torch.Tensor:
    return x if group is None else _all_reduce(x.detach(), group, op)


# ---------------------------------------------------------------------------
# point to point
# ---------------------------------------------------------------------------

def peer(group: dist.ProcessGroup, offset: int) -> int:
    """The global rank ``offset`` places after this one in ``group``'s
    ring."""
    ranks = dist.get_process_group_ranks(group)
    return ranks[(dist.get_rank(group) + offset) % len(ranks)]


def exchange(send: Optional[torch.Tensor], dst: Optional[int],
             recv: Optional[torch.Tensor], src: Optional[int],
             group: dist.ProcessGroup) -> None:
    """Post the send and the receive together and wait for both."""
    ops: List[dist.P2POp] = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), dst, group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, src, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    out = torch.empty_like(x)
    exchange(x, peer(group, offset), out, peer(group, -offset), group)
    return out


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def rotate(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's ``x`` moves one rank on around ``group``'s ring (the
    result holds the previous rank's)."""
    return x if group is None else _Rotate.apply(x, group)
