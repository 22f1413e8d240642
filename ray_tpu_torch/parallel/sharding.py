"""Logical-axis sharding rules (counterpart of
``ray_tpu/parallel/sharding.py``).

Parameters and activations carry *logical* axis names; a rules table maps
each name onto mesh axes. A spec is a tuple with one entry per tensor dim:
None (replicated), a mesh-axis name, or a tuple of names (the dim is split
over their product, the first name outermost), as a JAX ``PartitionSpec``
is. Where GSPMD shards a global array from its spec, here each rank holds
its own block as a plain tensor (``shard``), and the model inserts the
collectives the layout implies.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

# Default rules, Megatron-style: hidden dims over tp, d_model params over fsdp,
# batch over (dp, fsdp), sequence over sp, experts over ep.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",        # d_model dimension of weight matrices
    "vocab": "tp",
    "mlp": "tp",            # ffn hidden dimension
    "heads": "tp",          # attention heads
    "kv_heads": "tp",
    "head_dim": None,
    "qkv": None,
    "expert": "ep",
    "layers": None,         # stacked-layer leading axis (pp splits it by stage)
    "stage": "pp",
    "act_embed": None,      # activation d_model — replicated within (tp) by default
}


def spec_for(logical_axes: Tuple[Optional[str], ...],
             rules: Optional[Dict[str, MeshAxes]] = None) -> Spec:
    rules = rules or DEFAULT_RULES
    return tuple(None if name is None else rules.get(name)
                 for name in logical_axes)


def _is_axes_leaf(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_specs(logical_tree: Any,
               rules: Optional[Dict[str, MeshAxes]] = None) -> Any:
    """Map a nested dict of logical-axis tuples to one of specs."""
    if _is_axes_leaf(logical_tree):
        return spec_for(logical_tree, rules)
    return {k: tree_specs(v, rules) for k, v in logical_tree.items()}


def batch_spec() -> Spec:
    """[batch, seq, ...] activation spec."""
    return (("dp", "fsdp"), "sp")


def axes_of(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(entry: MeshAxes, ctx) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a dim split over
    ``entry``'s axes."""
    index, count = 0, 1
    for axis in axes_of(entry):
        index = index * ctx.size(axis) + ctx.rank(axis)
        count *= ctx.size(axis)
    return index, count


def shard(x: torch.Tensor, spec: Spec, ctx) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec`` (a view
    where no dim is split)."""
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} does not fit a {x.dim()}-d tensor")
    for dim, entry in enumerate(spec):
        index, count = shard_index(entry, ctx)
        if count == 1:
            continue
        if x.shape[dim] % count:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {entry} ({count} ways)")
        size = x.shape[dim] // count
        x = x.narrow(dim, index * size, size)
    return x


def tree_shard(tree: Any, specs: Any, ctx) -> Any:
    """``shard`` over matching nested dicts of global tensors and specs."""
    if isinstance(tree, dict):
        return {k: tree_shard(v, specs[k], ctx) for k, v in tree.items()}
    return shard(tree, specs, ctx)


_RANK_LOCAL = "_ray_tpu_torch_rank_local"


def mark_rank_local(t: torch.Tensor) -> torch.Tensor:
    """Mark ``t`` as this rank's rows of the global batch already (what
    ``iter_torch_batches(ctx=..., global_batch=True)`` yields):
    ``shard_batch`` then leaves its batch dim alone. The mark lives on
    this tensor object only; tensors computed from it are unmarked."""
    setattr(t, _RANK_LOCAL, True)
    return t


def batch_to(batch: Any, device: Any, non_blocking: bool = False
             ) -> torch.Tensor:
    """``batch`` (a tensor or an array) as a tensor on ``device``, keeping
    the mark of ``mark_rank_local``."""
    out = torch.as_tensor(batch).to(device, non_blocking=non_blocking)
    if out is not batch and is_rank_local(batch):
        mark_rank_local(out)
    return out


def is_rank_local(t: Any) -> bool:
    """Whether ``t`` carries the mark of ``mark_rank_local``."""
    return getattr(t, _RANK_LOCAL, False)


def shard_batch(batch: Any, ctx, num_microbatches: int = 1) -> Any:
    """This rank's part of a global ``[B, S, ...]`` batch (a tensor, or a
    dict or tuple of them): batch over ``(dp, fsdp)``, sequence over
    ``sp``.

    With ``num_microbatches`` M > 1 the rank's rows are its share of each
    of the M global microbatches (rows ``[i*B/M, (i+1)*B/M)``), so that its
    i-th local microbatch is its part of the global i-th one, as GPipe
    over a batch-sharded mesh sees it.

    A tensor marked by ``mark_rank_local`` holds this rank's rows
    already; only its sequence is split."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, ctx, num_microbatches)
                for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, ctx, num_microbatches)
                           for v in batch)
    rows, seq = batch_spec()
    index, count = shard_index(rows, ctx)
    if is_rank_local(batch):
        index, count = 0, 1
    B, M = batch.shape[0], num_microbatches
    if B % (M * count):
        raise ValueError(f"global batch {B} does not split into {M} "
                         f"microbatches over {count} batch shards")
    if count > 1:
        part = B // (M * count)
        batch = batch.reshape(M, B // M, *batch.shape[1:]).narrow(
            1, index * part, part).reshape(M * part, *batch.shape[1:])
    return shard(batch, (None, seq) + (None,) * (batch.dim() - 2), ctx)
