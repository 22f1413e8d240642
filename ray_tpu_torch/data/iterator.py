"""DataIterator: batch formation + prefetch + torch conversion.

Analogue of the reference's iteration path (reference:
python/ray/data/iterator.py:71 DataIterator.iter_batches +
_internal/block_batching/ prefetch windows; iter_torch_batches): blocks
are zero-copy views of the shm store up to the hop to the device.
``torch`` is imported only inside ``iter_torch_batches_from_refs``: the
data tasks and the split coordinator import this package and never load
torch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, concat_blocks


def _format_batch(batch, batch_format: str):
    acc = BlockAccessor(batch)
    if batch_format == "numpy":
        return acc.to_numpy_batch()
    if batch_format == "pyarrow":
        return acc.to_arrow()
    if batch_format == "rows":
        return acc.to_rows()
    raise ValueError(f"unknown batch_format {batch_format!r}")


def iter_batches_from_refs(ref_iter: Iterator[Any], *, batch_size: Optional[int],
                           batch_format: str = "numpy",
                           prefetch_blocks: int = 2,
                           drop_last: bool = False) -> Iterator[Any]:
    """Stream blocks (prefetching refs ahead) and re-chunk rows into batches
    of exactly batch_size (except possibly the last)."""
    window: List[Any] = []

    def fill(it):
        while len(window) < prefetch_blocks + 1:
            try:
                window.append(next(it))
            except StopIteration:
                return False
        return True

    it = iter(ref_iter)
    carry = None  # leftover rows as a block
    while True:
        fill(it)
        if not window:
            break
        block = ray_tpu_torch.get(window.pop(0))
        if carry is not None:
            block = concat_blocks([carry, block])
            carry = None
        acc = BlockAccessor(block)
        n = acc.num_rows()
        if batch_size is None:
            if n:
                yield _format_batch(block, batch_format)
            continue
        start = 0
        while n - start >= batch_size:
            yield _format_batch(acc.slice(start, start + batch_size),
                                batch_format)
            start += batch_size
        if start < n:
            carry = acc.slice(start, n)
    if carry is not None and BlockAccessor(carry).num_rows() and not drop_last:
        if batch_size is None or not drop_last:
            yield _format_batch(carry, batch_format)


# Pinned host buffers per column on the way to the card: a buffer is
# written again only after the copy that read it has run, so the host may
# run this many batches ahead of the device before it waits.
PINNED_BUFFERS = 3


def _torch_dtype(dtypes: Any, key: str) -> Any:
    return dtypes.get(key) if isinstance(dtypes, dict) else dtypes


def iter_torch_batches_from_refs(ref_iter: Iterator[Any], *,
                                 batch_size: Optional[int],
                                 device: Any = None,
                                 ctx: Optional[Any] = None,
                                 global_batch: bool = False,
                                 dtypes: Any = None,
                                 prefetch_blocks: int = 2,
                                 drop_last: bool = True
                                 ) -> Iterator[Dict[str, Any]]:
    """numpy batches -> torch tensors on ``device`` (``ctx.device`` when a
    ``ParallelContext`` is given; ``None`` is the card, and raises without
    one).

    The host path is zero-copy up to here: block bytes are mapped from the
    shm store as read-only views. On the CPU the batch is one copy of them
    (writable, owning its memory). On the card each column is copied into
    one of ``PINNED_BUFFERS`` pinned host buffers and sent with
    ``non_blocking=True``; a CUDA event recorded after each copy guards the
    buffer until the copy has run, so the host never waits for the steps
    queued before it.

    ``global_batch=True`` (with ``ctx``) says each batch is this rank's
    rows of the step's global batch, as ``streaming_split`` hands them out:
    the tensors are marked so that ``shard_batch`` keeps them as they are
    (no gather, no copy). The context must split the batch over all of its
    ranks and nothing else. Without it a batch is a whole batch.

    ``dtypes``: one torch dtype, or {column: dtype}; a column keeps its
    block's dtype otherwise.
    """
    from ray_tpu_torch.device import resolve_device

    # checked here, at the call, not at the first batch
    if global_batch:
        if ctx is None:
            raise ValueError("global_batch=True needs the ParallelContext "
                             "whose batch the rank's rows belong to")
        from ray_tpu_torch.parallel.sharding import (batch_spec,
                                                     shard_index)
        _, count = shard_index(batch_spec()[0], ctx)
        if count != ctx.mesh.size():
            raise ValueError(
                f"global_batch=True needs a mesh that splits the batch over "
                f"all its {ctx.mesh.size()} ranks (dp x fsdp); "
                f"{ctx.config} splits it {count} ways, so the rows of one "
                f"rank are not its part of the global batch")
    dev = ctx.device if ctx is not None else resolve_device(device)
    return _torch_batches(ref_iter, batch_size, dev, global_batch, dtypes,
                          prefetch_blocks, drop_last)


def _torch_batches(ref_iter, batch_size, dev, global_batch, dtypes,
                   prefetch_blocks, drop_last):
    import torch

    from ray_tpu_torch.parallel.sharding import mark_rank_local

    pinned: Dict[str, List[Any]] = {}
    events: Dict[str, List[Any]] = {}
    turn = 0

    def to_device(key: str, arr: np.ndarray) -> Any:
        if dev.type != "cuda":
            return torch.from_numpy(np.array(arr, order="C", copy=True))
        ring = pinned.setdefault(key, [None] * PINNED_BUFFERS)
        evs = events.setdefault(key, [None] * PINNED_BUFFERS)
        slot = turn % PINNED_BUFFERS
        if evs[slot] is not None:
            evs[slot].synchronize()  # the copy that last read this buffer
        buf = ring[slot]
        if buf is None or buf.numel() < arr.nbytes:
            buf = ring[slot] = torch.empty(arr.nbytes, dtype=torch.uint8,
                                           pin_memory=True)
        dtype = torch.from_numpy(np.empty(0, dtype=arr.dtype)).dtype
        host = buf[:arr.nbytes].view(dtype).view(arr.shape)
        host.numpy()[...] = arr
        out = host.to(dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        evs[slot] = ev
        return out

    for batch in iter_batches_from_refs(ref_iter, batch_size=batch_size,
                                        batch_format="numpy",
                                        prefetch_blocks=prefetch_blocks,
                                        drop_last=drop_last):
        if batch_size is not None and drop_last:
            n = len(next(iter(batch.values()))) if batch else 0
            if n != batch_size:
                continue
        out = {}
        for k, v in batch.items():
            t = to_device(k, np.asarray(v))
            dtype = _torch_dtype(dtypes, k)
            if dtype is not None and t.dtype != dtype:
                t = t.to(dtype)
            out[k] = mark_rank_local(t) if global_batch else t
        turn += 1
        yield out
