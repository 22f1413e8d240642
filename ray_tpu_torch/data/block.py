"""Blocks — the unit of data movement (reference: python/ray/data/block.py:51
Block = Arrow table | pandas frame; here Arrow table | numpy-dict | row list,
numpy-dict is the native batch format because it maps zero-copy out of
the shm store, up to the one copy to the device in ``iter_torch_batches``).

A block travels the cluster as one ObjectRef in the shared-memory store;
numpy/Arrow payloads use pickle-5 out-of-band buffers, so workers map them
zero-copy from tmpfs.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

try:
    import pyarrow as pa
except Exception:  # pragma: no cover
    pa = None

Block = Union["pa.Table", Dict[str, np.ndarray], List[Any]]


def _column_array(vals: list) -> "np.ndarray":
    """Column values -> numpy, falling back to dtype=object for RAGGED
    columns (per-row arrays/lists of differing lengths — e.g. token-id
    prompts); a bare np.asarray would raise on the inhomogeneous
    shape."""
    try:
        return np.asarray(vals)
    except ValueError:
        out = np.empty(len(vals), object)
        out[:] = vals
        return out


class BlockAccessor:
    """Uniform view over the three block representations (reference:
    python/ray/data/block.py BlockAccessor.for_block)."""

    def __init__(self, block: Block):
        self._b = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # -- shape -----------------------------------------------------------
    def num_rows(self) -> int:
        b = self._b
        if pa is not None and isinstance(b, pa.Table):
            return b.num_rows
        if isinstance(b, dict):
            return len(next(iter(b.values()))) if b else 0
        return len(b)

    def size_bytes(self) -> int:
        b = self._b
        if pa is not None and isinstance(b, pa.Table):
            return b.nbytes
        if isinstance(b, dict):
            return sum(v.nbytes for v in b.values())
        import sys
        return sum(sys.getsizeof(x) for x in b)

    def schema(self) -> Any:
        b = self._b
        if pa is not None and isinstance(b, pa.Table):
            return b.schema
        if isinstance(b, dict):
            return {k: v.dtype for k, v in b.items()}
        return type(b[0]).__name__ if b else None

    # -- conversions -----------------------------------------------------
    def to_arrow(self) -> "pa.Table":
        b = self._b
        if pa is None:
            raise RuntimeError("pyarrow unavailable")
        if isinstance(b, pa.Table):
            return b
        if isinstance(b, dict):
            return pa.table({k: pa.array(v) for k, v in b.items()})
        if b and isinstance(b[0], dict):
            return pa.Table.from_pylist(b)
        return pa.table({"item": pa.array(b)})

    def to_numpy_batch(self) -> Dict[str, np.ndarray]:
        """Columnar numpy dict — zero-copy from Arrow where dtypes allow."""
        b = self._b
        if pa is not None and isinstance(b, pa.Table):
            out = {}
            for name in b.column_names:
                col = b.column(name)
                try:
                    out[name] = col.to_numpy(zero_copy_only=True)
                except Exception:
                    out[name] = col.to_numpy(zero_copy_only=False)
            return out
        if isinstance(b, dict):
            return b
        if b and isinstance(b[0], dict):
            keys = b[0].keys()
            return {k: _column_array([r[k] for r in b]) for k in keys}
        return {"item": _column_array(list(b))}

    def to_rows(self) -> List[Any]:
        b = self._b
        if pa is not None and isinstance(b, pa.Table):
            return b.to_pylist()
        if isinstance(b, dict):
            keys = list(b)
            n = self.num_rows()
            return [{k: b[k][i] for k in keys} for i in range(n)]
        return list(b)

    # -- slicing ---------------------------------------------------------
    def slice(self, start: int, end: int) -> Block:
        b = self._b
        if pa is not None and isinstance(b, pa.Table):
            return b.slice(start, end - start)
        if isinstance(b, dict):
            return {k: v[start:end] for k, v in b.items()}
        return b[start:end]


def concat_blocks(blocks: List[Block]) -> Block:
    """Concatenate same-representation blocks."""
    blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
    if not blocks:
        return []
    b0 = blocks[0]
    if pa is not None and isinstance(b0, pa.Table):
        return pa.concat_tables([BlockAccessor(b).to_arrow() for b in blocks])
    if isinstance(b0, dict):
        keys = b0.keys()
        return {k: np.concatenate([b[k] for b in blocks]) for k in keys}
    out: List[Any] = []
    for b in blocks:
        out.extend(b)
    return out
