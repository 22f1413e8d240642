"""Hash-shuffle stage: distributed groupby/aggregate/join.

Analogue of the reference's hash-shuffle operators (reference:
python/ray/data/_internal/execution/operators/hash_shuffle.py:1032
HashShufflingOperatorBase, hash_aggregate.py, join.py). Redesign for this
framework's linear-plan executor: the all-to-all exchange is two task
waves —

  map wave:    one task per input block, partitioning rows by a
               process-stable hash of the key into P column-blocks
               (num_returns=P: each part is its own object, so reducers
               pull only their partition)
  reduce wave: P tasks; reducer j concatenates part j of every map task
               and runs the per-partition reduction (vectorized
               aggregation, hash join, or a user map_groups fn)

Keys hash with crc32 (NOT Python's per-process-randomized str hash):
both sides of a join partition identically in different worker
processes.
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, concat_blocks

AggSpec = Tuple[str, Optional[str]]  # (op, column); column None for count


def _hash_partition_codes(vals: np.ndarray, num_partitions: int
                          ) -> np.ndarray:
    """Process-stable partition code per row.

    Numeric keys normalize to float64 then mix the bit pattern
    (splitmix64, vectorized) — equal values of different dtypes (3 vs
    3.0, int32 vs int64) land in the same partition, and strided key
    spaces don't degenerate onto one reducer the way raw modulo would.
    Everything else hashes crc32 of its string form (NOT Python's
    per-process-randomized hash)."""
    if vals.dtype.kind in "iufb":
        v = vals.astype(np.float64) + 0.0  # -0.0 -> +0.0
        h = v.view(np.uint64).copy()
        c1 = np.uint64(0xFF51AFD7ED558CCD)
        c2 = np.uint64(0xC4CEB9FE1A85EC53)
        s = np.uint64(33)
        h ^= h >> s
        h *= c1
        h ^= h >> s
        h *= c2
        h ^= h >> s
        return (h % np.uint64(num_partitions)).astype(np.int64)
    out = np.empty(len(vals), np.int64)
    for i, v in enumerate(vals):
        out[i] = zlib.crc32(str(v).encode()) % num_partitions
    return out


@ray_tpu_torch.remote
def _block_columns(block: Any) -> List[str]:
    """Column names of a block ([] when empty) — schema without moving
    the data to the driver."""
    acc = BlockAccessor(block)
    if not acc.num_rows():
        return []
    return list(acc.to_numpy_batch().keys())


@ray_tpu_torch.remote
def _partition_block(block: Any, key: str, num_partitions: int):
    """Map side: split one block into per-partition column blocks."""
    cols = BlockAccessor(block).to_numpy_batch()
    if key not in cols:
        raise KeyError(f"groupby/join key {key!r} not in columns "
                       f"{sorted(cols)}")
    codes = _hash_partition_codes(np.asarray(cols[key]), num_partitions)
    parts = []
    for j in range(num_partitions):
        mask = codes == j
        parts.append({k: np.asarray(v)[mask] for k, v in cols.items()})
    return tuple(parts)


def _partition_refs(ds, key: str, num_partitions: int) -> List[List[Any]]:
    """All input blocks -> refs[part_j] = [map task parts]."""
    mat = ds.materialize()
    if num_partitions == 1:
        # hash % 1 == 0 for every row: blocks pass through unpartitioned.
        return [list(mat._sources)]
    per_map = [
        _partition_block.options(num_returns=num_partitions).remote(
            ref, key, num_partitions)
        for ref in mat._sources
    ]
    return [[parts[j] for parts in per_map]
            for j in range(num_partitions)]


def _default_partitions(*datasets) -> int:
    return max(1, *(d.num_blocks() for d in datasets))


# ----------------------------------------------------------------------
# aggregation reducers
# ----------------------------------------------------------------------

def _agg_name(op: str, col: Optional[str]) -> str:
    return f"{op}({col})" if col else f"{op}()"


@ray_tpu_torch.remote
def _agg_reduce(key: str, aggs: List[AggSpec], *parts):
    """Reduce side: vectorized per-key aggregation of one partition."""
    block = concat_blocks(list(parts))
    if BlockAccessor(block).num_rows() == 0:
        return {}
    cols = BlockAccessor(block).to_numpy_batch()
    uniq, inv = np.unique(np.asarray(cols[key]), return_inverse=True)
    n = len(uniq)
    counts = np.bincount(inv, minlength=n)
    out: Dict[str, np.ndarray] = {key: uniq}
    for spec in aggs:
        op, col = spec[0], spec[1]
        if op == "count":
            out[_agg_name(op, col)] = counts
            continue
        v = np.asarray(cols[col], dtype=np.float64)
        if op in ("sum", "mean", "std"):
            sums = np.zeros(n)
            np.add.at(sums, inv, v)
            if op == "sum":
                out[_agg_name(op, col)] = sums
            elif op == "mean":
                out[_agg_name(op, col)] = sums / counts
            else:  # std; ddof rides as the spec's third element
                ddof = spec[2] if len(spec) > 2 else 0
                sq = np.zeros(n)
                np.add.at(sq, inv, v * v)
                mean = sums / counts
                var = np.maximum(sq / counts - mean * mean, 0.0)
                denom = np.maximum(counts - ddof, 1)
                var = var * counts / denom
                out[_agg_name(op, col)] = np.sqrt(var)
        elif op == "min":
            acc = np.full(n, np.inf)
            np.minimum.at(acc, inv, v)
            out[_agg_name(op, col)] = acc
        elif op == "max":
            acc = np.full(n, -np.inf)
            np.maximum.at(acc, inv, v)
            out[_agg_name(op, col)] = acc
        else:
            raise ValueError(f"unsupported aggregation {op!r}")
    return out


@ray_tpu_torch.remote
def _map_groups_reduce(key: str, fn_blob: bytes, *parts):
    """Reduce side: run a user function once per key group."""
    import cloudpickle

    fn = cloudpickle.loads(fn_blob)
    block = concat_blocks(list(parts))
    if BlockAccessor(block).num_rows() == 0:
        return []
    cols = BlockAccessor(block).to_numpy_batch()
    uniq, inv = np.unique(np.asarray(cols[key]), return_inverse=True)
    out_blocks = []
    for g in range(len(uniq)):
        mask = inv == g
        group = {k: np.asarray(v)[mask] for k, v in cols.items()}
        res = fn(group)
        if res is not None:
            out_blocks.append(res)
    return concat_blocks(out_blocks) if out_blocks else []


class GroupedData:
    """Deferred groupby (reference: grouped_data.py GroupedData)."""

    def __init__(self, ds, key: str,
                 num_partitions: Optional[int] = None):
        self._ds = ds
        self._key = key
        self._parts = num_partitions
        # One shuffle serves every aggregation on this GroupedData:
        # repeated g.count(); g.mean() must not re-run the exchange.
        self._part_cache: Dict[int, List[List[Any]]] = {}

    def _partitions(self, P: int) -> List[List[Any]]:
        refs = self._part_cache.get(P)
        if refs is None:
            refs = self._part_cache[P] = _partition_refs(
                self._ds, self._key, P)
        return refs

    def _agg(self, aggs: List[AggSpec]):
        from ray_tpu_torch.data.dataset import Dataset

        P = self._parts or _default_partitions(self._ds)
        part_refs = self._partitions(P)
        refs = [_agg_reduce.remote(self._key, aggs, *part_refs[j])
                for j in range(P)]
        return Dataset(refs, [],
                       name=f"{self._ds._name}(groupby:{self._key})")

    def count(self):
        return self._agg([("count", None)])

    def sum(self, on: str):
        return self._agg([("sum", on)])

    def mean(self, on: str):
        return self._agg([("mean", on)])

    def min(self, on: str):
        return self._agg([("min", on)])

    def max(self, on: str):
        return self._agg([("max", on)])

    def std(self, on: str, ddof: int = 0):
        return self._agg([("std", on, ddof)])

    def aggregate(self, *specs: AggSpec):
        """Multiple aggregations at once: aggregate(("sum", "x"),
        ("mean", "y"), ("count", None))."""
        return self._agg(list(specs))

    def map_groups(self, fn: Callable[[Dict[str, np.ndarray]], Any]):
        """fn(group_columns) -> block (columns dict or row list) per
        key group (reference: grouped_data.py map_groups)."""
        import cloudpickle

        from ray_tpu_torch.data.dataset import Dataset

        P = self._parts or _default_partitions(self._ds)
        part_refs = self._partitions(P)
        blob = cloudpickle.dumps(fn)
        refs = [_map_groups_reduce.remote(self._key, blob, *part_refs[j])
                for j in range(P)]
        return Dataset(refs, [],
                       name=f"{self._ds._name}(map_groups:{self._key})")


# ----------------------------------------------------------------------
# joins
# ----------------------------------------------------------------------

@ray_tpu_torch.remote
def _join_reduce(on: str, how: str, n_left: int, right_cols: List[str],
                 *parts):
    """Reduce side: hash join of one partition (both sides already
    co-partitioned by the same stable key hash). right_cols is the
    GLOBAL right-side schema — a partition whose right side is empty
    must still emit None for every right column on `how=left`, or the
    output schema varies by partition."""
    left = concat_blocks(list(parts[:n_left]))
    right = concat_blocks(list(parts[n_left:]))
    lrows = BlockAccessor(left).to_rows() if \
        BlockAccessor(left).num_rows() else []
    rrows = BlockAccessor(right).to_rows() if \
        BlockAccessor(right).num_rows() else []
    by_key: Dict[Any, List[dict]] = {}
    for r in rrows:
        by_key.setdefault(r[on], []).append(r)
    rcols = set(right_cols) - {on}
    out = []
    for lr in lrows:
        matches = by_key.get(lr[on])
        if matches:
            for rr in matches:
                row = dict(lr)
                for k in rr:
                    if k == on:
                        continue
                    # collision -> right column gets a _right suffix
                    row[f"{k}_right" if k in row else k] = rr[k]
                out.append(row)
        elif how == "left":
            row = dict(lr)
            for k in rcols:
                row[f"{k}_right" if k in row else k] = None
            out.append(row)
    return out


def join_datasets(left, right, on: str, how: str = "inner",
                  num_partitions: Optional[int] = None):
    """Distributed hash join (reference: join.py JoinOperator;
    inner/left)."""
    from ray_tpu_torch.data.dataset import Dataset

    if how not in ("inner", "left"):
        raise ValueError(f"unsupported join type {how!r}")
    P = num_partitions or _default_partitions(left, right)
    right = right.materialize()
    lparts = _partition_refs(left, on, P)
    rparts = _partition_refs(right, on, P)
    right_cols: List[str] = []
    if how == "left":
        # Schema only — a tiny task per block, never the block itself.
        for ref in right._sources:
            cols = ray_tpu_torch.get(_block_columns.remote(ref))
            if cols:
                right_cols = cols
                break
    refs = [
        _join_reduce.remote(on, how, len(lparts[j]), right_cols,
                            *lparts[j], *rparts[j])
        for j in range(P)
    ]
    return Dataset(refs, [],
                   name=f"{left._name}(join:{on}:{right._name})")
