"""Dataset — the lazy distributed data pipeline.

Analogue of the reference's Dataset (reference: python/ray/data/dataset.py —
map:276, map_batches:457, streaming_split:1826, iter_batches:4973,
iter_torch_batches:5044) over a LOGICAL PLAN that a
small planner lowers to the operator-graph streaming executor (reference:
_internal/logical/optimizers.py fusion rule + planner/planner.py →
execution/streaming_executor.py). Consecutive row/batch transforms fuse
into one map node (the fusion rule applied eagerly at plan-build time);
actor-pool maps, all-to-all exchanges (shuffle/sort/repartition), and
unions each lower to their own physical operator.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch

_py_range = range  # the public range() below shadows the builtin
from ray_tpu_torch.data import datasource as _ds
from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks
from ray_tpu_torch.data.iterator import (iter_batches_from_refs,
                                         iter_torch_batches_from_refs)


# ---------------------------------------------------------------------------
# logical plan nodes (reference: _internal/logical/operators/*)
# ---------------------------------------------------------------------------

class _Read:
    """Source blocks: materialized ObjectRefs or zero-arg read callables."""
    __slots__ = ("sources",)

    def __init__(self, sources: List[Any]):
        self.sources = sources


class _Fused:
    """A fused chain of block -> Iterator[block] stages (the reference's
    map-fusion rule output)."""
    __slots__ = ("stages",)

    def __init__(self, stages: List[Callable]):
        self.stages = stages


class _ActorMapNode:
    """map_batches on a pool of long-lived actors."""
    __slots__ = ("fn", "batch_size", "batch_format", "concurrency",
                 "ctor_args", "fn_kwargs", "resources")

    def __init__(self, fn, batch_size, batch_format, concurrency,
                 ctor_args, fn_kwargs, resources=None):
        self.fn = fn
        self.batch_size = batch_size
        self.batch_format = batch_format
        self.concurrency = concurrency
        self.ctor_args = ctor_args
        self.fn_kwargs = fn_kwargs
        self.resources = resources


class _ExchangeNode:
    """All-to-all barrier: fn(list of input refs) -> list of output refs
    (repartition / random_shuffle / sort lower to this)."""
    __slots__ = ("fn", "name", "num_blocks_hint")

    def __init__(self, fn, name: str, num_blocks_hint: Optional[int] = None):
        self.fn = fn
        self.name = name
        self.num_blocks_hint = num_blocks_hint


class _UnionNode:
    """Ordered concatenation of several sub-plans."""
    __slots__ = ("parts",)

    def __init__(self, parts: List[List[Any]]):
        self.parts = parts


class Dataset:
    def __init__(self, sources: List[Any], stages: Optional[List] = None,
                 name: str = "dataset"):
        self._plan: List[Any] = [_Read(list(sources))]
        if stages:
            self._plan.append(_Fused(list(stages)))
        self._name = name

    @classmethod
    def _from_plan(cls, plan: List[Any], name: str) -> "Dataset":
        ds = cls.__new__(cls)
        ds._plan = plan
        ds._name = name
        return ds

    @property
    def _sources(self) -> List[Any]:
        """Source list of a plain (un-transformed) dataset — the
        materialized-refs contract shuffle.py relies on."""
        assert len(self._plan) == 1 and isinstance(self._plan[0], _Read), \
            f"_sources on a transformed dataset: {self._plan}"
        return self._plan[0].sources

    # ------------------------------------------------------------------
    # transforms (lazy; each appends to the logical plan)
    # ------------------------------------------------------------------
    def _with_stage(self, stage, name: str) -> "Dataset":
        plan = list(self._plan)
        if plan and isinstance(plan[-1], _Fused):
            plan[-1] = _Fused(plan[-1].stages + [stage])
        else:
            plan.append(_Fused([stage]))
        return Dataset._from_plan(plan, f"{self._name}->{name}")

    def _with_exchange(self, fn, name: str,
                       num_blocks_hint: Optional[int] = None) -> "Dataset":
        plan = list(self._plan) + [_ExchangeNode(fn, name, num_blocks_hint)]
        return Dataset._from_plan(plan, f"{self._name}->{name}")

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: str = "numpy",
                    fn_kwargs: Optional[dict] = None,
                    concurrency: Optional[int] = None,
                    fn_constructor_args: tuple = (),
                    resources: Optional[dict] = None) -> "Dataset":
        """Apply fn to batches (reference: dataset.py:457). With
        batch_size=None each block is one batch; otherwise blocks are
        re-chunked to batch_size rows (within a block; a trailing short
        batch per block is possible, as with the reference's default
        shuffle=False zero-copy path).

        concurrency=N runs the transform on a pool of N ACTORS as its own
        physical operator (reference: ActorPoolMapOperator /
        map_batches(CallableClass, concurrency=N)) — pass a callable
        CLASS to construct once per actor (model loading etc.) and call
        per batch."""
        if concurrency is not None:
            if concurrency < 1:
                raise ValueError(f"concurrency must be >= 1, "
                                 f"got {concurrency}")
            plan = list(self._plan) + [_ActorMapNode(
                fn, batch_size, batch_format, concurrency,
                fn_constructor_args, fn_kwargs or {}, resources)]
            return Dataset._from_plan(
                plan, f"{self._name}->map_batches(actors)")
        if isinstance(fn, type) or fn_constructor_args:
            # Fused stages call fn(batch); a callable CLASS would be
            # constructed per batch WITH the batch as its ctor arg.
            raise ValueError(
                "callable classes / fn_constructor_args require "
                "concurrency=N (the actor-compute strategy)")
        kwargs = fn_kwargs or {}

        def stage(block):
            yield from _map_block_batches(block, fn, batch_size,
                                          batch_format, kwargs)

        return self._with_stage(stage, "map_batches")

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        def stage(block):
            yield [fn(row) for row in BlockAccessor(block).to_rows()]

        return self._with_stage(stage, "map")

    def flat_map(self, fn: Callable[[Any], List[Any]]) -> "Dataset":
        def stage(block):
            out: List[Any] = []
            for row in BlockAccessor(block).to_rows():
                out.extend(fn(row))
            yield out

        return self._with_stage(stage, "flat_map")

    def filter(self, pred: Callable[[Any], bool]) -> "Dataset":
        def stage(block):
            acc = BlockAccessor(block)
            if isinstance(block, dict):  # columnar fast path
                rows = acc.to_rows()
                keep = [r for r in rows if pred(r)]
                if keep:
                    yield {k: np.asarray([r[k] for r in keep])
                           for k in keep[0]}
                return
            keep = [r for r in acc.to_rows() if pred(r)]
            if keep:
                yield keep

        return self._with_stage(stage, "filter")

    # ------------------------------------------------------------------
    # execution: plan -> operator topology -> streaming executor
    # ------------------------------------------------------------------
    def _build_states(self):
        from ray_tpu_torch.data.operators import (ActorPoolMapOperator,
                                                  AllToAllOperator,
                                                  ConcatOperator,
                                                  MapTaskOperator,
                                                  SourceOperator)
        from ray_tpu_torch.data.streaming_executor import OpState

        import cloudpickle

        states: List[OpState] = []

        def wire(up: OpState, down: OpState) -> None:
            up.downstream = (down, None)
            down.upstreams.append(up)

        def build_chain(nodes: List[Any]) -> OpState:
            head = nodes[0]
            idx = 1
            if isinstance(head, _Read):
                wire_items = [
                    s if isinstance(s, ray_tpu_torch.ObjectRef)
                    else cloudpickle.dumps(s)
                    for s in head.sources]
                last = OpState(SourceOperator(wire_items))
                states.append(last)
                needs_task = any(not isinstance(s, ray_tpu_torch.ObjectRef)
                                 for s in head.sources)
                if idx < len(nodes) and isinstance(nodes[idx], _Fused):
                    # The fusion payoff: read + every chained transform
                    # in ONE streaming task per source block.
                    mo = OpState(MapTaskOperator(nodes[idx].stages,
                                                 name="read->map"))
                    wire(last, mo)
                    states.append(mo)
                    last = mo
                    idx += 1
                elif needs_task:
                    mo = OpState(MapTaskOperator([], name="read"))
                    wire(last, mo)
                    states.append(mo)
                    last = mo
            elif isinstance(head, _UnionNode):
                cs = OpState(ConcatOperator(len(head.parts)))
                for bi, part in enumerate(head.parts):
                    sink = build_chain(part)
                    sink.downstream = (cs, bi)
                    cs.upstreams.append(sink)
                states.append(cs)
                last = cs
            else:
                raise AssertionError(f"bad plan head {head!r}")

            while idx < len(nodes):
                node = nodes[idx]
                if isinstance(node, _Fused):
                    op = MapTaskOperator(node.stages, name="map")
                elif isinstance(node, _ActorMapNode):
                    op = ActorPoolMapOperator(
                        node.fn, node.ctor_args, node.fn_kwargs,
                        node.batch_size, node.batch_format,
                        node.concurrency, resources=node.resources)
                elif isinstance(node, _ExchangeNode):
                    op = AllToAllOperator(node.fn, name=node.name)
                else:
                    raise AssertionError(f"bad plan node {node!r}")
                st = OpState(op)
                wire(last, st)
                states.append(st)
                last = st
                idx += 1
            return last

        build_chain(self._plan)
        return states

    def iter_block_refs(self, window: Optional[int] = None) -> Iterator[Any]:
        from ray_tpu_torch.data.streaming_executor import (DEFAULT_TASK_BUDGET,
                                                           StreamingExecutor)
        budget = DEFAULT_TASK_BUDGET if window is None else max(1, window)
        ex = StreamingExecutor(self._build_states(), task_budget=budget)
        self._last_executor = ex  # stats() reads the live/last metrics
        return ex.run()

    def materialize(self) -> "Dataset":
        """Execute now; the result holds block refs (reference:
        dataset.py materialize -> MaterializedDataset)."""
        refs = list(self.iter_block_refs())
        return Dataset(refs, [], name=f"{self._name}(materialized)")

    def iter_batches(self, *, batch_size: Optional[int] = None,
                     batch_format: str = "numpy", prefetch_blocks: int = 2,
                     drop_last: bool = False) -> Iterator[Any]:
        return iter_batches_from_refs(
            self.iter_block_refs(), batch_size=batch_size,
            batch_format=batch_format, prefetch_blocks=prefetch_blocks,
            drop_last=drop_last)

    def iter_rows(self) -> Iterator[Any]:
        for batch in self.iter_batches(batch_format="rows"):
            yield from batch

    def iter_torch_batches(self, *, batch_size: Optional[int] = None,
                           device: Any = None, ctx: Optional[Any] = None,
                           global_batch: bool = False, dtypes: Any = None,
                           prefetch_blocks: int = 2,
                           drop_last: bool = True
                           ) -> Iterator[Dict[str, Any]]:
        """Batches as torch tensors on ``device`` (``None``: the card) —
        the ingest hop: zero-copy out of the shm store, then one copy, to
        the device through pinned buffers (``iterator.py``)."""
        return iter_torch_batches_from_refs(
            self.iter_block_refs(), batch_size=batch_size, device=device,
            ctx=ctx, global_batch=global_batch, dtypes=dtypes,
            prefetch_blocks=prefetch_blocks, drop_last=drop_last)

    # ------------------------------------------------------------------
    # consumption helpers
    # ------------------------------------------------------------------
    def take(self, k: int = 20) -> List[Any]:
        out: List[Any] = []
        for batch in self.iter_batches(batch_format="rows"):
            out.extend(batch)
            if len(out) >= k:
                return out[:k]
        return out

    def take_all(self) -> List[Any]:
        out: List[Any] = []
        for batch in self.iter_batches(batch_format="rows"):
            out.extend(batch)
        return out

    def count(self) -> int:
        return sum(BlockAccessor(ray_tpu_torch.get(r)).num_rows()
                   for r in self.iter_block_refs())

    def schema(self) -> Any:
        for ref in self.iter_block_refs(window=1):
            return BlockAccessor(ray_tpu_torch.get(ref)).schema()
        return None

    def num_blocks(self) -> int:
        n = 0
        for node in self._plan:
            if isinstance(node, _Read):
                n = len(node.sources)
            elif isinstance(node, _UnionNode):
                n = sum(Dataset._from_plan(p, "part").num_blocks()
                        for p in node.parts)
            elif isinstance(node, _ExchangeNode) and \
                    node.num_blocks_hint is not None:
                n = node.num_blocks_hint
        return n

    # ------------------------------------------------------------------
    # reorganization (lazy all-to-all exchanges)
    # ------------------------------------------------------------------
    def repartition(self, num_blocks: int) -> "Dataset":
        """Rebalance rows into num_blocks blocks (lazy barrier)."""

        @ray_tpu_torch.remote(num_returns="streaming")
        def _rechunk(refs, n):
            # refs ride inside a list arg so they arrive as refs (borrow-
            # accounted), not pre-resolved values.
            whole = concat_blocks([ray_tpu_torch.get(r) for r in refs])
            yield from _emit_chunks(BlockAccessor(whole), n)

        def exchange(refs: List[Any]) -> List[Any]:
            return list(_rechunk.remote(list(refs), num_blocks))

        return self._with_exchange(exchange, "repartition",
                                   num_blocks_hint=num_blocks)

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Global shuffle: permute all rows (lazy barrier; single-task
        permutation — fine at the block counts this framework targets per
        host; the reference's distributed shuffle service is multi-TB
        scale)."""
        n_blocks = max(1, self.num_blocks())

        @ray_tpu_torch.remote(num_returns="streaming")
        def _shuffle(refs, n, seed):
            rng = np.random.RandomState(seed)
            whole = concat_blocks([ray_tpu_torch.get(r) for r in refs])
            acc = BlockAccessor(whole)
            total = acc.num_rows()
            perm = rng.permutation(total)
            if isinstance(whole, dict):
                shuffled: Block = {k: v[perm] for k, v in whole.items()}
            else:
                rows = acc.to_rows()
                shuffled = [rows[i] for i in perm]
            yield from _emit_chunks(BlockAccessor(shuffled), n)

        def exchange(refs: List[Any]) -> List[Any]:
            return list(_shuffle.remote(list(refs), n_blocks, seed))

        return self._with_exchange(exchange, "random_shuffle",
                                   num_blocks_hint=n_blocks)

    def groupby(self, key: str, *,
                num_partitions: Optional[int] = None):
        """Group rows by a column via a distributed hash shuffle
        (reference: dataset.py:2688 groupby -> GroupedData). Aggregations
        and map_groups run one reducer task per partition."""
        from ray_tpu_torch.data.shuffle import GroupedData
        return GroupedData(self, key, num_partitions)

    def join(self, other: "Dataset", on: str, how: str = "inner", *,
             num_partitions: Optional[int] = None) -> "Dataset":
        """Distributed hash join with another dataset (reference:
        data/_internal/execution/operators/join.py; inner/left). Both
        sides co-partition by a process-stable key hash; right-side
        column collisions get a _right suffix."""
        from ray_tpu_torch.data.shuffle import join_datasets
        return join_datasets(self, other, on, how, num_partitions)

    def unique(self, column: str) -> List[Any]:
        """Distinct values of a column (reference: dataset.py unique)."""
        out = self.groupby(column).count().take_all()
        return [r[column] for r in out]

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenate datasets (reference: dataset.py union). Blocks of
        each input stream in order through a concat operator; transforms
        chained after the union apply to the concatenated stream."""
        parts = [list(self._plan)] + [list(o._plan) for o in others]
        return Dataset._from_plan([_UnionNode(parts)], name="union")

    def sort(self, key: str, *, descending: bool = False) -> "Dataset":
        """Global sort by a column (reference: dataset.py sort), STABLE
        in both directions (lazy barrier; single-task sort — fine at
        per-host block counts; the reference's distributed
        range-partition sort is multi-TB scale)."""
        n_blocks = max(1, self.num_blocks())

        @ray_tpu_torch.remote(num_returns="streaming")
        def _sorted(refs, n, key, descending):
            whole = concat_blocks([ray_tpu_torch.get(r) for r in refs])
            acc = BlockAccessor(whole)
            if isinstance(whole, dict):
                v = whole[key]
                if descending:
                    # Stable descending: argsort the negated RANK codes
                    # (reversing an ascending argsort would reverse ties).
                    _, inv = np.unique(v, return_inverse=True)
                    order = np.argsort(-inv, kind="stable")
                else:
                    order = np.argsort(v, kind="stable")
                out: Block = {k: col[order] for k, col in whole.items()}
            else:
                out = sorted(acc.to_rows(),
                             key=lambda r: r[key], reverse=descending)
            yield from _emit_chunks(BlockAccessor(out), n)

        def exchange(refs: List[Any]) -> List[Any]:
            return list(_sorted.remote(list(refs), n_blocks, key,
                                       descending))

        return self._with_exchange(exchange, "sort",
                                   num_blocks_hint=n_blocks)

    def split(self, n: int) -> List["Dataset"]:
        """Materialize and split into n datasets by whole blocks
        (reference: dataset.py split)."""
        mat = self.materialize()
        refs = mat._sources
        shards: List[List[Any]] = [[] for _ in _py_range(n)]
        for i, r in enumerate(refs):
            shards[i % n].append(r)
        return [Dataset(s, [], name=f"{self._name}(split{i})")
                for i, s in enumerate(shards)]

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None) -> List["DataIterator"]:
        """n per-consumer iterators over one shared streaming execution
        (reference: dataset.py:1826 streaming_split + output_splitter
        coordinated by a SplitCoordinator actor)."""
        from ray_tpu_torch.data.split import create_streaming_split
        return create_streaming_split(self, n, equal=equal)

    # ------------------------------------------------------------------
    # writers (reference: dataset.py write_parquet/write_csv/write_json
    # -> one output file per block, written by parallel tasks)
    # ------------------------------------------------------------------
    def _write(self, path: str, file_format: str,
               filename_prefix: str) -> List[str]:
        import os

        from ray_tpu_torch.data.datasource import write_block

        os.makedirs(path, exist_ok=True)

        @ray_tpu_torch.remote
        def _write_one(block, out_path):
            return write_block(block, out_path, file_format)

        refs = []
        for i, block_ref in enumerate(self.iter_block_refs()):
            out = os.path.join(
                path, f"{filename_prefix}-{i:05d}.{file_format}")
            refs.append(_write_one.remote(block_ref, out))
        return ray_tpu_torch.get(refs)

    def write_parquet(self, path: str, *,
                      filename_prefix: str = "part") -> List[str]:
        return self._write(path, "parquet", filename_prefix)

    def write_csv(self, path: str, *,
                  filename_prefix: str = "part") -> List[str]:
        return self._write(path, "csv", filename_prefix)

    def write_json(self, path: str, *,
                   filename_prefix: str = "part") -> List[str]:
        """JSON-lines, one file per block."""
        return self._write(path, "json", filename_prefix)

    def stats(self) -> Dict[str, Any]:
        """Plan shape + per-operator metrics of the most recent execution
        started from THIS dataset object (reference: Dataset.stats() /
        _internal/stats.py per-op counters)."""
        out: Dict[str, Any] = {
            "plan": [type(n).__name__ for n in self._plan]}
        ex = getattr(self, "_last_executor", None)
        if ex is not None:
            out["operators"] = {
                name: {"inputs": m.inputs_received,
                       "tasks_launched": m.tasks_launched,
                       "tasks_finished": m.tasks_finished,
                       "blocks_out": m.blocks_out}
                for name, m in ex.metrics().items()}
        return out

    def __repr__(self):
        return (f"Dataset(name={self._name!r}, "
                f"plan={[type(n).__name__ for n in self._plan]})")


def _emit_chunks(acc: "BlockAccessor", n: int):
    """Slice a block into ~n chunks (shared by repartition / shuffle /
    sort; handles the empty-block case)."""
    total = acc.num_rows()
    if total == 0:
        return
    per = max(1, (total + n - 1) // n)
    for lo in _py_range(0, total, per):
        yield acc.slice(lo, min(total, lo + per))


def _map_block_batches(block, call, batch_size, batch_format, kwargs):
    """One block -> transformed output batches (shared by the fused
    stage and the actor-compute worker so batching semantics can't
    diverge)."""
    from ray_tpu_torch.data.iterator import _format_batch
    acc = BlockAccessor(block)
    n = acc.num_rows()
    step = batch_size or n or 1
    for lo in _py_range(0, n, step):
        batch = acc.slice(lo, min(n, lo + step))
        yield call(_format_batch(batch, batch_format), **kwargs)


class _MapActor:
    """Pool worker for actor-compute map_batches (reference:
    _map_actor_context in map_operator actors)."""

    def __init__(self, fn_blob: bytes, ctor_args_blob: bytes,
                 batch_size: Optional[int], batch_format: str,
                 kwargs_blob: bytes):
        import cloudpickle
        fn = cloudpickle.loads(fn_blob)
        ctor_args = cloudpickle.loads(ctor_args_blob)
        self._kwargs = cloudpickle.loads(kwargs_blob)
        # A callable CLASS is constructed once per actor.
        self._callable = fn(*ctor_args) if isinstance(fn, type) else fn
        self._batch_size = batch_size
        self._batch_format = batch_format

    def apply(self, block):
        outs = list(_map_block_batches(block, self._callable,
                                       self._batch_size,
                                       self._batch_format, self._kwargs))
        return concat_blocks(outs) if len(outs) != 1 else outs[0]


class DataIterator:
    """Per-consumer iterator facade (reference: data/iterator.py:71).

    Wraps a block-ref iterable factory so iter_batches can be called
    multiple times where the underlying source allows it."""

    def __init__(self, ref_iter_factory: Callable[[], Iterator[Any]],
                 name: str = "iter"):
        self._factory = ref_iter_factory
        self._name = name

    def iter_block_refs(self) -> Iterator[Any]:
        return self._factory()

    def iter_batches(self, *, batch_size: Optional[int] = None,
                     batch_format: str = "numpy", prefetch_blocks: int = 2,
                     drop_last: bool = False) -> Iterator[Any]:
        return iter_batches_from_refs(
            self._factory(), batch_size=batch_size,
            batch_format=batch_format, prefetch_blocks=prefetch_blocks,
            drop_last=drop_last)

    def iter_torch_batches(self, *, batch_size: Optional[int] = None,
                           device: Any = None, ctx: Optional[Any] = None,
                           global_batch: bool = False, dtypes: Any = None,
                           prefetch_blocks: int = 2,
                           drop_last: bool = True
                           ) -> Iterator[Dict[str, Any]]:
        return iter_torch_batches_from_refs(
            self._factory(), batch_size=batch_size, device=device, ctx=ctx,
            global_batch=global_batch, dtypes=dtypes,
            prefetch_blocks=prefetch_blocks, drop_last=drop_last)

    def __repr__(self):
        return f"DataIterator({self._name})"


# ---------------------------------------------------------------------------
# constructors (reference: ray.data.range / from_items / read_*)
# ---------------------------------------------------------------------------

def range(n: int, *, num_blocks: Optional[int] = None) -> Dataset:  # noqa: A001
    return Dataset(_ds.range_read_tasks(n, num_blocks), name=f"range({n})")


def from_items(items: List[Any], *, num_blocks: int = 1) -> Dataset:
    return Dataset(_ds.items_read_tasks(list(items), num_blocks),
                   name="from_items")


def from_numpy(batch, *, num_blocks: int = 1) -> Dataset:
    if isinstance(batch, np.ndarray):
        batch = {"data": batch}
    return Dataset(_ds.numpy_read_tasks(batch, num_blocks),
                   name="from_numpy")


def from_blocks(blocks: List[Block]) -> Dataset:
    return Dataset([ray_tpu_torch.put(b) for b in blocks], name="from_blocks")


def read_parquet(paths, *, columns: Optional[List[str]] = None) -> Dataset:
    return Dataset(_ds.parquet_read_tasks(paths, columns),
                   name="read_parquet")


def read_csv(paths) -> Dataset:
    return Dataset(_ds.csv_read_tasks(paths), name="read_csv")


def read_json(paths) -> Dataset:
    return Dataset(_ds.json_read_tasks(paths), name="read_json")


def read_text(paths, *, encoding: str = "utf-8") -> Dataset:
    """One row per line, column "text" (reference: ray.data.read_text)."""
    return Dataset(_ds.text_read_tasks(paths, encoding=encoding),
                   name="read_text")


def read_binary_files(paths, *, include_paths: bool = False) -> Dataset:
    """One row per file, column "bytes" (reference:
    ray.data.read_binary_files)."""
    return Dataset(_ds.binary_read_tasks(paths,
                                         include_paths=include_paths),
                   name="read_binary_files")


def read_images(paths, *, size=None, mode: Optional[str] = None) -> Dataset:
    """One row per image, column "image" as [H, W, C] arrays (reference:
    ray.data.read_images; size=(w, h) resizes, mode converts e.g. "RGB")."""
    return Dataset(_ds.image_read_tasks(paths, size=size, mode=mode),
                   name="read_images")


def read_webdataset(paths, *, rows_per_block: int = 256,
                    decode: bool = True) -> Dataset:
    """Webdataset tar shards: one row per sample keyed by the dotted
    file-name prefix, columns per extension plus "__key__" (reference:
    ray.data.read_webdataset / _internal/datasource/
    webdataset_datasource.py). `decode=False` keeps raw bytes."""
    return Dataset(_ds.webdataset_read_tasks(
        paths, rows_per_block=rows_per_block, decode=decode),
        name="read_webdataset")


def read_lance(uri, *, columns: Optional[List[str]] = None) -> Dataset:
    """Lance dataset fragments (reference: ray.data.read_lance); needs
    the optional `lance` package."""
    return Dataset(_ds.lance_read_tasks(uri, columns=columns),
                   name="read_lance")
