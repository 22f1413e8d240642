"""Fused map task bodies for the Data streaming executor.

The planner (dataset.py _build_states) fuses every chain of row/batch
transforms into ONE streaming task per source block (the reference's
MapOperator fusion rule — reference:
python/ray/data/_internal/logical/rules/operator_fusion.py — taken to its
limit); this module holds the task-side machinery those fused tasks run.
The executor loop, operators, and backpressure live in
streaming_executor.py / operators.py.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List

# A stage maps one block to zero or more output blocks.
Stage = Callable[[Any], Iterator[Any]]


def apply_stages(block: Any, stages: List[Stage]) -> Iterator[Any]:
    """Run the fused stage chain over one block (executes inside a task)."""
    if not stages:
        yield block
        return
    head, rest = stages[0], stages[1:]
    for out in head(block):
        yield from apply_stages(out, rest)


def _source_task_fn(source, stages_blob: bytes):
    """Body of one fused streaming source task: read -> stages -> yield.

    `source` arrives as either a pickled read callable (bytes) or the
    BLOCK VALUE itself: a materialized ObjectRef source is passed as a real
    task arg (so borrow accounting pins it) and the runtime resolves ref
    args to values before execution.
    """
    import cloudpickle as cp

    stages = cp.loads(stages_blob)
    if isinstance(source, (bytes, bytearray)):
        blocks: Iterator[Any] = cp.loads(source)()  # read callable
    else:
        blocks = iter([source])  # already-resolved materialized block
    for block in blocks:
        yield from apply_stages(block, stages)
