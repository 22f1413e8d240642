"""Streaming executor: drives an operator-graph topology with per-op
budgets and backpressure.

Analogue of the reference's streaming execution core (reference:
python/ray/data/_internal/execution/streaming_executor.py:61 executor loop,
streaming_executor_state.py build_streaming_topology/select_operator_to_run/
process_completed_tasks, resource_manager.py:40 ResourceManager +
:363 ReservationOpResourceAllocator, backpressure_policy/
concurrency_cap_backpressure_policy.py). Redesigned pull-driven:

  * The CONSUMER drives the loop — each `next()` harvests completions,
    moves blocks downstream, and dispatches new work until an output
    block is available. No executor thread: when the consumer stalls,
    dispatch stops, in-flight generator tasks park on the runtime's
    per-task yield backpressure, and total in-flight memory stays at
    (per-op task budget x per-task window) blocks. A slow consumer
    therefore stalls the producers (the reference needs a thread +
    output-queue cap for the same property; here it falls out of the
    pull design).
  * Operator selection prefers the op CLOSEST TO THE SINK that can run
    (same drain-downstream-first policy as select_operator_to_run:
    finishing blocks frees memory before new blocks are created).
  * The ResourceManager splits a global in-flight task budget equally
    across task-launching ops (reservation), and lends unused slots to
    ops with queued work (the reservation allocator's shared pool).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ray_tpu_torch.data.operators import (AllToAllOperator, ConcatOperator,
                                          PhysicalOperator, SourceOperator)
from ray_tpu_torch.utils import get_logger

logger = get_logger("data.streaming_executor")

# Global in-flight task budget split across task-launching operators
# (reference: ReservationOpResourceAllocator's reservation ratio over the
# cluster resource budget; here BOTH a task-slot budget and a BYTE budget
# apply — slots bound cold-start concurrency, bytes bound steady-state
# memory once block sizes are observed).
DEFAULT_TASK_BUDGET = 8

# Per-edge queue cap: an op stops dispatching when this many of its output
# blocks sit undispatched in the downstream op's input queue (reference:
# OutputQueueSizeBackpressurePolicy).
DEFAULT_EDGE_QUEUE_CAP = 16


def _default_memory_budget() -> int:
    from ray_tpu_torch.utils.config import GlobalConfig
    b = GlobalConfig.data_memory_budget_bytes
    if b > 0:
        return b
    # A quarter of the local object store: leaves room for task args,
    # other datasets, and non-Data objects.
    return max(64 * 1024 * 1024,
               GlobalConfig.object_store_memory_bytes // 4)


class OpState:
    """Executor-side wiring for one operator."""

    def __init__(self, op: PhysicalOperator):
        self.op = op
        # (downstream OpState, branch index for ConcatOperator or None)
        self.downstream: Optional[Tuple["OpState", Optional[int]]] = None
        self.upstreams: List["OpState"] = []
        self.done_notified = False
        # Byte accounting for blocks queued at THIS op's input (sizes
        # parallel the op's input deque for launcher ops; Concat tracks
        # per-branch totals).
        self.in_sizes: deque = deque()
        self.in_bytes = 0
        self.branch_in_bytes: Dict[int, int] = {}
        self.branch_in_sizes: Dict[int, deque] = {}

    @property
    def name(self) -> str:
        return self.op.name


class ResourceManager:
    """Task-slot budgeting + queue backpressure across operators
    (reference: resource_manager.py ReservationOpResourceAllocator +
    backpressure policies). Each task-launching op holds a reserved share
    of the global budget; the remainder is a shared pool any op may
    borrow from. An op's output edge blocks when the downstream input
    queue exceeds the edge cap."""

    def __init__(self, ops: List[OpState], budget: int = DEFAULT_TASK_BUDGET,
                 edge_queue_cap: int = DEFAULT_EDGE_QUEUE_CAP,
                 memory_budget: Optional[int] = None):
        self.budget = max(1, budget)
        self.edge_queue_cap = edge_queue_cap
        self.memory_budget = (memory_budget if memory_budget is not None
                              else _default_memory_budget())
        # Barrier (AllToAll) ops run driver-side outside the slot budget,
        # so they neither reserve nor consume shares.
        self._launchers = [
            s for s in ops
            if not isinstance(s.op, (SourceOperator, ConcatOperator,
                                     AllToAllOperator))]
        n = max(1, len(self._launchers))
        self._reserved = max(1, self.budget // n)
        self._shared_pool = max(0, self.budget - self._reserved * n)
        # Byte budget split the same way: each launcher owns a reserved
        # share; the remainder is a shared pool (reference:
        # resource_manager.py:363 ReservationOpResourceAllocator, whose
        # core abstraction is MEMORY — slot budgets alone cannot prevent
        # OOM when block sizes vary 10x between ops).
        self._mem_reserved = max(1, self.memory_budget // n)
        self._mem_shared = max(0, self.memory_budget
                               - self._mem_reserved * n)
        self.peak_mem_used = 0
        self._sink_bytes_fn = lambda: 0  # wired by the executor

    # Pessimistic per-task output estimate until the op's first task
    # finishes (the reference similarly charges an assumed block size
    # before sizes are observed — a zero cold estimate would let the
    # full slot budget launch before the byte budget could engage).
    COLD_TASK_BYTES = 2 * 1024 * 1024

    @classmethod
    def _est_task_bytes(cls, state: OpState) -> int:
        """Expected output bytes of ONE task of this op, from observed
        blocks (pessimistic constant until the first task finishes)."""
        m = state.op.metrics
        if m.tasks_finished <= 0:
            return cls.COLD_TASK_BYTES
        return m.bytes_out_estimate // m.tasks_finished

    def _mem_used(self, state: OpState) -> int:
        """Bytes attributable to this op: its unconsumed output blocks
        (queued at the downstream input / executor sink) plus the
        expected output of its in-flight tasks."""
        down = state.downstream
        if down is None:
            queued = self._sink_bytes_fn()
        else:
            target, branch = down
            queued = (target.branch_in_bytes.get(branch, 0)
                      if branch is not None else target.in_bytes)
        return queued + state.op.num_active_tasks() \
            * self._est_task_bytes(state)

    def mem_usage(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self._launchers:  # diagnostic view; names may repeat
            out[s.name] = out.get(s.name, 0) + self._mem_used(s)
        return out

    def can_launch(self, state: OpState) -> bool:
        op = state.op
        if isinstance(op, AllToAllOperator):
            return True  # barrier op: runs once, driver-side
        actives = [s.op.num_active_tasks() for s in self._launchers]
        if sum(actives) >= self.budget:
            return False  # absolute cap — borrows never exceed the budget
        if op.num_active_tasks() >= self._reserved:
            shared_used = sum(max(0, a - self._reserved) for a in actives)
            if shared_used >= self._shared_pool:
                return False
        # Byte budget: would this launch push the op past its memory
        # allowance (reserved share, then the shared byte pool)?
        est = self._est_task_bytes(state)
        # Keyed by OpState IDENTITY: op names are not unique (every
        # union branch is "read->map"), and a name collision would let
        # same-named ops alias one ledger entry and overrun the budget.
        used = {id(s): self._mem_used(s) for s in self._launchers}
        total = sum(used.values())
        self.peak_mem_used = max(self.peak_mem_used, total)
        mine = used.get(id(state), 0)
        if mine + est > self._mem_reserved:
            # Progress guarantee: an op with NOTHING in flight and
            # nothing queued may always launch one task, even when a
            # single task's estimate exceeds its whole allowance —
            # otherwise an oversized block (or a budget below the cold
            # estimate) would wedge the pipeline forever.
            if op.num_active_tasks() == 0 and mine == 0:
                return True
            mem_shared_used = sum(max(0, u - self._mem_reserved)
                                  for u in used.values())
            if mem_shared_used + est > self._mem_shared:
                return False
        return True

    def output_blocked(self, state: OpState, sink_queue_len: int) -> bool:
        down = state.downstream
        if down is None:
            # Sink edge: bounded by the executor's output buffer (the
            # pull-driven consumer usually keeps this at ~0).
            return sink_queue_len >= self.edge_queue_cap
        target, branch = down
        if branch is not None and isinstance(target.op, ConcatOperator):
            queued = len(target.op._branch_queues[branch])
        else:
            queued = target.op.num_queued_inputs()
        return queued >= self.edge_queue_cap


class StreamingExecutor:
    """Executes a topology (list of OpStates in topological order, the
    last being the sink) as a pull-driven block-ref iterator."""

    def __init__(self, states: List[OpState],
                 task_budget: int = DEFAULT_TASK_BUDGET,
                 edge_queue_cap: int = DEFAULT_EDGE_QUEUE_CAP,
                 memory_budget: Optional[int] = None):
        self._states = states
        self._sink = states[-1]
        assert self._sink.downstream is None
        self._rm = ResourceManager(states, task_budget, edge_queue_cap,
                                   memory_budget)
        self._out_queue: deque = deque()
        self._out_bytes = 0
        self._out_sizes: deque = deque()
        self._rm._sink_bytes_fn = lambda: self._out_bytes
        self._started = False
        self._shut = False

    # -- public ---------------------------------------------------------
    def run(self) -> Iterator[Any]:
        try:
            while True:
                ref = self._next_output()
                if ref is _DONE:
                    return
                yield ref
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        if self._shut:
            return
        self._shut = True
        for s in self._states:
            try:
                s.op.shutdown()
            except Exception:
                logger.debug("shutdown of %s failed", s.name, exc_info=True)

    def metrics(self) -> Dict[str, Any]:
        return {s.name: s.op.metrics for s in self._states}

    # -- internals ------------------------------------------------------
    def _pop_output(self):
        self._out_bytes -= self._out_sizes.popleft() if self._out_sizes \
            else 0
        return self._out_queue.popleft()

    def _next_output(self):
        if not self._started:
            self._started = True
            for s in self._states:
                s.op.start()
        while True:
            if self._out_queue:
                return self._pop_output()
            progressed = self._step()
            if self._out_queue:
                return self._pop_output()
            if self._all_done():
                return _DONE
            if not progressed:
                self._wait_for_progress()

    def _step(self) -> bool:
        """One scheduling pass: harvest + route + dispatch. Returns True
        if anything moved."""
        progressed = False

        # 1. Harvest completions and route blocks downstream, sink-first
        #    (freeing downstream capacity before upstream produces more).
        for s in reversed(self._states):
            outs = s.op.poll()
            if outs:
                progressed = True
                for ref in outs:
                    self._route(s, ref)
            # Propagate upstream-exhaustion exactly once.
            if s.op.completed() and not s.done_notified:
                s.done_notified = True
                progressed = True
                self._notify_done(s)

        # 2. Dispatch: pick ops that can run, closest-to-sink first.
        for s in reversed(self._states):
            while (s.op.can_dispatch()
                   and self._rm.can_launch(s)
                   and not self._rm.output_blocked(s, len(self._out_queue))):
                before = s.op.num_queued_inputs()
                if not s.op.dispatch():
                    break
                # The op consumed inputs: retire their tracked sizes
                # (launcher ops pop exactly one per dispatch; barrier
                # ops drain in bulk inside poll and resync below).
                consumed = before - s.op.num_queued_inputs()
                for _ in range(consumed):
                    if s.in_sizes:
                        s.in_bytes -= s.in_sizes.popleft()
                progressed = True
        # Non-launcher ops (AllToAll/Concat) consume inputs inside
        # poll(): resync their byte ledgers to the surviving queues.
        for s in self._states:
            if s.in_sizes and isinstance(s.op, AllToAllOperator):
                q = s.op.num_queued_inputs()
                while len(s.in_sizes) > q:
                    s.in_bytes -= s.in_sizes.popleft()
            if s.branch_in_sizes and isinstance(s.op, ConcatOperator):
                for b, sizes in s.branch_in_sizes.items():
                    q = len(s.op._branch_queues[b])
                    while len(sizes) > q:
                        s.branch_in_bytes[b] -= sizes.popleft()
        return progressed

    @staticmethod
    def _size_of(ref: Any) -> int:
        """Byte size of a block ref from the owner's ledger (0 for
        non-ref items such as pickled read callables)."""
        try:
            from ray_tpu_torch.core.ref import ObjectRef, get_core_worker
            if not isinstance(ref, ObjectRef):
                return 0
            e = get_core_worker().objects.get(ref.binary())
            return int(e.size or 0) if e is not None else 0
        except Exception:
            return 0

    def _route(self, s: OpState, ref: Any) -> None:
        size = self._size_of(ref)
        s.op.metrics.bytes_out_estimate += size
        down = s.downstream
        if down is None:
            self._out_queue.append(ref)
            self._out_sizes.append(size)
            self._out_bytes += size
            return
        target, branch = down
        if branch is not None:
            assert isinstance(target.op, ConcatOperator)
            target.op.add_branch_input(branch, ref)
            target.branch_in_bytes[branch] = \
                target.branch_in_bytes.get(branch, 0) + size
            target.branch_in_sizes.setdefault(branch, deque()).append(size)
        else:
            target.op.add_input(ref)
            target.in_sizes.append(size)
            target.in_bytes += size

    def _notify_done(self, s: OpState) -> None:
        down = s.downstream
        if down is None:
            return
        target, branch = down
        if branch is not None:
            assert isinstance(target.op, ConcatOperator)
            target.op.branch_done(branch)
        else:
            # Multi-upstream non-concat target: done only when ALL
            # upstreams are done.
            if all(u.done_notified for u in target.upstreams):
                target.op.all_inputs_done()

    def _all_done(self) -> bool:
        return not self._out_queue \
            and all(s.op.completed() for s in self._states)

    def _wait_for_progress(self, timeout: float = 0.05) -> None:
        """Nothing moved and nothing ready: park on the busiest op."""
        for s in reversed(self._states):
            if s.op.num_active_tasks():
                s.op.wait_any(timeout)
                return
        import time
        time.sleep(0.005)


class _Done:
    pass


_DONE = _Done()


def execute_topology(states: List[OpState],
                     task_budget: int = DEFAULT_TASK_BUDGET,
                     edge_queue_cap: int = DEFAULT_EDGE_QUEUE_CAP
                     ) -> Iterator[Any]:
    ex = StreamingExecutor(states, task_budget, edge_queue_cap)
    return ex.run()
