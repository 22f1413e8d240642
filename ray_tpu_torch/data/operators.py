"""Physical operators for the Data streaming executor.

Analogue of the reference's execution operators (reference:
python/ray/data/_internal/execution/operators/map_operator.py,
actor_pool_map_operator.py, base_physical_operator.py AllToAllOperator,
output_splitter.py; interfaces in execution/interfaces/physical_operator.py).
Redesigned around this runtime's primitives:

  * Map work runs as STREAMING GENERATOR tasks (one per input item) whose
    per-task output window is bounded by the runtime's generator
    backpressure — an operator's memory footprint is therefore
    (active tasks x backpressure window) blocks, both factors bounded by
    the executor's resource manager.
  * Operators are PULL-polled by the executor loop (no operator threads):
    `poll()` harvests whatever finished without blocking, `dispatch()`
    launches at most one unit of work. All scheduling policy (budgets,
    backpressure, priority) lives in the executor, not the operators.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.core.common import GetTimeoutError
from ray_tpu_torch.utils import get_logger

logger = get_logger("data.operators")


class OpMetrics:
    """Per-operator counters the resource manager and tests read."""

    def __init__(self) -> None:
        self.inputs_received = 0
        self.tasks_launched = 0
        self.tasks_finished = 0
        self.blocks_out = 0
        self.bytes_out_estimate = 0

    def __repr__(self) -> str:
        return (f"OpMetrics(in={self.inputs_received}, "
                f"tasks={self.tasks_launched}/{self.tasks_finished}, "
                f"blocks_out={self.blocks_out})")


class PhysicalOperator:
    """Base operator: the executor pushes inputs in, polls outputs out.

    Lifecycle: start() -> {add_input()* , dispatch()*, poll()*} ->
    all_inputs_done() -> (drain) -> completed() -> shutdown().
    """

    def __init__(self, name: str):
        self.name = name
        self.metrics = OpMetrics()
        self._input_queue: deque = deque()
        self._inputs_done = False

    # -- input side (executor calls) -----------------------------------
    def add_input(self, item: Any) -> None:
        self.metrics.inputs_received += 1
        self._input_queue.append(item)

    def all_inputs_done(self) -> None:
        self._inputs_done = True

    def num_queued_inputs(self) -> int:
        return len(self._input_queue)

    # -- work side ------------------------------------------------------
    def start(self) -> None:
        pass

    def can_dispatch(self) -> bool:
        """True if a dispatch() call would launch work right now."""
        return bool(self._input_queue)

    def dispatch(self) -> bool:
        """Launch at most ONE unit of work (a task / an actor call).
        Returns True if something was launched."""
        return False

    def num_active_tasks(self) -> int:
        return 0

    def poll(self) -> List[Any]:
        """Harvest finished work WITHOUT blocking; returns output block
        refs in operator order."""
        return []

    def wait_any(self, timeout: float) -> None:
        """Block up to `timeout` for progress (executor idle path)."""
        import time
        time.sleep(timeout)

    def completed(self) -> bool:
        return (self._inputs_done and not self._input_queue
                and self.num_active_tasks() == 0)

    def shutdown(self) -> None:
        pass


class SourceOperator(PhysicalOperator):
    """Emits a fixed list of source items (materialized block refs or
    pickled read callables). The no-op head of every topology (reference:
    InputDataBuffer)."""

    def __init__(self, sources: List[Any], name: str = "input"):
        super().__init__(name)
        for s in sources:
            self._input_queue.append(s)
        self.metrics.inputs_received = len(sources)
        self._inputs_done = True

    def poll(self) -> List[Any]:
        out = list(self._input_queue)
        self._input_queue.clear()
        self.metrics.blocks_out += len(out)
        return out


class _StreamHandle:
    """One in-flight streaming task: non-blocking harvest of its yielded
    refs via next_stream_item(timeout=0), staged locally so EVERY
    stream's backpressure window keeps rolling even while output order
    holds emission to the head stream."""

    __slots__ = ("gen", "idx", "done", "staged")

    def __init__(self, gen):
        self.gen = gen          # ObjectRefGenerator
        self.idx = 0
        self.done = False
        self.staged: deque = deque()

    def drain(self, limit: int) -> int:
        """Pull up to `limit` ready items into the staging queue; returns
        the number pulled."""
        from ray_tpu_torch.core.ref import get_core_worker
        cw = get_core_worker()
        pulled = 0
        while not self.done and pulled < limit:
            try:
                ref = cw.next_stream_item(self.gen.task_id, self.idx,
                                          timeout=0)
            except GetTimeoutError:
                break
            if ref is None:
                self.done = True
                break
            self.idx += 1
            self.staged.append(ref)
            pulled += 1
        return pulled

    def wait(self, timeout: float) -> None:
        from ray_tpu_torch.core.ref import get_core_worker
        # Peek-wait: park until item `idx` is ready without consuming it.
        get_core_worker().wait_stream_item(self.gen.task_id, self.idx,
                                           timeout)


class MapTaskOperator(PhysicalOperator):
    """Fused map chain as streaming tasks: one task per input item
    (reference: MapOperator via TaskPoolMapOperator + the fusion rule).

    Input items are materialized block refs OR pickled zero-arg read
    callables; the task body applies the fused stage chain and yields
    output blocks (executor.py _source_task_fn).
    """

    def __init__(self, stages: List[Callable], name: str = "map",
                 resources: Optional[dict] = None):
        super().__init__(name)
        import cloudpickle
        self._stages_blob = cloudpickle.dumps(list(stages))
        self._resources = resources
        self._streams: deque[_StreamHandle] = deque()
        self._remote_fn = None

    def start(self) -> None:
        from ray_tpu_torch.data.executor import _source_task_fn
        fn = ray_tpu_torch.remote(num_returns="streaming")(_source_task_fn)
        if self._resources:
            fn = fn.options(resources=self._resources)
        self._remote_fn = fn

    def dispatch(self) -> bool:
        if not self._input_queue:
            return False
        item = self._input_queue.popleft()
        gen = self._remote_fn.remote(item, self._stages_blob)
        self._streams.append(_StreamHandle(gen))
        self.metrics.tasks_launched += 1
        return True

    def num_active_tasks(self) -> int:
        return len(self._streams)

    # Per-stream staging bound: keeps output order without re-parking a
    # stream the instant its runtime backpressure window frees up.
    _STAGE_LIMIT = 16

    def poll(self) -> List[Any]:
        """Drain EVERY in-flight stream into its staging queue (so all
        backpressure windows roll), then emit staged items in stream
        order (output order = input order)."""
        out: List[Any] = []
        for h in self._streams:
            h.drain(self._STAGE_LIMIT - len(h.staged))
        while self._streams:
            head = self._streams[0]
            while head.staged:
                out.append(head.staged.popleft())
            if head.done:
                self._streams.popleft()
                self.metrics.tasks_finished += 1
            else:
                break
        self.metrics.blocks_out += len(out)
        return out

    def wait_any(self, timeout: float) -> None:
        if self._streams:
            self._streams[0].wait(timeout)
        else:
            super().wait_any(timeout)

    def shutdown(self) -> None:
        for h in self._streams:
            try:
                h.gen.release()
            except Exception:
                pass
        self._streams.clear()


class ActorPoolMapOperator(PhysicalOperator):
    """Map via a pool of long-lived actors — for callable-class
    transforms that carry per-worker state (reference:
    actor_pool_map_operator.py + _ActorPool).

    Output order preserved: results are queued per-dispatch and yielded
    head-first once ready. Dispatch targets the least-loaded actor.
    """

    def __init__(self, fn, ctor_args: tuple, fn_kwargs: dict,
                 batch_size: Optional[int], batch_format: str,
                 pool_size: int, name: str = "map(actors)",
                 max_inflight_per_actor: int = 2,
                 resources: Optional[dict] = None):
        super().__init__(name)
        import cloudpickle
        self._fn_blob = cloudpickle.dumps(fn)
        self._ctor_blob = cloudpickle.dumps(ctor_args)
        self._kwargs_blob = cloudpickle.dumps(fn_kwargs)
        self._actor_resources = dict(resources or {})
        self._batch_size = batch_size
        self._batch_format = batch_format
        self._pool_size = pool_size
        self._max_inflight = max_inflight_per_actor
        self._actors: List[Any] = []
        self._actor_load: List[int] = []
        # [ref, actor_idx, ready] in dispatch order (output order).
        self._inflight: deque = deque()

    def start(self) -> None:
        from ray_tpu_torch.data.dataset import _MapActor
        actor_cls = ray_tpu_torch.remote(_MapActor)
        if self._actor_resources:
            # Pool actors with device/resource requests (e.g. one GPU
            # per batch-inference engine — reference: map_batches
            # num_gpus/resources options).
            res = dict(self._actor_resources)
            opts = {}
            if "CPU" in res:
                opts["num_cpus"] = res.pop("CPU")
            if "GPU" in res:
                opts["num_gpus"] = res.pop("GPU")
            if res:
                opts["resources"] = res
            actor_cls = actor_cls.options(**opts)
        self._actors = [
            actor_cls.remote(self._fn_blob, self._ctor_blob,
                             self._batch_size, self._batch_format,
                             self._kwargs_blob)
            for _ in range(self._pool_size)]
        self._actor_load = [0] * self._pool_size

    def can_dispatch(self) -> bool:
        return (bool(self._input_queue)
                and len(self._inflight) < self._pool_size * self._max_inflight)

    def dispatch(self) -> bool:
        if not self.can_dispatch():
            return False
        item = self._input_queue.popleft()
        ai = min(range(len(self._actors)), key=lambda i: self._actor_load[i])
        ref = self._actors[ai].apply.remote(item)
        self._actor_load[ai] += 1
        self._inflight.append([ref, ai, False])
        self.metrics.tasks_launched += 1
        return True

    def num_active_tasks(self) -> int:
        return len(self._inflight)

    def poll(self) -> List[Any]:
        # Readiness scan over ALL in-flight entries (not just the head):
        # load accounting must see completions behind a straggling head or
        # least-loaded dispatch piles onto the slow actor.
        for entry in self._inflight:
            if not entry[2]:
                ready, _ = ray_tpu_torch.wait([entry[0]], num_returns=1, timeout=0)
                if ready:
                    entry[2] = True
                    self._actor_load[entry[1]] -= 1
                    self.metrics.tasks_finished += 1
        out: List[Any] = []
        while self._inflight and self._inflight[0][2]:
            out.append(self._inflight.popleft()[0])
        self.metrics.blocks_out += len(out)
        return out

    def wait_any(self, timeout: float) -> None:
        if self._inflight:
            ray_tpu_torch.wait([self._inflight[0][0]], num_returns=1,
                         timeout=timeout)
        else:
            super().wait_any(timeout)

    def completed(self) -> bool:
        return (self._inputs_done and not self._input_queue
                and not self._inflight)

    def shutdown(self) -> None:
        # poll() only emits SEALED results (ray_tpu_torch.wait said ready), so
        # killing the pool never invalidates refs already handed
        # downstream; in-flight work (early abandonment via take(k))
        # dies with the actors.
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._actors = []


class AllToAllOperator(PhysicalOperator):
    """Barrier operator: collects EVERY input ref, then runs a driver-side
    exchange function refs -> refs (hash shuffle, sort, repartition)
    (reference: base_physical_operator.py AllToAllOperator; the exchange
    fns themselves stay the two-wave task pipelines in shuffle.py).

    The exchange runs on a worker THREAD launched by dispatch() — the
    exchange fns block on their barrier task waves, and running them on
    the executor loop would stall harvesting/dispatch for every
    independent operator (e.g. the other branch of a union) while the
    barrier runs. Driver API calls are thread-safe (the core worker
    marshals them onto its IO loop)."""

    def __init__(self, exchange_fn: Callable[[List[Any]], List[Any]],
                 name: str = "all_to_all"):
        super().__init__(name)
        self._exchange_fn = exchange_fn
        self._collected: List[Any] = []
        self._emitted = False
        self._thread = None
        self._result: Optional[List[Any]] = None
        self._error: Optional[BaseException] = None

    def can_dispatch(self) -> bool:
        # Runs exactly once, only after the full input set arrived.
        return (self._inputs_done and not self._emitted
                and self._thread is None)

    def dispatch(self) -> bool:
        if not self.can_dispatch():
            return False
        import threading
        self._collected.extend(self._input_queue)
        self._input_queue.clear()

        def _run():
            try:
                self._result = list(self._exchange_fn(self._collected))
            except BaseException as e:  # surfaced from poll()
                self._error = e

        self._thread = threading.Thread(
            target=_run, name=f"data-{self.name}", daemon=True)
        self._thread.start()
        self.metrics.tasks_launched += 1
        return True

    def num_active_tasks(self) -> int:
        return 1 if (self._thread is not None
                     and not self._emitted) else 0

    def poll(self) -> List[Any]:
        if self._thread is None:
            # keep collecting as inputs stream in
            self._collected.extend(self._input_queue)
            self._input_queue.clear()
            return []
        if self._thread.is_alive():
            return []
        self._thread.join()
        if self._error is not None:
            err, self._error = self._error, None
            self._emitted = True
            raise err
        if self._emitted:
            return []
        out = self._result or []
        self._result = None
        self._collected = []
        self._emitted = True
        self.metrics.tasks_finished += 1
        self.metrics.blocks_out += len(out)
        return out

    def wait_any(self, timeout: float) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout)
        else:
            super().wait_any(timeout)

    def completed(self) -> bool:
        return self._emitted


class ConcatOperator(PhysicalOperator):
    """Union glue: forwards branch outputs in branch order (reference:
    union is a logical concat of input streams). The executor wires every
    branch's sink here; branch i+1's blocks are held until branch i is
    exhausted so output order matches the union order."""

    def __init__(self, num_branches: int, name: str = "union"):
        super().__init__(name)
        self._branch_queues: List[deque] = [deque()
                                            for _ in range(num_branches)]
        self._branch_done = [False] * num_branches
        self._next_branch = 0

    def add_branch_input(self, branch: int, item: Any) -> None:
        self.metrics.inputs_received += 1
        self._branch_queues[branch].append(item)

    def branch_done(self, branch: int) -> None:
        self._branch_done[branch] = True

    def poll(self) -> List[Any]:
        out: List[Any] = []
        while self._next_branch < len(self._branch_queues):
            q = self._branch_queues[self._next_branch]
            while q:
                out.append(q.popleft())
            if self._branch_done[self._next_branch]:
                self._next_branch += 1
            else:
                break
        self.metrics.blocks_out += len(out)
        return out

    def completed(self) -> bool:
        return self._next_branch >= len(self._branch_queues)
