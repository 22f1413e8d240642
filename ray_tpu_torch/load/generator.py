"""Open-loop load generator: submit on schedule, complete on the side.

The submitter thread walks the pre-generated arrival schedule and fires
each request at its scheduled instant, whether or not earlier requests
have completed — the open-loop discipline (reference contrast: a
closed-loop driver waits for responses and so measures its own
backpressure, masking queue collapse; see also the coordinated-omission
trap). Completions are collected by a separate waiter pool, and latency
is measured from the SCHEDULED arrival time, not the submit time, so a
stalled submitter cannot hide queueing delay either.

Workloads implement a 3-call protocol (plus optional teardown):

    setup()               spin up actors/deployments, run one warmup
    submit(size) -> h     non-blocking dispatch of one request
    wait(h, timeout)      block until that request completes (raises on
                          failure; the waiter pool calls this)
    teardown()            optional: release driver-process globals the
                          workload planted (the soak runs inside the
                          caller's interpreter — e.g. under pytest —
                          so leaked module state outlives the cluster)

Three production-shaped workloads drive the three user-facing planes
concurrently: Serve inference (deployment handle), Data ingest
(put + remote transform), Train stepping with periodic checkpoints
(restartable actor that restores from the latest checkpoint).
"""

from __future__ import annotations

import math
import queue
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from ray_tpu_torch.load.arrivals import Arrival


@dataclass
class Request:
    """One request's life: scheduled -> submitted -> done."""
    t_sched: float            # scheduled arrival offset, s from t0
    size: int                 # payload bytes
    t_submit: float = math.nan  # actual submit offset, s from t0
    t_done: float = math.nan    # completion offset, s from t0
    ok: bool = False
    err: str = ""

    @property
    def latency_s(self) -> float:
        """Open-loop latency: completion minus SCHEDULED arrival."""
        return self.t_done - self.t_sched


class OpenLoopRunner:
    """Drives one workload through one arrival schedule.

    One submitter thread (never blocks on responses) + `waiters`
    completion threads. The unbounded handoff queue is the point: if
    the cluster falls behind, requests pile up here and their measured
    latency grows — they are not silently deferred."""

    def __init__(self, workload, schedule: List[Arrival],
                 timeout_s: float = 30.0, waiters: int = 4):
        self.workload = workload
        self.schedule = schedule
        self.timeout_s = timeout_s
        self.requests: List[Request] = [Request(a.t_s, a.size)
                                        for a in schedule]
        self._q: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._n_waiters = max(1, waiters)
        self._done = threading.Event()

    # -- submit side ----------------------------------------------------
    def _submit_loop(self, t0: float) -> None:
        for rec in self.requests:
            now = time.monotonic() - t0
            if rec.t_sched > now:
                time.sleep(rec.t_sched - now)
            rec.t_submit = time.monotonic() - t0
            try:
                handle = self.workload.submit(rec.size)
            except Exception as e:
                rec.t_done = time.monotonic() - t0
                rec.err = f"submit: {e!r}"
                continue
            self._q.put((rec, handle))
        for _ in range(self._n_waiters):
            self._q.put(None)  # poison pills

    # -- completion side ------------------------------------------------
    def _wait_loop(self, t0: float) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            rec, handle = item
            try:
                self.workload.wait(handle, self.timeout_s)
                rec.ok = True
            except Exception as e:
                rec.err = repr(e)
            rec.t_done = time.monotonic() - t0

    def start(self, t0: float) -> None:
        name = getattr(self.workload, "name", "load")
        sub = threading.Thread(target=self._run, args=(t0,),
                               name=f"soak-{name}", daemon=True)
        self._threads.append(sub)
        sub.start()

    def _run(self, t0: float) -> None:
        waiters = [threading.Thread(target=self._wait_loop, args=(t0,),
                                    name=f"soak-wait-{i}", daemon=True)
                   for i in range(self._n_waiters)]
        for w in waiters:
            w.start()
        self._submit_loop(t0)
        for w in waiters:
            w.join()
        self._done.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)


def summarize(name: str, requests: List[Request],
              duration_s: float) -> dict:
    """Per-workload roll-up: offered vs achieved rate, open-loop
    latency percentiles over successes, error/timeout fractions."""
    n = len(requests)
    ok = [r for r in requests if r.ok]
    lat = sorted(r.latency_s for r in ok if not math.isnan(r.t_done))

    def pct(q: float) -> float:
        if not lat:
            return math.nan
        return lat[min(len(lat) - 1, int(q * len(lat)))]

    timeouts = sum(1 for r in requests
                   if not r.ok and "Timeout" in r.err)
    return {
        "workload": name,
        "requests": n,
        "completed": len(ok),
        "offered_hz": round(n / duration_s, 3) if duration_s else 0.0,
        "achieved_hz": round(len(ok) / duration_s, 3)
        if duration_s else 0.0,
        "p50_ms": round(pct(0.50) * 1e3, 2),
        "p99_ms": round(pct(0.99) * 1e3, 2),
        "error_frac": round((n - len(ok)) / n, 4) if n else 0.0,
        "timeout_frac": round(timeouts / n, 4) if n else 0.0,
        "bytes_total": sum(r.size for r in requests),
    }


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

@dataclass
class WorkloadCtx:
    """Shared bits handed to every workload at setup."""
    run_dir: str = ""
    seed: int = 0


class ServeWorkload:
    """Serve inference: a 2-replica echo deployment; each request ships
    `size` payload bytes through the router and back. Replica death is
    serve's to heal (health pass + reconcile); the handle re-routes
    once on a dead replica."""

    name = "serve"

    def __init__(self, num_replicas: int = 2):
        self.num_replicas = num_replicas
        self._handle = None

    def setup(self, ctx: WorkloadCtx) -> None:
        import ray_tpu_torch.serve as serve

        @serve.deployment(num_replicas=self.num_replicas)
        class LoadEcho:
            async def __call__(self, payload: bytes) -> int:
                # Print -> graftlog task-attributed row -> the chaos
                # scheduler can target this replica and the salvage
                # verdict gets a crash tail to recover.
                print(f"serve echo {len(payload)}B")
                return len(payload)

        self._handle = serve.run(LoadEcho.bind(), name="load_echo")
        # Warmup: one request end-to-end before the load clock starts.
        assert self._handle.remote(b"x").result(timeout=60.0) == 1

    def submit(self, size: int):
        return self._handle.remote(b"\x5a" * size)

    def wait(self, handle, timeout: float) -> None:
        handle.result(timeout=timeout)

    def teardown(self) -> None:
        # serve caches its controller handle at module scope; left in
        # place it points the NEXT cluster in this interpreter at a
        # dead actor.
        import ray_tpu_torch.serve as serve
        serve.shutdown()


class DataWorkload:
    """Data ingest: put a payload block into the object store, then a
    remote transform consumes it (the classic ingest shape: producer
    puts, tasks map). Task retries absorb worker kills."""

    name = "data"

    def __init__(self):
        self._ingest = None

    def setup(self, ctx: WorkloadCtx) -> None:
        import ray_tpu_torch

        @ray_tpu_torch.remote(max_retries=4)
        def load_ingest(block: bytes) -> int:
            # The print makes every ingest task a chaos-targetable,
            # salvage-verifiable graftlog producer; the strided sum
            # materialises the block on the consumer.
            print(f"ingest {len(block)}B")
            return sum(block[:: max(1, len(block) // 64)])

        self._ingest = load_ingest
        ray_tpu_torch.get(self._ingest.remote(b"warmup"), timeout=60.0)

    def submit(self, size: int):
        import ray_tpu_torch
        ref = ray_tpu_torch.put(b"\xa5" * size)
        return self._ingest.remote(ref)

    def wait(self, handle, timeout: float) -> None:
        import ray_tpu_torch
        ray_tpu_torch.get(handle, timeout=timeout)


class TrainWorkload:
    """Train stepping: a restartable trainer actor steps a small numpy
    model and checkpoints every `ckpt_every` steps via the real
    checkpointing path. On restart (max_restarts) the actor restores
    from the latest committed checkpoint — chaos kills exercise the
    resume path the soak verdict then audits."""

    name = "train"

    def __init__(self, ckpt_every: int = 5):
        self.ckpt_every = ckpt_every
        self._actor = None

    def setup(self, ctx: WorkloadCtx) -> None:
        import ray_tpu_torch

        @ray_tpu_torch.remote(max_restarts=4, max_task_retries=4)
        class LoadTrainer:
            def __init__(self, run_dir: str, ckpt_every: int):
                import numpy as np
                self.run_dir = run_dir
                self.ckpt_every = ckpt_every
                self.step_n = 0
                self.w = np.zeros(256, dtype=np.float32)
                latest = self._latest_step()
                if latest is not None:
                    from ray_tpu_torch.train.checkpointing import \
                        load_checkpoint_host
                    import os
                    host = load_checkpoint_host(
                        os.path.join(run_dir, f"step-{latest}"))
                    self.w = host["w"]
                    self.step_n = latest

            def _latest_step(self):
                import os
                steps = []
                if os.path.isdir(self.run_dir):
                    for name in os.listdir(self.run_dir):
                        if name.startswith("step-") and os.path.exists(
                                os.path.join(self.run_dir, name,
                                             "COMMIT")):
                            steps.append(int(name[5:]))
                return max(steps) if steps else None

            def train_step(self, size: int) -> int:
                import numpy as np
                self.step_n += 1
                print(f"train step {self.step_n} (batch {size})")
                grad = np.ones(256, dtype=np.float32)
                self.w = self.w + 1e-3 * grad * (size % 7 + 1)
                if self.step_n % self.ckpt_every == 0:
                    from ray_tpu_torch.train.checkpointing import \
                        save_checkpoint
                    save_checkpoint(self.run_dir, {"w": self.w},
                                    self.step_n)
                return self.step_n

        self._actor = LoadTrainer.remote(ctx.run_dir, self.ckpt_every)
        # Warmup covers the actor spawn AND the first torch import inside
        # save_checkpoint so neither lands inside the measured window.
        for _ in range(self.ckpt_every):
            ray_tpu_torch.get(self._actor.train_step.remote(1),
                              timeout=180.0)

    def submit(self, size: int):
        return self._actor.train_step.remote(size)

    def wait(self, handle, timeout: float) -> None:
        import ray_tpu_torch
        ray_tpu_torch.get(handle, timeout=timeout)


WORKLOADS = {"serve": ServeWorkload, "data": DataWorkload,
             "train": TrainWorkload}


def make_workload(kind: str, **kw):
    return WORKLOADS[kind](**kw)
