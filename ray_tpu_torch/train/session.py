"""Worker-side train session: report() + get_context() (a copy of
``ray_tpu/train/session.py``; ``profile()`` writes a torch.profiler
Chrome trace).

Analogue of the reference's train session (reference: python/ray/train/
_internal/session.py get_session / ray.train.report, v2 via
train/v2/_internal/execution/worker_group/thread_runner.py): the user's
train loop runs in a thread inside the worker actor and communicates with
the controller through this module.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple


class TrainContext:
    def __init__(self, rank: int, world_size: int,
                 experiment_name: str = "", storage_path: str = "",
                 restored_checkpoint: Optional[Any] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None):
        self.rank = rank
        self.world_size = world_size
        self.experiment_name = experiment_name
        self.storage_path = storage_path
        self._restored_checkpoint = restored_checkpoint
        self._dataset_shards = dict(dataset_shards or {})

    def get_world_rank(self) -> int:
        return self.rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_checkpoint(self) -> Optional[Any]:
        """Checkpoint to resume from (set on group restart), else None."""
        return self._restored_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        """This worker's DataIterator for the trainer's datasets= entry
        (reference: ray.train.get_dataset_shard)."""
        if name not in self._dataset_shards:
            raise KeyError(
                f"no dataset shard {name!r}; trainer datasets= had "
                f"{sorted(self._dataset_shards)}")
        return self._dataset_shards[name]


class _Session:
    def __init__(self, ctx: TrainContext):
        self.ctx = ctx
        self.lock = threading.Lock()
        # (metrics, checkpoint) tuples not yet drained by the controller.
        self.reported: List[Tuple[Dict[str, Any], Optional[Any]]] = []
        self.finished = False
        self.error: Optional[str] = None

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Any] = None) -> None:
        with self.lock:
            self.reported.append((dict(metrics), checkpoint))

    def drain(self) -> List[Tuple[Dict[str, Any], Optional[Any]]]:
        with self.lock:
            out = self.reported
            self.reported = []
            return out


_session: Optional[_Session] = None


def _start_session(ctx: TrainContext) -> _Session:
    global _session
    _session = _Session(ctx)
    return _session


def _end_session() -> None:
    global _session, _async_ckptr
    _session = None
    # Flush any in-flight async save: the worker reporting "finished"
    # (and getting killed) must not strand an uncommitted checkpoint.
    ckptr, _async_ckptr = _async_ckptr, None
    if ckptr is not None:
        try:
            ckptr.close()
        except Exception:
            from ray_tpu_torch.utils import get_logger
            get_logger("train.session").warning(
                "async checkpoint flush at session end failed",
                exc_info=True)


def get_context() -> TrainContext:
    if _session is None:
        raise RuntimeError("not inside a train worker session")
    return _session.ctx


def get_dataset_shard(name: str = "train"):
    """This worker's dataset shard (reference: ray.train.get_dataset_shard)."""
    return get_context().get_dataset_shard(name)


def profile():
    """Context manager: profile the block with ``torch.profiler`` (CPU
    activity, and CUDA activity once the process uses the card) and write
    it as a Chrome trace, ``trace.json`` (chrome://tracing, Perfetto), into
    ``<storage_path>/<experiment>/profile-rank<r>/``; without a storage
    path the base is ``ray_tpu_torch_profiles`` in the temporary
    directory. Yields that directory (reference analogue: SURVEY §5.1 —
    task timeline + the framework profiler as the tracing story).

        with ray_tpu_torch.train.profile():
            state, m = step_fn(state, batch)
    """
    import contextlib
    import os
    import tempfile

    @contextlib.contextmanager
    def _ctx():
        import torch
        from torch.profiler import ProfilerActivity
        ctx = get_context()
        base = ctx.storage_path or os.path.join(tempfile.gettempdir(),
                                                "ray_tpu_torch_profiles")
        out = os.path.join(base, ctx.experiment_name or "train_run",
                           f"profile-rank{ctx.rank}")
        os.makedirs(out, exist_ok=True)
        cuda = torch.cuda.is_initialized()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with torch.profiler.profile(activities=acts) as prof:
            yield out
            if cuda:
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(out, "trace.json"))

    return _ctx()


def save_checkpoint(state: Any, step: int,
                    metrics: Optional[Dict[str, Any]] = None, *,
                    block: bool = True, ctx: Any = None, specs: Any = None):
    """Sharded save of a state tree (``make_train_fns``'s, or any dict of
    tensors and numbers) into the run's storage path with
    ``ray_tpu_torch.train.checkpointing``; call from EVERY rank (per-rank
    block writes + commit barrier), then report the returned handle:
    ``report(metrics, checkpoint=save_checkpoint(...))``.

    block=False (async, SURVEY §5.4 Orbax pattern): only the
    device->host snapshot runs here; file writes + the commit barrier
    run on a background thread and a Future[Checkpoint] is returned —
    call ``.result()`` (or save again, which serializes) before
    reporting it.

    ``ctx`` (a ``ParallelContext`` over the whole group) and ``specs``
    (e.g. ``state_shardings(cfg, ctx)``) say which rank writes which
    block, as the JAX package's global arrays say it themselves: a group
    of more than one rank must pass the context (replicated leaves need
    no specs)."""
    from ray_tpu_torch.train.checkpointing import run_dir
    from ray_tpu_torch.train.checkpointing import save_checkpoint as _save
    tctx = get_context()
    if not tctx.storage_path:
        raise RuntimeError("RunConfig.storage_path is not set")
    if ctx is None and tctx.world_size > 1:
        raise ValueError("save_checkpoint from a group of more than one "
                         "rank needs ctx=, the ParallelContext that says "
                         "which rank writes which block")
    directory = run_dir(tctx.storage_path, tctx.experiment_name)
    if block:
        return _save(directory, state, step, metrics, ctx=ctx, specs=specs)
    global _async_ckptr
    if _async_ckptr is None:
        from ray_tpu_torch.train.checkpointing import AsyncCheckpointer
        _async_ckptr = AsyncCheckpointer()
    return _async_ckptr.save(directory, state, step, metrics, ctx=ctx,
                             specs=specs)


_async_ckptr = None


def report(metrics: Dict[str, Any], checkpoint: Optional[Any] = None) -> None:
    """Report metrics (and optionally a checkpoint) from the train loop.

    Reference analogue: ray.train.report (train/_internal/session.py).
    """
    if _session is None:
        raise RuntimeError("report() called outside a train worker session")
    _session.report(metrics, checkpoint)
