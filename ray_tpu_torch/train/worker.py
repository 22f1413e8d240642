"""TrainWorker — the per-process training actor (a copy of
``ray_tpu/train/worker.py``).

Analogue of the reference's Train v2 worker (reference:
python/ray/train/v2/_internal/execution/worker_group/worker.py +
thread_runner.py — run the user loop in a thread, poll status), with the
torch backend bolted in: the loop's thread first joins
``torch.distributed`` from the env the controller set at actor spawn
(reference: python/ray/train/torch/config.py _TorchBackend.on_start), and
destroys the process group when the loop ends.

``RAY_TPU_TORCH_TRAIN_{COORD,WORLD,RANK}`` give the group's store (a
``TCPStore`` that rank 0 hosts at ``COORD``), size and rank;
``RAY_TPU_TORCH_TRAIN_BACKEND`` is ``nccl`` for a worker that holds a GPU,
``gloo`` otherwise. ``CUDA_VISIBLE_DEVICES`` (the agent's pinning) is read
by CUDA at its first use in the process, which is why the controller
passes env through ``runtime_env={"env_vars": ...}``.
"""

from __future__ import annotations

import datetime
import os
import threading
import traceback
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch.train import session as _session_mod

# How long a rank waits for the others at the group's store.
GROUP_TIMEOUT_S = 120


def _env_rank_world() -> tuple:
    return (int(os.environ.get("RAY_TPU_TORCH_TRAIN_RANK", "0")),
            int(os.environ.get("RAY_TPU_TORCH_TRAIN_WORLD", "1")))


def torch_info() -> dict:
    """This worker's view of its devices and group: the backend (None
    before a group exists), its device, the card's name, the pinned
    ``CUDA_VISIBLE_DEVICES``, and its rank and world. Callable from the
    train loop."""
    import torch
    import torch.distributed as dist

    rank, world = _env_rank_world()
    backend = os.environ.get("RAY_TPU_TORCH_TRAIN_BACKEND", "gloo")
    gpu = backend == "nccl" and torch.cuda.is_available()
    return {"backend": dist.get_backend() if dist.is_initialized() else None,
            "device": "cuda:0" if gpu else "cpu",
            "device_name": torch.cuda.get_device_name(0) if gpu else None,
            "cuda_device_count": torch.cuda.device_count(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "rank": rank, "world": world}


class TrainWorker:
    """Gang-scheduled by the TrainController; one torch process per
    actor."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._session: Optional[_session_mod._Session] = None
        self._group_initialized = False

    # -- backend ---------------------------------------------------------
    def _init_torch_distributed(self) -> Dict[str, Any]:
        coord = os.environ.get("RAY_TPU_TORCH_TRAIN_COORD", "")
        rank, world = _env_rank_world()
        if world > 1 and coord and not self._group_initialized:
            import torch.distributed as dist
            host, port = coord.rsplit(":", 1)
            timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
            # Blocks until all `world` ranks have joined rank 0's store.
            store = dist.TCPStore(host, int(port), world,
                                  is_master=rank == 0, timeout=timeout)
            dist.init_process_group(
                os.environ.get("RAY_TPU_TORCH_TRAIN_BACKEND", "gloo"),
                store=store, rank=rank, world_size=world, timeout=timeout)
            self._group_initialized = True
        return torch_info()

    @staticmethod
    def _destroy_group() -> None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()

    # -- controller API --------------------------------------------------
    def start(self, fn_blob: bytes, config: Optional[dict],
              experiment_name: str = "", storage_path: str = "",
              restored_checkpoint: Any = None,
              shards_blob: Optional[bytes] = None) -> None:
        """Launch the user train loop in a thread and return immediately
        (the actor stays responsive to poll())."""
        assert self._thread is None, "start() called twice"
        rank, world = _env_rank_world()
        shards = cloudpickle.loads(shards_blob) if shards_blob else {}
        ctx = _session_mod.TrainContext(rank, world, experiment_name,
                                        storage_path, restored_checkpoint,
                                        dataset_shards=shards)
        self._session = _session_mod._start_session(ctx)
        fn = cloudpickle.loads(fn_blob)

        def _run():
            try:
                self._init_torch_distributed()
                if config is None:
                    fn()
                else:
                    fn(config)
                self._destroy_group()
            except BaseException:
                self._session.error = traceback.format_exc()
            finally:
                self._session.finished = True

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="train-loop")
        self._thread.start()

    def poll(self) -> dict:
        """Drain new report()s + liveness/status (reference:
        controller.py _poll_workers)."""
        s = self._session
        if s is None:
            return {"status": "idle", "reported": []}
        reported = s.drain()
        if s.error is not None:
            return {"status": "error", "error": s.error, "reported": reported}
        if s.finished:
            return {"status": "finished", "reported": reported}
        return {"status": "running", "reported": reported}

    def torch_info(self) -> dict:
        return torch_info()

    def shutdown_worker(self) -> str:
        return "ok"
