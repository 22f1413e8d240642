"""TorchTrainer — the public data-parallel trainer for torch on GPUs (a
copy of ``ray_tpu/train/jax_trainer.py``, whose ``JaxTrainer`` it
replaces).

Analogue of the reference's trainers (reference:
python/ray/train/v2/api/data_parallel_trainer.py:60 DataParallelTrainer /
fit():118 and python/ray/train/torch/torch_trainer.py TorchTrainer): the
worker group is one torch process per worker, each pinned to its GPUs by
the scheduler; ``torch.distributed`` is initialized from env the
controller injects at spawn (NCCL on GPUs, gloo otherwise), and inside the
loop the user composes this package's SPMD stack (ray_tpu_torch.parallel /
ray_tpu_torch.train.spmd) over the group.

Example::

    def loop(config):
        ctx = ray_tpu_torch.train.get_context()
        pctx = ParallelContext.create(MeshConfig(dp=ctx.get_world_size()))
        ... torch code on pctx.device ...
        ray_tpu_torch.train.report({"loss": loss})

    trainer = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=4, use_gpu=True))
    result = trainer.fit()
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.train.api_config import Result, RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import TrainController


class TorchTrainer:
    def __init__(self, train_loop_per_worker, *,
                 train_loop_config: Optional[dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 worker_env: Optional[Dict[str, Optional[str]]] = None):
        """worker_env: extra env vars for every worker process (value None
        unsets a var). CUDA reads its env at its first use in the process,
        so device selection (CUDA_VISIBLE_DEVICES overrides, NCCL_* knobs)
        must ride here rather than inside the train loop.

        datasets: {name: ray_tpu_torch.data.Dataset} — each is
        streaming_split across the worker group (equal=True for SPMD step
        parity); the loop reads its shard via
        ray_tpu_torch.train.get_dataset_shard(name)
        (reference: DataParallelTrainer datasets= + train v2 data ingest).
        """
        self._controller = TrainController(
            train_loop_per_worker, train_loop_config,
            scaling_config or ScalingConfig(),
            run_config or RunConfig(), worker_env, datasets)

    def fit(self) -> Result:
        result = self._controller.run()
        if result.error is not None:
            raise result.error
        return result
