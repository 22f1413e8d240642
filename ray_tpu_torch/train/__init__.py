"""Training (counterpart of ``ray_tpu/train``): ``TorchTrainer`` runs the
user's loop in a gang of GPU (or CPU) worker processes on the runtime,
each fed its shard of a ``ray_tpu_torch.data`` dataset; inside the loop,
the step of ``spmd.py`` runs on one device or over a ``ParallelContext``,
and ``save_checkpoint`` (the session's) writes sharded checkpoints with
``checkpointing.py``, whose own ``save_checkpoint`` takes a directory
(``ray_tpu_torch.train.checkpointing.save_checkpoint``)."""

from ray_tpu_torch.train.api_config import (CheckpointConfig, FailureConfig,
                                            Result, RunConfig, ScalingConfig)
from ray_tpu_torch.train.checkpointing import (AsyncCheckpointer, Checkpoint,
                                               CheckpointManager,
                                               load_checkpoint_host,
                                               restore_checkpoint)
from ray_tpu_torch.train.scaling_policy import (ElasticScalingPolicy,
                                                FixedScalingPolicy,
                                                ScalingPolicy)
from ray_tpu_torch.train.session import (get_context, get_dataset_shard,
                                         profile, report, save_checkpoint)
from ray_tpu_torch.train.spmd import (ClipAdamW, default_optimizer,
                                      make_train_fns, state_from_jax,
                                      state_shardings)
from ray_tpu_torch.train.torch_trainer import TorchTrainer

__all__ = [
    "AsyncCheckpointer", "Checkpoint", "CheckpointConfig",
    "CheckpointManager", "ClipAdamW",
    "ElasticScalingPolicy", "FailureConfig", "FixedScalingPolicy",
    "Result", "RunConfig", "ScalingConfig", "ScalingPolicy",
    "TorchTrainer", "default_optimizer", "get_context", "get_dataset_shard",
    "load_checkpoint_host", "make_train_fns", "profile", "report",
    "restore_checkpoint", "save_checkpoint", "state_from_jax",
    "state_shardings",
]
