"""Training (counterpart of ``ray_tpu/train``): the step of ``spmd.py``,
on one device or over a ``ParallelContext``, and sharded checkpoints
(``checkpointing.py``). The trainer, session and data ingest wait for
later slices; until the session's ``save_checkpoint`` is ported, the name
is the checkpoint module's."""

from ray_tpu_torch.train.checkpointing import (AsyncCheckpointer, Checkpoint,
                                               CheckpointManager,
                                               load_checkpoint_host,
                                               restore_checkpoint,
                                               save_checkpoint)
from ray_tpu_torch.train.spmd import (ClipAdamW, default_optimizer,
                                      make_train_fns, state_from_jax,
                                      state_shardings)

__all__ = ["AsyncCheckpointer", "Checkpoint", "CheckpointManager",
           "ClipAdamW", "default_optimizer", "load_checkpoint_host",
           "make_train_fns", "restore_checkpoint", "save_checkpoint",
           "state_from_jax", "state_shardings"]
