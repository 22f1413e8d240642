"""Training (counterpart of ``ray_tpu/train``): the step of ``spmd.py``,
on one device or over a ``ParallelContext``. The trainer, session and data
ingest wait for later slices."""

from ray_tpu_torch.train.spmd import (ClipAdamW, default_optimizer,
                                      make_train_fns, state_from_jax,
                                      state_shardings)

__all__ = ["ClipAdamW", "default_optimizer", "make_train_fns",
           "state_from_jax", "state_shardings"]
