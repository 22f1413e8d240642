"""Training (counterpart of ``ray_tpu/train``): the single-device step of
``spmd.py``. The trainer, session and data ingest wait for later slices."""

from ray_tpu_torch.train.spmd import (ClipAdamW, default_optimizer,
                                      make_train_fns, state_from_jax)

__all__ = ["ClipAdamW", "default_optimizer", "make_train_fns",
           "state_from_jax"]
