from ray_tpu_torch.models.llama import (LlamaConfig, forward, init_params,
                                        logical_axes, param_count,
                                        params_from_jax)

__all__ = ["LlamaConfig", "forward", "init_params", "logical_axes",
           "param_count", "params_from_jax"]
