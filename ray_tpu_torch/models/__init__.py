from ray_tpu_torch.models.llama import (LlamaConfig, flops_per_token, forward,
                                        init_params, logical_axes, loss_fn,
                                        param_count, param_specs,
                                        params_from_jax)

__all__ = ["LlamaConfig", "flops_per_token", "forward", "init_params",
           "logical_axes", "loss_fn", "param_count", "param_specs", "params_from_jax"]
