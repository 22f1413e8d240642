from ray_tpu_torch.ops.attention import (attention_reference, flash_attention,
                                         flash_bwd, flash_fwd, repeat_kv)
from ray_tpu_torch.ops.norms import apply_rope, rms_norm, rope_frequencies

__all__ = ["attention_reference", "flash_attention", "flash_bwd", "flash_fwd",
           "repeat_kv", "apply_rope", "rms_norm", "rope_frequencies"]
