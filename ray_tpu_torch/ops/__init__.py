from ray_tpu_torch.ops.attention import (attention_reference, flash_attention,
                                         flash_bwd, flash_fwd, repeat_kv)
from ray_tpu_torch.ops.moe import moe_ffn, top_k_routing
from ray_tpu_torch.ops.norms import apply_rope, rms_norm, rope_frequencies
from ray_tpu_torch.ops.ring_attention import ring_attention

__all__ = ["attention_reference", "flash_attention", "flash_bwd", "flash_fwd",
           "repeat_kv", "moe_ffn", "top_k_routing", "apply_rope", "rms_norm",
           "rope_frequencies", "ring_attention"]
