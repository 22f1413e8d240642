from ray_tpu_torch.utils.config import GlobalConfig
from ray_tpu_torch.utils.logging import get_logger

__all__ = ["GlobalConfig", "get_logger"]
