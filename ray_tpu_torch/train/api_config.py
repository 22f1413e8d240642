"""Train configuration dataclasses.

Analogue of the reference's AIR/Train configs (reference: python/ray/air/
config.py ScalingConfig/RunConfig/FailureConfig/CheckpointConfig and
python/ray/train/v2/api/config.py — incl. use_gpu), slimmed; a copy of
``ray_tpu/train/api_config.py`` with GPUs in place of TPU chips.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ScalingConfig:
    """How many training workers and what each one needs.

    num_workers: one torch process per worker (usually one per GPU).
    use_gpu: request GPUs from the scheduler.
    gpus_per_worker: whole GPUs pinned to each worker
      (CUDA_VISIBLE_DEVICES); 0 with use_gpu means 1.
    resources_per_worker: extra scheduler resources per worker.
    placement_strategy: bundle placement (PACK | SPREAD | STRICT_SPREAD).
    """
    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: int = 0
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    placement_strategy: str = "PACK"
    # Elastic mode (reference: train/v2 ScalingPolicy resize decisions):
    # with max_workers set, the controller tracks cluster capacity in
    # [min_workers or num_workers, max_workers] — a node join re-gangs
    # the job larger from the latest checkpoint; a loss shrinks it.
    min_workers: Optional[int] = None
    max_workers: Optional[int] = None

    def bundle(self) -> Dict[str, float]:
        res = {"CPU": 1.0}
        res.update(self.resources_per_worker)
        if self.use_gpu:
            res["GPU"] = float(self.gpus_per_worker or 1)
        return res


@dataclass
class FailureConfig:
    """max_failures: worker-group restarts allowed (-1 = unlimited)."""
    max_failures: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # or "min"


@dataclass
class RunConfig:
    name: str = ""
    storage_path: str = ""
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)


@dataclass
class Result:
    """What fit() returns (reference: python/ray/air/result.py)."""
    metrics: Dict[str, Any] = field(default_factory=dict)
    metrics_history: list = field(default_factory=list)
    checkpoint: Optional[Any] = None
    error: Optional[BaseException] = None
    path: str = ""
