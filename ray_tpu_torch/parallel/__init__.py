from ray_tpu_torch.parallel.mesh import (AXIS_NAMES, MeshConfig, build_mesh,
                                         single_device_mesh)
from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES, batch_spec,
                                             shard, shard_batch, spec_for,
                                             tree_shard, tree_specs)
from ray_tpu_torch.parallel.context import ParallelContext
from ray_tpu_torch.parallel.pipeline import gpipe_spmd

__all__ = [
    "AXIS_NAMES", "MeshConfig", "build_mesh", "single_device_mesh",
    "DEFAULT_RULES", "batch_spec", "shard", "shard_batch", "spec_for",
    "tree_shard", "tree_specs", "ParallelContext", "gpipe_spmd",
]
