"""ParallelContext: mesh + mesh config + sharding rules, threaded through
the model and the train step (counterpart of
``ray_tpu/parallel/context.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.parallel.mesh import AXIS_NAMES, MeshConfig, build_mesh
from ray_tpu_torch.parallel.sharding import DEFAULT_RULES, MeshAxes, batch_spec


@dataclasses.dataclass
class ParallelContext:
    mesh: DeviceMesh
    config: MeshConfig
    rules: Dict[str, MeshAxes] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def __post_init__(self):
        self._coord = dict(zip(AXIS_NAMES, self.mesh.get_coordinate()))

    @staticmethod
    def create(config: Optional[MeshConfig] = None,
               device: DeviceLike = None) -> "ParallelContext":
        """The context of ``config`` (default: all-FSDP over the world)
        over the default process group. ``device=None`` means the card and
        NCCL, ``device="cpu"`` gloo. A config of one device creates a
        world-1 group when none exists; any other needs the caller's
        ``torch.distributed.init_process_group``, whose backend must serve
        the device."""
        dev = resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if not dist.is_initialized():
            if config is None or config.num_devices != 1:
                raise RuntimeError(
                    "ParallelContext.create needs an initialised process "
                    "group (torch.distributed.init_process_group) for a "
                    "mesh of more than one device")
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        # a "cpu:gloo,cuda:nccl" group serves both
        if backend not in dist.get_backend():
            raise RuntimeError(
                f"the default process group's backend is "
                f"{dist.get_backend()!r}; a {dev.type} mesh needs {backend}")
        if config is None:
            config = MeshConfig.for_devices(dist.get_world_size())
        return ParallelContext(build_mesh(config, dev.type), config)

    @property
    def device(self) -> torch.device:
        return resolve_device(self.mesh.device_type)

    @property
    def num_slices(self) -> int:
        """Nodes this context's mesh spans (DCN axes; 1 = one node)."""
        return self.config.num_slices

    @property
    def sp(self) -> int:
        return self.config.sp

    @property
    def pp(self) -> int:
        return self.config.pp

    @property
    def ep(self) -> int:
        return self.config.ep

    def size(self, axis: str) -> int:
        return self.mesh.size(AXIS_NAMES.index(axis))

    def rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self._coord[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The process group of this rank's line along ``axis``; None when
        the axis has size 1 (every collective over it is the identity)."""
        return self.mesh.get_group(axis) if self.size(axis) > 1 else None

    def batch_sharding(self):
        return batch_spec()

    def activation_spec(self):
        return (*batch_spec(), None)


def axis_size(ctx: Optional[ParallelContext], axis: str) -> int:
    """``ctx.size(axis)``, and 1 without a context."""
    return 1 if ctx is None else ctx.size(axis)


def axis_group(ctx: Optional[ParallelContext],
               axis: str) -> Optional[dist.ProcessGroup]:
    """``ctx.group(axis)``, and None (the identity) without a context."""
    return None if ctx is None else ctx.group(axis)
