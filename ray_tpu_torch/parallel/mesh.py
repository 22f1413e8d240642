"""Device-mesh construction (counterpart of ``ray_tpu/parallel/mesh.py``).

Parallelism is expressed as the six named axes of a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, one rank per device. The axis vocabulary and its order are
the JAX package's:

  pp   pipeline parallel — activations hop stage to stage, outermost
  dp   pure data parallel — gradient all-reduce per step
  fsdp sharded data parallel — parameters all-gathered, gradients
       reduce-scattered
  ep   expert parallel — MoE experts split across ranks
  sp   sequence parallel — ring attention's K/V rotation
  tp   tensor parallel — per-layer all-reduce, innermost

``MeshConfig``, ``_slice_groups`` and the hybrid layout are this package's
own copies of the JAX package's (which imports JAX). A "slice" there is a
TPU slice; here it is a node, the ranks of one host: the DCN factor of an
axis is outermost within that axis, so only that factor crosses hosts.
"""

from __future__ import annotations

import dataclasses
import math
import socket
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXIS_NAMES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# Axes over which the global batch is split.
BATCH_AXES = ("dp", "fsdp")
# Axes over which model parameters are sharded (fsdp dimension-sharding + tp).
PARAM_AXES = ("fsdp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    # Cross-node (DCN) factors: how much of pp/dp/fsdp spans nodes. Only
    # the lowest-bandwidth axes may cross nodes; tp/sp/ep have no factor,
    # so they stay within a node by construction. The node-crossing factor
    # of each axis is OUTERMOST within that axis.
    dcn_pp: int = 1
    dcn_dp: int = 1
    dcn_fsdp: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.pp, self.dp, self.fsdp, self.ep, self.sp, self.tp)

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    @property
    def num_slices(self) -> int:
        return self.dcn_pp * self.dcn_dp * self.dcn_fsdp

    @property
    def dcn_shape(self) -> tuple[int, ...]:
        return (self.dcn_pp, self.dcn_dp, self.dcn_fsdp, 1, 1, 1)

    @property
    def ici_shape(self) -> tuple[int, ...]:
        """Per-slice factor of each axis."""
        out = []
        for name, total, dcn in zip(AXIS_NAMES, self.shape, self.dcn_shape):
            if total % dcn:
                raise ValueError(
                    f"axis {name}={total} not divisible by its DCN factor "
                    f"{dcn} (the slice-crossing factor must divide the "
                    f"axis)")
            out.append(total // dcn)
        return tuple(out)

    def with_axes(self, **kw) -> "MeshConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def for_devices(n: int) -> "MeshConfig":
        """Default factorization: all-FSDP (ZeRO-style) over n devices."""
        return MeshConfig(fsdp=n)


@dataclasses.dataclass(frozen=True)
class RankDevice:
    """One rank of the process group as a mesh device: ``id`` is its rank,
    ``slice_index`` its node (None where ranks report none, as on the
    CPU)."""

    id: int
    slice_index: Optional[int] = None


def _slice_groups(devices: list, num_slices: int,
                  per: Optional[int] = None) -> list:
    """Partition devices into per-slice groups. Devices that report a
    ``slice_index`` are grouped by it; devices that report none fall back
    to contiguous equal chunks.

    ``per`` (group size) defaults to len(devices)//num_slices; pass it
    explicitly when ``devices`` is a superset to draw from."""
    if per is None:
        if len(devices) % num_slices:
            raise ValueError(f"{len(devices)} devices do not split into "
                             f"{num_slices} equal slices")
        per = len(devices) // num_slices
    if per < 1 or len(devices) < num_slices * per:
        raise ValueError(f"need {num_slices} slices of {per} devices, "
                         f"have {len(devices)} devices")
    by_slice: dict = {}
    n_with = sum(1 for d in devices
                 if getattr(d, "slice_index", None) is not None)
    if n_with and n_with != len(devices):
        raise ValueError(
            f"mixed device list: {n_with}/{len(devices)} devices report a "
            f"slice_index — cannot infer slice topology")
    if n_with:
        for d in devices:
            by_slice.setdefault(d.slice_index, []).append(d)
    if by_slice:
        # No group may straddle a physical slice boundary; one physical
        # slice with >= k*per devices yields k virtual slices. SELECT
        # round-robin across physical slices (depth-first would leave the
        # higher ones out of the mesh); ORDER the selection
        # physical-slice-major, so the outermost nontrivial DCN axis is
        # the one that crosses physical slices.
        per_slice_groups = []  # [(phys_key, [groups...])] in index order
        for k in sorted(by_slice):
            ds = by_slice[k]
            per_slice_groups.append(
                (k, [ds[i * per:(i + 1) * per]
                     for i in range(len(ds) // per)]))
        selected: list = []  # (phys_order, depth, group)
        depth = 0
        while len(selected) < num_slices:
            layer = [(order, depth, gs[depth])
                     for order, (_, gs) in enumerate(per_slice_groups)
                     if depth < len(gs)]
            if not layer:
                raise ValueError(
                    f"cannot form {num_slices} slices of {per} devices "
                    f"from physical slices "
                    f"{ {k: len(v) for k, v in by_slice.items()} } "
                    f"without straddling a slice boundary — pick DCN "
                    f"factors matching the real slice topology")
            selected.extend(layer)
            depth += 1
        selected = selected[:num_slices]
        selected.sort(key=lambda t: (t[0], t[1]))
        return [g for _, _, g in selected]
    # No slice identity (CPU): contiguous equal chunks.
    return [devices[i * per:(i + 1) * per] for i in range(num_slices)]


def _merge_hybrid(groups: list, config: MeshConfig) -> np.ndarray:
    """Compose per-slice submeshes into the hybrid layout: axis k of the
    result is dcn_k (outer) x ici_k (inner)."""
    ici_shape = config.ici_shape
    dcn_shape = config.dcn_shape
    arr = np.empty(dcn_shape + ici_shape, dtype=object)
    for si, g in enumerate(groups):
        sub = np.empty(len(g), dtype=object)
        sub[:] = g
        arr[np.unravel_index(si, dcn_shape)] = sub.reshape(ici_shape)
    k = len(AXIS_NAMES)
    arr = arr.transpose([ax for i in range(k) for ax in (i, k + i)])
    return arr.reshape(config.shape)


def _select_single_slice(devices: list, n: int) -> list:
    """Pick n devices for a single-slice mesh, preferring one physical
    slice when the devices report one."""
    if getattr(devices[0], "slice_index", None) is None:
        return devices[:n]
    by_slice: dict = {}
    for d in devices:
        si = getattr(d, "slice_index", None)
        if si is None:
            return devices[:n]  # mixed: no usable topology signal
        by_slice.setdefault(si, []).append(d)
    for k in sorted(by_slice):
        if len(by_slice[k]) >= n:
            return by_slice[k][:n]
    warnings.warn(
        f"single-slice mesh of {n} devices spans {len(by_slice)} nodes — "
        f"every axis's collectives will cross nodes; set MeshConfig dcn_* "
        f"factors to place only dp/fsdp/pp across nodes")
    return devices[:n]


def device_layout(config: MeshConfig, devices: Sequence) -> np.ndarray:
    """The devices of ``config``'s mesh as an object array of shape
    ``config.shape``, laid out as the JAX package's ``build_mesh`` lays
    them out (without a TPU's physical topology: ranks in order)."""
    n = config.num_devices
    if n > len(devices):
        raise ValueError(f"MeshConfig {config} needs {n} devices but only "
                         f"{len(devices)} available")
    devices = list(devices)
    if config.num_slices == 1:
        chosen = _select_single_slice(devices, n)
        arr = np.empty(n, dtype=object)
        arr[:] = chosen
        return arr.reshape(config.shape)
    per = math.prod(config.ici_shape)
    return _merge_hybrid(_slice_groups(devices, config.num_slices, per=per),
                         config)


def _rank_devices(device_type: str) -> List[RankDevice]:
    """Every rank of the default group with its node: on the card, the
    index of its host name among the hosts; on the CPU none."""
    world = dist.get_world_size()
    if device_type != "cuda" or world == 1:
        return [RankDevice(r) for r in range(world)]
    hosts: List[Optional[str]] = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    order = sorted(set(hosts))
    return [RankDevice(r, order.index(h)) for r, h in enumerate(hosts)]


def build_mesh(config: MeshConfig, device_type: str = "cuda") -> DeviceMesh:
    """The ``DeviceMesh`` of ``config`` over the default process group
    (which must be initialised, with one rank per device of the mesh), with
    ``mesh_dim_names=AXIS_NAMES``."""
    world = dist.get_world_size()
    if config.num_devices != world:
        raise ValueError(f"MeshConfig {config} needs {config.num_devices} "
                         f"ranks; the process group has {world}")
    layout = device_layout(config, _rank_devices(device_type))
    ranks = np.vectorize(lambda d: d.id, otypes=[np.int64])(layout)
    return DeviceMesh(device_type, ranks.tolist(), mesh_dim_names=AXIS_NAMES)


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A mesh of every axis at size 1 over a world of one rank."""
    return build_mesh(MeshConfig(), device_type)
