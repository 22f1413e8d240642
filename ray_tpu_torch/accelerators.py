"""GPU accelerator manager: device discovery, visibility, node labels.

Counterpart of ``ray_tpu/accelerators.py`` (the TPU manager) and of the
reference's NVIDIA GPU accelerator manager (reference:
python/ray/_private/accelerators/nvidia_gpu.py — CUDA_VISIBLE_DEVICES for
discovery and for pinning workers). The node agent calls into this module
at startup to advertise ``GPU`` as a first-class scheduler resource, and
at actor spawn to pin whole devices to a worker process.

This module must not import ``torch`` or touch CUDA: the node agent would
otherwise hold a CUDA context on a card it hands to a worker. Discovery
reads the config, the environment and ``/dev`` only.

There is no single-host counterpart of ``reserve_tpu_slice``: gang
reservation across GPU hosts waits for the multi-host trainer.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

from ray_tpu_torch.utils.config import GlobalConfig

# Node label keys (reference: accelerators/nvidia_gpu.py accelerator type)
GPU_ACCELERATOR_TYPE_LABEL = "ray_tpu_torch.io/accelerator-type"


def _ids_from_visible(spec: str) -> List[str]:
    """Entries of a CUDA_VISIBLE_DEVICES value. ``""`` and ``-1`` hide
    every device. Ids may be indices or UUIDs; CUDA stops at the first
    invalid entry, so a ``-1`` ends the list."""
    out: List[str] = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok or tok.startswith("-"):
            break
        out.append(tok)
    return out


def num_gpus() -> int:
    """Detect the number of GPUs this host may use.

    Priority: explicit config flag (tests / operator override) >
    CUDA_VISIBLE_DEVICES (entries counted; ``""`` and ``-1`` mean none) >
    NVIDIA_VISIBLE_DEVICES, the container runtime's selection (entries
    counted; ``all`` defers to the device files, ``none``/``void``/``""``
    mean none) > ``/dev/nvidia[0-9]*`` device files > none. A container
    may hold device files of cards it was not given, so its selection
    counts before them.
    """
    if GlobalConfig.gpus_per_host > 0:
        return int(GlobalConfig.gpus_per_host)
    spec = os.environ.get("CUDA_VISIBLE_DEVICES")
    if spec is not None:
        return len(_ids_from_visible(spec))
    spec = os.environ.get("NVIDIA_VISIBLE_DEVICES")
    if spec is not None and spec.strip() != "all":
        if spec.strip() in ("none", "void"):
            return 0
        return len(_ids_from_visible(spec))
    return len(glob.glob("/dev/nvidia[0-9]*"))


def visible_gpu_ids() -> List[int]:
    """Device ordinals this agent may hand to workers (gpu_visible_ids
    filter). Ordinals index the agent's own view: under a
    CUDA_VISIBLE_DEVICES of the agent, ordinal i is its i-th entry."""
    n = num_gpus()
    spec = GlobalConfig.gpu_visible_ids.strip()
    if spec:
        ids = sorted({int(x) for x in spec.split(",") if x.strip()})
        return [i for i in ids if 0 <= i < n]
    return list(range(n))


def _physical_ids(ordinals: List[int]) -> List[str]:
    """Map the agent's ordinals to what a worker's CUDA_VISIBLE_DEVICES
    must name: the agent's own entries when it runs under one."""
    spec = os.environ.get("CUDA_VISIBLE_DEVICES")
    if spec is None or GlobalConfig.gpus_per_host > 0:
        return [str(i) for i in ordinals]
    mine = _ids_from_visible(spec)
    return [mine[i] if i < len(mine) else str(i) for i in ordinals]


def accelerator_type() -> str:
    """e.g. 'NVIDIA H100 80GB HBM3' — the kernel module's procfs model
    line of the first device, else empty (read without a CUDA context)."""
    for info in sorted(glob.glob("/proc/driver/nvidia/gpus/*/information")):
        try:
            with open(info) as f:
                for line in f:
                    if line.startswith("Model:"):
                        return line.split(":", 1)[1].strip()
        except OSError:
            continue
    return ""


def node_labels() -> Dict[str, str]:
    labels: Dict[str, str] = {}
    if num_gpus() > 0 and accelerator_type():
        labels[GPU_ACCELERATOR_TYPE_LABEL] = accelerator_type()
    return labels


def worker_env_for_gpus(gpu_ids: List[int]) -> Dict[str, str]:
    """Env vars that scope a spawned worker process to specific GPUs
    (reference: nvidia_gpu.py set_current_process_visible_accelerator_ids
    → CUDA_VISIBLE_DEVICES)."""
    return {"CUDA_VISIBLE_DEVICES": ",".join(_physical_ids(gpu_ids))}
