"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The package keeps the module names of ``ray_tpu`` so each counterpart is
easy to find (``ops/attention.py``, ``models/llama.py``,
``serve/engine.py``, ...). It imports ``torch`` and never ``jax``, and
nothing of ``ray_tpu``: what it needs from there it keeps as its own copy.

Every entry point takes a ``device``. ``None`` means the CUDA card; with no
card that raises rather than carrying on on the CPU. Tests pass
``device="cpu"``, where each kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA card, raising when none is visible. A
    CUDA device always comes back with its index, so that threads can
    ``torch.cuda.set_device`` it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
