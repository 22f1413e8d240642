"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The package keeps the module names of ``ray_tpu`` so each counterpart is
easy to find (``ops/attention.py``, ``models/llama.py``,
``serve/engine.py``, ``core/``, ``api.py``, ...). It imports ``torch`` and
never ``jax``, and nothing of ``ray_tpu``: what it needs from there it
keeps as its own copy.

The distributed runtime (``init``, ``remote``, ``get``, ``put``, actors,
placement groups) loads on first use and imports no ``torch``: its
controller, node agents and workers start without it, and a task that
uses torch imports it itself. GPUs are a scheduler resource
(``remote(num_gpus=1)``); the agent pins each to one worker through
``CUDA_VISIBLE_DEVICES``.

Every model entry point takes a ``device``. ``None`` means the CUDA card;
with no card that raises rather than carrying on on the CPU. Tests pass
``device="cpu"``, where each kernel wrapper runs its plain PyTorch
version. ``resolve_device`` and ``DeviceLike`` live in
``ray_tpu_torch.device``.
"""

__version__ = "0.1.0"

_API_NAMES = (
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "placement_group",
    "remove_placement_group", "PlacementGroup", "nodes", "cluster_resources",
    "available_resources", "ObjectRef", "ActorHandle", "ObjectRefGenerator",
)
_DEVICE_NAMES = ("DeviceLike", "resolve_device")


def __getattr__(name):
    # Lazy: importing ray_tpu_torch imports neither the runtime nor torch.
    if name in _API_NAMES:
        if name in ("ObjectRef", "ActorHandle", "ObjectRefGenerator"):
            from ray_tpu_torch.core import ref as _ref
            return getattr(_ref, name)
        from ray_tpu_torch import api as _api
        return getattr(_api, name)
    if name in _DEVICE_NAMES:
        from ray_tpu_torch import device as _device
        return getattr(_device, name)
    raise AttributeError(name)


__all__ = ["__version__", *_API_NAMES, *_DEVICE_NAMES]
