"""Experimental accelerator-plane features (counterpart of
``ray_tpu/experimental``): the device transfer plane, device channels and
the DAG's tensor transport (reference: python/ray/experimental/channel/)."""

from ray_tpu_torch.experimental.channel import DeviceChannel  # noqa: F401
