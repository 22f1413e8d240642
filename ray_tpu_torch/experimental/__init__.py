"""Experimental accelerator-plane features (counterpart of
``ray_tpu/experimental``): the device transfer plane. Device channels and
the DAG's tensor transport are not ported yet."""
