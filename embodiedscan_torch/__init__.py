"""PyTorch/CUDA port of embodiedscan_tpu for NVIDIA Hopper GPUs.

The serving path of the multi-view 3D detector (``configs.base.build_model``)
runs here; the JAX package ``embodiedscan_tpu`` is the reference it is held
against. This package never imports JAX or the reference package.
"""
