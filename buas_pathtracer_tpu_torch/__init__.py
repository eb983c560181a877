"""PyTorch/CUDA port of buas_pathtracer_tpu for NVIDIA Hopper (H100).

The JAX package ``buas_pathtracer_tpu`` stays the reference.  This package
mirrors its layout (core, models, ops, integrators, runtime, utils, native)
and renders the same frames with plain PyTorch tensor code around
hand-written CUDA kernels (``csrc/``).  It imports nothing of JAX or of the
JAX package.

Every entry point takes ``device=None``, which means the CUDA card; without
a card it raises unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
