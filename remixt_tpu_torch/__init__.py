"""PyTorch/CUDA port of ``remixt_tpu``.

Joint inference of clone-specific segment and breakpoint copy number,
running on an NVIDIA GPU. The package mirrors the module layout of
``remixt_tpu`` (the JAX reference) and imports nothing from it.
"""
