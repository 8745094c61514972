"""lodestar_tpu_torch: the PyTorch + CUDA port of lodestar_tpu.

The JAX package `lodestar_tpu` stays the reference; this package imports
nothing of it and nothing of JAX.  Entry points run on the CUDA device
unless the caller passes `device="cpu"`, which selects the kernels'
plain torch versions.
"""
