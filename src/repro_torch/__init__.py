"""PyTorch + CUDA port of ALID (scalable dominant cluster detection).

The JAX package `repro` is the reference; this package mirrors its layout
module for module and runs its main path, one fit on the replicated
engine, through hand-written Hopper kernels (`repro_torch/csrc/`). It
imports neither `jax` nor `repro`.
"""
