"""PyTorch + CUDA port of the MX GEMM engine and its paged-KV serving path.

The JAX package `repro` is the reference; this package mirrors its layout
(`configs/`, `kernels/`, `core/`, `models/`, `runtime/`, `launch/`) and
imports nothing from it.  Each TPU Pallas kernel on the ported path is a
CUDA C++ kernel for Hopper (`csrc/*.cu`, built lazily by `kernels/_build`),
with a plain PyTorch version of the same function beside it that CPU
tensors take.
"""
