"""Ported kernels: each CUDA kernel (csrc/) beside its plain PyTorch version.

| TPU kernel (repro/kernels)          | port                                  |
|-------------------------------------|---------------------------------------|
| mx_matmul.py::mx_matmul_fused       | mx_matmul.py + csrc/mx_matmul.cu      |
| baseline_matmul.py::baseline_matmul | baseline_matmul.py + csrc/baseline_matmul.cu |
| mx_flash_decode.py::mx_flash_decode | mx_flash_decode.py + csrc/mx_flash_decode.cu |
|   (f32/bf16 pages, int8 pages with k_scale / v_scale)                       |
| mx_flash_decode.py::mx_flash_verify | mx_flash_decode.py + csrc/mx_flash_decode.cu |
|   (the same page types; S = k+1 window rows per slot)                       |

Not ported yet: mx_grouped_matmul, mx_flash_attention, ssd_scan, the GEMM's
scale / 2:4 / ABFT stages and the ring composites (ROADMAP queue 2).
"""
from __future__ import annotations

from typing import Dict

from .baseline_matmul import baseline_matmul
from .mx_flash_decode import mx_flash_decode, mx_flash_verify
from .mx_matmul import mx_matmul_fused

WRAPPERS = {
    "mx_matmul_fused": mx_matmul_fused,
    "baseline_matmul": baseline_matmul,
    "mx_flash_decode": mx_flash_decode,
    "mx_flash_verify": mx_flash_verify,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches made on CUDA tensors since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
