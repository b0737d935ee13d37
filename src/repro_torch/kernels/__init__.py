"""Ported kernels: each CUDA kernel (csrc/) beside its plain PyTorch version.

| TPU kernel (repro/kernels)          | port                                  |
|-------------------------------------|---------------------------------------|
| mx_matmul.py::mx_matmul_fused       | mx_matmul.py + csrc/mx_matmul*.cu     |
|   (dense f32/bf16, every epilogue; int8/fp8 payloads with scales;         |
|    2:4 sparse weights: _sparse.cu; ABFT checksums + flags: _abft.cu;      |
|    dense decode rows, M <= 16: csrc/decode_tile.cuh's streaming loop;    |
|    f32 / bf16 A at M > 16: csrc/prefill_tile.cuh's tensor-core loop)    |
| baseline_matmul.py::baseline_matmul | baseline_matmul.py + csrc/baseline_matmul.cu |
|   (decode and prefill rows on the same loops, round trip every bk)       |
| mx_flash_decode.py::mx_flash_decode | mx_flash_decode.py + csrc/mx_flash_decode.cu |
|   (f32/bf16 pages, int8 / fp8 pages with k_scale / v_scale)                 |
| mx_flash_decode.py::mx_flash_verify | mx_flash_decode.py + csrc/mx_flash_decode.cu |
|   (the same page types; S = k+1 window rows per slot)                       |
| mx_grouped_matmul.py::mx_grouped_matmul | mx_grouped_matmul.py + csrc/mx_grouped_matmul*.cu |
|   (f32/bf16 and int8/fp8 experts with per-expert scales, 2:4 sparse      |
|    experts, per-expert ABFT; plain in ref.py)                              |
| ssd_scan.py::ssd_scan               | ssd_scan.py + csrc/ssd_scan.cu        |
|   (batched (B, L, H, P), b / c per group, f32/bf16; plain in ref.py)       |
| mx_flash_attention.py::mx_flash_attention | mx_flash_attention.py +          |
|   csrc/mx_flash_attention.cu ((B, S, H, d), GQA, causal or not, d <= 128, |
|   f32/bf16; plain in ref.py)                                              |

`sparse.py` (the 2:4 wire format) and `abft.py` (checksum specs, fault
operands, the recovery policy and counters) are plain Python beside them.

Not ported yet: the ring composites of mx_collective_matmul.py (ROADMAP
queue 2).
"""
from __future__ import annotations

from typing import Dict

from .baseline_matmul import baseline_matmul
from .mx_flash_attention import mx_flash_attention
from .mx_flash_decode import mx_flash_decode, mx_flash_verify
from .mx_grouped_matmul import mx_grouped_matmul
from .mx_matmul import mx_matmul_fused
from .ssd_scan import ssd_scan

WRAPPERS = {
    "mx_matmul_fused": mx_matmul_fused,
    "baseline_matmul": baseline_matmul,
    "mx_flash_decode": mx_flash_decode,
    "mx_flash_verify": mx_flash_verify,
    "mx_grouped_matmul": mx_grouped_matmul,
    "ssd_scan": ssd_scan,
    "mx_flash_attention": mx_flash_attention,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches made on CUDA tensors since the last reset (every
    variant of a GEMM counted under its wrapper)."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def variant_launch_counts() -> Dict[str, int]:
    """The GEMMs' launches by variant since the last reset, as
    "<wrapper> <variant>" -> count (variants "dense", "sparse", "abft")."""
    return {f"{name} {v}": n for name, fn in WRAPPERS.items()
            for v, n in getattr(fn, "variants", {}).items()}


def decode_launch_counts() -> Dict[str, int]:
    """The dense GEMMs' launches on the decode tile (M <= 16,
    csrc/decode_tile.cuh) since the last reset."""
    return {name: fn.decode_launches for name, fn in WRAPPERS.items()
            if hasattr(fn, "decode_launches")}


def prefill_launch_counts() -> Dict[str, int]:
    """The dense GEMMs' launches on the tensor-core prefill tile (every
    operand pair at M > 16, and the ABFT tiles recomputed from such
    launches, csrc/prefill_tile.cuh; every variant) since the last reset."""
    return {name: fn.prefill_launches for name, fn in WRAPPERS.items()
            if hasattr(fn, "prefill_launches")}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        for tile in ("decode_launches", "prefill_launches"):
            if hasattr(fn, tile):
                setattr(fn, tile, 0)
        for v in getattr(fn, "variants", {}):
            fn.variants[v] = 0
