"""Symmetric-scale quantization (port of `compute_scale` / `quantize` /
`dequantize` from `repro/kernels/quant.py`).

Plain tensor code, as in JAX: the int8 paged KV cache quantizes each K/V
row on write (`models/layers.py::Attention._write_kv_pages`) and the
attention kernels dequantize on read.  The arithmetic follows JAX step by
step so both packages store the same payload bytes: the amax is taken in
f32, the scale is amax / qmax (1.0 where the amax is 0), the payload is
`x / scale` (a division, not a multiply by the reciprocal), and int8 rounds
half to even (`torch.round`, like `jnp.round`) before clipping to +-127.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.precision import QuantSpec


def compute_scale(x: torch.Tensor, qmax: float, axis=None) -> torch.Tensor:
    """Symmetric scale: amax/qmax over `axis` (keepdims), 1.0 where amax==0."""
    ax = x.float().abs()
    amax = ax.amax() if axis is None else ax.amax(dim=axis, keepdim=True)
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax)).float()


def quantize(x: torch.Tensor, spec: QuantSpec, *, axis=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(payload, scale) for a quantized spec.  `axis` is the reduction axis
    of the amax (None = per tensor).  int8 rounds half to even and clips to
    +-127; fp8 clips to +-max-finite, then casts.  A spec with a
    `static_scale` uses that scalar in the keepdims layout `compute_scale`
    would give."""
    if not spec.quantized:
        raise ValueError(f"spec {spec} is cast-only; nothing to quantize")
    qmax = spec.qmax
    if spec.static_scale is not None:
        shape = () if axis is None else tuple(
            1 if i == (axis % x.dim()) else n for i, n in enumerate(x.shape))
        scale = torch.full(shape, spec.static_scale, dtype=torch.float32,
                           device=x.device)
    else:
        scale = compute_scale(x, qmax, axis=axis)
    scaled = x.float() / scale
    if spec.dtype == "int8":
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    else:
        q = torch.clamp(scaled, -qmax, qmax).to(spec.torch_dtype)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 reconstruction; broadcasting covers every scale granularity."""
    return q.float() * scale
