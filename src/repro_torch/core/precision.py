"""QuantSpec: how one operand is represented (port of the `QuantSpec` /
`DTYPES` subset of `repro/core/precision.py`).

Pure metadata.  The port uses it for the int8 paged KV cache: payload in
the spec's dtype plus per-(row, head) f32 dequant scales
(`models/layers.py::Attention.init_paged_cache`).  `PrecisionPolicy` and the
quantized GEMM operands are not ported yet (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# name -> (torch dtype, bytes/elem, qmax for symmetric scaling; None = cast-only)
DTYPES = {
    "f32": (torch.float32, 4, None),
    "bf16": (torch.bfloat16, 2, None),
    "int8": (torch.int8, 1, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 1, 448.0),  # max finite e4m3
}
GRANULARITIES = ("tensor", "tile")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How one operand is represented on the HBM side.

    ``dtype``: one of DTYPES.  f32/bf16 are cast-only (no scales); int8 /
    fp8_e4m3 are symmetric-scale quantized with f32 scales.
    ``granularity``: "tensor" (one scale) or "tile" (per output row for the
    A operand, per output column for B).  ``static_scale``: a calibrated
    fixed scale that replaces the per-call amax reduction (values beyond
    the calibrated range saturate at +-qmax).
    """

    dtype: str = "f32"
    granularity: str = "tile"
    static_scale: Optional[float] = None

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; one of {tuple(DTYPES)}")
        if self.granularity not in GRANULARITIES:
            raise ValueError(
                f"unknown granularity {self.granularity!r}; one of {GRANULARITIES}")
        if self.static_scale is not None:
            if DTYPES[self.dtype][2] is None:
                raise ValueError(
                    f"static_scale only applies to quantized dtypes, got {self.dtype!r}")
            if not self.static_scale > 0:
                raise ValueError(f"static_scale must be > 0, got {self.static_scale}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype][0]

    @property
    def qmax(self) -> Optional[float]:
        return DTYPES[self.dtype][2]

    @property
    def quantized(self) -> bool:
        """True when the operand carries scales (int8/fp8)."""
        return self.qmax is not None

    def bytes_for(self, input_itemsize: int) -> int:
        """HBM bytes/element this operand moves.  A cast-only f32 spec keeps
        the incoming dtype (it is the identity, not an up-cast)."""
        if self.dtype == "f32":
            return input_itemsize
        return DTYPES[self.dtype][1]

    def transforms(self, input_dtype: torch.dtype) -> bool:
        """Does applying this spec change the operand at all?"""
        if self.quantized:
            return True
        if self.dtype == "f32":
            return False
        return input_dtype != self.torch_dtype
