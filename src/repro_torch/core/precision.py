"""PrecisionPolicy / QuantSpec: one source of truth for mixed precision
(port of `repro/core/precision.py`).

Pure metadata, as in JAX:
  - ``QuantSpec``: how ONE operand is represented (target dtype and scale
    granularity: "tensor" = one scale; "tile" = one scale per output row of
    A / output column of B, constant along K, so the scale applies once at
    the GEMM's single write-back).  Also the KV page payload
    (`models/layers.py::Attention.init_paged_cache`, int8 or fp8 pages with
    per-(row, head) f32 scale pages).
  - ``PrecisionPolicy``: the (a, b, acc, out) bundle that `core/ops.py`
    quantizes by and the GEMM kernels consume (narrow payloads in, f32 or
    exact int32 accumulation, dequant scales at the store).
  - ``NAMED_POLICIES`` / ``resolve_precision``: what models and configs
    declare per projection (`Config.precision`), and ``use_precision``,
    the ambient context every `ops.linear` / `ops.grouped_matmul` inside it
    takes (an explicit per-call declaration wins).

``SparsitySpec`` declares 2:4 sparsity on the weight operand: `core/ops.py`
prunes the original weight, quantizes it under ``b``, and compresses the
payload to the wire format of `kernels/sparse.py`, which the 2:4 GEMM
kernels stream ("sparse24", "sparse24_int8").
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Union

import torch

# name -> (torch dtype, bytes/elem, qmax for symmetric scaling; None = cast-only)
DTYPES = {
    "f32": (torch.float32, 4, None),
    "bf16": (torch.bfloat16, 2, None),
    "int8": (torch.int8, 1, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 1, 448.0),  # max finite e4m3
}
GRANULARITIES = ("tensor", "tile")
SPARSITY_KINDS = ("2:4",)


@dataclasses.dataclass(frozen=True)
class SparsitySpec:
    """Structured N:M sparsity declaration for the weight (B) operand: of
    every 4 consecutive elements along K the 2 largest survive, and the
    weight travels as the kept values plus 2-bit position metadata
    (`kernels/sparse.py`)."""

    kind: str = "2:4"

    def __post_init__(self):
        if self.kind not in SPARSITY_KINDS:
            raise ValueError(
                f"unknown sparsity kind {self.kind!r}; one of {SPARSITY_KINDS}")


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


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-operand precision for one GEMM: D = dequant(A_q @ B_q) + epilogue.

    ``a`` is the activation operand, ``b`` the weight operand.  Accumulation
    is always f32 (exact int32 for int8 x int8); ``out`` overrides the
    output dtype (None = the caller's out_dtype).  ``b_sparse`` declares 2:4
    sparsity on the weight (pruned, quantized, then compressed by
    `core/ops.py`).  Frozen and hashable, as in JAX."""

    a: QuantSpec = QuantSpec()
    b: QuantSpec = QuantSpec()
    acc: str = "f32"
    out: Optional[str] = None
    b_sparse: Optional[SparsitySpec] = None

    def __post_init__(self):
        if self.acc != "f32":
            raise ValueError(
                f"only f32 accumulation is supported (the MX accumulator), "
                f"got acc={self.acc!r}")
        if self.out is not None and self.out not in DTYPES:
            raise ValueError(f"unknown out dtype {self.out!r}; one of {tuple(DTYPES)}")

    @property
    def out_torch_dtype(self) -> Optional[torch.dtype]:
        return None if self.out is None else DTYPES[self.out][0]

    @property
    def any_quantized(self) -> bool:
        return self.a.quantized or self.b.quantized

    def is_noop_for(self, a_dtype, b_dtype) -> bool:
        """True when applying this policy changes nothing (pure passthrough)."""
        return not (self.a.transforms(a_dtype) or self.b.transforms(b_dtype)
                    or self.out is not None or self.b_sparse is not None)


def calibrate_static_scale(spec: QuantSpec, samples, *,
                           margin: float = 1.0) -> QuantSpec:
    """Offline calibration: the max |activation| over representative
    ``samples`` fixes the operand's scale once (times ``margin``), so later
    calls skip the per-call amax reduction; values beyond the calibrated
    range saturate at +-qmax.  Returns a new frozen spec."""
    if not spec.quantized:
        raise ValueError(f"spec {spec} is cast-only; nothing to calibrate")
    if margin <= 0:
        raise ValueError(f"margin must be > 0, got {margin}")
    amax = 0.0
    for x in samples:
        amax = max(amax, float(torch.as_tensor(x).float().abs().max()))
    scale = (amax * margin) / spec.qmax if amax > 0 else 1.0
    return dataclasses.replace(spec, static_scale=float(scale))


# "none" = no declaration: resolves to None, so the ambient use_precision()
# context still applies (the default of config and module fields).  "f32"
# = an explicit FORCING declaration: an identity policy that overrides the
# ambient context.  Quantized defaults: weights int8 / fp8 per column,
# activations bf16 (cast only); "_all" quantizes the activations per row
# too, "int8_tensor" both operands per tensor.
NAMED_POLICIES = {
    "none": None,
    "f32": PrecisionPolicy(),
    "bf16": PrecisionPolicy(a=QuantSpec("bf16"), b=QuantSpec("bf16")),
    "int8": PrecisionPolicy(a=QuantSpec("bf16"), b=QuantSpec("int8", "tile")),
    "int8_all": PrecisionPolicy(a=QuantSpec("int8", "tile"),
                                b=QuantSpec("int8", "tile")),
    "int8_tensor": PrecisionPolicy(a=QuantSpec("int8", "tensor"),
                                   b=QuantSpec("int8", "tensor")),
    "fp8": PrecisionPolicy(a=QuantSpec("bf16"), b=QuantSpec("fp8_e4m3", "tile")),
    "fp8_all": PrecisionPolicy(a=QuantSpec("fp8_e4m3", "tile"),
                               b=QuantSpec("fp8_e4m3", "tile")),
    "sparse24": PrecisionPolicy(b_sparse=SparsitySpec()),
    "sparse24_int8": PrecisionPolicy(a=QuantSpec("bf16"),
                                     b=QuantSpec("int8", "tile"),
                                     b_sparse=SparsitySpec()),
}


def resolve_precision(p: Union[None, str, PrecisionPolicy]) -> Optional[PrecisionPolicy]:
    """None / registry name / policy object -> Optional[PrecisionPolicy]."""
    if p is None or isinstance(p, PrecisionPolicy):
        return p
    try:
        return NAMED_POLICIES[p]
    except KeyError:
        raise ValueError(
            f"unknown precision {p!r}; one of {tuple(NAMED_POLICIES)}") from None


_state = threading.local()


def current_precision() -> Optional[PrecisionPolicy]:
    """The ambient PrecisionPolicy, or None (no quantization)."""
    return getattr(_state, "precision", None)


@contextlib.contextmanager
def use_precision(p: Union[None, str, PrecisionPolicy]):
    """Route every ops.linear / ops.grouped_matmul inside the context
    through the given precision policy (explicit per-call args win)."""
    prev = getattr(_state, "precision", None)
    _state.precision = resolve_precision(p)
    try:
        yield _state.precision
    finally:
        _state.precision = prev
