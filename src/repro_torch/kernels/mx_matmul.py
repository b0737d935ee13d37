"""MX GEMM with a declarative fused epilogue (port of
`repro/kernels/mx_matmul.py`).

`mx_matmul_fused` computes D = epilogue(A @ B): on a CUDA tensor it launches
the Hopper kernel `csrc/mx_matmul.cu` (f32 accumulators held in registers
for the whole K loop, epilogue applied in registers, one store); on a CPU
tensor it runs `mx_matmul_fused_plain`, the plain PyTorch version of the
same function, which the tests hold against the JAX kernel and which
`chip_smoke.py` holds the CUDA kernel against on the card.

Quantized operands (stage 1b): a / b / b_gate carry int8 or fp8 payloads
(or bf16 casts), with per-row `a_scale` (M, 1) and per-column `b_scale` /
`bg_scale` (1, N) f32 dequant scales applied at the single write-back;
int8 x int8 accumulates exactly (an integer MAC), every other pair in f32.

Not ported yet (they raise NotImplementedError naming the ROADMAP item):
2:4 sparse weights (queue 2, item 1c) and ABFT checksums (1d).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

ACTIVATIONS = ("none", "relu", "gelu", "silu", "swiglu")
ACT_CODES = {a: i for i, a in enumerate(ACTIVATIONS)}  # csrc/common.cuh ReproAct


def apply_activation(x: torch.Tensor, activation: str) -> torch.Tensor:
    """Elementwise activations with the JAX package's numerics (gelu is
    the tanh approximation, as `jax.nn.gelu` defaults to)."""
    if activation == "none":
        return x
    if activation == "relu":
        return torch.relu(x)
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")
    if activation == "silu":
        return F.silu(x)
    raise ValueError(f"unknown activation {activation!r}; one of {ACTIVATIONS}")


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B with f32 accumulation for any operand dtype: int x int is an
    exact integer MAC before widening (summed in f64, which holds every
    partial sum of int8 products exactly for K < 2^37, on the CPU and on
    the card alike); mixed dtypes and narrow floats widen to f32 first;
    f32/bf16 products are exact in f32 either way."""
    if (a.dtype == b.dtype and not a.dtype.is_floating_point
            and not a.dtype.is_complex):
        return torch.matmul(a.double(), b.double()).to(torch.float32)
    return torch.matmul(a.float(), b.float())


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """What happens to the output tile at the single write-back, while it
    is still in registers (all in f32, in this order):

        acc *= a_scale * b_scale           [dequant: quantized operands]
        acc += bias                        [bias]
        acc  = act(acc)  or  silu(gate_acc) * acc   [swiglu]
        acc += residual                    [residual]
        acc *= out_scale                   [out_scale]
        out  = acc.to(out_dtype)           (the ONE write-back)
    """

    activation: str = "none"
    bias: bool = False
    residual: bool = False
    out_scale: Optional[float] = None
    a_scale: bool = False
    b_scale: bool = False

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(
                f"unknown activation {self.activation!r}; one of {ACTIVATIONS}")

    @property
    def has_gate(self) -> bool:
        return self.activation == "swiglu"

    @property
    def n_fused_ops(self) -> int:
        """How many elementwise HBM round-trips the fusion eliminates."""
        n = 0
        if self.a_scale:
            n += 1
        if self.b_scale:
            n += 1
        if self.bias:
            n += 1
        if self.activation == "swiglu":
            n += 2  # silu(gate) and the gating multiply
        elif self.activation != "none":
            n += 1
        if self.residual:
            n += 1
        if self.out_scale is not None:
            n += 1
        return n


def apply_epilogue(y, epilogue: Epilogue, *, bias=None, gate=None,
                   residual=None, a_scale=None, b_scale=None, bg_scale=None,
                   out_dtype=None):
    """Unfused application of an Epilogue to an f32 GEMM result, in exactly
    the order the fused kernel uses: dequant scales -> bias -> activation /
    gating -> residual -> out_scale."""
    if epilogue.has_gate != (gate is not None):
        raise ValueError("gate must be given iff epilogue.activation=='swiglu'")
    if epilogue.a_scale != (a_scale is not None):
        raise ValueError("a_scale operand must match epilogue.a_scale")
    if epilogue.b_scale != (b_scale is not None):
        raise ValueError("b_scale operand must match epilogue.b_scale")
    if (bg_scale is not None) != (epilogue.has_gate and epilogue.b_scale):
        raise ValueError("bg_scale must be given iff the epilogue is gated "
                         "AND b_scale is set")
    if a_scale is not None:
        y = y * a_scale
        if gate is not None:
            gate = gate * a_scale
    if b_scale is not None:
        y = y * b_scale
    if gate is not None and bg_scale is not None:
        gate = gate * bg_scale
    if bias is not None:
        y = y + bias.float()
    if epilogue.has_gate:
        y = F.silu(gate) * y
    else:
        y = apply_activation(y, epilogue.activation)
    if residual is not None:
        y = y + residual.float()
    if epilogue.out_scale is not None:
        y = y * float(epilogue.out_scale)
    return y if out_dtype is None else y.to(out_dtype)


def mx_matmul_fused_plain(a, b, *, epilogue: Epilogue = Epilogue(),
                          b_gate=None, bias=None, residual=None, a_scale=None,
                          b_scale=None, bg_scale=None, out_dtype=None):
    """The plain PyTorch version of the fused kernel: `dot_f32` of the same
    payloads, then `apply_epilogue` with the scales."""
    y = dot_f32(a, b)
    gate = dot_f32(a, b_gate) if epilogue.has_gate else None
    return apply_epilogue(y, epilogue, bias=bias, gate=gate, residual=residual,
                          a_scale=a_scale, b_scale=b_scale, bg_scale=bg_scale,
                          out_dtype=out_dtype or a.dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 7 + (_I, _P, _I, _P) + (_I,) * 8 + (_F, _P)


def _require_cuda_operand(t: torch.Tensor, what: str, device, shape=None):
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _scale_vec(t, n: int, what: str, device):
    """A (.., 1) or (1, ..) scale as the contiguous f32 (n,) the kernel reads."""
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    return t.reshape(n).to(torch.float32).contiguous()


def _launch_fused(a, b, epilogue, b_gate, bias, residual, a_scale, b_scale, bg_scale,
                  out_dtype):
    M, K = a.shape
    N = b.shape[1]
    a_dt, b_dt = _build.pair_codes(a, b, "mx_matmul_fused")
    if b_gate is not None and b_gate.dtype != b.dtype:
        raise TypeError(f"mx_matmul_fused: b_gate dtype {b_gate.dtype} != b dtype "
                        f"{b.dtype}")
    _require_cuda_operand(a, "a", a.device)
    _require_cuda_operand(b, "b", a.device, (K, N))
    if b_gate is not None:
        _require_cuda_operand(b_gate, "b_gate", a.device, (K, N))
    if bias is not None:
        _require_cuda_operand(bias, "bias", a.device, (N,))
    if residual is not None:
        _require_cuda_operand(residual, "residual", a.device, (M, N))
    scales = [_scale_vec(t, n, what, a.device) for t, n, what in (
        (a_scale, M, "a_scale"), (b_scale, N, "b_scale"), (bg_scale, N, "bg_scale"))]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    fn = _build.function("mx_matmul", "mx_matmul_fused_launch", _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(),
             None if b_gate is None else b_gate.data_ptr(),
             *(None if t is None else t.data_ptr() for t in scales),
             None if bias is None else bias.data_ptr(),
             0 if bias is None else _build.dtype_code(bias.dtype, "bias"),
             None if residual is None else residual.data_ptr(),
             0 if residual is None else _build.dtype_code(residual.dtype, "residual"),
             out.data_ptr(), _build.dtype_code(out_dtype, "out_dtype"),
             M, N, K, a_dt, b_dt, ACT_CODES[epilogue.activation],
             int(epilogue.out_scale is not None),
             float(epilogue.out_scale or 0.0), _build.stream_ptr(a))
    _build.check(err, "mx_matmul", "mx_matmul_fused")
    mx_matmul_fused.launches += 1
    return out


def mx_matmul_fused(a: torch.Tensor, b: torch.Tensor, *,
                    epilogue: Epilogue = Epilogue(),
                    b_gate: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    residual: Optional[torch.Tensor] = None,
                    a_scale=None, b_scale=None, bg_scale=None,
                    b_sparse: bool = False, b_meta=None, bg_meta=None,
                    out_dtype=None, abft=None) -> torch.Tensor:
    """D = epilogue(A @ B), the epilogue fused into the single write-back.
    a: (M, K), b: (K, N); bias: (N,); residual: (M, N); b_gate: (K, N)
    when epilogue.activation == "swiglu".

    Quantized operands: a / b / b_gate carry narrow payloads (the quantized
    values), with per-row ``a_scale`` (M, 1) and per-column ``b_scale`` /
    ``bg_scale`` (1, N) f32 scales (`kernels/quant.quantize_operand`), each
    given iff its epilogue flag is set.  out_dtype defaults to a.dtype;
    pass it for quantized payloads.

    A CUDA `a` launches `csrc/mx_matmul.cu` for the operand pairs
    (f32, f32), (bf16, bf16), (bf16, int8), (bf16, fp8), (int8, int8) and
    (fp8, fp8) (a TypeError for any other), f32 or bf16 output, ragged
    edges masked in the kernel; a CPU `a` takes `mx_matmul_fused_plain`.
    """
    if b_sparse or b_meta is not None or bg_meta is not None:
        raise NotImplementedError(
            "2:4 sparse weights are not ported yet: ROADMAP queue 2 item 1c")
    if abft is not None:
        raise NotImplementedError(
            "ABFT checksums are not ported yet: ROADMAP queue 2 item 1d")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"mx_matmul expects 2-D operands, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if epilogue.has_gate != (b_gate is not None):
        raise ValueError("b_gate must be given iff epilogue.activation=='swiglu'")
    if epilogue.bias != (bias is not None):
        raise ValueError("bias operand must match epilogue.bias")
    if epilogue.residual != (residual is not None):
        raise ValueError("residual operand must match epilogue.residual")
    if epilogue.a_scale != (a_scale is not None):
        raise ValueError("a_scale operand must match epilogue.a_scale")
    if epilogue.b_scale != (b_scale is not None):
        raise ValueError("b_scale operand must match epilogue.b_scale")
    if (bg_scale is not None) != (epilogue.has_gate and epilogue.b_scale):
        raise ValueError("bg_scale must be given iff the epilogue is gated "
                         "AND b_scale is set")
    M, N = a.shape[0], b.shape[1]
    for t, shape, what in ((a_scale, (M, 1), "a_scale"), (b_scale, (1, N), "b_scale"),
                           (bg_scale, (1, N), "bg_scale")):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")
    out_dtype = out_dtype or a.dtype
    if a.is_cuda:
        return _launch_fused(a, b, epilogue, b_gate, bias, residual, a_scale, b_scale,
                             bg_scale, out_dtype)
    return mx_matmul_fused_plain(a, b, epilogue=epilogue, b_gate=b_gate,
                                 bias=bias, residual=residual, a_scale=a_scale,
                                 b_scale=b_scale, bg_scale=bg_scale,
                                 out_dtype=out_dtype)


mx_matmul_fused.launches = 0  # kernel launches (CUDA tensors only)


def mx_matmul(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
              *, out_dtype=None) -> torch.Tensor:
    """D = A @ B (+ C): the general GEMM's C operand is the residual
    epilogue, added in f32 at the single write-back."""
    ep = Epilogue(residual=c is not None)
    return mx_matmul_fused(a, b, epilogue=ep, residual=c, out_dtype=out_dtype)
