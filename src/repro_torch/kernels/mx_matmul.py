"""MX GEMM with a declarative fused epilogue (port of
`repro/kernels/mx_matmul.py`).

`mx_matmul_fused` computes D = epilogue(A @ B): on a CUDA tensor it launches
the Hopper kernel `csrc/mx_matmul.cu` (f32 accumulators held for the whole
K loop, the epilogue applied once, one store; decode rows, M <= 16, stream
the weight through `csrc/decode_tile.cuh`'s loop with `_build.decode_tile`'s
tile; the rows at M > 16 of every operand pair run the tensor-core loop of
`csrc/prefill_tile.cuh` with `_build.prefill_tile`'s tile, int8 x int8 and
e4m3 x e4m3 on the 8-bit route: the s8 MMA, e4m3 widened to f16; the 2:4
and ABFT variants run the same two loops); on a CPU
tensor it runs `mx_matmul_fused_plain`, the plain PyTorch version of the
same function, which the tests hold against the JAX kernel and which
`chip_smoke.py` holds the CUDA kernel against on the card.

Quantized operands (stage 1b): a / b / b_gate carry int8 or fp8 payloads
(or bf16 casts), with per-row `a_scale` (M, 1) and per-column `b_scale` /
`bg_scale` (1, N) f32 dequant scales applied at the single write-back;
int8 x int8 accumulates exactly (int32 sums, K <= `_build.INT8_MAX_K`),
every other pair in f32.

2:4 sparse weights (stage 1c): b / b_gate carry the compressed payloads
(K/2, N) with uint8 metadata (K/8, N) (`kernels/sparse.py`); the CUDA
variant `csrc/mx_matmul_sparse.cu` streams them as they are and expands
them on the card (in registers at decode height, in shared memory on the
tensor cores), the plain version through `expand_24`.

ABFT (stage 1d): with ``abft`` (an `AbftSpec`) the call returns (out,
flags), flags the (grid_m, grid_n) int32 per-tile corruption map over the
tiles of `_build.gemm_tile` (`csrc/mx_matmul_abft.cu` on the card; on the
CPU the plain version takes JAX's checksum arithmetic over the same
tiles), with optional per-tile fault operands.  The output is bitwise the
output without ABFT.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .abft import AbftSpec, make_abft_spec
from .sparse import expand_24

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


def abft_spec_for(a: torch.Tensor, b: torch.Tensor, *, inject: bool = False) -> AbftSpec:
    """The AbftSpec of an (M, K) x (K, N) launch of `mx_matmul_fused` on
    these operand dtypes, its rtol from the tile the kernel launches."""
    bm, bn, _ = _build.gemm_tile(a.shape[0])
    return make_abft_spec(a.dtype, b.dtype, a.shape[1], bm, bn, inject=inject)


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def abft_plain(a, b, acc, spec: AbftSpec, bm: int, bn: int, fault_delta=None,
               fault_row=None, fault_col=None):
    """JAX's checksum arithmetic (`abft_accumulate` / `abft_inject` /
    `abft_verify`) over the (bm, bn) tiles of one (M, K) x (K, N) product:
    returns the finished accumulator with the fault operands applied (f32;
    integers exact below 2^24, as the kernel widens them) and the (grid_m,
    grid_n) int32 flag map.  `acc` is the product `dot_f32(a, b)`.  Integer
    payloads sum exactly (in f64, exact here) and compare modulo 2^32, as
    the kernel's wrapping 32-bit sums; floats compare against rtol *
    |.|-checksum + atol in f32."""
    M, K = a.shape
    N = b.shape[1]
    gm, gn = -(-M // bm), -(-N // bn)
    Mp, Np = gm * bm, gn * bn
    ct = torch.float64 if spec.exact else torch.float32
    ap, bp = _pad2(a.to(ct), Mp, K), _pad2(b.to(ct), K, Np)
    full = torch.matmul(ap, bp) if spec.exact else _pad2(acc.float(), Mp, Np)
    faults = [] if fault_delta is None else torch.nonzero(fault_delta != 0).tolist()
    for ti, tj in faults:
        r = ti * bm + int(fault_row[ti, tj])
        c = tj * bn + int(fault_col[ti, tj])
        d = float(fault_delta[ti, tj])
        full[r, c] += float(int(d)) if spec.exact else d

    def sums(x, y):
        return (x.reshape(gm, bm, K).sum(1) @ y,        # ccol (gm, Np)
                x @ y.reshape(K, gn, bn).sum(2))        # crow (Mp, gn)

    ccol, crow = sums(ap, bp)
    scol = full.reshape(gm, bm, Np).sum(1)
    srow = full.reshape(Mp, gn, bn).sum(2)
    if spec.exact:
        col_bad = (scol - ccol).long() % 2**32 != 0
        row_bad = (srow - crow).long() % 2**32 != 0
    else:
        acol, arow = sums(ap.abs(), bp.abs())
        col_bad = (scol - ccol).abs() > spec.rtol * acol + spec.atol
        row_bad = (srow - crow).abs() > spec.rtol * arow + spec.atol
    flags = (col_bad.reshape(gm, gn, bn).any(-1)
             | row_bad.reshape(gm, bm, gn).any(1)).to(torch.int32)
    # with no fault the accumulator is returned as given: the epilogue then
    # sees the very tensor it sees without ABFT (torch's CPU activations
    # may round a strided view differently)
    return (full[:M, :N].float().contiguous() if faults else acc), flags


def mx_matmul_fused_plain(a, b, *, epilogue: Epilogue = Epilogue(),
                          b_gate=None, bias=None, residual=None, a_scale=None,
                          b_scale=None, bg_scale=None, b_meta=None, bg_meta=None,
                          out_dtype=None, abft: Optional[AbftSpec] = None,
                          fault_delta=None, fault_row=None, fault_col=None):
    """The plain PyTorch version of the fused kernel: `dot_f32` of the same
    payloads (2:4 payloads through `expand_24` first), then
    `apply_epilogue` with the scales; with ``abft`` also the flag map
    (`abft_plain` over `_build.gemm_tile`'s tiles), returned as (out,
    flags)."""
    if b_meta is not None:
        b = expand_24(b, b_meta)
        if b_gate is not None:
            b_gate = expand_24(b_gate, bg_meta)
    y = dot_f32(a, b)
    flags = None
    if abft is not None:
        bm, bn, _ = _build.gemm_tile(a.shape[0])
        y, flags = abft_plain(a, b, y, abft, bm, bn, fault_delta, fault_row, fault_col)
    gate = dot_f32(a, b_gate) if epilogue.has_gate else None
    out = apply_epilogue(y, epilogue, bias=bias, gate=gate, residual=residual,
                         a_scale=a_scale, b_scale=b_scale, bg_scale=bg_scale,
                         out_dtype=out_dtype or a.dtype)
    return out if abft is None else (out, flags)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# a, b, b_gate, [b_meta, bg_meta], a_scale, b_scale, bg_scale, bias, then
# _EPI, then the tile: the decode tile's (bn, bk, tm, stages, threads, va,
# vb[, vm]) or the prefill tile's (bm, bn, stages, split, parts, va, vb,
# vm); then [flags, fault_delta, fault_row, fault_col, rtol, atol], stream
_EPI = (_I, _P, _I, _P) + (_I,) * 8 + (_F,)  # bias_dt .. out_scale
_DECODE_TILE, _PREFILL_TILE = (_I,) * 7, (_I,) * 8
_LAUNCHERS = {  # variant -> (source, symbol, argtypes); "decode" is the dense one
    "decode": ("mx_matmul", "mx_matmul_decode_launch",
               (_P,) * 7 + _EPI + _DECODE_TILE + (_P,)),
    "sparse": ("mx_matmul_sparse", "mx_matmul_sparse_launch",
               (_P,) * 9 + _EPI + _DECODE_TILE + (_I, _P)),
    "abft": ("mx_matmul_abft", "mx_matmul_abft_launch",
             (_P,) * 7 + _EPI + _DECODE_TILE + (_P,) * 4 + (_F, _F, _P)),
    "dense prefill": ("mx_matmul", "mx_matmul_prefill_launch",
                      (_P,) * 7 + _EPI + _PREFILL_TILE + (_P,)),
    "sparse prefill": ("mx_matmul_sparse", "mx_matmul_sparse_prefill_launch",
                       (_P,) * 9 + _EPI + _PREFILL_TILE + (_P,)),
    "abft prefill": ("mx_matmul_abft", "mx_matmul_abft_prefill_launch",
                     (_P,) * 7 + _EPI + _PREFILL_TILE + (_P,) * 4 + (_F, _F, _P)),
}


def decode_launch_tile(a: torch.Tensor, b: torch.Tensor, b_gate=None, b_meta=None,
                       bg_meta=None, variant: str = "dense"):
    """The decode launch's tile arguments (bn, bk, tm, stages, threads, va,
    vb), and for "sparse" vm, for operands a (M <= 16, K) and b / b_gate
    (K, N), or their 2:4 payloads (K/2, N) with metadata (K/8, N):
    `_build.decode_tile` of the variant, and the copy widths of A's, B's
    and the metadata's rows from their row bytes and base addresses
    (`_build.copy_width`; a metadata row takes at most bn bytes a copy)."""
    M, K = a.shape
    N = b.shape[1]
    t = _build.decode_tile(M, N, a.dtype, b.dtype, b_gate is not None, variant)
    va = _build.copy_width(K * a.element_size(), a.data_ptr(), vec=t.vec)
    vb = _build.copy_width(N * b.element_size(), b.data_ptr(),
                           *(() if b_gate is None else (b_gate.data_ptr(),)), vec=t.vec)
    tile = (t.bn, t.bk, t.tm, t.stages, t.threads, va, vb)
    if variant != "sparse":
        return tile
    vm = _build.copy_width(N, *(m.data_ptr() for m in (b_meta, bg_meta) if m is not None),
                           vec=min(t.vec, t.bn))
    return (*tile, vm)


def prefill_launch_tile(a: torch.Tensor, b: torch.Tensor, b_gate=None, b_meta=None,
                        bg_meta=None, variant: str = "dense"):
    """The tensor-core prefill launch's tile arguments (bm, bn, stages,
    split, parts, va, vb, vm) for operands a (M > 16, K) and b / b_gate
    (K, N), or their 2:4 payloads (K/2, N) with metadata (K/8, N):
    `_build.prefill_tile`, and the copy widths of A's, B's and the
    metadata's rows from their row bytes and base addresses
    (`_build.copy_width`)."""
    M, K = a.shape
    N = b.shape[1]
    # an ABFT tile of <= 16 rows recomputed on its parent launch's route
    # (`recompute_fused`) takes the tile of M = 17, which covers its rows
    t = _build.prefill_tile(max(M, _build.DECODE_MAX_M + 1), N, K, a.dtype, b.dtype,
                            b_gate is not None, variant)
    va = _build.copy_width(K * a.element_size(), a.data_ptr())
    vb = _build.copy_width(N * b.element_size(), b.data_ptr(),
                           *(() if b_gate is None else (b_gate.data_ptr(),)))
    vm = (_build.copy_width(N, *(m.data_ptr() for m in (b_meta, bg_meta) if m is not None))
          if b_meta is not None else _build.COPY_BYTES)
    return t.bm, t.bn, t.stages, t.split, t.parts, va, vb, vm


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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fault_operands(fault, device):
    """The fault operands as the contiguous f32 / int32 / int32 arrays the
    kernels read (or Nones)."""
    if fault[0] is None:
        return None, None, None
    return tuple(t.to(device=device, dtype=dt).contiguous()
                 for t, dt in zip(fault, (torch.float32, torch.int32, torch.int32)))


def fused_route(M: int, N: int, K: int, a_dtype: torch.dtype, b_dtype: torch.dtype,
                gated: bool = False, variant: str = "dense") -> str:
    """The K loop a launch of `mx_matmul_fused` runs on the card: "decode"
    (the rows at M <= 16 of every variant, csrc/decode_tile.cuh) or "mma"
    (the rows at M > 16 of every pair, csrc/prefill_tile.cuh).  `variant`:
    "dense", "sparse" or "abft"."""
    if M <= _build.DECODE_MAX_M:
        return "decode"
    return _build.prefill_tile(M, N, K, a_dtype, b_dtype, gated, variant).route


def grouped_route(T: int, N: int, K: int, G: int, a_dtype: torch.dtype,
                  b_dtype: torch.dtype, gated: bool = False, variant: str = "dense") -> str:
    """The K loop a launch of `mx_grouped_matmul` on x (T, K), w (G, K, N)
    runs on the card: "mma" for every pair (prefill_tile.cuh's loop per
    group, csrc/grouped_mma.cuh), `_build.grouped_tile`'s.  The grouped
    GEMM's ABFT recovery recomputes a flagged tile on it through
    `recompute_fused`, which gives the grouped launch's bits."""
    return _build.grouped_tile(T, N, K, G, a_dtype, b_dtype, gated, variant).route


def _launch_fused(a, b, epilogue, b_gate, bias, residual, a_scale, b_scale, bg_scale,
                  out_dtype, b_meta=None, bg_meta=None, abft=None, fault=(None,) * 3,
                  route=None):
    """Launch the dense, 2:4 sparse (b_meta given) or ABFT (abft given)
    variant of the kernel on CUDA operands, on `route` (`fused_route`'s,
    by default); returns out, or (out, flags)."""
    M, K = a.shape
    N = b.shape[1]
    variant = "sparse" if b_meta is not None else "abft" if abft is not None else "dense"
    a_dt, b_dt = _build.pair_codes(a, b, "mx_matmul_fused", sparse=variant == "sparse")
    _build.check_int8_k(a.dtype, b.dtype, K, "mx_matmul_fused")
    if b_gate is not None and b_gate.dtype != b.dtype:
        raise TypeError(f"mx_matmul_fused: b_gate dtype {b_gate.dtype} != b dtype "
                        f"{b.dtype}")
    kb = K // 2 if variant == "sparse" else K
    _require_cuda_operand(a, "a", a.device)
    _require_cuda_operand(b, "b", a.device, (kb, N))
    if b_gate is not None:
        _require_cuda_operand(b_gate, "b_gate", a.device, (kb, N))
    for t, what in ((b_meta, "b_meta"), (bg_meta, "bg_meta")):
        if t is not None:
            _require_cuda_operand(t, what, a.device, (K // 8, N))
    if bias is not None:
        _require_cuda_operand(bias, "bias", a.device, (N,))
    if residual is not None:
        _require_cuda_operand(residual, "residual", a.device, (M, N))
    scales = [_scale_vec(t, n, what, a.device) for t, n, what in (
        (a_scale, M, "a_scale"), (b_scale, N, "b_scale"), (bg_scale, N, "bg_scale"))]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if route is None:
        route = (fused_route(M, N, K, a.dtype, b.dtype, b_gate is not None, variant)
                 if M and N else "decode")
    if route not in ("decode", "mma"):
        raise ValueError(f"mx_matmul_fused: unknown route {route!r}; 'decode' or 'mma'")
    decode = route == "decode"
    flags = None
    if abft is not None:  # gemm_tile's grid; <= 16 rows on "mma" take M = 17's CTA tile
        bm, bn, _ = _build.gemm_tile(M if decode else max(M, _build.DECODE_MAX_M + 1))
        flags = torch.zeros((-(-M // bm), -(-N // bn)), dtype=torch.int32, device=a.device)
    if M == 0 or N == 0:
        return out if flags is None else (out, flags)
    if decode:
        tile = decode_launch_tile(a, b, b_gate, b_meta, bg_meta, variant)
        key = "decode" if variant == "dense" else variant
    else:
        tile = prefill_launch_tile(a, b, b_gate, b_meta, bg_meta, variant)
        key = f"{variant} prefill"
    source, symbol, argtypes = _LAUNCHERS[key]
    fn = _build.function(source, symbol, argtypes)
    head = [a.data_ptr(), b.data_ptr(), _ptr(b_gate)]
    if variant == "sparse":
        head += [b_meta.data_ptr(), _ptr(bg_meta)]
    args = [*head, *(_ptr(t) for t in scales), _ptr(bias),
            0 if bias is None else _build.dtype_code(bias.dtype, "bias"), _ptr(residual),
            0 if residual is None else _build.dtype_code(residual.dtype, "residual"),
            out.data_ptr(), _build.dtype_code(out_dtype, "out_dtype"),
            M, N, K, a_dt, b_dt, ACT_CODES[epilogue.activation],
            int(epilogue.out_scale is not None), float(epilogue.out_scale or 0.0), *tile]
    if variant == "abft":
        fd, fr, fc = _fault_operands(fault, a.device)
        args += [flags.data_ptr(), _ptr(fd), _ptr(fr), _ptr(fc), abft.rtol, abft.atol]
    err = fn(*args, _build.stream_ptr(a))
    _build.check(err, source, "mx_matmul_fused")
    mx_matmul_fused.launches += 1
    mx_matmul_fused.variants[variant] += 1
    mx_matmul_fused.decode_launches += decode
    mx_matmul_fused.prefill_launches += not decode
    return out if flags is None else (out, flags)


def _check_variant_args(b_sparse, meta, gmeta, gated, abft, fault, K, kb, N, Gshape=()):
    """JAX's argument rules for the 2:4 and ABFT slots, shared by both
    GEMM wrappers.  `kb`: the weight's contraction rows as given."""
    if abft is not None and not isinstance(abft, AbftSpec):
        raise TypeError(f"abft must be an AbftSpec (kernels/abft.make_abft_spec, or the "
                        f"wrapper's abft_spec_for), got {abft!r}")
    inject = abft is not None and abft.inject
    if inject != (fault[0] is not None):
        raise ValueError("fault operands must be given iff abft.inject")
    if any(t is not None for t in fault) and any(t is None for t in fault):
        raise ValueError("fault_delta, fault_row and fault_col go together")
    if b_sparse != (meta is not None):
        raise ValueError("the metadata (b_meta / w_meta) must be given iff b_sparse")
    if (gmeta is not None) != (b_sparse and gated):
        raise ValueError("the gate metadata (bg_meta / wg_meta) must be given iff "
                         "b_sparse AND gated")
    if b_sparse and abft is not None:
        raise ValueError("b_sparse does not compose with abft in-kernel; "
                         "decompress to dense for the checksummed path")
    if not b_sparse:
        if kb != K:
            raise ValueError(f"contraction mismatch: K={K} vs the weight's {kb}")
        return
    if 2 * kb != K:
        raise ValueError(f"sparse payload K/2={kb} inconsistent with the activations' "
                         f"K={K}")
    if K % 8 != 0:
        raise ValueError(f"2:4 sparse GEMM needs K % 8 == 0, got {K}")
    want = (*Gshape, K // 8, N)
    for t in (meta, gmeta):
        if t is not None and (tuple(t.shape) != want or t.dtype != torch.uint8):
            raise ValueError(f"the metadata must be uint8 {want}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def mx_matmul_fused(a: torch.Tensor, b: torch.Tensor, *,
                    epilogue: Epilogue = Epilogue(),
                    b_gate: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    residual: Optional[torch.Tensor] = None,
                    a_scale=None, b_scale=None, bg_scale=None,
                    b_sparse: bool = False, b_meta=None, bg_meta=None,
                    out_dtype=None, abft: Optional[AbftSpec] = None,
                    fault_delta=None, fault_row=None, fault_col=None):
    """D = epilogue(A @ B), the epilogue fused into the single write-back.
    a: (M, K), b: (K, N); bias: (N,); residual: (M, N); b_gate: (K, N)
    when epilogue.activation == "swiglu".

    Quantized operands: a / b / b_gate carry narrow payloads (the quantized
    values), with per-row ``a_scale`` (M, 1) and per-column ``b_scale`` /
    ``bg_scale`` (1, N) f32 scales (`kernels/quant.quantize_operand`), each
    given iff its epilogue flag is set.  out_dtype defaults to a.dtype;
    pass it for quantized payloads.

    2:4 sparsity: with ``b_sparse`` b / b_gate are the compressed payloads
    (K/2, N) and ``b_meta`` / ``bg_meta`` their uint8 metadata (K/8, N)
    (`kernels/sparse.compress_24`); K % 8 == 0.  Not with ``abft``.

    ABFT: with ``abft`` (`AbftSpec`, see `abft_spec_for`) returns (out,
    flags), flags the (grid_m, grid_n) int32 map over `_build.gemm_tile`'s
    tiles (0 = verified clean); ``fault_*`` are the optional (grid_m,
    grid_n) injection operands (`kernels/abft.build_fault_operands`),
    given iff ``abft.inject``.  out is bitwise the output without ABFT.

    A CUDA `a` launches `csrc/mx_matmul.cu` (dense; the pairs (f32, f32),
    (bf16, bf16), (bf16, int8), (bf16, fp8), (int8, int8), (fp8, fp8)),
    `csrc/mx_matmul_sparse.cu` (2:4; (f32, f32), (bf16, bf16), (bf16,
    int8)) or `csrc/mx_matmul_abft.cu` (ABFT; the dense pairs); a TypeError
    for any other pair.  The rows at M <= 16 run the decode tile
    (csrc/decode_tile.cuh), those at M > 16 of every pair the tensor-core
    loop (csrc/prefill_tile.cuh), in all three (`fused_route`).
    A CPU `a` takes `mx_matmul_fused_plain`.
    """
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"mx_matmul expects 2-D operands, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    fault = (fault_delta, fault_row, fault_col)
    M, K = a.shape
    N = b.shape[1]
    _check_variant_args(b_sparse, b_meta, bg_meta, epilogue.has_gate, abft, fault, K,
                        b.shape[0], N)
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
    for t, shape, what in ((a_scale, (M, 1), "a_scale"), (b_scale, (1, N), "b_scale"),
                           (bg_scale, (1, N), "bg_scale")):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")
    if fault_delta is not None:
        bm, bn, _ = _build.gemm_tile(M)
        grid = (-(-M // bm), -(-N // bn))
        for t in fault:
            if tuple(t.shape) != grid:
                raise ValueError(f"fault operand shape {tuple(t.shape)} != grid {grid}")
    _build.refuse_grad("mx_matmul_fused", a, b, b_gate, bias, residual, a_scale, b_scale,
                        bg_scale)
    out_dtype = out_dtype or a.dtype
    if a.is_cuda:
        return _launch_fused(a, b, epilogue, b_gate, bias, residual, a_scale, b_scale,
                             bg_scale, out_dtype, b_meta, bg_meta, abft, fault)
    return mx_matmul_fused_plain(a, b, epilogue=epilogue, b_gate=b_gate,
                                 bias=bias, residual=residual, a_scale=a_scale,
                                 b_scale=b_scale, bg_scale=bg_scale, b_meta=b_meta,
                                 bg_meta=bg_meta, out_dtype=out_dtype, abft=abft,
                                 fault_delta=fault_delta, fault_row=fault_row,
                                 fault_col=fault_col)


mx_matmul_fused.launches = 0  # kernel launches (CUDA tensors only), every variant
mx_matmul_fused.variants = {"dense": 0, "sparse": 0, "abft": 0}  # by variant
mx_matmul_fused.decode_launches = 0  # of every variant, those on the decode tile
mx_matmul_fused.prefill_launches = 0  # of every variant, those on the tensor-core prefill tile


def recompute_fused(route: str, a: torch.Tensor, b: torch.Tensor, *, epilogue: Epilogue,
                    abft: AbftSpec, b_gate=None, bias=None, residual=None, a_scale=None,
                    b_scale=None, bg_scale=None, out_dtype=None):
    """An ABFT launch of `mx_matmul_fused` on a given K loop, for the tile
    recoveries of core/ops.py (operands as the launch being recovered,
    sliced to the flagged tile's rows and columns): a CUDA `a` runs `route`
    ("decode" or "mma": `fused_route` or `grouped_route` of the launch it
    recovers) whatever its own M, so the recomputed tile gets that
    launch's bits; a CPU `a` takes
    `mx_matmul_fused_plain`.  Returns (out, flags)."""
    _build.refuse_grad("mx_matmul_fused", a, b, b_gate, bias, residual, a_scale, b_scale,
                        bg_scale)
    out_dtype = out_dtype or a.dtype
    if not a.is_cuda:
        return mx_matmul_fused_plain(a, b, epilogue=epilogue, b_gate=b_gate, bias=bias,
                                     residual=residual, a_scale=a_scale, b_scale=b_scale,
                                     bg_scale=bg_scale, out_dtype=out_dtype, abft=abft)
    return _launch_fused(a, b, epilogue, b_gate, bias, residual, a_scale, b_scale, bg_scale,
                         out_dtype, abft=abft, route=route)


def mx_matmul(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
              *, out_dtype=None) -> torch.Tensor:
    """D = A @ B (+ C): the general GEMM's C operand is the residual
    epilogue, added in f32 at the single write-back."""
    ep = Epilogue(residual=c is not None)
    return mx_matmul_fused(a, b, epilogue=ep, residual=c, out_dtype=out_dtype)
