"""Symmetric-scale quantization (port of `compute_scale` / `quantize` /
`dequantize` / `quantize_operand` from `repro/kernels/quant.py`).

Plain tensor code, as in JAX, consumed from two directions:
  - the int8 / fp8 paged KV cache quantizes each K/V row on write
    (`models/layers.py::Attention._write_kv_pages`) and the attention
    kernels dequantize on read;
  - `quantize_operand` prepares a GEMM operand for `core/ops.py`: the
    payload in the target dtype plus an f32 scale shaped for the kernel's
    write-back, (..., M, 1) per row of A and (..., 1, N) per column of B
    (per expert on a (G, K, N) stack).
The arithmetic follows JAX step by step so both packages hold the same
payload bytes: the amax is taken in f32, the scale is amax / qmax (1.0
where the amax is 0), the payload is `x / scale` (a division, not a
multiply by the reciprocal), int8 rounds half to even (`torch.round`, like
`jnp.round`) before clipping to +-127, and fp8 clips to +-448 before the
cast (an e4m3 overflow would be NaN).

`quantize_int8_tensor` is the int8 wire format of the gradient
compression (`optim/compression.py`), bitwise JAX's;
`quantize_int8_stochastic` rounds stochastically with a `torch.Generator`
(JAX's draws come from its threefry key, which torch does not reproduce:
the payloads are unbiased and pure in the generator's seed, not JAX's).
`executed_gemm_bytes` derives the as-executed HBM bytes of one GEMM launch
from its concrete operands and tile (padded shapes, real itemsizes, scale
sidecars, 2:4 metadata), as JAX's does; `launch_gemm_bytes` applies it at
the tile `core.tiling.plan_matmul_tiles` prices for the launch, so kernel
1's and kernel 2's launches each get their own bytes.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
    return payload(x, spec, scale), scale


def payload(x: torch.Tensor, spec: QuantSpec, scale: torch.Tensor) -> torch.Tensor:
    """The quantized payload of x under `scale` (broadcastable to x)."""
    scaled = x.float() / scale
    if spec.dtype == "int8":
        return torch.clamp(torch.round(scaled), -spec.qmax, spec.qmax).to(torch.int8)
    return torch.clamp(scaled, -spec.qmax, spec.qmax).to(spec.torch_dtype)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 reconstruction; broadcasting covers every scale granularity."""
    return q.float() * scale


def quantize_operand(x: torch.Tensor, spec: QuantSpec, operand: str, *,
                     row_groups: Optional[Sequence[int]] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply one QuantSpec to a GEMM operand.

    operand "a": (..., M, K) activations, "tile" scales per row, returned
    (..., M, 1); operand "b": (..., K, N) weights, "tile" scales per
    column, (..., 1, N) (per expert on a (G, K, N) stack).  "tensor" takes
    one amax over the whole operand (the whole expert stack for "b") and
    broadcasts it to the same tile shape.  Cast-only specs return
    (cast payload, None); an "f32" spec is the identity.

    ``row_groups`` (operand "a" (T, K), "tensor" granularity, no static
    scale): the rows are laid out as (outer, G, inner) = row_groups, and
    one amax is taken per index of the middle axis -- the routing groups of
    the MoE's expert-major buffer, which JAX quantizes one group per call."""
    if operand not in ("a", "b"):
        raise ValueError(f"operand must be 'a' or 'b', got {operand!r}")
    if not spec.quantized:
        if spec.dtype == "f32" or x.dtype == spec.torch_dtype:
            return x, None
        return x.to(spec.torch_dtype), None
    if operand == "b" and x.dim() == 3:
        return _quantize_stack(x, spec)
    k_axis = x.dim() - 1 if operand == "a" else x.dim() - 2
    if spec.granularity == "tile":
        return quantize(x, spec, axis=k_axis)
    tile_shape = list(x.shape)
    tile_shape[k_axis] = 1
    if row_groups is not None and spec.static_scale is None:
        if operand != "a" or x.dim() != 2:
            raise ValueError("row_groups apply to a 2-D activation operand")
        amax = x.reshape(*row_groups, -1).float().abs().amax(dim=(0, 2, 3))
        sg = torch.where(amax > 0, amax / spec.qmax, torch.ones_like(amax)).float()
        scale = sg[None, :, None].expand(*row_groups).reshape(tile_shape)
        return payload(x, spec, scale), scale
    q, scale = quantize(x, spec, axis=None)
    return q, torch.broadcast_to(scale.reshape((1,) * x.dim()), tile_shape)


def _quantize_stack(w: torch.Tensor, spec: QuantSpec):
    """A (G, K, N) expert stack as quantize_operand(w, spec, "b") would
    quantize it whole (per expert and column; "tensor": one amax over the
    stack), one expert at a time, so no f32 temporary of the stack is made
    (grok-1's (8, 6144, 32768) stacks are 6.4 GB each in f32)."""
    G, _, N = w.shape
    q = torch.empty(w.shape, dtype=spec.torch_dtype, device=w.device)
    if spec.granularity == "tile":
        scale = torch.empty((G, 1, N), dtype=torch.float32, device=w.device)
        for g in range(G):
            q[g], scale[g] = quantize(w[g], spec, axis=0)
        return q, scale
    if spec.static_scale is not None:
        s = torch.full((), spec.static_scale, dtype=torch.float32, device=w.device)
    else:
        amax = torch.zeros((), dtype=torch.float32, device=w.device)
        for g in range(G):
            amax = torch.maximum(amax, w[g].float().abs().amax())
        s = torch.where(amax > 0, amax / spec.qmax, torch.ones_like(amax))
    for g in range(G):
        q[g] = payload(w[g], spec, s)
    return q, torch.broadcast_to(s.reshape(1, 1, 1), (G, 1, N))


# ---------------------------------------------------------------------------
# per-tensor int8 wire format (gradient compression)
# ---------------------------------------------------------------------------


def quantize_int8_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (int8 payload, scalar f32 scale), the wire
    format of the compressed gradient all-reduce."""
    scale = compute_scale(x, 127.0, axis=None)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8_stochastic(x: torch.Tensor, generator: torch.Generator, *, axis=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastically rounded symmetric int8: (payload, f32 scale).

    floor(x / scale + u), u ~ U[0, 1) drawn from `generator`, rounds up with
    probability equal to the fractional part, so E[dequantize(q)] == x
    elementwise (where |x| / scale stays inside +-127).  The same generator
    state and operand give the same payload; `generator` lives on x's
    device.  `axis` selects the amax granularity as in `quantize`."""
    scale = compute_scale(x, 127.0, axis=axis)
    noise = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.floor(x.float() / scale + noise), -127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------------------
# as-executed traffic accounting
# ---------------------------------------------------------------------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _grid(M: int, N: int, K: int, bm: int, bn: int, bk: int):
    """(nm, nn, Mp, Np, Kp): the tile counts along M and N and the padded
    extents of a launch (a tile larger than its dimension shrinks to it)."""
    bm_, bn_, bk_ = min(bm, M), min(bn, N), min(bk, K)
    nm, nn, nk = _ceil_div(M, bm_), _ceil_div(N, bn_), _ceil_div(K, bk_)
    return nm, nn, nm * bm_, nn * bn_, nk * bk_


def _b_panel(b: torch.Tensor, b_meta: Optional[torch.Tensor], nm: int, Kp: int, Np: int) -> int:
    """A weight panel's bytes, one pass per M-tile: the dense (Kp, Np) rows,
    or the 2:4 payload (Kp/2, Np) with its packed metadata (Kp/8, Np)."""
    if b_meta is None:
        return nm * Kp * Np * b.dtype.itemsize
    return nm * (Kp // 2) * Np * b.dtype.itemsize + nm * (Kp // 8) * Np * b_meta.dtype.itemsize


def executed_gemm_bytes(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int, bk: int,
                        out_itemsize: int, scales: Tuple[Optional[torch.Tensor], ...] = (),
                        b_meta: Optional[torch.Tensor] = None) -> int:
    """HBM bytes one GEMM launch moves, derived from the CONCRETE operands
    and tile (JAX's function on torch tensors): padded shapes, real payload
    itemsizes, one A-panel pass per N-tile and one B-panel pass per M-tile,
    a single M*N write-back, plus the scale sidecars (each scale panel
    rides with its tile once per revisit).

    With ``b_meta`` (2:4 sparse) ``b`` is the compressed (K/2, N) payload
    and the metadata panel (K/8, N uint8) streams with the same per-M-tile
    revisits.  Against `transfer_model.HopperGemmTiling.hbm_bytes`
    (unpadded problem, payloads only) it differs by the padding and the
    scale traffic alone."""
    M, K = a.shape[-2], a.shape[-1]
    nm, nn, Mp, Np, Kp = _grid(M, b.shape[-1], K, bm, bn, bk)
    total = (
        nn * Mp * Kp * a.dtype.itemsize    # A panel re-read per N-tile
        + _b_panel(b, b_meta, nm, Kp, Np)  # B panel re-read per M-tile
        + Mp * Np * out_itemsize           # the single write-back
    )
    for s in scales:
        if s is None:
            continue
        # a scale panel is (M, 1) or (1, N): revisited once per opposite tile
        revisits = nn if s.shape[-1] == 1 else nm
        total += revisits * s.numel() * s.dtype.itemsize
    return int(total)


def launch_gemm_bytes(a: torch.Tensor, b: torch.Tensor, *, variant: str = "dense",
                      b_gate: Optional[torch.Tensor] = None,
                      scales: Tuple[Optional[torch.Tensor], ...] = (),
                      b_meta: Optional[torch.Tensor] = None,
                      bg_meta: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None) -> int:
    """`executed_gemm_bytes` of one launch of kernel 1 (`mx_matmul_fused`,
    variant "dense", "sparse" or "abft") or kernel 2 (`baseline_matmul`,
    "baseline") on a (M, K) and b (K, N), at the tile
    `core.tiling.plan_matmul_tiles` prices for it; plus the gate's weight
    panel (and metadata) of a swiglu launch, and for kernel 2 its output
    round trips: one read and one write per further `tiling.BASELINE_BK`
    rows of K.  ``scales``: every f32 scale operand of the launch (a_scale,
    b_scale, bg_scale); ``out_dtype`` defaults to the launch's (a's, f32
    for int8 / e4m3 activations)."""
    from ..core import tiling

    M, K = a.shape
    N = b.shape[1]
    if out_dtype is None:
        out_dtype = a.dtype if a.dtype in (torch.float32, torch.bfloat16) else torch.float32
    plan = tiling.plan_matmul_tiles(M, N, K, a.dtype, b.dtype, variant,
                                    gated=b_gate is not None, out_dtype=out_dtype)
    total = executed_gemm_bytes(a, b, bm=plan.bm, bn=plan.bn, bk=plan.bk,
                                out_itemsize=out_dtype.itemsize, scales=scales, b_meta=b_meta)
    nm, _, Mp, Np, Kp = _grid(M, N, K, plan.bm, plan.bn, plan.bk)
    if b_gate is not None:
        total += _b_panel(b_gate, bg_meta, nm, Kp, Np)
    if variant == "baseline":
        total += 2 * (_ceil_div(K, tiling.BASELINE_BK) - 1) * Mp * Np * out_dtype.itemsize
    return int(total)
