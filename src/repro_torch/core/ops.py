"""MX dispatch layer (port of `repro/core/ops.py`, dense and quantized).

Every weight-times-activation product of the model routes through
`matmul` / `linear`; `MXPolicy.backend` picks the physical path:

  - "cuda_mx"       -- the Hopper MX kernel (`kernels/mx_matmul.py`): f32
                       register accumulator over the whole K loop, the
                       epilogue fused into the single write-back.
  - "cuda_baseline" -- the paper's baseline (`kernels/baseline_matmul.py`):
                       partial sums read back and rewritten in the output
                       every `bk` columns of K, epilogue unfused.
  - "torch"         -- plain PyTorch ops, unfused (the A/B reference).

The default (`backend=None`) is "cuda_mx" for CUDA operands and "torch" on
the CPU.  The JAX package defaults to its plain "xla" backend everywhere
and its serve launcher never selects the kernels; the port departs from
that on purpose so that serving on the card runs the kernels.  The kernel
wrappers themselves run their plain versions on CPU tensors, so
"cuda_mx" / "cuda_baseline" on the CPU exercise this dispatch without a
card.

The CUDA kernels take their tiles from `kernels/_build.py`, the one tile
rule (by M; by the mean rows per group for the grouped GEMM), and the
baseline runs at its default read-modify-write chunk (bk = 128, the JAX
default).  JAX's tile planner (`repro/core/tiling.py`, a search under its
VMEM budget) becomes the pricer `core/tiling.plan_matmul_tiles`, which
re-derives no choice: it prices the tile a launch takes (shared memory,
register accumulator, HBM bytes).

`grouped_matmul` (the MoE expert GEMMs) runs the plain
`grouped_matmul_ref` on "torch" and the MX grouped kernel on both CUDA
backends: JAX's "pallas_baseline" takes its reference there, but the port
runs no plain version on the card, and the paper's A/B is the dense GEMM.

Mixed precision threads through as one object, `core.precision.
PrecisionPolicy`: an explicit `precision=` argument (policy or registry
name) or the ambient `use_precision()` context (linear and grouped_matmul
only, as in JAX).  `_prepare_quantized` quantizes the operands, and the
payloads and scales go to the fused kernel's scale slots on "cuda_mx" (and
the grouped kernel on both CUDA backends), or through JAX's unfused
quantized reference (`dot_f32` of the same payloads, then
`apply_epilogue`) on "torch".  The baseline GEMM has no scale slots: a
quantized `linear` on "cuda_baseline" computes the reference on the CPU
and raises on a CUDA tensor, where the port runs no plain version.

Weights are quantized once: the (payload, scale) of each weight operand
is kept and reused while the parameter is unchanged (the key is the
tensor, its in-place version counter, the spec and the sparsity), the same
bits as quantizing at every call, which JAX's jitted step does.
Activations are quantized at every call.

2:4 sparse policies ("sparse24", "sparse24_int8") prune the original
weight, quantize it, then compress the quantized payload (`kernels/
sparse.py`), once per parameter version like the quantized payloads; the
CUDA GEMMs take the compressed payload and its metadata (stages 1c / 5c),
"torch" expands it (JAX's unfused reference).  K % 8 != 0 keeps the
pruned weight dense-masked (no metadata), as in JAX.

ABFT (``abft=`` per call, or the ambient `kernels.abft.use_abft()`)
engages on "cuda_mx" only, as on JAX's "pallas_mx": the checksummed
kernels (stages 1d / 5d) return a per-tile flag map, which is read on the
host after each GEMM (one sync per GEMM), and each flagged tile is
recomputed alone through the same kernel on slices of the operands --
bitwise what the fault-free launch writes, since every output element is
one sequential MAC chain over K whatever the tile -- with `max_retries`
attempts before a typed `SDCError` (`abft_stats()` counts).  A sparse
weight under ABFT is expanded first (recovery slices dense panels), as in
JAX.

Tensor parallelism: `linear(..., tp_mode=...)` under an active
`parallel.sharding.collective_policy` runs the projection as a ring
collective GEMM over the policy's ring (`_collective_linear`,
`kernels/mx_collective_matmul.py`): "allgather" (x sharded on rows, w on
columns: q / k / v, up) or "reduce_scatter" (x and w sharded on the
contraction: out, down); without a policy the declaration is inert, as in
JAX.

Training differentiates "torch" (`launch/steps.make_train_step` sets it),
as JAX trains on "xla": the CUDA kernels have no backward, so every kernel
entry and every payload kept per parameter version (`_kept`: the quantized
and 2:4 weights, the ring's column shards) refuses a grad-enabled operand
that requires grad (`kernels/_build.refuse_grad`) rather than return an
output without a gradient.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import weakref
from typing import Dict, Optional, Sequence

import torch

from ..kernels import _build
from ..kernels import abft as abft_mod
from ..kernels.abft import AbftConfig, SDCError
from ..kernels.baseline_matmul import baseline_matmul
from ..kernels.mx_collective_matmul import (RING_STATS, ChunkCompute, ring_allgather_matmul,
                                            ring_matmul_reduce_scatter)
from ..kernels.mx_grouped_matmul import mx_grouped_matmul
from ..kernels.mx_grouped_matmul import abft_spec_for as grouped_abft_spec
from ..kernels.mx_matmul import (Epilogue, abft_spec_for, apply_epilogue, dot_f32,
                                 fused_route, grouped_route, mx_matmul_fused,
                                 recompute_fused)
from ..kernels.quant import quantize_operand
from ..kernels.ref import grouped_matmul_ref
from ..kernels.sparse import compress_24, expand_24, prune_24
from ..parallel.sharding import current_collectives
from .precision import (PrecisionPolicy, QuantSpec, SparsitySpec, current_precision,
                        resolve_precision)

BACKENDS = ("torch", "cuda_mx", "cuda_baseline")
TP_MODES = ("allgather", "reduce_scatter")


@dataclasses.dataclass(frozen=True)
class MXPolicy:
    backend: Optional[str] = None  # None: "cuda_mx" on CUDA, "torch" on CPU

    def __post_init__(self):
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of {BACKENDS}")

    def resolve(self, t: torch.Tensor) -> str:
        """The backend that runs for operand `t`."""
        if self.backend is not None:
            return self.backend
        return "cuda_mx" if t.is_cuda else "torch"


_state = threading.local()


def current_policy() -> MXPolicy:
    return getattr(_state, "policy", None) or MXPolicy()


@contextlib.contextmanager
def use_policy(policy: MXPolicy):
    prev = getattr(_state, "policy", None)
    _state.policy = policy
    try:
        yield policy
    finally:
        _state.policy = prev


def _resolve_abft(abft) -> Optional[AbftConfig]:
    """Per-call ``abft=`` wins (True -> defaults, False -> off, or an
    AbftConfig); None takes the ambient use_abft() context."""
    if abft is False:
        return None
    if abft is None:
        return abft_mod.current_abft()
    if abft is True:
        return AbftConfig()
    return abft


def _ambient_precision(precision) -> Optional[PrecisionPolicy]:
    """An explicit per-call precision (policy or registry name) wins; else
    the use_precision() context; else None.  None and "none" are no
    declaration and fall through to the context; "f32" is a real identity
    policy and so overrides it."""
    resolved = resolve_precision(precision) if precision is not None else None
    return resolved if resolved is not None else current_precision()


def _effective_precision(prec, a_dtype, b_dtype) -> Optional[PrecisionPolicy]:
    """Drop a policy that is the identity for these operand dtypes."""
    if prec is not None and prec.is_noop_for(a_dtype, b_dtype):
        return None
    return prec


# (data_ptr, shape, strides, dtype, device, spec, sparsity) -> (weakref to
# the parameter's base tensor, its version, (payload, scale, metadata))
_weights: Dict[tuple, tuple] = {}


def _sparse_operand(w: torch.Tensor, spec: QuantSpec):
    """JAX's sparse pipeline on one weight: prune the ORIGINAL weight, then
    quantize (per-column scales are constant along K, so pruning commutes
    with them), then compress the quantized payload.  Returns (payload,
    scale, metadata); metadata None when K % 8 != 0 (the pruned weight
    stays dense-masked).  An expert stack goes one expert at a time, except
    under a "tensor" spec, whose one scale spans the stack."""
    if w.dim() == 3 and not (spec.quantized and spec.granularity == "tensor"):
        first = _sparse_operand(w[0], spec)
        outs = [None if t is None else
                torch.empty((w.shape[0], *t.shape), dtype=t.dtype, device=t.device)
                for t in first]
        for g in range(w.shape[0]):
            part = first if g == 0 else _sparse_operand(w[g], spec)
            for o, t in zip(outs, part):
                if o is not None:
                    o[g] = t
        return tuple(outs)
    q, scale = quantize_operand(prune_24(w), spec, "b")
    if w.shape[-2] % 8 != 0:
        return q, scale, None
    payload, meta = compress_24(q)
    return payload, scale, meta


def _kept(cache: Dict[tuple, tuple], w: torch.Tensor, extra: tuple, make):
    """make(), kept in `cache` per parameter version: reused while the same
    tensor (a view of the same base, e.g. a layer of a stacked leaf) is
    unchanged in place.  The entry goes when the base tensor does.  What it
    keeps is made once and reused, so it holds no autograd graph: a weight
    that requires grad in a grad-enabled region raises (its gradient would
    be lost), as the kernels do (`_build.refuse_grad`)."""
    _build.refuse_grad("a kept weight operand (quantized, 2:4 or ring shard)", w)
    base = w if w._base is None else w._base
    key = (w.data_ptr(), tuple(w.shape), w.stride(), w.dtype, w.device, *extra)
    hit = cache.get(key)
    if hit is not None and hit[0]() is base and hit[1] == w._version:
        return hit[2]

    def drop(ref, key=key):
        entry = cache.get(key)
        if entry is not None and entry[0] is ref:
            del cache[key]

    made = make()
    cache[key] = (weakref.ref(base, drop), w._version, made)
    return made


def _weight_operand(w: torch.Tensor, spec: QuantSpec,
                    sparse: Optional[SparsitySpec] = None):
    """(payload, scale, metadata) of weight `w` under `spec` (and 2:4
    `sparse`), made once per parameter version (`_kept`)."""
    if sparse is None and not spec.transforms(w.dtype):
        return w, None, None
    return _kept(_weights, w, (spec, sparse), lambda: (
        _sparse_operand(w, spec) if sparse is not None
        else (*quantize_operand(w, spec, "b"), None)))


def clear_weight_cache() -> None:
    """Forget every kept weight payload (they are rebuilt at the next call)."""
    _weights.clear()


def _prepare_quantized(x, w, w_gate, prec: PrecisionPolicy,
                       a_row_groups: Optional[Sequence[int]] = None):
    """Quantize / cast / compress one GEMM's operands per the policy.
    Returns (qa, a_s, qb, b_s, qg, bg_s, b_meta, bg_meta); scales are None
    for cast-only specs, the metadata None for dense policies (and for
    K % 8 != 0).  The gate weight takes the same spec as w with its OWN
    scales."""
    qa, a_s = quantize_operand(x, prec.a, "a", row_groups=a_row_groups)
    qb, b_s, b_meta = _weight_operand(w, prec.b, prec.b_sparse)
    qg = bg_s = bg_meta = None
    if w_gate is not None:
        qg, bg_s, bg_meta = _weight_operand(w_gate, prec.b, prec.b_sparse)
    return qa, a_s, qb, b_s, qg, bg_s, b_meta, bg_meta


def _expand_sparse(qb, qg, b_meta, bg_meta):
    """A prepared sparse weight pair back to dense-masked form (the unfused
    reference, and the ABFT path): the SAME payload the sparse kernel
    streams, so both agree on the weight values bit for bit."""
    qb = expand_24(qb, b_meta)
    if qg is not None:
        qg = expand_24(qg, bg_meta)
    return qb, qg


def _flagged(flags: torch.Tensor):
    """The flagged tiles of a flag map, read on the host (a sync)."""
    return [tuple(t) for t in torch.nonzero(flags).tolist()]


def _sdc(flagged, what, cfg):
    abft_mod._bump("sdc_errors")
    raise SDCError(f"SDC persisted in {len(flagged)} {what}(s) {flagged} after "
                   f"{cfg.max_retries} recompute attempt(s)",
                   flagged=flagged, attempts=cfg.max_retries)


def _cols(t, c0, c1):
    return None if t is None else t[..., c0:c1].contiguous()


def _abft_fused_gemm(x2, w, *, ep, bias, residual, w_gate, a_s, b_s, bg_s, out_dtype,
                     cfg: AbftConfig):
    """One checksummed fused GEMM and the recovery protocol (JAX
    `_abft_fused_gemm`, eager): the kernel returns the (grid_m, grid_n)
    flag map; each flagged tile is recomputed ALONE, the same kernel on the
    tile's rows of x and columns of the weight (and of bias, residual and
    scales) on the launch's own K loop (`fused_route`: a last row tile of
    <= 16 rows of a tensor-core launch stays on the tensor cores), which
    gives the fault-free launch's bits; `cfg.max_retries` attempts, then
    SDCError.  `cfg.fault` corrupts the first attempt only."""
    M, K = x2.shape
    N = w.shape[-1]
    bm, bn, _ = _build.gemm_tile(M)
    gm, gn = -(-M // bm), -(-N // bn)
    spec = abft_spec_for(x2, w)
    base = dict(epilogue=ep, b_gate=w_gate, bias=bias, residual=residual, a_scale=a_s,
                b_scale=b_s, bg_scale=bg_s, out_dtype=out_dtype)
    fault = abft_mod.build_fault_operands(cfg.fault, gm, gn, bm, bn, device=x2.device)
    fkw = {} if fault is None else dict(zip(("fault_delta", "fault_row", "fault_col"), fault))
    out, flags = mx_matmul_fused(x2, w, abft=spec.with_inject(fault is not None), **fkw,
                                 **base)
    abft_mod._bump("gemms_verified")
    flagged = _flagged(flags)
    if not flagged:
        return out
    abft_mod._bump("tiles_flagged", len(flagged))
    n_bad = len(flagged)
    route = fused_route(M, N, K, x2.dtype, w.dtype, w_gate is not None, "abft")
    for _ in range(cfg.max_retries):
        still = []
        for ti, tj in flagged:
            r0, c0 = ti * bm, tj * bn
            r1, c1 = min(r0 + bm, M), min(c0 + bn, N)
            xs, ws = x2[r0:r1], _cols(w, c0, c1)
            t_out, t_flags = recompute_fused(
                route, xs, ws, epilogue=ep, b_gate=_cols(w_gate, c0, c1),
                bias=_cols(bias, c0, c1),
                residual=None if residual is None else _cols(residual[r0:r1], c0, c1),
                a_scale=None if a_s is None else a_s[r0:r1], b_scale=_cols(b_s, c0, c1),
                bg_scale=_cols(bg_s, c0, c1), out_dtype=out_dtype, abft=spec)
            if _flagged(t_flags):
                still.append((ti, tj))
                continue
            out[r0:r1, c0:c1] = t_out
        flagged = still
        if not flagged:
            abft_mod._bump("tiles_recovered", n_bad)
            return out
    _sdc(flagged, "tile", cfg)


def _abft_grouped_gemm(x, w, group_sizes, *, activation, w_gate, a_s, b_s, bg_s,
                       out_dtype, cfg: AbftConfig):
    """Checksummed grouped GEMM and recovery (JAX `_abft_grouped_gemm`,
    eager): each flagged (row tile, column tile) is recomputed per
    OVERLAPPING expert through the fused kernel on the tile's rows of x and
    that expert's weight columns, with the grouped kernel's epilogue order,
    and only that expert's rows are written back: the fault-free grouped
    launch's bits (`recompute_fused` on the grouped launch's route,
    `grouped_route`, "mma" for every pair: it sums the same K parts in the
    same order as the grouped launch at any row count).
    A flagged tile whose rows no group owns needs no recompute (its rows are
    zeros whatever the accumulator)."""
    T, K = x.shape
    G, _, N = w.shape
    bm, bn = _build.grouped_flag_tile(T, G, x.dtype, w.dtype)
    route = grouped_route(T, N, K, G, x.dtype, w.dtype, w_gate is not None, "abft")
    gm, gn = -(-T // bm), -(-N // bn)
    spec = grouped_abft_spec(x, w)
    base = dict(w_gate=w_gate, activation=activation, a_scale=a_s, b_scale=b_s,
                bg_scale=bg_s, out_dtype=out_dtype)
    fault = abft_mod.build_fault_operands(cfg.fault, gm, gn, bm, bn, device=x.device)
    fkw = {} if fault is None else dict(zip(("fault_delta", "fault_row", "fault_col"), fault))
    out, flags = mx_grouped_matmul(x, w, group_sizes, abft=spec.with_inject(fault is not None),
                                   **fkw, **base)
    abft_mod._bump("gemms_verified")
    flagged = _flagged(flags)
    if not flagged:
        return out
    abft_mod._bump("tiles_flagged", len(flagged))
    spans, start = [], 0
    for n in group_sizes.tolist():
        end = min(start + max(n, 0), T)
        spans.append((start, end))
        start = end
    ep = Epilogue(activation=activation, a_scale=a_s is not None, b_scale=b_s is not None)
    n_bad = len(flagged)
    for _ in range(cfg.max_retries):
        still = []
        for t, j in flagged:
            r0, c0 = t * bm, j * bn
            r1, c1 = min(r0 + bm, T), min(c0 + bn, N)
            xs = x[r0:r1]
            for g, (s, e) in enumerate(spans):
                g0, g1 = max(r0, s), min(r1, e)
                if g0 >= g1:
                    continue
                ws = _cols(w[g], c0, c1)
                t_out, t_flags = recompute_fused(
                    route, xs, ws, epilogue=ep,
                    b_gate=None if w_gate is None else _cols(w_gate[g], c0, c1),
                    a_scale=None if a_s is None else a_s[r0:r1],
                    b_scale=None if b_s is None else _cols(b_s[g], c0, c1),
                    bg_scale=None if bg_s is None else _cols(bg_s[g], c0, c1),
                    out_dtype=out_dtype, abft=abft_spec_for(xs, ws))
                if _flagged(t_flags):
                    still.append((t, j))
                    break
                out[g0:g1, c0:c1] = t_out[g0 - r0:g1 - r0]
        flagged = still
        if not flagged:
            abft_mod._bump("tiles_recovered", n_bad)
            return out
    _sdc(flagged, "grouped tile", cfg)


def _flatten_leading(a: torch.Tensor):
    lead = tuple(a.shape[:-2]) if a.dim() > 2 else ()
    return a.reshape(-1, a.shape[-1]), lead


def matmul(a: torch.Tensor, b: torch.Tensor, *, policy: Optional[MXPolicy] = None,
           out_dtype=None, precision=None, abft=None) -> torch.Tensor:
    """D = A @ B through the MX dispatch.  a: (..., M, K), b: (K, N).
    ``precision`` (explicit only: the ambient use_precision() context
    applies to linear and grouped_matmul, not to raw matmuls) routes
    through `linear`'s quantized path.  ``abft`` (config, True / False, or
    None for the ambient use_abft() context) checksums the product on
    "cuda_mx"."""
    policy = policy or current_policy()
    out_dtype = out_dtype or a.dtype
    prec = _effective_precision(resolve_precision(precision), a.dtype, b.dtype)
    if prec is not None:
        return linear(a, b, None, policy=policy, out_dtype=out_dtype, precision=prec,
                      abft=abft)
    backend = policy.resolve(a)
    if backend == "torch":
        return dot_f32(a, b).to(out_dtype)
    a2, lead = _flatten_leading(a)
    cfg = _resolve_abft(abft) if backend == "cuda_mx" else None
    if cfg is not None:
        out = _abft_fused_gemm(a2.contiguous(), b, ep=Epilogue(), bias=None, residual=None,
                               w_gate=None, a_s=None, b_s=None, bg_s=None,
                               out_dtype=out_dtype, cfg=cfg)
    elif backend == "cuda_mx":
        out = mx_matmul_fused(a2.contiguous(), b, out_dtype=out_dtype)
    else:
        out = baseline_matmul(a2.contiguous(), b, out_dtype=out_dtype)
    if a.dim() > 2:
        out = out.reshape(*lead, a.shape[-2], b.shape[-1])
    return out


# (data_ptr, shape, strides, dtype, device, ring size, ranks) -> (weakref to
# the weight's base tensor, its version, the contiguous column shards)
_shards: Dict[tuple, tuple] = {}


def _column_shards(w: torch.Tensor, P: int, ranks: Sequence[int]):
    """Contiguous column shards w[:, r*N/P:(r+1)*N/P] of a (K, N) weight for
    the ring ranks this process holds: kernel 1 takes contiguous operands,
    and a strided shard copied at every call would read the weight P times
    per linear.  Kept per parameter version (`_kept`);
    `shard_cache_bytes()` says what they hold."""
    n = w.shape[-1] // P
    return _kept(_shards, w, (P, tuple(ranks)),
                 lambda: [w[:, r * n:(r + 1) * n].contiguous() for r in ranks])


def shard_cache_bytes() -> int:
    """Bytes of the kept weight shards of the all-gather rings."""
    return sum(t.numel() * t.element_size() for e in _shards.values() for t in e[2])


def clear_shard_cache() -> None:
    _shards.clear()


def _fallback(reason: str) -> None:
    """A ring linear that does not fit the ring runs the single-device
    dispatch, as in JAX; counted, so a run that never rings shows."""
    RING_STATS["fallbacks"] += 1
    RING_STATS["fallback_reasons"][reason] = RING_STATS["fallback_reasons"].get(reason, 0) + 1


def _read_flags(nflags: torch.Tensor) -> int:
    """A ring's ABFT flag total, read on the host (a sync), counted."""
    RING_STATS["flag_reads"] += 1
    return int(nflags)


def _collective_linear(x, w, b, *, activation, w_gate, residual, out_scale, backend,
                       out_dtype, tp_mode, coll, prec=None,
                       abft_cfg: Optional[AbftConfig] = None):
    """One linear through the ring collective GEMM over `coll`'s ring (JAX
    `_collective_linear`).  Returns None when it does not fit the ring
    (ring size 1, a 2:4 policy, M or N (all-gather) or K (reduce-scatter)
    not dividing, a gated reduce-scatter); the caller then runs the
    single-device dispatch.  Bidir with odd chunk rows runs "fwd".

    Quantization happens ONCE, globally, before sharding: per-row and
    per-column scales are constant along K, so sharding the payload is
    exact on both rings; on the all-gather ring the per-row scale sidecar
    travels with its x chunk, on the reduce-scatter ring the scales stay
    local and partials travel dequantized.

    ABFT (on "cuda_mx"): checksummed chunk GEMMs plus the rings' sidecars;
    the ring-wide flag total is summed on the device and read once per
    ring linear; a flagged ring reruns clean (bitwise the fault-free ring)
    up to `max_retries` times, then SDCError.  A `TileFault` becomes a
    `RingFault` as in JAX.

    Global in, global out: a `LocalRing` concatenates its ranks' output
    shards, a `DistRing` all-gathers them -- one collective more than JAX's
    sharded output, so that `linear` keeps its contract.  The chunk GEMMs
    run kernel 1 on "cuda_mx" and the plain reference on every other
    backend, as JAX's run its "xla" reference for every backend but
    "pallas_mx"."""
    ring = coll.ring
    P_ = coll.axis_size
    if P_ <= 1:
        return None
    if prec is not None and prec.b_sparse is not None:
        # compressed payloads and their metadata do not shard over the ring
        return _fallback("sparse")
    x2, lead = _flatten_leading(x)
    M, K = x2.shape
    N = w.shape[-1]
    ep = Epilogue(activation=activation, bias=b is not None,
                  residual=residual is not None, out_scale=out_scale)
    if tp_mode == "allgather" and (M % P_ or N % P_):
        return _fallback(f"allgather M={M} N={N}")
    if tp_mode == "reduce_scatter" and ep.has_gate:
        return _fallback("reduce_scatter gate")
    if tp_mode == "reduce_scatter" and (M % P_ or K % P_):
        return _fallback(f"reduce_scatter M={M} K={K}")
    m_loc = M // P_
    direction = coll.direction
    if direction == "bidir" and m_loc % 2:
        direction = "fwd"  # odd chunk rows cannot split into two half-rings

    a_s = b_s = bg_s = None
    if prec is not None:
        x2, a_s, w, b_s, w_gate, bg_s, _, _ = _prepare_quantized(x2, w, w_gate, prec)
    x2 = x2.contiguous()
    fault_t = None
    if abft_cfg is not None and abft_cfg.fault is not None:
        f = abft_cfg.fault
        # the reduce-scatter ring receives from step 1 on, the all-gather
        # ring verifies every step
        step = (f.tile_i % P_ if tp_mode == "allgather" else 1 + f.tile_i % max(P_ - 1, 1))
        fault_t = (step, int(f.row), int(f.col), float(f.delta))
    cc = ChunkCompute(backend="cuda_mx" if backend == "cuda_mx" else "torch",
                      abft=abft_cfg is not None)
    res2 = None
    if residual is not None:
        res2 = torch.broadcast_to(residual, (*lead, x.shape[-2], N) if lead else (M, N)
                                  ).reshape(M, N)
    L = ring.ranks
    if tp_mode == "allgather":
        n_loc = N // P_

        def cols(t):
            return None if t is None else [t[..., r * n_loc:(r + 1) * n_loc] for r in L]

        ring_fn, dim = ring_allgather_matmul, 1
        xs, ws = [x2[r * m_loc:(r + 1) * m_loc] for r in L], _column_shards(w, P_, L)
        kw = dict(
            bias=cols(b), b_gate=None if w_gate is None else _column_shards(w_gate, P_, L),
            residual=None if res2 is None else [c.contiguous() for c in cols(res2)],
            a_scale=None if a_s is None else [a_s[r * m_loc:(r + 1) * m_loc] for r in L],
            b_scale=cols(b_s), bg_scale=cols(bg_s))
    else:
        k_loc = K // P_
        ring_fn, dim = ring_matmul_reduce_scatter, 0
        xs = [x2[:, r * k_loc:(r + 1) * k_loc].contiguous() for r in L]
        ws = [w[r * k_loc:(r + 1) * k_loc].contiguous() for r in L]
        kw = dict(
            bias=None if b is None else [b] * len(L),
            residual=None if res2 is None else [res2[r * m_loc:(r + 1) * m_loc] for r in L],
            a_scale=None if a_s is None else [a_s] * len(L),
            b_scale=None if b_s is None else [b_s] * len(L))
    run = functools.partial(ring_fn, ring, xs, ws, compute=cc, epilogue=ep,
                            out_dtype=out_dtype, direction=direction, **kw)
    if abft_cfg is None:
        outs = run()
    else:
        outs, nflags = run(fault=fault_t)
        abft_mod._bump("gemms_verified")
        n = _read_flags(nflags)  # the one host read of a clean ring linear
        if n:
            abft_mod._bump("tiles_flagged", n)
            for _ in range(abft_cfg.max_retries):
                outs2, nf2 = run()  # faults are transient: the rerun is clean
                if _read_flags(nf2) == 0:
                    abft_mod._bump("tiles_recovered", n)
                    outs = outs2
                    break
            else:
                abft_mod._bump("sdc_errors")
                raise SDCError(f"SDC persisted in {tp_mode} ring collective after "
                               f"{abft_cfg.max_retries} rerun attempt(s)",
                               flagged=(("ring", n),), attempts=abft_cfg.max_retries)
    out = ring.gather(outs, dim)
    if x.dim() > 2:
        out = out.reshape(*lead, x.shape[-2], N)
    return out


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
           activation: str = "none", w_gate: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None, out_scale: Optional[float] = None,
           policy: Optional[MXPolicy] = None, out_dtype=None,
           tp_mode: Optional[str] = None, precision=None, abft=None) -> torch.Tensor:
    """y = act(x @ w + b) [+ residual] [* out_scale], the fused-epilogue
    entry point.  x: (..., M, K), w: (K, N), b: (N,), residual broadcastable
    to (..., M, N).  activation "swiglu" gates with w_gate (K, N):
    y = silu(x @ w_gate) * (x @ w + b).  ``precision`` (a policy, a registry
    name, or None for the ambient use_precision() context) quantizes the
    operands; its ``out`` overrides out_dtype.

    On "cuda_mx" the whole epilogue, dequant scales first, happens inside
    the kernel's single write-back (a 2:4 policy streams the compressed
    weight); ``abft`` (config, True / False, or None for the ambient
    use_abft() context) checksums it, with recovery.  The other backends
    compute the same math unfused, and take no ABFT, as JAX's xla and
    pallas_baseline take none.  ``tp_mode`` ("allgather" /
    "reduce_scatter") runs the ring collective GEMM under an active
    collective policy when the shapes divide over its ring."""
    policy = policy or current_policy()
    out_dtype = out_dtype or x.dtype
    prec = _effective_precision(_ambient_precision(precision), x.dtype, w.dtype)
    if tp_mode is not None and tp_mode not in TP_MODES:
        raise ValueError(f"unknown tp_mode {tp_mode!r}; one of {TP_MODES}")
    if prec is not None and prec.out is not None:
        out_dtype = prec.out_torch_dtype
    if (activation == "swiglu") != (w_gate is not None):
        raise ValueError(
            "w_gate must be given iff activation='swiglu' "
            f"(got activation={activation!r}, "
            f"w_gate={'set' if w_gate is not None else None})")
    backend = policy.resolve(x)
    coll = current_collectives() if tp_mode is not None else None
    if coll is not None:
        out = _collective_linear(
            x, w, b, activation=activation, w_gate=w_gate, residual=residual,
            out_scale=out_scale, backend=backend, out_dtype=out_dtype, tp_mode=tp_mode,
            coll=coll, prec=prec,
            abft_cfg=_resolve_abft(abft) if backend == "cuda_mx" else None)
        if out is not None:
            return out
    if backend == "cuda_mx":
        x2, lead = _flatten_leading(x)
        M, N = x2.shape[0], w.shape[-1]
        a_s = b_s = bg_s = b_meta = bg_meta = None
        if prec is not None:
            (x2, a_s, w, b_s, w_gate, bg_s,
             b_meta, bg_meta) = _prepare_quantized(x2, w, w_gate, prec)
        ep = Epilogue(activation=activation, bias=b is not None,
                      residual=residual is not None, out_scale=out_scale,
                      a_scale=a_s is not None, b_scale=b_s is not None)
        res2 = None
        if residual is not None:
            full = (*lead, x.shape[-2], N) if lead else (M, N)
            res2 = torch.broadcast_to(residual, full).reshape(M, N).contiguous()
        cfg = _resolve_abft(abft)
        if b_meta is not None and cfg is not None:
            # recovery slices dense weight panels: decompress first, as JAX
            w, w_gate = _expand_sparse(w, w_gate, b_meta, bg_meta)
            b_meta = bg_meta = None
        if cfg is not None:
            out = _abft_fused_gemm(x2.contiguous(), w, ep=ep, bias=b, residual=res2,
                                   w_gate=w_gate, a_s=a_s, b_s=b_s, bg_s=bg_s,
                                   out_dtype=out_dtype, cfg=cfg)
        else:
            out = mx_matmul_fused(x2.contiguous(), w, epilogue=ep, b_gate=w_gate, bias=b,
                                  residual=res2, a_scale=a_s, b_scale=b_s, bg_scale=bg_s,
                                  b_sparse=b_meta is not None, b_meta=b_meta,
                                  bg_meta=bg_meta, out_dtype=out_dtype)
        if x.dim() > 2:
            out = out.reshape(*lead, x.shape[-2], N)
        return out
    if prec is not None:
        # JAX's unfused quantized reference: the SAME payloads (2:4 ones
        # expanded) through the same dot_f32 accumulation, dequantized by
        # apply_epilogue.  The baseline GEMM has no scale or 2:4 slots, and
        # the port runs no plain version on the card in its place.
        if backend == "cuda_baseline" and x.is_cuda:
            raise NotImplementedError(
                "cuda_baseline with a quantizing or 2:4 sparse precision: the baseline "
                "GEMM has no scale slots and no 2:4 slots (JAX's pallas_baseline computes "
                "its jnp reference there); use cuda_mx, or torch for the reference")
        qa, a_s, qb, b_s, qg, bg_s, b_meta, bg_meta = _prepare_quantized(x, w, w_gate, prec)
        if b_meta is not None:
            qb, qg = _expand_sparse(qb, qg, b_meta, bg_meta)
        y = dot_f32(qa, qb)
        gate = dot_f32(qa, qg) if activation == "swiglu" else None
        ep = Epilogue(activation=activation, bias=b is not None,
                      residual=residual is not None, out_scale=out_scale,
                      a_scale=a_s is not None, b_scale=b_s is not None)
        return apply_epilogue(y, ep, bias=b, gate=gate, residual=residual,
                              a_scale=a_s, b_scale=b_s, bg_scale=bg_s,
                              out_dtype=out_dtype)
    # unfused reference composition ("torch" / "cuda_baseline"): each
    # epilogue step is its own op
    ep = Epilogue(activation=activation, bias=b is not None,
                  residual=residual is not None, out_scale=out_scale)
    y = matmul(x, w, policy=policy, out_dtype=torch.float32, abft=False)
    gate = (matmul(x, w_gate, policy=policy, out_dtype=torch.float32, abft=False)
            if activation == "swiglu" else None)
    return apply_epilogue(y, ep, bias=b, gate=gate, residual=residual,
                          out_dtype=out_dtype)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
                   activation: str = "none", w_gate: Optional[torch.Tensor] = None,
                   policy: Optional[MXPolicy] = None, out_dtype=None, precision=None,
                   abft=None, a_row_groups: Optional[Sequence[int]] = None
                   ) -> torch.Tensor:
    """Ragged grouped GEMM: out[t] = act(x[t] @ w[g(t)]) for rows sorted by
    group.  x: (T, K), w: (G, K, N), group_sizes: (G,) on x's device.  One
    kernel launch for all groups on the CUDA backends.

    ``precision`` (explicit or the ambient use_precision() context)
    quantizes x per row and w PER EXPERT per output column; the (G, 1, N)
    weight scales apply at each group's store.  ``a_row_groups`` = (E, R,
    C): x's rows are the MoE's expert-major buffer (E experts x R routing
    groups x C rows), and a "tensor"-granularity activation scale is taken
    per routing group, as JAX's one call per group takes it.

    A 2:4 policy streams each expert's compressed payload (the sparse
    kernel; "torch" expands it).  ``abft`` checksums every expert's
    product on "cuda_mx" (per-expert recovery); a sparse stack is expanded
    first."""
    policy = policy or current_policy()
    out_dtype = out_dtype or x.dtype
    prec = _effective_precision(_ambient_precision(precision), x.dtype, w.dtype)
    if prec is not None and prec.out is not None:
        out_dtype = prec.out_torch_dtype
    a_s = b_s = bg_s = b_meta = bg_meta = None
    if prec is not None:
        (x, a_s, w, b_s, w_gate, bg_s,
         b_meta, bg_meta) = _prepare_quantized(x, w, w_gate, prec, a_row_groups)
    kw = dict(w_gate=w_gate, activation=activation, a_scale=a_s, b_scale=b_s,
              bg_scale=bg_s, out_dtype=out_dtype)
    backend = policy.resolve(x)
    if backend == "torch":
        return grouped_matmul_ref(x, w, group_sizes, **kw, w_meta=b_meta, wg_meta=bg_meta)
    cfg = _resolve_abft(abft) if backend == "cuda_mx" else None
    if b_meta is not None and cfg is not None:
        # per-expert recovery slices dense panels: decompress first, as JAX
        w, w_gate = _expand_sparse(w, w_gate, b_meta, bg_meta)
        b_meta = bg_meta = None
        kw["w_gate"] = w_gate
    if cfg is not None:
        return _abft_grouped_gemm(x.contiguous(), w, group_sizes, activation=activation,
                                  w_gate=w_gate, a_s=a_s, b_s=b_s, bg_s=bg_s,
                                  out_dtype=out_dtype, cfg=cfg)
    return mx_grouped_matmul(x.contiguous(), w, group_sizes, **kw,
                             b_sparse=b_meta is not None, w_meta=b_meta, wg_meta=bg_meta)
