"""The Hopper tile pricer: the port's counterpart of `repro/core/tiling.py`.

JAX's planner searches Pallas block shapes (bm, bn, bk) under a VMEM budget
for the least HBM traffic.  On the card the tile rule already exists, once:
`kernels/_build.py` (`gemm_tile`, `decode_tile`, `prefill_tile`,
`grouped_tile`, `grouped_flag_tile`) gives every GEMM launch its tile, and
the launchers refuse any other.  A second copy of that rule here could
drift from its tables and break the K-parts rule that keeps dense, 2:4,
ABFT and recomputed tiles bitwise equal (`_build.prefill_parts`).  So
`plan_matmul_tiles` re-derives no choice: it takes the tile the launch
takes and prices it in the transfer model's units -- its shared memory per
CTA (checked against `_build.SMEM_PER_CTA`), its register accumulator and
its HBM bytes (`transfer_model.HopperGemmTiling`).
`paper_subtile_space` is the paper's own sub-tile space, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch

from ..kernels import _build
from .transfer_model import GemmProblem, HopperGemmTiling

VARIANTS = ("dense", "sparse", "abft", "baseline")
BASELINE_BK = 128  # kernel 2's K step between output round trips (baseline_matmul.KERNEL_BK)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The tile one GEMM launch takes, priced.

    ``route``: "decode" or "mma" (`HopperGemmTiling`); (bm, bn) the CTA
    tile (a decode CTA covers all M rows: bm = M), bk the K rows per ring
    stage; ``stages``, ``split`` and
    ``parts`` the ring depth, the CTAs per cluster and the K parts
    (`_build.prefill_parts`); ``ctas`` the grid; ``smem_bytes`` the dynamic
    shared memory per CTA; ``acc_bytes`` the register accumulator per CTA;
    ``hbm_bytes`` the HBM traffic of `tiling` on `problem` (kernel 2: its
    output round trip every BASELINE_BK rows of K; the grouped GEMM: G
    groups of T / G rows, each streaming its expert's weights); ``flag_tile`` the ABFT
    flag map's (bm, bn), None outside ABFT."""

    route: str
    bm: int
    bn: int
    bk: int
    stages: int
    split: int
    parts: int
    ctas: int
    smem_bytes: int
    acc_bytes: int
    hbm_bytes: int
    arithmetic_intensity: float
    grid_steps: int
    epilogue_saved_bytes: int
    problem: GemmProblem
    tiling: HopperGemmTiling
    flag_tile: Optional[Tuple[int, int]] = None


def _launch_tile(M, N, K, a_dtype, b_dtype, variant, gated, groups):
    """(route, bm, bn, bk, stages, split, parts, ctas, smem, flag_tile) of
    the launch, from `kernels/_build.py` alone."""
    if groups is not None:
        if variant == "baseline":
            raise ValueError("the grouped GEMM has no baseline variant")
        t = _build.grouped_tile(M, N, K, groups, a_dtype, b_dtype, gated, variant)
        flag = _build.grouped_flag_tile(M, groups, a_dtype, b_dtype) if variant == "abft" else None
        return (t.route, t.bm, t.bn, t.bk, t.stages, t.split, t.parts, t.ctas, t.smem, flag)
    flag = _build.gemm_tile(M)[:2] if variant == "abft" else None
    if M <= _build.DECODE_MAX_M:  # kernel 1's decode tile of the variant, kernel 2's dense one
        t = _build.decode_tile(M, N, a_dtype, b_dtype, gated,
                               "dense" if variant == "baseline" else variant)
        return ("decode", M, t.bn, t.bk, t.stages, 1, 1, t.ctas, t.smem, flag)
    t = _build.prefill_tile(M, N, K, a_dtype, b_dtype, gated, variant)
    return (t.route, t.bm, t.bn, t.bk, t.stages, t.split, t.parts, t.ctas, t.smem, flag)


def plan_matmul_tiles(M: int, N: int, K: int, a_dtype: torch.dtype, b_dtype: torch.dtype,
                      variant: str = "dense", *, gated: bool = False,
                      groups: Optional[int] = None, out_dtype: Optional[torch.dtype] = None,
                      fused_epilogue_ops: int = 0) -> TilePlan:
    """The priced tile of one launch on A (M, K) x B (K, N).

    ``variant``: kernel 1's "dense", "sparse" (2:4 weights: b_dtype is the
    payload's) or "abft", or kernel 2's "baseline"; ``gated``: a swiglu
    launch's second weight; ``groups``: the grouped GEMM over G experts
    (M = T rows in all).  ``out_dtype`` (default A's, f32 for int8 / e4m3
    activations) prices the store.  ValueError where the launchers refuse
    the shape, or where the tile's shared memory would pass
    `_build.SMEM_PER_CTA`."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    route, bm, bn, bk, stages, split, parts, ctas, smem, flag = _launch_tile(
        M, N, K, a_dtype, b_dtype, variant, gated, groups)
    if out_dtype is None:
        out_dtype = a_dtype if a_dtype in _build.FLOATS else torch.float32
    p = GemmProblem(M, N, K, a_dtype.itemsize, b_bytes=b_dtype.itemsize,
                    out_bytes=out_dtype.itemsize, b_sparse=variant == "sparse")
    baseline = variant == "baseline"
    tiling = HopperGemmTiling(bm, bn, BASELINE_BK if baseline else bk,
                              accumulate_in_registers=not baseline,
                              fused_epilogue_ops=fused_epilogue_ops, route=route,
                              stages=stages, split=split, parts=parts, gated=gated,
                              ring_bk=bk if baseline else 0, abft=variant == "abft")
    # the grouped GEMM streams each expert's weights for its own rows:
    # priced as G groups of T / G rows (uniform routing)
    hbm = (tiling.hbm_bytes(p) if groups is None else groups * tiling.hbm_bytes(
        dataclasses.replace(p, M=-(-M // groups))))
    if tiling.smem_bytes(p) != smem:
        raise AssertionError(f"the priced shared memory {tiling.smem_bytes(p)} is not the "
                             f"launch's {smem} ({route} {bm} x {bn}, {variant})")
    if smem > _build.SMEM_PER_CTA:
        raise ValueError(f"{route} tile {bm} x {bn} x {bk} at {stages} stages needs {smem} "
                         f"bytes of shared memory per CTA, past {_build.SMEM_PER_CTA}")
    return TilePlan(route=route, bm=bm, bn=bn, bk=bk, stages=stages, split=split, parts=parts,
                    ctas=ctas, smem_bytes=smem, acc_bytes=tiling.acc_register_bytes(p),
                    hbm_bytes=hbm, arithmetic_intensity=p.flops / hbm,
                    grid_steps=tiling.grid_steps(p),
                    epilogue_saved_bytes=tiling.epilogue_saved_bytes(p), problem=p,
                    tiling=tiling, flag_tile=flag)


def paper_subtile_space() -> Iterable[Tuple[int, int, int]]:
    """The paper's feasible sub-tile space: m', n', k' in {4, 8} under the
    256 B buffer (m'*n' output elements * 8 B <= 256 B for FP64)."""
    for m_ in (4, 8):
        for n_ in (4, 8):
            for k_ in (4, 8):
                if m_ * n_ * 8 <= 256:
                    yield (m_, n_, k_)
