"""ABFT (algorithm-based fault tolerance) for the MX GEMMs (port of
`repro/kernels/abft.py`).

Beside each output tile's accumulator the kernel keeps a column-checksum
row and a row-checksum column, in the association order that makes them
independent of the main accumulator's (sum first, multiply second):

    ccol[1, bn] += colsum(a_blk) @ b_blk
    crow[bm, 1] += a_blk @ rowsum(b_blk)

At the single write-back the finished tile's row and column sums are
compared against them and a per-tile flag is written: int8 x int8 exactly
(wrapping 32-bit integers), every float pair against
``rtol * |.|-checksum + atol`` with ``rtol = eps_f32 * (K + max(bm, bn)) *
safety``, the |a|/|b| checksums being the scale of legitimate rounding.
The checksums cover the raw accumulator (before the epilogue).  Optional
per-tile fault operands (delta, row, col) corrupt the finished accumulator
after the checksums closed and before the compare, where a write-back bit
flip would land.  With no fault operands the main accumulator's datapath is
untouched, so ABFT on is bitwise equal to ABFT off.

In the port the tile (bm, bn) is the one the CUDA kernel launches
(`kernels/_build.gemm_tile` / `grouped_flag_tile`), on the CPU too, so a flag map
and a fault land on the same tile on both devices.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch

_EPS_F32 = float(torch.finfo(torch.float32).eps)
# Safety factor on the linear rounding-error bound (already pessimistic
# against the sqrt(n) growth of real rounding error).
_RTOL_SAFETY = 8.0
# Floor for all-zero / denormal tiles where the |.|-checksum vanishes.
_ATOL = 1e-12


class SDCError(RuntimeError):
    """Silent data corruption detected and NOT recovered within the retry
    budget; carries the flagged tile coordinates and the attempt count."""

    def __init__(self, msg: str, *, flagged=(), attempts: int = 0):
        super().__init__(msg)
        self.flagged = tuple(flagged)
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class AbftSpec:
    """The checksum arithmetic of one kernel launch.  ``exact`` selects
    integer checksums with an equality compare; otherwise f32 checksums and
    the rtol / atol compare.  ``inject`` declares the fault operands."""

    exact: bool
    rtol: float = 0.0
    atol: float = 0.0
    inject: bool = False

    def with_inject(self, inject: bool) -> "AbftSpec":
        return dataclasses.replace(self, inject=inject)


def abft_rtol(K: int, bm: int, bn: int) -> float:
    """Relative tolerance of the float compare: the linear f32 rounding
    bound over the longest chain (K products plus the bm- or bn-long
    reduction of the finished tile), times the safety factor."""
    return _EPS_F32 * (K + max(bm, bn)) * _RTOL_SAFETY


def _is_integer(dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def make_abft_spec(a_dtype, b_dtype, K: int, bm: int, bn: int, *,
                   inject: bool = False) -> AbftSpec:
    """The spec of a GEMM with these operand dtypes and tile: exact iff both
    payloads are integers (the int8 MAC), else the f32 tolerance."""
    if _is_integer(a_dtype) and _is_integer(b_dtype):
        return AbftSpec(exact=True, inject=inject)
    return AbftSpec(exact=False, rtol=abft_rtol(K, bm, bn), atol=_ATOL, inject=inject)


@dataclasses.dataclass(frozen=True)
class TileFault:
    """One injected corruption: add ``delta`` to accumulator element (row,
    col) of output tile (tile_i, tile_j); reduced mod the grid and tile at
    dispatch."""

    tile_i: int
    tile_j: int
    row: int
    col: int
    delta: float


def build_fault_operands(fault: Optional[TileFault], grid_m: int, grid_n: int, bm: int,
                         bn: int, device=None):
    """The (grid_m, grid_n) fault operands a kernel takes: delta (f32, zero
    but at the target tile) and the in-tile row / col (int32).  None ->
    None."""
    if fault is None:
        return None
    ti, tj = int(fault.tile_i) % grid_m, int(fault.tile_j) % grid_n
    delta = torch.zeros((grid_m, grid_n), dtype=torch.float32, device=device)
    delta[ti, tj] = float(fault.delta)
    row = torch.full((grid_m, grid_n), int(fault.row) % bm, dtype=torch.int32, device=device)
    col = torch.full((grid_m, grid_n), int(fault.col) % bn, dtype=torch.int32, device=device)
    return delta, row, col


@dataclasses.dataclass(frozen=True)
class AbftConfig:
    """Dispatch-level policy: recompute attempts for a flagged tile before
    the typed SDCError, and (tests) the fault injected into the first
    attempt.  Faults are transient: retries run clean."""

    max_retries: int = 2
    fault: Optional[TileFault] = None


_state = threading.local()


def current_abft() -> Optional[AbftConfig]:
    """The ambient config installed by use_abft(), or None (off)."""
    return getattr(_state, "abft", None)


class use_abft:
    """Turn ABFT on for every checksummed GEMM dispatched inside the block::

        with use_abft():                          # defaults
            y = ops.linear(x, w, activation="gelu")
        with use_abft(AbftConfig(max_retries=1)):
            ...
    """

    def __init__(self, config: Optional[AbftConfig] = None):
        self.config = config if config is not None else AbftConfig()
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_state, "abft", None)
        _state.abft = self.config
        return self.config

    def __exit__(self, *exc):
        _state.abft = self._prev
        return False


# Process-wide detection / recovery counters; reset_abft_stats() between runs.
_STATS_LOCK = threading.Lock()
_STATS = {"gemms_verified": 0, "tiles_flagged": 0, "tiles_recovered": 0,
          "sdc_errors": 0}


def abft_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_abft_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += n
