"""Energy accounting for MX vs baseline kernels (paper §III-B.6, Fig. 3,
Table IV): a copy of `repro/core/energy.py`'s framework-free part.

The paper measures power with PrimeTime on post-PnR netlists.  What is
reproducible is the paper's energy accounting structure:

    E_total = sum_over_levels( #accesses(level) * e_level )
            + #MACs * e_mac + #instructions * e_insn + cycles * p_static

The per-row access counters come from `core.transfer_model` (whose Mem-VRF
column matches Table IV exactly); the per-level coefficients are
*calibrated* against Table IV's measured energies with a non-negative
least-squares fit, and validated by:

  1. coefficient ordering is physical (e_mem >= e_vrf: the memory-hierarchy
     energy pyramid the whole paper rests on);
  2. leave-out generalization: fit on the 16^3/32^3 rows only, predict the
     64^3 rows' MX-vs-baseline efficiency gain against the paper's +10.9%;
  3. the modeled VRF-energy reduction against Fig. 3 (-53.5% dual-core).

JAX's module also prices a TPU step (`tpu_step_energy_j`) from per-byte
and per-FLOP energies of a 7 nm-class accelerator.  It gets no counterpart:
the port keeps no TPU constant, and no energy per byte or per FLOP of the
H100 has been measured.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from . import paper_data
from .paper_data import Table4Row
from .transfer_model import BaselineKernel, GemmProblem, MXKernel

FEATURES = ("mem", "vrf", "buf", "srf", "mac", "insn", "cycle")


def row_problem(row: Table4Row) -> GemmProblem:
    return GemmProblem(row.size, row.size, row.size, elem_bytes=row.elem_bytes)


def row_kernel(row: Table4Row):
    if row.config == "baseline":
        return BaselineKernel(*row.tile, num_fpus=4)
    m, n, k = row.tile
    return MXKernel(m, n, k, *row.subtile, num_fpus=4)


def access_counters(row: Table4Row) -> Dict[str, float]:
    """Per-row activity counters, whole-problem totals."""
    p = row_problem(row)
    kern = row_kernel(row)
    macs = p.macs
    peak = (
        paper_data.DUAL_CORE_PEAK_FLOP_PER_CYCLE
        if row.cluster == "dual"
        else paper_data.MEMPOOL_PEAK_FLOP_PER_CYCLE
    ) // 2  # MACs/cycle
    cycles = macs / (peak * row.utilization)
    mem = kern.mem_to_vrf(p).total
    if isinstance(kern, BaselineKernel):
        fpu = kern.vrf_to_fpu(p)
        # A comes from the scalar register file (Table II footnote a).
        vrf = fpu.b_down + fpu.cd_down + fpu.d_up + mem
        srf = fpu.a_down
        buf = 0.0
        insn = kern.vector_instructions(p)
    else:
        vb = kern.vrf_to_buf(p)
        vrf = vb.total + mem
        srf = 0.0
        bf = kern.buf_to_fpu(p)
        buf = bf.total
        insn = kern.vector_instructions(p)
    return {
        "mem": float(mem),
        "vrf": float(vrf),
        "buf": float(buf),
        "srf": float(srf),
        "mac": float(macs),
        "insn": float(insn),
        "cycle": float(cycles),
    }


def _nnls(A: np.ndarray, b: np.ndarray, iters: int = 20) -> np.ndarray:
    """Small active-set non-negative least squares (no scipy dependency)."""
    active = np.ones(A.shape[1], dtype=bool)
    x = np.zeros(A.shape[1])
    for _ in range(iters):
        if not active.any():
            break
        sol, *_ = np.linalg.lstsq(A[:, active], b, rcond=None)
        if (sol >= 0).all():
            x[:] = 0.0
            x[active] = sol
            return x
        # drop the most negative coefficient and retry
        idx = np.where(active)[0]
        drop = idx[np.argmin(sol)]
        active[drop] = False
    x[:] = 0.0
    if active.any():
        sol, *_ = np.linalg.lstsq(A[:, active], b, rcond=None)
        x[active] = np.clip(sol, 0.0, None)
    return x


@dataclasses.dataclass
class EnergyModel:
    """Calibrated per-event energies (Joules per event) for one cluster."""

    cluster: str
    coef: Dict[str, float]

    def energy_j(self, row: Table4Row) -> float:
        c = access_counters(row)
        return sum(self.coef[f] * c[f] for f in FEATURES)

    def efficiency_gflops_w(self, row: Table4Row) -> float:
        return row.flops / self.energy_j(row) / 1e9

    def vrf_energy_j(self, row: Table4Row) -> float:
        return self.coef["vrf"] * access_counters(row)["vrf"]


def fit_energy_model(
    rows: Sequence[Table4Row],
    cluster: str,
    features: Sequence[str] = FEATURES,
) -> EnergyModel:
    A = np.array(
        [[access_counters(r)[f] for f in features] for r in rows], dtype=np.float64
    )
    b = np.array([r.energy_j for r in rows], dtype=np.float64)
    # scale columns for conditioning
    scale = A.max(axis=0)
    scale[scale == 0] = 1.0
    x = _nnls(A / scale, b)
    coef = {f: float(v / s) for f, v, s in zip(features, x, scale)}
    for f in FEATURES:
        coef.setdefault(f, 0.0)
    return EnergyModel(cluster, coef)


def modeled_gain(
    model: EnergyModel, cluster: str, size: int
) -> Dict[str, float]:
    """MX-vs-baseline efficiency gain at `size`, modeled vs paper."""
    base = paper_data.best_row(cluster, "baseline", size)
    mx = paper_data.best_row(cluster, "mx", size)
    modeled = (
        model.efficiency_gflops_w(mx) / model.efficiency_gflops_w(base) - 1.0
    )
    paper = mx.energy_eff_gflops_w / base.energy_eff_gflops_w - 1.0
    vrf_red = 1.0 - (
        model.vrf_energy_j(mx) / max(model.vrf_energy_j(base), 1e-30)
    )
    return {"modeled": modeled, "paper": paper, "modeled_vrf_reduction": vrf_red}
