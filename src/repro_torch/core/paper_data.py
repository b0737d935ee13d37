"""The paper's published numbers, embedded as validation targets (a copy
of `repro/core/paper_data.py`: the paper's own data, no framework's).

Table IV of the paper (kernel info, performance, energy efficiency) for the
Dual-Core (FP64) and 64-Core MemPool (FP32) clusters.
`tests/test_torch_analytics.py` reproduces the analytic columns (Mem-VRF
Transfers, Arithmetic Intensity) exactly from `core.transfer_model`, and
`core.energy` fits its energy model against the measured columns.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Table4Row:
    cluster: str  # "dual" | "64c"
    config: str  # "baseline" | "mx"
    size: int  # M == N == K
    tile: Tuple[int, int, int]  # (m, n, k)
    subtile: Optional[Tuple[int, int, int]]  # (m', n', k') or None
    mem_vrf_transfers: int
    arithmetic_intensity: float  # FLOP/B
    simd_ratio: float  # FLOP/vinsn
    utilization: float  # fraction
    perf_tt_gflops: float
    power_tt_w: float
    energy_eff_gflops_w: float
    # True for the one Table IV row whose printed transfer count deviates
    # from the paper's own Table II closed form (see KNOWN_DISCREPANCIES).
    formula_deviates: bool = False

    @property
    def elem_bytes(self) -> int:
        return 8 if self.cluster == "dual" else 4

    @property
    def flops(self) -> int:
        return 2 * self.size**3

    @property
    def energy_j(self) -> float:
        """Total kernel energy implied by the table: FLOPs / (FLOPS/W)."""
        return self.flops / (self.energy_eff_gflops_w * 1e9)

    @property
    def time_s(self) -> float:
        return self.flops / (self.perf_tt_gflops * 1e9)


# Dual-Core cluster: 2 cores x 4 FP64 FPUs, peak 16 DP-FLOP/cycle, tt 1 GHz.
DUAL_CORE_PEAK_FLOP_PER_CYCLE = 16
DUAL_CORE_TT_HZ = 1.0e9
# 64-Core cluster: 64 CCs x 4 FP32 FPUs, peak 512 SP-FLOP/cycle, tt 910 MHz.
MEMPOOL_PEAK_FLOP_PER_CYCLE = 512
MEMPOOL_TT_HZ = 0.91e9

TABLE4 = [
    # --- Dual-Core, FP64 ---
    Table4Row("dual", "baseline", 64, (8, 16, 1), None, 53248, 1.23, 16.00, 0.959, 15.34, 0.21, 71.49),
    Table4Row("dual", "baseline", 64, (4, 32, 1), None, 77824, 0.84, 32.00, 0.978, 15.65, 0.21, 73.48),
    Table4Row("dual", "baseline", 32, (8, 16, 1), None, 7168, 1.14, 16.00, 0.900, 14.40, 0.20, 70.95),
    Table4Row("dual", "baseline", 32, (4, 32, 1), None, 10240, 0.80, 32.00, 0.933, 14.93, 0.20, 72.87),
    Table4Row("dual", "baseline", 16, (8, 16, 1), None, 1024, 1.00, 16.00, 0.701, 11.22, 0.16, 71.69),
    Table4Row("dual", "baseline", 16, (4, 32, 1), None, 1408, 0.73, 32.00, 0.647, 10.35, 0.16, 66.70,
              formula_deviates=True),
    Table4Row("dual", "mx", 64, (4, 8, 4), (4, 4, 4), 102400, 0.64, 34.73, 0.941, 15.06, 0.21, 72.91),
    Table4Row("dual", "mx", 64, (8, 8, 4), (8, 4, 4), 69632, 0.94, 63.22, 0.956, 15.30, 0.19, 79.15),
    Table4Row("dual", "mx", 64, (4, 16, 4), (4, 4, 4), 86016, 0.76, 36.76, 0.964, 15.42, 0.21, 75.19),
    Table4Row("dual", "mx", 64, (8, 16, 4), (8, 4, 4), 53248, 1.23, 66.59, 0.972, 15.55, 0.19, 81.49),
    Table4Row("dual", "mx", 32, (4, 8, 4), (4, 4, 4), 13312, 0.62, 34.29, 0.884, 14.14, 0.20, 71.90),
    Table4Row("dual", "mx", 32, (8, 8, 4), (8, 4, 4), 9216, 0.89, 62.48, 0.897, 14.35, 0.18, 77.68),
    Table4Row("dual", "mx", 32, (4, 16, 4), (4, 4, 4), 11264, 0.73, 36.21, 0.927, 14.83, 0.20, 74.36),
    Table4Row("dual", "mx", 32, (8, 16, 4), (8, 4, 4), 7168, 1.14, 65.68, 0.935, 14.96, 0.19, 80.38),
    Table4Row("dual", "mx", 16, (4, 8, 4), (4, 4, 4), 1792, 0.57, 33.45, 0.631, 10.10, 0.15, 67.45),
    Table4Row("dual", "mx", 16, (8, 8, 4), (8, 4, 4), 1280, 0.80, 61.09, 0.661, 10.58, 0.14, 75.03),
    Table4Row("dual", "mx", 16, (4, 16, 4), (4, 4, 4), 1536, 0.67, 35.20, 0.716, 11.46, 0.16, 72.03),
    Table4Row("dual", "mx", 16, (8, 16, 4), (8, 4, 4), 1024, 1.00, 64.00, 0.703, 11.25, 0.15, 75.41),
    # --- 64-Core MemPool, FP32 ---
    Table4Row("64c", "baseline", 256, (8, 32, 1), None, 2686976, 3.12, 32.0, 0.945, 439.94, 1.57, 279.86),
    Table4Row("64c", "baseline", 128, (8, 32, 1), None, 344064, 3.05, 32.0, 0.907, 422.31, 1.57, 268.64),
    Table4Row("64c", "baseline", 64, (8, 8, 1), None, 69632, 1.88, 8.0, 0.504, 234.68, 1.20, 194.91),
    Table4Row("64c", "mx", 256, (8, 32, 8), (8, 4, 8), 2686976, 3.12, 137.74, 0.967, 449.97, 1.46, 307.35),
    Table4Row("64c", "mx", 128, (8, 32, 8), (8, 4, 8), 344064, 3.05, 136.23, 0.958, 445.86, 1.46, 304.55),
    Table4Row("64c", "mx", 64, (8, 8, 8), (8, 4, 8), 69632, 1.88, 123.43, 0.787, 366.35, 1.50, 244.24),
]

KNOWN_DISCREPANCIES = """
Table IV row (dual, baseline, 16^3, tile (4,32,1)) prints 1408 Mem-VRF
transfers; the paper's own Table II baseline formula gives
  (N/n)MK + (M/m)NK + MN = 1*256 + 4*256 + 256 = 1536.
The n=32 vector span exceeds N=16 in this one cell, so their measured kernel
presumably handles the row boundary specially.  All other 23 rows match the
closed form exactly; this row's printed arithmetic intensity (0.73) is
consistent with 1408, so we keep the paper's number as ground truth and flag
the formula deviation.
"""

# Headline claims (paper abstract + §IV-C):
HEADLINE = {
    "dual_core_eff_gain_64": 0.109,  # +10.9% energy efficiency, 64^3 FP64
    "mempool_eff_gain_64": 0.25,  # +25% energy efficiency, 64^3 FP32
    "mempool_perf_gain_64": 0.56,  # +56% performance, 64^3 FP32
    "dual_vrf_power_reduction": 0.535,  # Fig. 3 left
    "mempool_vrf_power_reduction": 0.60,  # Fig. 3 right
    "area_overhead_max": 0.03,  # < 3% (hardware-only; not transferable)
}


def rows(cluster: str, config: Optional[str] = None):
    return [
        r
        for r in TABLE4
        if r.cluster == cluster and (config is None or r.config == config)
    ]


def best_row(cluster: str, config: str, size: int) -> Table4Row:
    cands = [r for r in rows(cluster, config) if r.size == size]
    return max(cands, key=lambda r: r.energy_eff_gflops_w)
