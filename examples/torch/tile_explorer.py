"""Tile-space explorer for the PyTorch + CUDA port: the paper's Table IV
*search* (which tile / sub-tile wins and why), then the tile each Hopper
GEMM kernel launches for a GEMM, priced (`core/tiling.plan_matmul_tiles`).

  PYTHONPATH=src python examples/torch/tile_explorer.py [M N K dtype]

dtype is float32 or bfloat16 (default: 8192 8192 8192 bfloat16).  Pure
arithmetic: it runs on the host and needs no card.
"""
import sys

import torch

from repro_torch.core.tiling import VARIANTS, paper_subtile_space, plan_matmul_tiles
from repro_torch.core.transfer_model import GemmProblem, MXKernel


def paper_search():
    print("== the paper's search space (dual-core, 64^3 FP64) ==")
    p = GemmProblem(64, 64, 64, 8)
    print(f"{'tile':>12} {'subtile':>10} {'transfers':>10} {'AI':>6} {'ops/insn':>9}")
    best = None
    for m_, n_, k_ in paper_subtile_space():
        for B in (2, 4):
            tile = (m_, B * n_, k_)
            try:
                kern = MXKernel(*tile, m_, n_, k_)
            except ValueError:
                continue
            t = kern.mem_to_vrf(p).total
            ai = kern.arithmetic_intensity(p)
            sr = kern.simd_ratio(p)
            print(f"{str(tile):>12} {str((m_, n_, k_)):>10} {t:>10} {ai:>6.2f} {sr:>9.1f}")
            key = (t, -sr)
            if best is None or key < best[0]:
                best = (key, tile, (m_, n_, k_))
    print(f"--> minimum-traffic config: tile {best[1]} sub-tile {best[2]} "
          f"(paper's best: (8,16,4)/(8,4,4))")


def hopper_search(M, N, K, dtype):
    print(f"\n== Hopper tiles for {M}x{N}x{K} ({dtype}) ==")
    for variant in VARIANTS:
        try:
            plan = plan_matmul_tiles(M, N, K, dtype, dtype, variant)
        except ValueError as e:
            print(f" {variant:>8}: refused ({e})")
            continue
        print(f" {variant:>8}: route {plan.route}, tile ({plan.bm}, {plan.bn}, {plan.bk}) x "
              f"{plan.stages} stages, split {plan.split}, parts {plan.parts}, {plan.ctas} CTAs;"
              f" shared memory {plan.smem_bytes / 2**10:.1f} KiB; HBM "
              f"{plan.hbm_bytes / 2**30:.3f} GiB; AI {plan.arithmetic_intensity:.0f}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    paper_search()
    if len(argv) == 4:
        hopper_search(*(int(x) for x in argv[:3]), getattr(torch, argv[3]))
    else:
        hopper_search(8192, 8192, 8192, torch.bfloat16)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
