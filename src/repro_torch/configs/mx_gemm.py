"""The paper's own benchmark workload: square MatMuls at the sizes of
Table IV, plus the tile/sub-tile configurations evaluated there.  Consumed
by benchmarks/table*.py and examples/tile_explorer.py."""
from __future__ import annotations

from typing import Tuple

# (M=N=K, elem_bytes) pairs from Table IV
DUAL_CORE_SIZES: Tuple[Tuple[int, int], ...] = ((16, 8), (32, 8), (64, 8))
MEMPOOL_SIZES: Tuple[Tuple[int, int], ...] = ((64, 4), (128, 4), (256, 4))

# TPU-scale GEMMs for the framework's own kernel benchmarks (bf16)
TPU_GEMM_SIZES: Tuple[Tuple[int, int, int], ...] = (
    (512, 512, 512),
    (1024, 1024, 1024),
    (4096, 4096, 4096),
    (8192, 8192, 8192),
    (4096, 53248, 16384),  # llama3-405b MLP up-proj shape (tokens x ff x d)
)
