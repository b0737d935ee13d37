"""The paper's §II analytical transfer-count model (Tables I and II): the
port of `repro/core/transfer_model.py`, framework-free, copied.

The heart of MX: exact element-transfer counts between every pair of
adjacent memory-hierarchy levels for a tiled GEMM

    D[M,N] = A[M,K] @ B[K,N] + C[M,N]

The hierarchy is MEM -> VRF -> BUF -> FPU in the paper (TCDM -> vector
register file -> near-FPU tile buffer -> FPUs).  On the H100 the same
calculus prices HBM -> shared memory (a CTA's ring of staged A and B
tiles) -> registers (the f32 accumulator, kept across the whole K loop by
kernel 1 and round-tripped through the output every K step by kernel 2):
`HopperGemmTiling`, JAX's `PallasGemmTiling` with its VMEM budget replaced
by the launch's shared memory, computed by the functions the launchers use
(`kernels/_build.py`).

`tests/test_torch_analytics.py` reproduces the "Mem-VRF Transfers" and
"Arithmetic Intensity" columns of the paper's Table IV and holds every
class against JAX's, count for count.  `RingCollectiveGemm` prices the ring
collective GEMMs (`kernels/mx_collective_matmul.py`, `parallel/sharding.py`'s
autotuner); the serving classes price the paged cache, page migration, the
prefix cache and speculation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class GemmProblem:
    """A GEMM problem D = A@B + C with element size in bytes.

    ``elem_bytes`` is the A-operand (and default) element size, as in the
    paper's uniform-precision Tables.  Mixed-precision problems (the §III
    argument: narrow operands through the same datapath, wide accumulation)
    set ``b_bytes`` / ``out_bytes`` per operand — a weights-int8 GEMM is
    e.g. GemmProblem(M, N, K, 2, b_bytes=1, out_bytes=2).  None means
    "same as elem_bytes", so every existing uniform-precision call site and
    the Table IV validation are unchanged.

    ``b_sparse`` marks the weight operand as 2:4 structured-sparse
    (kernels/sparse.py wire format): the B panel streams the compressed
    payload at ``b_elem_bytes``/2 per dense element plus 1 metadata bit —
    a FRACTIONAL per-dense-element size (f32: 2.125), which is why it is a
    flag consumed by ``b_stream_bytes`` rather than an integer b_bytes.
    """

    M: int
    N: int
    K: int
    elem_bytes: int = 8  # FP64 in the paper's Dual-Core study
    b_bytes: Optional[int] = None
    out_bytes: Optional[int] = None
    b_sparse: bool = False

    @property
    def a_elem_bytes(self) -> int:
        return self.elem_bytes

    @property
    def b_elem_bytes(self) -> int:
        return self.elem_bytes if self.b_bytes is None else self.b_bytes

    @property
    def b_stream_bytes(self) -> float:
        """Effective HBM bytes per DENSE B element: the payload itemsize
        for a dense operand; payload/2 + 1/8 (2-bit indices, 2 kept of 4,
        packed 2 groups/byte) under 2:4 sparsity."""
        if not self.b_sparse:
            return float(self.b_elem_bytes)
        return self.b_elem_bytes / 2 + 0.125

    @property
    def out_elem_bytes(self) -> int:
        return self.elem_bytes if self.out_bytes is None else self.out_bytes

    @property
    def macs(self) -> int:
        return self.M * self.N * self.K

    @property
    def flops(self) -> int:
        return 2 * self.macs


@dataclasses.dataclass(frozen=True)
class Transfers:
    """Element counts moved between one pair of adjacent levels.

    Follows the paper's four-term decomposition: A down, B down, C/D down
    (loads/fetches of the output operand), D up (stores/write-backs).
    """

    a_down: int
    b_down: int
    cd_down: int
    d_up: int

    @property
    def total(self) -> int:
        return self.a_down + self.b_down + self.cd_down + self.d_up

    def bytes(self, elem_bytes: int) -> int:
        return self.total * elem_bytes


# ---------------------------------------------------------------------------
# Table I — generic three-level tiling
# ---------------------------------------------------------------------------


def mem_to_vrf(
    p: GemmProblem,
    m: int,
    n: int,
    k: int,
    *,
    inter_k_buffering: bool = False,
    c_is_zero: bool = False,
) -> Transfers:
    """Table I ref. 1): transfers between the memory and the VRF.

    Tiles in the VRF have sizes (m,k), (n,k), (m,n).
    - ``inter_k_buffering``: the output tile stays in the VRF across the whole
      K dimension => the K/k round-trip factor collapses to 1 (paper §II-C-a).
    - ``c_is_zero``: C-tile reset (paper §II-C-b) => no load of C at all.
    """
    M, N, K = p.M, p.N, p.K
    a_down = _ceil_div(N, n) * M * K
    b_down = _ceil_div(M, m) * N * K
    k_trips = 1 if inter_k_buffering else _ceil_div(K, k)
    cd_down = 0 if (c_is_zero and k_trips == 1) else (0 if c_is_zero else k_trips * M * N)
    # With C==0 but no inter-k buffering, partial D tiles still round-trip
    # K/k - 1 times (first pass needs no load thanks to the reset).
    if c_is_zero and k_trips > 1:
        cd_down = (k_trips - 1) * M * N
    d_up = k_trips * M * N
    return Transfers(a_down, b_down, cd_down, d_up)


def vrf_to_buf(
    p: GemmProblem,
    m: int,
    n: int,
    k: int,
    m_: int,
    n_: int,
    k_: int,
    *,
    inter_k_buffering_buf: bool = False,
    inter_k_buffering_vrf: bool = False,
    c_is_zero: bool = False,
) -> Transfers:
    """Table I ref. 2): transfers between the VRF and the near-FPU buffer.

    Sub-tiles in the buffer have sizes (m',k'), (n',k'), (m',n').  Counts are
    totals over the whole program (the paper's "(K/k)(k/k') M/m' N/n'" form).

    - ``inter_k_buffering_buf``: output sub-tile stays in the buffer for the
      whole K dimension => (K/k)(k/k') -> 1.
    - ``inter_k_buffering_vrf``: buffering only up to the k dimension of the
      VRF tile => (k/k') -> 1 within each of the K/k tile passes.
    """
    M, N, K = p.M, p.N, p.K
    a_down = _ceil_div(N, n_) * M * K
    b_down = _ceil_div(M, m_) * N * K
    if inter_k_buffering_buf:
        trips = 1
    elif inter_k_buffering_vrf:
        trips = _ceil_div(K, k)
    else:
        trips = _ceil_div(K, k) * _ceil_div(k, k_)
    cd_down = 0 if c_is_zero and trips == 1 else ((trips - 1) if c_is_zero else trips) * M * N
    d_up = trips * M * N
    return Transfers(a_down, b_down, cd_down, d_up)


def buf_to_fpu(
    p: GemmProblem,
    m_: int,
    n_: int,
    k_: int,
    t_a: int,
    t_b: int,
) -> Transfers:
    """Table I ref. 3): operand fetches between the buffer and the FPUs.

    ``t_a`` / ``t_b`` are how many elements of the A / B sub-tiles are
    consumed per fetch (the broadcast factors).
    """
    M, N, K = p.M, p.N, p.K
    a_down = _ceil_div(N, t_b) * M * K
    b_down = _ceil_div(M, t_a) * N * K
    cd_down = K * M * N
    d_up = K * M * N
    return Transfers(a_down, b_down, cd_down, d_up)


# ---------------------------------------------------------------------------
# Table II — the paper's baseline vs MX-ready configurations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BaselineKernel:
    """The paper's scalar-vector baseline: m scalar elements of A from the
    scalar RF, n-long vectors of B; output tile (m, n) buffered in the VRF
    across the whole K (k == 1 in Table IV's baseline rows)."""

    m: int
    n: int
    k: int = 1
    num_fpus: int = 4  # F in Table II

    def mem_to_vrf(self, p: GemmProblem) -> Transfers:
        # Table II rows 1-2: C is zero-reset (no load), D stored once (MN).
        a_down = _ceil_div(p.N, self.n) * p.M * p.K
        b_down = _ceil_div(p.M, self.m) * p.N * p.K
        return Transfers(a_down, b_down, 0, p.M * p.N)

    def vrf_to_fpu(self, p: GemmProblem) -> Transfers:
        a_down = _ceil_div(p.N, self.num_fpus) * p.M * p.K
        b_down = p.M * p.N * p.K
        return Transfers(a_down, b_down, p.K * p.M * p.N, p.K * p.M * p.N)

    def simd_ratio(self, p: GemmProblem) -> float:
        """MACs per vector instruction, counting compute + tile memory insns.

        The paper's Table IV baseline column equals exactly `n` (compute
        instructions only); we report the compute-only ratio to match.
        """
        return float(self.n)

    def vector_instructions(self, p: GemmProblem) -> int:
        """All vector instructions: vfmacc + vector loads of B + stores."""
        vfmacc = p.M * p.K * _ceil_div(p.N, self.n)
        vload_b = p.K * _ceil_div(p.N, self.n) * _ceil_div(p.M, self.m)
        vstore = _ceil_div(p.M * p.N, self.n)
        return vfmacc + vload_b + vstore

    def arithmetic_intensity(self, p: GemmProblem) -> float:
        return p.flops / self.mem_to_vrf(p).bytes(p.elem_bytes)


@dataclasses.dataclass(frozen=True)
class MXKernel:
    """The MX-ready kernel of Table II.

    Tiles (m, n, k) live in the VRF; sub-tiles (m', n', k') feed the near-FPU
    buffer.  The paper constrains m' == m, k' == k, and n == B * n' with the
    broadcast factor B in {2, 4, 8}; m', n', k' in {4, 8}.
    """

    m: int
    n: int
    k: int
    m_: int
    n_: int
    k_: int
    num_fpus: int = 4

    def __post_init__(self):
        if self.n % self.n_ != 0:
            raise ValueError(f"n={self.n} must be a multiple of n'={self.n_}")

    @property
    def broadcast_B(self) -> int:
        return self.n // self.n_

    def mem_to_vrf(self, p: GemmProblem) -> Transfers:
        # Table II row "MX #Elm^MEM_VRF": A amortized by B*n', C reset,
        # D written back once (inter-k buffering of the output in the VRF).
        a_down = _ceil_div(p.N, self.broadcast_B * self.n_) * p.M * p.K
        b_down = _ceil_div(p.M, self.m_) * p.N * p.K
        return Transfers(a_down, b_down, 0, p.M * p.N)

    def vrf_to_buf(self, p: GemmProblem) -> Transfers:
        a_down = _ceil_div(p.N, self.n_) * p.M * p.K
        b_down = _ceil_div(p.M, self.m_) * p.N * p.K
        trips = _ceil_div(p.K, self.k_)
        return Transfers(a_down, b_down, trips * p.M * p.N, trips * p.M * p.N)

    def buf_to_fpu(self, p: GemmProblem) -> Transfers:
        a_down = _ceil_div(p.N, self.num_fpus) * p.M * p.K
        b_down = _ceil_div(_ceil_div(p.M, self.m_), self.num_fpus) * p.N * p.K
        return Transfers(a_down, b_down, p.K * p.M * p.N, p.K * p.M * p.N)

    def vector_instructions(self, p: GemmProblem) -> int:
        """mxfmacc + mld.a + mld.b + mst.c instruction counts.

        NOTE (documented deviation): the paper's Table IV "SIMD ratio" column
        is not exactly reproducible from the ISA definition alone (it falls
        between compute-only and compute+memory accounting).  We report the
        compute+memory count; the qualitative claim (MX raises ops/insn by
        2-4x over the baseline) is preserved.  See EXPERIMENTS.md.
        """
        mxfmacc = (
            _ceil_div(p.M, self.m_) * _ceil_div(p.N, self.n_) * _ceil_div(p.K, self.k_)
        )
        mld_a = (
            _ceil_div(p.M, self.m_)
            * _ceil_div(p.K, self.k_)
            * _ceil_div(p.N, self.broadcast_B * self.n_)
        )
        mld_b = (
            _ceil_div(p.M, self.m_) * _ceil_div(p.N, self.n_) * _ceil_div(p.K, self.k_)
        )
        mst_c = _ceil_div(p.M * p.N, self.m_ * self.n_)
        return mxfmacc + mld_a + mld_b + mst_c

    def simd_ratio(self, p: GemmProblem) -> float:
        return p.macs / self.vector_instructions(p)

    def arithmetic_intensity(self, p: GemmProblem) -> float:
        return p.flops / self.mem_to_vrf(p).bytes(p.elem_bytes)

    def vrf_access_reduction_vs(self, base: "BaselineKernel", p: GemmProblem) -> float:
        """The §III-B.6 claim: MX reduces VRF accesses by ~(K/k') on the
        output operand.  Returns baseline_vrf_accesses / mx_vrf_accesses."""
        base_acc = base.vrf_to_fpu(p).total
        mx_acc = self.vrf_to_buf(p).total
        return base_acc / mx_acc


# ---------------------------------------------------------------------------
# Hopper mapping: HBM <-> shared memory <-> registers for the CUDA GEMMs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HopperGemmTiling:
    """HBM <-> shared memory traffic of a CUDA GEMM launch with CTA tile
    (bm, bn) and K step bk (JAX's `PallasGemmTiling` on the card).

    Maps the paper's Table I ref. 1) with the VRF := a CTA's shared memory
    and registers.  ``accumulate_in_registers`` is the MX inter-k-buffering
    analogue: the f32 accumulator stays in registers across the whole K
    loop and the output tile is written exactly once (kernel 1,
    `mx_matmul_fused`).  With it off (kernel 2, `baseline_matmul`) the
    output tile is re-read and re-written every ``bk`` rows of K -- the
    partial-sum round trip the paper kills -- so there ``bk`` is the
    baseline's round-trip step.  `hbm_transfers`, `hbm_bytes`,
    `epilogue_saved_bytes`, `unfused_chain_bytes`, `arithmetic_intensity`,
    `grid_steps` and `simd_ratio` are JAX's formulas: for the same (bm, bn,
    bk) they give JAX's numbers (``gated`` adds the gate's weight panel, a
    swiglu launch's second B).

    ``fused_epilogue_ops``: each elementwise epilogue op (bias-add,
    activation, residual-add, scale) fused into the single store would,
    unfused, re-read and re-write the M*N output through HBM once; each
    saves a full 2*M*N round trip (epilogue *operand* loads -- bias N,
    residual M*N -- happen in both versions and are not credited).

    ``route``, ``stages``, ``split``, ``parts`` and ``gated`` describe the
    launch's ring (`kernels/_build.py`): "decode" (csrc/decode_tile.cuh, M
    <= 16 rows in one CTA row), "mma" (csrc/prefill_tile.cuh and the
    grouped GEMM's csrc/grouped_mma.cuh; every pair at M > 16, int8 x int8
    and e4m3 x e4m3 in their own byte); ``ring_bk`` the ring's K rows per
    stage where they are not ``bk`` (kernel 2 stages as kernel 1 does and
    round-trips every ``bk``); ``abft`` an ABFT launch, whose decode ring
    keeps the checksums' scratch beside it.  `smem_bytes` replaces JAX's
    `vmem_bytes`.
    """

    bm: int
    bn: int
    bk: int
    accumulate_in_registers: bool = True
    c_is_zero: bool = True
    fused_epilogue_ops: int = 0
    route: str = "mma"
    stages: int = 2
    split: int = 1
    parts: int = 1
    gated: bool = False
    ring_bk: int = 0  # K rows per ring stage, where they differ from bk (kernel 2)
    abft: bool = False

    ROUTES = ("decode", "mma")

    def __post_init__(self):
        if self.route not in self.ROUTES:
            raise ValueError(f"unknown route {self.route!r}; one of {self.ROUTES}")

    def hbm_transfers(self, p: GemmProblem) -> Transfers:
        return mem_to_vrf(
            p,
            self.bm,
            self.bn,
            self.bk,
            inter_k_buffering=self.accumulate_in_registers,
            c_is_zero=self.c_is_zero,
        )

    def hbm_bytes(self, p: GemmProblem, out_bytes: Optional[int] = None) -> int:
        """Per-operand accounting: A and B panels move at their own element
        sizes (the §III narrow-operand traffic credit; a 2:4-sparse B panel
        moves compressed payload + metadata via ``b_stream_bytes``; a gated
        launch streams two B panels), the output operand at the OUTPUT
        element size -- the accumulator is f32 but never leaves the
        registers, so it costs nothing here."""
        t = self.hbm_transfers(p)
        ob = p.out_elem_bytes if out_bytes is None else out_bytes
        mats = 2 if self.gated else 1
        return round(t.a_down * p.a_elem_bytes + mats * t.b_down * p.b_stream_bytes
                     + (t.cd_down + t.d_up) * ob)

    def smem_bytes(self, p: GemmProblem) -> int:
        """Dynamic shared memory of one CTA, as the launch asks for it: the
        ring of `stages` slots of staged A rows and B (and gate) tiles (a
        2:4 B as payload and metadata), beside it on the "decode" route an
        ABFT launch's checksum scratch, and on the "mma" route the f32
        (int8 x int8: int32) tile a CTA folding several K parts keeps
        (csrc/prefill_tile.cuh `prefill_smem`; kernel 2 has none); the
        accumulator itself stays in registers (`acc_register_bytes`).
        Computed by the functions the launchers use (`_build.decode_smem`,
        `_build.prefill_smem`)."""
        from ..kernels import _build

        ea, eb, bk = p.a_elem_bytes, p.b_elem_bytes, self.ring_bk or self.bk
        if self.route == "decode":
            variant = "sparse" if p.b_sparse else "abft" if self.abft else "dense"
            return _build.decode_smem(p.M, self.bn, bk, ea, eb, self.stages, self.gated,
                                      variant)
        return _build.prefill_smem(self.bm, self.bn, bk, ea, eb, self.stages, self.split,
                                   self.parts, self.gated, p.b_sparse,
                                   self.accumulate_in_registers)

    def acc_register_bytes(self, p: GemmProblem, acc_bytes: int = 4) -> int:
        """The f32 accumulator of one CTA's output tile, held in registers
        across the K loop (a decode CTA covers all M rows; a gated launch
        keeps the gate's beside it)."""
        rows = p.M if self.route == "decode" else self.bm
        return rows * self.bn * acc_bytes * (2 if self.gated else 1)

    def epilogue_saved_bytes(self, p: GemmProblem, out_bytes: Optional[int] = None) -> int:
        """HBM bytes the fused epilogue eliminates vs the unfused op graph:
        2 * M * N (one read + one write of the output) per fused op, at the
        OUTPUT operand's element size."""
        ob = p.out_elem_bytes if out_bytes is None else out_bytes
        return self.fused_epilogue_ops * 2 * p.M * p.N * ob

    def unfused_chain_bytes(self, p: GemmProblem, out_bytes: Optional[int] = None) -> int:
        """Total HBM traffic of the equivalent *unfused* graph: the GEMM's
        own traffic plus one M*N round-trip per epilogue op."""
        return self.hbm_bytes(p, out_bytes) + self.epilogue_saved_bytes(p, out_bytes)

    def arithmetic_intensity(self, p: GemmProblem) -> float:
        return p.flops / self.hbm_bytes(p)

    def grid_steps(self, p: GemmProblem) -> int:
        return _ceil_div(p.M, self.bm) * _ceil_div(p.N, self.bn) * _ceil_div(p.K, self.bk)

    def simd_ratio(self, p: GemmProblem) -> float:
        """FLOPs per (tile, K step): the analogue of FLOP/vinsn."""
        return p.flops / self.grid_steps(p)


# ---------------------------------------------------------------------------
# ABFT mapping: checksum-extended GEMM overhead (kernels/abft)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AbftGemm:
    """Overhead of the checksum-extended GEMM (kernels/abft + the fused
    kernels' ``abft=`` mode) priced in the transfer model's own units.

    Alongside each (bm, bn) accumulator tile the kernel carries one
    checksum row (1, bn) and one checksum column (bm, 1) — the classical
    ABFT extension, accumulated per k step:

        ccol MACs = K * bn          (colsum(a_blk) @ b_blk)
        crow MACs = K * bm          (a_blk @ rowsum(b_blk))
        operand reductions = K * (bm + bn) adds (colsum/rowsum)

    per output tile, against the tile's own bm * bn * K main MACs — the
    relative compute overhead is therefore ~``1/bm + 1/bn`` (~1.6% at
    128x128), DOUBLED on float payloads, which additionally accumulate
    |a|/|b| checksums to scale the tolerance (``exact=False``).  The
    verify itself (row/col sums of the finished tile + compares) is
    ~2/K relative — it rides the write-back and is counted separately.

    HBM cost is one int32 flag per tile (the second kernel output) plus,
    only when a fault is being injected (tests/chaos), the three
    (grid_m, grid_n) fault operands.  On-chip cost is the checksum scratch
    living next to the accumulator: (bm + bn) f32/int32 entries, doubled
    for the float |.| pair (`extra_smem_bytes`; on the card it sits in the
    ABFT tile's static shared memory, `_build.PREFILL_ABFT_STATIC` at
    most)."""

    bm: int
    bn: int
    exact: bool = False
    inject: bool = False
    flag_bytes: int = 4

    def tiles(self, p: GemmProblem) -> int:
        return _ceil_div(p.M, self.bm) * _ceil_div(p.N, self.bn)

    @property
    def _pairs(self) -> int:
        """Checksum row/col pairs per tile: value, plus |.| on floats."""
        return 1 if self.exact else 2

    def checksum_macs(self, p: GemmProblem) -> int:
        """Extra MACs of the checksum accumulation over the whole GEMM."""
        per_tile = p.K * (self.bm + self.bn)
        return self._pairs * self.tiles(p) * per_tile

    def reduction_adds(self, p: GemmProblem) -> int:
        """colsum/rowsum adds feeding the checksum dots."""
        return self._pairs * self.tiles(p) * p.K * (self.bm + self.bn)

    def verify_adds(self, p: GemmProblem) -> int:
        """Write-back compare: row+col sums of each finished tile."""
        return 2 * self.tiles(p) * self.bm * self.bn

    def overhead_ratio(self, p: GemmProblem) -> float:
        """Checksum MACs relative to the main GEMM's MACs — the headline
        number (~(1/bm + 1/bn), x2 float) the README table quotes."""
        return self.checksum_macs(p) / p.macs

    def extra_hbm_bytes(self, p: GemmProblem) -> int:
        """Flags always; fault operands only under injection."""
        n = self.tiles(p)
        flags = n * self.flag_bytes
        fault = 3 * n * 4 if self.inject else 0
        return flags + fault

    def extra_smem_bytes(self) -> int:
        """Checksum scratch beside the (bm, bn) accumulator."""
        return self._pairs * (self.bm + self.bn) * 4

    def report(self, p: GemmProblem) -> dict:
        return {
            "bm": self.bm,
            "bn": self.bn,
            "exact": self.exact,
            "tiles": self.tiles(p),
            "checksum_macs": self.checksum_macs(p),
            "reduction_adds": self.reduction_adds(p),
            "verify_adds": self.verify_adds(p),
            "overhead_ratio": self.overhead_ratio(p),
            "extra_hbm_bytes": self.extra_hbm_bytes(p),
            "extra_smem_bytes": self.extra_smem_bytes(),
        }


# ---------------------------------------------------------------------------
# Sparsity mapping: 2:4 compressed weight-stream economics (kernels/sparse)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SparseGemm:
    """Traffic economics of one 2:4 structured-sparse GEMM (kernels/sparse
    wire format riding kernels/mx_matmul's fused write-back), priced in the
    transfer model's own units.

    The weight panel streams payload (b_elem_bytes / 2 per dense element)
    plus packed 2-bit metadata (1/8 byte per dense element); A, the output,
    and the write-back discipline are untouched.  The on-chip expansion at
    the dot costs compare-selects, not HBM bytes, so the whole benefit is
    the B-stream shrink — f32 weights drop to 0.53125x, int8-sparse weights
    to 0.15625x of dense f32.

    ``report`` prices the SAME (bm, bn, bk) tiling with the sparse flag on
    and off, so the ratio includes the tile revisits (nm) the planner's
    traffic model charges — it is the as-executed ratio, not the naive
    storage ratio (they coincide on aligned shapes)."""

    bm: int
    bn: int
    bk: int
    fused_epilogue_ops: int = 0

    def _tiling(self) -> HopperGemmTiling:
        return HopperGemmTiling(self.bm, self.bn, self.bk,
                                fused_epilogue_ops=self.fused_epilogue_ops)

    def _sparse(self, p: GemmProblem) -> GemmProblem:
        return dataclasses.replace(p, b_sparse=True)

    def weight_stream_bytes(self, p: GemmProblem) -> int:
        """B-panel HBM bytes of the sparse GEMM (payload + metadata,
        including per-tile revisits)."""
        t = self._tiling().hbm_transfers(p)
        return round(t.b_down * self._sparse(p).b_stream_bytes)

    def dense_weight_stream_bytes(self, p: GemmProblem) -> int:
        t = self._tiling().hbm_transfers(p)
        return t.b_down * p.b_elem_bytes

    def weight_ratio(self, p: GemmProblem) -> float:
        """sparse weight bytes / dense weight bytes at the SAME payload
        dtype: (itemsize/2 + 1/8) / itemsize — 0.53125 for f32, 0.625 for
        int8 (vs int8 dense; 0.15625 vs f32 dense)."""
        return self.weight_stream_bytes(p) / self.dense_weight_stream_bytes(p)

    def hbm_bytes(self, p: GemmProblem) -> int:
        return self._tiling().hbm_bytes(self._sparse(p))

    def dense_hbm_bytes(self, p: GemmProblem) -> int:
        return self._tiling().hbm_bytes(p)

    def saved_hbm_bytes(self, p: GemmProblem) -> int:
        return self.dense_hbm_bytes(p) - self.hbm_bytes(p)

    def smem_bytes(self, p: GemmProblem) -> int:
        """Staged working set of a two-slot tensor-core ring: A rows and
        the compressed B block (payload + metadata) with its widened copy
        (`_build.prefill_smem`, sparse)."""
        return self._tiling().smem_bytes(self._sparse(p))

    def report(self, p: GemmProblem) -> dict:
        return {
            "bm": self.bm,
            "bn": self.bn,
            "bk": self.bk,
            "b_bytes_per_dense_elem": self._sparse(p).b_stream_bytes,
            "weight_stream_bytes": self.weight_stream_bytes(p),
            "dense_weight_stream_bytes": self.dense_weight_stream_bytes(p),
            "weight_ratio": self.weight_ratio(p),
            "hbm_bytes": self.hbm_bytes(p),
            "hbm_bytes_dense": self.dense_hbm_bytes(p),
            "saved_hbm_bytes": self.saved_hbm_bytes(p),
            "smem_bytes": self.smem_bytes(p),
        }


# ---------------------------------------------------------------------------
# Serving mapping: decode-step KV-cache traffic (dense rectangle vs pages)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PagedKVDecode:
    """Per-decode-step KV-cache HBM traffic: the dense (slots, max_len)
    rectangle vs pages actually resident.

    Every decode step's attention must stream the cached K and V exactly
    once (the flash/online-softmax formulation already guarantees single-
    pass streaming — the MX inter-k discipline with K := the sequence
    axis).  What the cache LAYOUT decides is *how many rows* stream:

      dense  — batch_slots * max_len rows, regardless of how short the
               live sequences are (padding traffic);
      paged  — sum_i ceil(len_i / page_size) * page_size rows: the pages
               the page table actually names (runtime/kv_pages), so bytes
               scale with live tokens + one page of rounding per slot.

    Both layouts additionally write one row per active slot (the new
    token's K/V).  ``kv_bytes`` is the cache element size; a quantized
    cache sets ``scale_bytes`` for the per-row dequant sidecar (int8 cache:
    4-byte f32 scale per head per row, kernels/quant layout).
    """

    batch_slots: int
    max_len: int
    page_size: int
    n_kv_heads: int
    head_dim: int
    n_layers: int = 1
    kv_bytes: int = 2
    scale_bytes: int = 0

    @property
    def row_bytes(self) -> int:
        """One cached position: K + V across the kv heads (+ scale sidecar)."""
        payload = 2 * self.n_kv_heads * self.head_dim * self.kv_bytes
        sidecar = 2 * self.n_kv_heads * self.scale_bytes
        return payload + sidecar

    def _resident_rows(self, lengths) -> int:
        ps = self.page_size
        return sum(_ceil_div(int(l), ps) * ps for l in lengths if int(l) > 0)

    def dense_step_bytes(self, lengths) -> int:
        """Reads of the full padded rectangle + the live slots' row writes."""
        n_active = sum(1 for l in lengths if int(l) > 0)
        rows = self.batch_slots * self.max_len + n_active
        return rows * self.row_bytes * self.n_layers

    def paged_step_bytes(self, lengths) -> int:
        """Reads of the resident pages only + the live slots' row writes."""
        n_active = sum(1 for l in lengths if int(l) > 0)
        rows = self._resident_rows(lengths) + n_active
        return rows * self.row_bytes * self.n_layers

    def traffic_ratio(self, lengths) -> float:
        dense = self.dense_step_bytes(lengths)
        return self.paged_step_bytes(lengths) / dense if dense else 1.0

    def fill_ratio(self, lengths) -> float:
        cap = self.batch_slots * self.max_len
        return sum(int(l) for l in lengths) / cap if cap else 0.0

    def report(self, lengths, *, hbm_bw: Optional[float] = None) -> dict:
        """Machine-readable record for one batch state.  ``hbm_bw`` adds
        memory-term seconds."""
        dense = self.dense_step_bytes(lengths)
        paged = self.paged_step_bytes(lengths)
        rec = {
            "batch_slots": self.batch_slots,
            "max_len": self.max_len,
            "page_size": self.page_size,
            "n_layers": self.n_layers,
            "kv_bytes": self.kv_bytes,
            "scale_bytes": self.scale_bytes,
            "fill_ratio": self.fill_ratio(lengths),
            "live_tokens": int(sum(int(l) for l in lengths)),
            "resident_pages": int(sum(
                _ceil_div(int(l), self.page_size) for l in lengths if int(l) > 0)),
            "dense_step_bytes": dense,
            "paged_step_bytes": paged,
            "traffic_credit_bytes": dense - paged,
            "bytes_ratio": self.traffic_ratio(lengths),
        }
        if hbm_bw:
            rec["dense_memory_s"] = dense / hbm_bw
            rec["paged_memory_s"] = paged / hbm_bw
        return rec


@dataclasses.dataclass(frozen=True)
class PageMigration:
    """KV-page handoff cost between a prefill pool and a decode pool
    (runtime/disagg.DisaggEngine).

    The paper's tile-buffer argument applied to disaggregation: handoff and
    recovery cost scales with the bytes NOT already resident on the
    receiving side.

      - shared pool: the handoff ships the page *table* (incref + index
        publish + remount) — zero cache bytes move; only the metadata row,
        which is noise next to any page payload.
      - disjoint pools: every migrated full page's rows are read from the
        prefill cache and written into the decode cache, per layer and per
        K/V operand (+ scale sidecars for quantized caches).

    ``row_bytes`` matches `PagedKVDecode.row_bytes` per layer so the two
    models price the same cache layout consistently.
    """

    page_size: int
    n_kv_heads: int
    head_dim: int
    n_layers: int = 1
    kv_bytes: int = 2
    scale_bytes: int = 0

    @property
    def row_bytes(self) -> int:
        """One cached position: K + V across the kv heads (+ sidecar),
        single layer."""
        payload = 2 * self.n_kv_heads * self.head_dim * self.kv_bytes
        sidecar = 2 * self.n_kv_heads * self.scale_bytes
        return payload + sidecar

    @property
    def page_bytes(self) -> int:
        """One full page's cache payload across all layers."""
        return self.page_size * self.row_bytes * self.n_layers

    def migrate_bytes(self, pages: int) -> int:
        """HBM traffic of copying `pages` full pages across pools: one read
        + one write of every row (both memories are touched)."""
        return 2 * max(int(pages), 0) * self.page_bytes

    def handoff_bytes(self, pages: int, *, shared_pool: bool) -> int:
        """Cache bytes a handoff of `pages` pages moves: zero under the
        shared-pool metadata handoff, the full migration traffic across
        disjoint pools."""
        return 0 if shared_pool else self.migrate_bytes(pages)

    def migrate_seconds(self, pages: int, bw: float) -> float:
        """Memory-term seconds for a migration at `bw` bytes/s."""
        return self.migrate_bytes(pages) / bw if bw else 0.0

    def report(self, pages: int, *, bw: Optional[float] = None) -> dict:
        rec = {
            "pages": int(pages),
            "page_bytes": self.page_bytes,
            "row_bytes": self.row_bytes,
            "n_layers": self.n_layers,
            "shared_pool_handoff_bytes": self.handoff_bytes(
                pages, shared_pool=True),
            "migrated_bytes": self.migrate_bytes(pages),
        }
        if bw:
            rec["migrate_s"] = self.migrate_seconds(pages, bw)
        return rec


@dataclasses.dataclass(frozen=True)
class SharedPrefixPrefill:
    """Prefill work a prefix-cache hit avoids (runtime/prefix_cache).

    A request whose first ``matched`` prompt tokens map onto pages some
    earlier request already prefilled skips, per transformer layer:

      - the prefill GEMMs for those tokens (qkv, attention-out, and the MLP
        up/gate/down projections — the per-token weight-times-activation
        FLOPs, exactly the contractions `ops.linear` would have launched);
      - the weight bytes those GEMM launches would have streamed from HBM
        once per prefill chunk, and the activation reads/writes around
        them;
      - the K/V page writes for the matched rows (the new request
        *references* the resident rows instead of re-writing them — the
        tile-buffer reuse argument applied to the cache).

    Attention-score FLOPs are NOT credited: the tail tokens still attend
    over the shared prefix, so score work against those positions is paid
    by whoever computes the tail.  ``act_bytes`` is the activation element
    size of prefill compute; ``kv_bytes`` the cache payload element size
    (+ ``scale_bytes`` per row per head for quantized caches).
    """

    d_model: int
    d_ff: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    n_layers: int = 1
    gated_mlp: bool = True
    act_bytes: int = 2
    kv_bytes: int = 2
    scale_bytes: int = 0
    page_size: int = 16

    @property
    def flops_per_token(self) -> int:
        """Per-token prefill GEMM FLOPs across the stack (2*MACs)."""
        d, hd = self.d_model, self.head_dim
        qkv = d * (self.n_heads + 2 * self.n_kv_heads) * hd
        out = self.n_heads * hd * d
        mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        return 2 * (qkv + out + mlp) * self.n_layers

    @property
    def kv_row_bytes(self) -> int:
        payload = 2 * self.n_kv_heads * self.head_dim * self.kv_bytes
        sidecar = 2 * self.n_kv_heads * self.scale_bytes
        return (payload + sidecar) * self.n_layers

    @property
    def act_bytes_per_token(self) -> int:
        """Activation HBM bytes around the skipped GEMMs: the layer input
        read + output write per projection group (x into qkv, attn-out, MLP
        in/out), the intermediate d_ff row, and the D-row residual —
        single-pass counts, epilogue fusion assumed (no separate bias/act
        round-trips)."""
        d_rows = 4 * self.d_model + self.d_ff
        return d_rows * self.act_bytes * self.n_layers

    def hit_savings(self, matched: int) -> dict:
        """Per-hit savings for `matched` prefix tokens."""
        matched = max(int(matched), 0)
        return {
            "matched_tokens": matched,
            "shared_pages": _ceil_div(matched, self.page_size),
            "prefill_flops_saved": matched * self.flops_per_token,
            "kv_write_bytes_saved": matched * self.kv_row_bytes,
            "act_hbm_bytes_saved": matched * self.act_bytes_per_token,
            "hbm_bytes_saved": matched * (self.kv_row_bytes
                                          + self.act_bytes_per_token),
        }

    def report(self, prompt_len: int, overlaps=(0.0, 0.5, 0.9), *,
               flops_rate: Optional[float] = None,
               hbm_bw: Optional[float] = None) -> dict:
        """Savings table over prefix-overlap fractions of a `prompt_len`
        prompt.  Optional
        rates add roofline seconds: a hit's TTFT credit is the MAX of the
        compute and memory terms it skips."""
        out = {
            "prompt_len": int(prompt_len),
            "page_size": self.page_size,
            "n_layers": self.n_layers,
            "flops_per_token": self.flops_per_token,
            "kv_row_bytes": self.kv_row_bytes,
            "overlaps": {},
        }
        for ov in overlaps:
            matched = int(ov * prompt_len)
            rec = self.hit_savings(matched)
            rec["overlap"] = ov
            if flops_rate:
                rec["compute_s_saved"] = (rec["prefill_flops_saved"]
                                          / flops_rate)
            if hbm_bw:
                rec["memory_s_saved"] = rec["hbm_bytes_saved"] / hbm_bw
            if flops_rate and hbm_bw:
                rec["ttft_credit_s"] = max(rec["compute_s_saved"],
                                           rec["memory_s_saved"])
            out["overlaps"][f"{ov:.2f}"] = rec
        return out


@dataclasses.dataclass(frozen=True)
class SpeculativeDecode:
    """Decode-step cost amortization from batched verification
    (runtime/speculative + the mx_flash_verify window kernel).

    Plain greedy decode is launch- and weight-bound: EVERY emitted token
    re-reads every weight byte and every resident KV byte.  A speculative
    verify step reads them ONCE for a k+1-token window — the tile-buffer
    reuse argument applied along the time axis — and emits a geometric
    number of tokens set by the per-draft acceptance rate alpha:

        E[tokens/launch] = 1 + a + a^2 + ... + a^k = (1-a^(k+1)) / (1-a)

    (each draft is accepted only if every draft before it was — the
    greedy-exact chain).  Cost per launch, in units of one plain decode
    step, is 1 (the verify pass streams the same weights + pages; the
    extra k rows of attention/FFN arithmetic ride the already-streamed
    bytes) plus ``draft_cost_ratio`` per draft token for the drafter
    (0 for host-side n-gram lookup; a small draft model costs its
    parameter-read fraction).  Expected speedup in the memory-bound
    regime is then E[tokens] / (1 + draft_cost_ratio*k)."""

    k: int
    draft_cost_ratio: float = 0.0
    window_write_rows: int = 0  # extra K/V rows written vs 1 (the k drafts)

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if not 0.0 <= self.draft_cost_ratio:
            raise ValueError("draft_cost_ratio must be >= 0")

    def expected_tokens(self, alpha: float) -> float:
        """E[tokens emitted per verify launch] at per-draft acceptance
        rate alpha (the greedy-exact chain makes it a truncated geometric
        series; alpha=1 gives the full k+1)."""
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if alpha == 1.0:
            return float(self.k + 1)
        return (1.0 - alpha ** (self.k + 1)) / (1.0 - alpha)

    def launch_cost(self) -> float:
        """Verify-launch cost in plain-decode-step units: one full weight
        + resident-KV stream, plus the drafter's per-draft cost."""
        return 1.0 + self.draft_cost_ratio * self.k

    def speedup(self, alpha: float) -> float:
        """Expected decode tok/s multiple vs plain decode in the
        memory-/launch-bound regime."""
        return self.expected_tokens(alpha) / self.launch_cost()

    def breakeven_alpha(self, grid: int = 1000) -> float:
        """Smallest alpha (on a grid) where speculation stops losing —
        with a free drafter that is alpha=0 (speedup 1.0); a paid drafter
        needs real acceptance to cover its cost."""
        for i in range(grid + 1):
            a = i / grid
            if self.speedup(a) >= 1.0:
                return a
        return 1.0

    def weight_reads_per_token(self, alpha: float) -> float:
        """Full-parameter HBM sweeps per emitted token (plain decode: 1)."""
        return 1.0 / self.expected_tokens(alpha)

    def report(self, alphas=(0.0, 0.25, 0.5, 0.75, 0.9, 1.0)) -> dict:
        """alpha -> expected tokens per launch, weight reads per token and
        speedup."""
        return {
            "k": self.k,
            "draft_cost_ratio": self.draft_cost_ratio,
            "launch_cost_steps": self.launch_cost(),
            "breakeven_alpha": self.breakeven_alpha(),
            "alphas": {
                f"{a:.2f}": {
                    "expected_tokens_per_launch": self.expected_tokens(a),
                    "weight_reads_per_token": self.weight_reads_per_token(a),
                    "speedup": self.speedup(a),
                }
                for a in alphas
            },
        }


# ---------------------------------------------------------------------------
# Cluster mapping: ring collective GEMMs (comm/compute overlap)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RingCollectiveGemm:
    """Overlap-aware comm/compute model for a P-way ring collective GEMM.

    This is the paper's multi-core argument (§IV: 56% cluster gain from
    overlapping operand movement with MACs) applied one level up: the ring
    step is the cluster-level analogue of the inter-k accumulation, and the
    per-step exposed communication is ``max(0, comm_step - compute_step)``
    — zero when the chunk GEMM covers the transfer.

    ``mode``:
      "allgather"      — D[M, N/P] per device = AG_M(A) @ B_shard.  Each of
          the P steps multiplies a resident (M/P, K) chunk of A against the
          local (K, N/P) weight shard; P-1 sends move A chunks.
      "reduce_scatter" — D[M/P, N] per device = RS_M(A_shard @ B_shard).
          Each step contributes a (M/P, K/P)x(K/P, N) chunk GEMM into a
          traveling f32 partial accumulator of (M/P, N); P-1 sends move
          accumulators.

    ``bidirectional`` splits each chunk across both ring directions, so a
    step's per-link bytes (and thus its comm time) halve.

    The problem `p` is the GLOBAL GemmProblem (full M, N, K).
    """

    mode: str
    axis_size: int
    bidirectional: bool = True
    acc_bytes: int = 4  # f32 partial accumulators on the reduce-scatter ring

    MODES = ("allgather", "reduce_scatter")

    def __post_init__(self):
        if self.mode not in self.MODES:
            raise ValueError(f"unknown mode {self.mode!r}; one of {self.MODES}")
        if self.axis_size < 1:
            raise ValueError(f"axis_size must be >= 1, got {self.axis_size}")

    @property
    def steps(self) -> int:
        return self.axis_size

    @property
    def sends(self) -> int:
        return self.axis_size - 1

    def chunk_flops(self, p: GemmProblem) -> int:
        """FLOPs of one ring step's chunk GEMM on one device."""
        P = self.axis_size
        if self.mode == "allgather":
            return 2 * _ceil_div(p.M, P) * p.K * _ceil_div(p.N, P)
        return 2 * _ceil_div(p.M, P) * _ceil_div(p.K, P) * p.N

    def chunk_comm_bytes(self, p: GemmProblem) -> int:
        """Bytes one device puts on a link per ring step (halved per link
        when both ring directions carry half the chunk).  The all-gather
        ring moves A chunks, so quantized activations shrink the wire bytes
        too (per-row scale sidecars are M/P floats per hop — negligible and
        not modeled); the reduce-scatter ring moves f32 partials regardless
        of operand precision (acc_bytes)."""
        if self.mode == "allgather":
            full = _ceil_div(p.M, self.axis_size) * p.K * p.a_elem_bytes
        else:
            full = _ceil_div(p.M, self.axis_size) * p.N * self.acc_bytes
        return _ceil_div(full, 2) if self.bidirectional else full

    def total_comm_bytes(self, p: GemmProblem) -> int:
        """Total bytes a device sends over the whole collective (both
        directions combined — the volume is direction-independent)."""
        per_step = (self.chunk_comm_bytes(p) * 2 if self.bidirectional
                    else self.chunk_comm_bytes(p))
        return self.sends * per_step

    def step_compute_s(self, p: GemmProblem, peak_flops: float) -> float:
        return self.chunk_flops(p) / peak_flops

    def step_comm_s(self, p: GemmProblem, ici_bw: float) -> float:
        return self.chunk_comm_bytes(p) / ici_bw

    def exposed_comm_s(self, p: GemmProblem, *, ici_bw: float,
                       peak_flops: float) -> float:
        """Comm time NOT hidden behind chunk GEMMs: per send,
        max(0, comm_step - compute_step)."""
        return self.sends * max(
            0.0, self.step_comm_s(p, ici_bw) - self.step_compute_s(p, peak_flops)
        )

    def overlapped_time_s(self, p: GemmProblem, *, ici_bw: float,
                          peak_flops: float) -> float:
        """Ring schedule: first chunk GEMM, then P-1 rounds where the next
        send overlaps the current GEMM."""
        tc = self.step_compute_s(p, peak_flops)
        tm = self.step_comm_s(p, ici_bw)
        return tc + self.sends * max(tc, tm)

    def serialized_time_s(self, p: GemmProblem, *, ici_bw: float,
                          peak_flops: float) -> float:
        """The unoverlapped pattern: the whole collective first (P-1 ring
        hops at the same per-step bytes), THEN the full GEMM."""
        return (self.sends * self.step_comm_s(p, ici_bw)
                + self.steps * self.step_compute_s(p, peak_flops))

    def overlap_efficiency(self, p: GemmProblem, *, ici_bw: float,
                           peak_flops: float) -> float:
        """Fraction of the collective's comm time hidden behind compute."""
        total = self.sends * self.step_comm_s(p, ici_bw)
        if total == 0.0:
            return 1.0
        return 1.0 - self.exposed_comm_s(p, ici_bw=ici_bw,
                                         peak_flops=peak_flops) / total

    def report(self, p: GemmProblem, *, ici_bw: float,
               peak_flops: float) -> dict:
        """Per-layer machine-readable record: exposed-comm bytes/time and
        the overlapped-vs-serialized credit (consumed by dryrun/benchmark
        artifacts and tests)."""
        exposed_s = self.exposed_comm_s(p, ici_bw=ici_bw, peak_flops=peak_flops)
        return {
            "mode": self.mode,
            "axis_size": self.axis_size,
            "bidirectional": self.bidirectional,
            "steps": self.steps,
            "comm_bytes_total": self.total_comm_bytes(p),
            "comm_bytes_per_step": self.chunk_comm_bytes(p),
            "compute_flops_per_step": self.chunk_flops(p),
            "step_comm_s": self.step_comm_s(p, ici_bw),
            "step_compute_s": self.step_compute_s(p, peak_flops),
            "exposed_comm_s": exposed_s,
            "exposed_comm_bytes": int(min(1.0, exposed_s / max(
                self.sends * self.step_comm_s(p, ici_bw), 1e-30))
                * self.total_comm_bytes(p)),
            "overlapped_time_s": self.overlapped_time_s(
                p, ici_bw=ici_bw, peak_flops=peak_flops),
            "serialized_time_s": self.serialized_time_s(
                p, ici_bw=ici_bw, peak_flops=peak_flops),
            "overlap_efficiency": self.overlap_efficiency(
                p, ici_bw=ici_bw, peak_flops=peak_flops),
        }
