"""The two framework-free pieces of `repro/core/transfer_model.py` that the
ring collective GEMMs and their autotuner need: `GemmProblem` (a GEMM's
shape and per-operand element sizes) and `RingCollectiveGemm` (the
overlap model of a P-way ring all-gather x matmul or matmul x
reduce-scatter), copied as they are.  The rest of the paper's transfer
calculus comes with the analytics (ROADMAP queue 1 item 9).
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
