"""Three-term roofline calculus for one NVIDIA H100 SXM (port of
`repro/core/roofline.py`, its TPU constants replaced by the card's).

    compute term    = FLOPs              / (chips * peak FLOP/s of the type)
    memory term     = bytes              / (chips * HBM_BW)
    collective term = collective bytes   / (chips * NVLINK_BW)

The terms are *times in seconds*; the max of the three is the lower bound
on a step's time, and the dominant term is its bottleneck.  `bound_ms`
is the per-kernel form `chip_smoke.py` prints beside every kernel time:
the larger of the bytes term and the operations term, in milliseconds.

JAX's `parse_collective_bytes` reads the collectives' operand bytes out of
XLA's HLO text; it gets no counterpart.  The port counts the bytes its ring
hops copy as they run (`kernels/mx_collective_matmul.py` RING_STATS).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at the card's
# 700 W power limit
PEAK_FLOPS = {"float32": 67e12,  # FLOP/s off the tensor cores
              "tf32": 495e12, "bfloat16": 989e12,  # the tensor cores
              "int8": 1979e12, "float8_e4m3fn": 1979e12}
HBM_BW = 3.35e12   # B/s, HBM3
NVLINK_BW = 450e9  # B/s each way, per card (NVLink 4, 900 GB/s both ways)


def bound_ms(nbytes: float, flops: float, dtype: str):
    """(ms, "bytes" or "operations"): the least time one card can take to
    move `nbytes` through HBM and do `flops` at the peak rate of `dtype`
    (a key of PEAK_FLOPS), whichever is larger."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class RooflineReport:
    """A step's three-term roofline record.  `hlo_flops` and `hlo_bytes`
    keep JAX's names: the step's FLOPs and HBM bytes, however counted."""

    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    chips: int
    model_flops: Optional[float] = None  # 6*N*D (dense) / 6*N_active*D (MoE)
    peak_flops: float = PEAK_FLOPS["bfloat16"]
    hbm_bw: float = HBM_BW
    link_bw: float = NVLINK_BW

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * self.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * self.hbm_bw)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * self.link_bw)

    @property
    def exposed_collective_s(self) -> float:
        """Comm time left exposed IF every collective overlapped compute
        (the ring collective-matmul schedule): max(0, comm - compute).

        An OPTIMISTIC bound: it assumes all collective bytes can hide behind
        all compute, which holds for the tensor-parallel ring GEMMs but not
        e.g. a gradient all-reduce serialized after backward.  The
        per-layer numbers come from `transfer_model.RingCollectiveGemm.
        exposed_comm_s`; the true step bound lies between
        `overlapped_step_lb_s` and `step_time_lower_bound_s`."""
        return max(0.0, self.collective_s - self.compute_s)

    @property
    def overlapped_step_lb_s(self) -> float:
        """Step-time lower bound with full comm/compute overlap credited
        (see `exposed_collective_s` for why this is the optimistic end)."""
        return max(self.compute_s, self.memory_s, self.exposed_collective_s)

    @property
    def overlap_credit_s(self) -> float:
        """Maximum step time the overlapped schedule can save vs the
        serialized three-term bound (upper bound on the hiding)."""
        return self.step_time_lower_bound_s - self.overlapped_step_lb_s

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / counted FLOPs: catches recompute and redundancy."""
        if self.model_flops is None or self.hlo_flops == 0:
            return None
        return self.model_flops / self.hlo_flops

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Useful-FLOP utilization if the step ran at the roofline bound:
        MODEL_FLOPS / (chips * peak * bound_time)."""
        if self.model_flops is None:
            return None
        t = self.step_time_lower_bound_s
        if t == 0:
            return None
        return self.model_flops / (self.chips * self.peak_flops * t)

    def as_dict(self) -> dict:
        return {
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "exposed_collective_s": self.exposed_collective_s,
            "bound": self.bound,
            "step_lb_s": self.step_time_lower_bound_s,
            "overlapped_step_lb_s": self.overlapped_step_lb_s,
            "overlap_credit_s": self.overlap_credit_s,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def kv_decode_memory_s(step_bytes: float, chips: int = 1,
                       hbm_bw: float = HBM_BW) -> float:
    """Memory-term seconds for one decode step's KV-cache traffic (the
    serving analogue of `RooflineReport.memory_s`).  Decode is memory-bound
    almost by definition -- one token of compute against the whole cached
    context -- so this term IS the step-time lower bound; feed it
    `transfer_model.PagedKVDecode.{dense,paged}_step_bytes` to price the
    paged-cache traffic credit in seconds."""
    return step_bytes / (chips * hbm_bw)


def dense_model_flops(n_params: int, tokens: int) -> float:
    """6*N*D training FLOPs (fwd+bwd).  For inference use 2*N*D."""
    return 6.0 * n_params * tokens


def inference_model_flops(n_params: int, tokens: int) -> float:
    return 2.0 * n_params * tokens


def adamw_step_bytes(n_params: int) -> int:
    """HBM bytes of one f32 AdamW update, each pass over the N parameters
    counted once: read the parameters, gradients and both moments, write
    the parameters and both moments (7 x 4 N)."""
    return 7 * 4 * n_params


def train_step_bound_s(n_params: int, tokens: int) -> float:
    """The f32 training step's bound as `chip_smoke.py` phase 13 prints it:
    the SUM of 6 N T FLOPs at the f32 peak off the tensor cores (TF32 off)
    and AdamW's 7 x 4 N bytes at HBM_BW -- the optimizer's pass follows the
    backward pass, so the two do not overlap (not the max of
    `RooflineReport.step_time_lower_bound_s`)."""
    return (dense_model_flops(n_params, tokens) / PEAK_FLOPS["float32"]
            + adamw_step_bytes(n_params) / HBM_BW)
