"""MX dispatch layer (port of `repro/core/ops.py`, dense subset).

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

The TPU tile planner (`repro/core/tiling.py`, VMEM and MXU constants) is
not ported: the CUDA kernels use fixed Hopper tiles chosen by M (by the
mean rows per group for the grouped GEMM), and the baseline runs at its
default read-modify-write chunk (bk = 128, the JAX default).

`grouped_matmul` (the MoE expert GEMMs) runs the plain
`grouped_matmul_ref` on "torch" and the MX grouped kernel on both CUDA
backends: JAX's "pallas_baseline" takes its reference there, but the port
runs no plain version on the card, and the paper's A/B is the dense GEMM.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch
import torch.distributed as dist

from ..kernels.baseline_matmul import baseline_matmul
from ..kernels.mx_grouped_matmul import mx_grouped_matmul
from ..kernels.mx_matmul import Epilogue, apply_epilogue, dot_f32, mx_matmul_fused
from ..kernels.ref import grouped_matmul_ref

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


def _reject_unported(precision, abft) -> None:
    if precision is not None and precision != "none":
        raise NotImplementedError(
            f"precision={precision!r}: quantized / sparse GEMMs are not ported "
            "yet (ROADMAP queue 1 items 8 and 10)")
    if abft is not None and abft is not False:
        raise NotImplementedError(
            "abft: checksummed GEMMs are not ported yet (ROADMAP queue 1 item 11)")


def _flatten_leading(a: torch.Tensor):
    lead = tuple(a.shape[:-2]) if a.dim() > 2 else ()
    return a.reshape(-1, a.shape[-1]), lead


def matmul(a: torch.Tensor, b: torch.Tensor, *, policy: Optional[MXPolicy] = None,
           out_dtype=None, precision=None, abft=None) -> torch.Tensor:
    """D = A @ B through the MX dispatch.  a: (..., M, K), b: (K, N)."""
    _reject_unported(precision, abft)
    policy = policy or current_policy()
    out_dtype = out_dtype or a.dtype
    backend = policy.resolve(a)
    if backend == "torch":
        return dot_f32(a, b).to(out_dtype)
    a2, lead = _flatten_leading(a)
    if backend == "cuda_mx":
        out = mx_matmul_fused(a2.contiguous(), b, out_dtype=out_dtype)
    else:
        out = baseline_matmul(a2.contiguous(), b, out_dtype=out_dtype)
    if a.dim() > 2:
        out = out.reshape(*lead, a.shape[-2], b.shape[-1])
    return out


def _check_tp_mode(tp_mode: Optional[str]) -> None:
    """A tp_mode declaration is inert without a collective context, as in
    JAX; with an initialised multi-rank process group it would have to run
    the ring collective GEMM, which is not ported yet."""
    if tp_mode is None:
        return
    if tp_mode not in TP_MODES:
        raise ValueError(f"unknown tp_mode {tp_mode!r}; one of {TP_MODES}")
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"tp_mode={tp_mode!r} under a {dist.get_world_size()}-rank process "
            "group: the ring collective GEMM is not ported yet (ROADMAP queue 1 "
            "item 15)")


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
           activation: str = "none", w_gate: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None, out_scale: Optional[float] = None,
           policy: Optional[MXPolicy] = None, out_dtype=None,
           tp_mode: Optional[str] = None, precision=None, abft=None) -> torch.Tensor:
    """y = act(x @ w + b) [+ residual] [* out_scale], the fused-epilogue
    entry point.  x: (..., M, K), w: (K, N), b: (N,), residual broadcastable
    to (..., M, N).  activation "swiglu" gates with w_gate (K, N):
    y = silu(x @ w_gate) * (x @ w + b).

    On "cuda_mx" the whole epilogue happens inside the kernel's single
    write-back; the other backends compute the same math unfused."""
    _reject_unported(precision, abft)
    _check_tp_mode(tp_mode)
    policy = policy or current_policy()
    out_dtype = out_dtype or x.dtype
    if (activation == "swiglu") != (w_gate is not None):
        raise ValueError(
            "w_gate must be given iff activation='swiglu' "
            f"(got activation={activation!r}, "
            f"w_gate={'set' if w_gate is not None else None})")
    ep = Epilogue(activation=activation, bias=b is not None,
                  residual=residual is not None, out_scale=out_scale)
    if policy.resolve(x) == "cuda_mx":
        x2, lead = _flatten_leading(x)
        M, N = x2.shape[0], w.shape[-1]
        res2 = None
        if residual is not None:
            full = (*lead, x.shape[-2], N) if lead else (M, N)
            res2 = torch.broadcast_to(residual, full).reshape(M, N).contiguous()
        out = mx_matmul_fused(x2.contiguous(), w, epilogue=ep, b_gate=w_gate, bias=b,
                              residual=res2, out_dtype=out_dtype)
        if x.dim() > 2:
            out = out.reshape(*lead, x.shape[-2], N)
        return out
    # unfused reference composition ("torch" / "cuda_baseline"): each
    # epilogue step is its own op
    y = matmul(x, w, policy=policy, out_dtype=torch.float32)
    gate = (matmul(x, w_gate, policy=policy, out_dtype=torch.float32)
            if activation == "swiglu" else None)
    return apply_epilogue(y, ep, bias=b, gate=gate, residual=residual,
                          out_dtype=out_dtype)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
                   activation: str = "none", w_gate: Optional[torch.Tensor] = None,
                   policy: Optional[MXPolicy] = None, out_dtype=None, precision=None,
                   abft=None) -> torch.Tensor:
    """Ragged grouped GEMM: out[t] = act(x[t] @ w[g(t)]) for rows sorted by
    group.  x: (T, K), w: (G, K, N), group_sizes: (G,) on x's device.  One
    kernel launch for all groups on the CUDA backends."""
    _reject_unported(precision, abft)
    policy = policy or current_policy()
    out_dtype = out_dtype or x.dtype
    if policy.resolve(x) == "torch":
        return grouped_matmul_ref(x, w, group_sizes, w_gate=w_gate,
                                  activation=activation, out_dtype=out_dtype)
    return mx_grouped_matmul(x.contiguous(), w, group_sizes, w_gate=w_gate,
                             activation=activation, out_dtype=out_dtype)
