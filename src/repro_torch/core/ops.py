"""MX dispatch layer (port of `repro/core/ops.py`, dense and quantized).

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

Mixed precision threads through as one object, `core.precision.
PrecisionPolicy`: an explicit `precision=` argument (policy or registry
name) or the ambient `use_precision()` context (linear and grouped_matmul
only, as in JAX).  `_prepare_quantized` quantizes the operands, and the
payloads and scales go to the fused kernel's scale slots on "cuda_mx" (and
the grouped kernel on both CUDA backends), or through JAX's unfused
quantized reference (`dot_f32` of the same payloads, then
`apply_epilogue`) on "torch".  The baseline GEMM has no scale slots: a
quantized `linear` on "cuda_baseline" computes the reference on the CPU
and raises on a CUDA tensor, where the port runs no plain version.

Weights are quantized once: the (payload, scale) of each weight operand
is kept and reused while the parameter is unchanged (the key is the
tensor, its in-place version counter and the spec), the same bits as
quantizing at every call, which JAX's jitted step does.  Activations are
quantized at every call.  2:4 sparse policies and ABFT raise, naming their
ROADMAP items.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..kernels.baseline_matmul import baseline_matmul
from ..kernels.mx_grouped_matmul import mx_grouped_matmul
from ..kernels.mx_matmul import Epilogue, apply_epilogue, dot_f32, mx_matmul_fused
from ..kernels.quant import quantize_operand
from ..kernels.ref import grouped_matmul_ref
from .precision import PrecisionPolicy, QuantSpec, current_precision, resolve_precision

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


def _reject_unported(prec: Optional[PrecisionPolicy], abft) -> None:
    if prec is not None and prec.b_sparse is not None:
        raise NotImplementedError(
            "2:4 sparse GEMMs (a policy with b_sparse) are not ported yet (ROADMAP "
            "queue 1 item 10)")
    if abft is not None and abft is not False:
        raise NotImplementedError(
            "abft: checksummed GEMMs are not ported yet (ROADMAP queue 1 item 11)")


def _ambient_precision(precision) -> Optional[PrecisionPolicy]:
    """An explicit per-call precision (policy or registry name) wins; else
    the use_precision() context; else None.  None and "none" are no
    declaration and fall through to the context; "f32" is a real identity
    policy and so overrides it."""
    resolved = resolve_precision(precision) if precision is not None else None
    return resolved if resolved is not None else current_precision()


def _effective_precision(prec, a_dtype, b_dtype) -> Optional[PrecisionPolicy]:
    """Drop a policy that is the identity for these operand dtypes."""
    if prec is not None and prec.is_noop_for(a_dtype, b_dtype):
        return None
    return prec


# (data_ptr, shape, strides, dtype, device, spec) -> (weakref to the
# parameter's base tensor, its version, payload, scale)
_weights: Dict[tuple, tuple] = {}


def _weight_operand(w: torch.Tensor, spec: QuantSpec):
    """`quantize_operand(w, spec, "b")`, made once per parameter version:
    reused while the same tensor (a view of the same base, e.g. a layer of
    a stacked leaf) is unchanged in place.  The entry goes when the base
    tensor does."""
    if not spec.transforms(w.dtype):
        return w, None
    base = w if w._base is None else w._base
    key = (w.data_ptr(), tuple(w.shape), w.stride(), w.dtype, w.device, spec)
    hit = _weights.get(key)
    if hit is not None and hit[0]() is base and hit[1] == w._version:
        return hit[2], hit[3]

    def drop(ref, key=key):
        entry = _weights.get(key)
        if entry is not None and entry[0] is ref:
            del _weights[key]

    q, scale = quantize_operand(w, spec, "b")
    _weights[key] = (weakref.ref(base, drop), w._version, q, scale)
    return q, scale


def clear_weight_cache() -> None:
    """Forget every kept weight payload (they are rebuilt at the next call)."""
    _weights.clear()


def _prepare_quantized(x, w, w_gate, prec: PrecisionPolicy,
                       a_row_groups: Optional[Sequence[int]] = None):
    """Quantize / cast one GEMM's operands per the policy.  Returns (qa,
    a_s, qb, b_s, qg, bg_s); scales are None for cast-only specs.  The gate
    weight quantizes under the same spec as w with its OWN scales."""
    qa, a_s = quantize_operand(x, prec.a, "a", row_groups=a_row_groups)
    qb, b_s = _weight_operand(w, prec.b)
    qg = bg_s = None
    if w_gate is not None:
        qg, bg_s = _weight_operand(w_gate, prec.b)
    return qa, a_s, qb, b_s, qg, bg_s


def _flatten_leading(a: torch.Tensor):
    lead = tuple(a.shape[:-2]) if a.dim() > 2 else ()
    return a.reshape(-1, a.shape[-1]), lead


def matmul(a: torch.Tensor, b: torch.Tensor, *, policy: Optional[MXPolicy] = None,
           out_dtype=None, precision=None, abft=None) -> torch.Tensor:
    """D = A @ B through the MX dispatch.  a: (..., M, K), b: (K, N).
    ``precision`` (explicit only: the ambient use_precision() context
    applies to linear and grouped_matmul, not to raw matmuls) routes
    through `linear`'s quantized path."""
    policy = policy or current_policy()
    out_dtype = out_dtype or a.dtype
    prec = _effective_precision(resolve_precision(precision), a.dtype, b.dtype)
    if prec is not None:
        return linear(a, b, None, policy=policy, out_dtype=out_dtype, precision=prec,
                      abft=abft)
    _reject_unported(None, abft)
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
    y = silu(x @ w_gate) * (x @ w + b).  ``precision`` (a policy, a registry
    name, or None for the ambient use_precision() context) quantizes the
    operands; its ``out`` overrides out_dtype.

    On "cuda_mx" the whole epilogue, dequant scales first, happens inside
    the kernel's single write-back; the other backends compute the same
    math unfused."""
    policy = policy or current_policy()
    out_dtype = out_dtype or x.dtype
    prec = _effective_precision(_ambient_precision(precision), x.dtype, w.dtype)
    _reject_unported(prec, abft)
    _check_tp_mode(tp_mode)
    if prec is not None and prec.out is not None:
        out_dtype = prec.out_torch_dtype
    if (activation == "swiglu") != (w_gate is not None):
        raise ValueError(
            "w_gate must be given iff activation='swiglu' "
            f"(got activation={activation!r}, "
            f"w_gate={'set' if w_gate is not None else None})")
    backend = policy.resolve(x)
    if backend == "cuda_mx":
        x2, lead = _flatten_leading(x)
        M, N = x2.shape[0], w.shape[-1]
        a_s = b_s = bg_s = None
        if prec is not None:
            x2, a_s, w, b_s, w_gate, bg_s = _prepare_quantized(x2, w, w_gate, prec)
        ep = Epilogue(activation=activation, bias=b is not None,
                      residual=residual is not None, out_scale=out_scale,
                      a_scale=a_s is not None, b_scale=b_s is not None)
        res2 = None
        if residual is not None:
            full = (*lead, x.shape[-2], N) if lead else (M, N)
            res2 = torch.broadcast_to(residual, full).reshape(M, N).contiguous()
        out = mx_matmul_fused(x2.contiguous(), w, epilogue=ep, b_gate=w_gate, bias=b,
                              residual=res2, a_scale=a_s, b_scale=b_s, bg_scale=bg_s,
                              out_dtype=out_dtype)
        if x.dim() > 2:
            out = out.reshape(*lead, x.shape[-2], N)
        return out
    if prec is not None:
        # JAX's unfused quantized reference: the SAME payloads through the
        # same dot_f32 accumulation, dequantized by apply_epilogue.  The
        # baseline GEMM has no scale slots, and the port runs no plain
        # version on the card in its place.
        if backend == "cuda_baseline" and x.is_cuda:
            raise NotImplementedError(
                "cuda_baseline with a quantizing precision: the baseline GEMM has no "
                "scale slots (JAX's pallas_baseline computes its jnp reference "
                "there); use cuda_mx, or torch for the reference")
        qa, a_s, qb, b_s, qg, bg_s = _prepare_quantized(x, w, w_gate, prec)
        y = dot_f32(qa, qb)
        gate = dot_f32(qa, qg) if activation == "swiglu" else None
        ep = Epilogue(activation=activation, bias=b is not None,
                      residual=residual is not None, out_scale=out_scale,
                      a_scale=a_s is not None, b_scale=b_s is not None)
        return apply_epilogue(y, ep, bias=b, gate=gate, residual=residual,
                              a_scale=a_s, b_scale=b_s, bg_scale=bg_s,
                              out_dtype=out_dtype)
    # unfused reference composition ("torch" / "cuda_baseline"): each
    # epilogue step is its own op
    ep = Epilogue(activation=activation, bias=b is not None,
                  residual=residual is not None, out_scale=out_scale)
    y = matmul(x, w, policy=policy, out_dtype=torch.float32)
    gate = (matmul(x, w_gate, policy=policy, out_dtype=torch.float32)
            if activation == "swiglu" else None)
    return apply_epilogue(y, ep, bias=b, gate=gate, residual=residual,
                          out_dtype=out_dtype)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
                   activation: str = "none", w_gate: Optional[torch.Tensor] = None,
                   policy: Optional[MXPolicy] = None, out_dtype=None, precision=None,
                   abft=None, a_row_groups: Optional[Sequence[int]] = None
                   ) -> torch.Tensor:
    """Ragged grouped GEMM: out[t] = act(x[t] @ w[g(t)]) for rows sorted by
    group.  x: (T, K), w: (G, K, N), group_sizes: (G,) on x's device.  One
    kernel launch for all groups on the CUDA backends.

    ``precision`` (explicit or the ambient use_precision() context)
    quantizes x per row and w PER EXPERT per output column; the (G, 1, N)
    weight scales apply at each group's store.  ``a_row_groups`` = (E, R,
    C): x's rows are the MoE's expert-major buffer (E experts x R routing
    groups x C rows), and a "tensor"-granularity activation scale is taken
    per routing group, as JAX's one call per group takes it."""
    policy = policy or current_policy()
    out_dtype = out_dtype or x.dtype
    prec = _effective_precision(_ambient_precision(precision), x.dtype, w.dtype)
    _reject_unported(prec, abft)
    if prec is not None and prec.out is not None:
        out_dtype = prec.out_torch_dtype
    a_s = b_s = bg_s = None
    if prec is not None:
        x, a_s, w, b_s, w_gate, bg_s = _prepare_quantized(x, w, w_gate, prec,
                                                          a_row_groups)
    kw = dict(w_gate=w_gate, activation=activation, a_scale=a_s, b_scale=b_s,
              bg_scale=bg_s, out_dtype=out_dtype)
    if policy.resolve(x) == "torch":
        return grouped_matmul_ref(x, w, group_sizes, **kw)
    return mx_grouped_matmul(x.contiguous(), w, group_sizes, **kw)
