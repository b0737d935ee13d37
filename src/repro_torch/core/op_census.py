"""Op census: what one step computes and moves, counted aten op by aten op
(the port's counterpart of JAX's `core/hlo_census.py`).

JAX's census parses the optimized HLO text of a compiled step, because
`compiled.cost_analysis()` counts a `while` loop's body once and its
scanned layer stacks would be undercounted by about the layer count.  The
port has no HLO: it runs the step itself, usually on "meta" tensors (shapes
and dtypes, no storage; `launch/specs.py`), under one `TorchDispatchMode`
that sees every aten op the eager step dispatches, the backward's included.
There is no trip count to recover: a Python loop runs every iteration's
ops, so the count is exact as it stands.  xlstm-125m's sLSTM steps a
Python loop per token, so its long cells (train_4k: 4096 tokens forward
and backward, prefill_32k: 32768 forward) dispatch every token's ops and
are counted the same way, directly and exactly; they are the slow cells
of `launch/dryrun.py --all` (minutes of one CPU core each, not an hour).

For one step it returns:

  flops       the FLOPs of every op that `torch.utils.flop_counter` has a
              formula for (matmuls, convolutions, attention), by those
              formulas; ops it does not price are decomposed first, as
              `FlopCounterMode` does, so the two totals agree exactly
  op_bytes    inputs plus outputs of every aten op, as the eager path
              moves them: an input at its distinct elements (an expanded
              dimension once), a view or an alias none, an allocation
              without a fill none
  floor_bytes each argument read once and each output written once: an
              output that is an argument updated in place (AdamW's state,
              the cache) at the bytes the step wrote into it, capped at its
              size.  The roofline's memory term uses this, so the bound
              stays a lower bound for a fused implementation too
  peak_live_bytes  the most bytes of storages the step allocated that were
              alive at once (weak references to each storage; arguments
              excluded), and `peak_bytes` that plus the argument bytes
  by_op       calls, FLOPs and bytes per aten op

JAX's census also counts collective operand bytes from the HLO; a port
process runs no collective inside one step's ops, so `launch/dryrun.py`
prices the rings from the transfer model instead.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Dict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# queried for metadata only; `FlopCounterMode` lets them through untouched
_METADATA = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
             aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
             aten.is_non_overlapping_and_dense.default, aten.size.default,
             aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
             aten.storage_offset.default, aten.sym_storage_offset.default,
             aten.numel.default, aten.sym_numel.default, aten.dim.default,
             torch.ops.prim.layout.default}
# allocate without writing a byte
_ALLOCATIONS = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
                aten.new_empty_strided}


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses: a dimension of
    stride 0 (an `expand`) counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else min(size, 1)
    return n * t.element_size()


def _tensors(tree):
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _writes(func) -> bool:
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


@dataclasses.dataclass
class CensusResult:
    flops: int
    op_bytes: int
    floor_bytes: int
    argument_bytes: int
    output_bytes: int  # every storage the step returns, arguments updated in place too
    alias_bytes: int  # of them, the arguments updated in place (JAX's donated buffers)
    peak_live_bytes: int
    by_op: Dict[str, Dict[str, int]]

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self.peak_live_bytes

    @property
    def temp_bytes(self) -> int:
        """The live peak beyond the step's new outputs (JAX's temp)."""
        return max(0, self.peak_live_bytes - (self.output_bytes - self.alias_bytes))


class OpCensus(TorchDispatchMode):
    """The dispatch mode behind `census`: counts every aten op dispatched
    while it is active.  `held` are the step's arguments: their storages
    count as argument bytes, not as the step's allocations."""

    def __init__(self, held=()):
        super().__init__()
        self.flops = 0
        self.op_bytes = 0
        self.by_op: Dict[str, Dict[str, int]] = {}
        self.held: Dict[int, int] = {}
        for t in _tensors(held):
            st = t.untyped_storage()
            self.held[st._cdata] = st.nbytes()
        self.written: Dict[int, int] = {}  # held storage -> bytes written in place
        self.live = 0
        self.peak_live = 0
        self._alive: Dict[int, tuple] = {}  # storage -> (nbytes, weak reference)
        self._lock = threading.Lock()  # a storage may die on an autograd engine thread

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.held or key in self._alive:
            return
        n = st.nbytes()

        def freed(_, key=key):
            with self._lock:
                nbytes, _ref = self._alive.pop(key)
                self.live -= nbytes

        with self._lock:
            self._alive[key] = (n, weakref.ref(st, freed))
            self.live += n
            self.peak_live = max(self.peak_live, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        if func not in flop_registry and func is not torch.ops.prim.device.default:
            with self:  # FlopCounterMode's rule: price what an op decomposes into
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        writes = _writes(func)
        if packet in _ALLOCATIONS or (
                not writes and outs and all(t.untyped_storage()._cdata in in_keys
                                            for t in outs)):
            nbytes = 0  # an allocation, a view or an alias
        else:
            nbytes = sum(distinct_bytes(t) for t in ins) + sum(distinct_bytes(t)
                                                               for t in outs)
        for t in outs:
            if writes and t.untyped_storage()._cdata in self.held:
                key = t.untyped_storage()._cdata
                self.written[key] = self.written.get(key, 0) + distinct_bytes(t)
            self._track(t)
        self.flops += flops
        self.op_bytes += nbytes
        rec = self.by_op.setdefault(str(packet), {"calls": 0, "flops": 0, "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        return out

    def result(self, out) -> CensusResult:
        """The census of a step that returned `out`."""
        seen, output, alias, written = set(), 0, 0, 0
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            n = st.nbytes()
            output += n
            if st._cdata in self.held:
                alias += n
                written += min(n, self.written.get(st._cdata, 0))
            else:
                written += n
        argument = sum(self.held.values())
        return CensusResult(flops=int(self.flops), op_bytes=int(self.op_bytes),
                            floor_bytes=int(argument + written), argument_bytes=int(argument),
                            output_bytes=int(output), alias_bytes=int(alias),
                            peak_live_bytes=int(self.peak_live), by_op=self.by_op)


def census(fn, *args, **kwargs) -> tuple:
    """(CensusResult, fn's result) of one call `fn(*args, **kwargs)`; the
    positional arguments are the step's held arguments."""
    mode = OpCensus(held=args)
    with mode:
        out = fn(*args, **kwargs)
    return mode.result(out), out


def top_ops(result: CensusResult, n: int = 8, key: str = "flops") -> Dict[str, Any]:
    """The n ops with the most `key` ("flops" or "bytes")."""
    ranked = sorted(result.by_op.items(), key=lambda kv: -kv[1][key])
    return dict(ranked[:n])
