"""Logical-axis sharding rules and the collective policy (port of
`repro/parallel/sharding.py`).

Model code annotates parameters and activations with *logical* axes
("embed", "heads", "vocab", "expert", "batch", ...); `AxisRules` maps them
to mesh axes with per-dimension divisibility checks: an axis that does not
divide is left unsharded (replicated), and the drop is warned once and
counted per logical axis.  The rules and profiles are JAX's:

  batch     -> ("pod", "data")   data parallelism
  heads/mlp/vocab/expert -> "model"   tensor / expert parallelism
  embed     -> "data" when fsdp
  cache_seq -> "model"           context-parallel decode
  seq       -> "model" when sequence parallel

Specs are the port's own tuples (one entry per dimension: None, a mesh axis
or a tuple of mesh axes, trailing Nones dropped), not `PartitionSpec`.
`constrain` is the identity, a deliberate difference: a process of the port
holds whole tensors, and the rings slice what they need.

`collective_policy(mesh)` is the context under which `core.ops.linear(...,
tp_mode=...)` runs eligible projections as ring collective GEMMs over the
mesh's `"model"` ring (`kernels/mx_collective_matmul.py`);
`autotune_collective_policy` picks the ring's direction from the
`RingCollectiveGemm` overlap model.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from ..launch.mesh import Mesh

AxisVal = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass
class AxisRules:
    mesh: Mesh
    rules: Dict[str, AxisVal]
    dropped: list = dataclasses.field(default_factory=list)
    # per-logical-axis drop counters: how many times each logical axis lost a
    # mesh axis to a divisibility fallback
    drops_by_axis: Dict[str, int] = dataclasses.field(default_factory=dict)
    _warned: set = dataclasses.field(default_factory=set, repr=False)

    def _axis_size(self, mesh_axes: AxisVal) -> int:
        if mesh_axes is None:
            return 1
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        return math.prod(self.mesh.shape[a] for a in mesh_axes)

    def _record_drop(self, shape, ax, mesh_axis, dim, product) -> None:
        self.dropped.append((tuple(shape), ax, mesh_axis, dim))
        self.drops_by_axis[ax] = self.drops_by_axis.get(ax, 0) + 1
        key = (ax, mesh_axis, dim, product)
        if key not in self._warned:  # one line per unique fallback, not per call
            self._warned.add(key)
            warnings.warn(
                f"sharding: dim {dim} (logical axis {ax!r}) is not divisible by "
                f"mesh-axis product {product} — dropping mesh axis {mesh_axis!r} "
                f"(replicating)",
                stacklevel=3,
            )

    def spec(self, shape: Sequence[int], axes: Sequence[Optional[str]]) -> tuple:
        """The spec of `shape` annotated with logical `axes`.

        Drops (replicates) any dim whose size is not divisible by the mapped
        mesh-axis product, and never uses a mesh axis twice in one spec.
        Every drop is warned once and counted in `drops_by_axis`."""
        used: set = set()
        out = []
        for dim, ax in zip(shape, axes):
            mesh_axes = self.rules.get(ax) if ax is not None else None
            if mesh_axes is None:
                out.append(None)
                continue
            tpl = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
            tpl = tuple(a for a in tpl if a not in used and a in self.mesh.shape)
            # progressive fallback: drop trailing axes until the product divides
            while tpl and dim % self._axis_size(tpl) != 0:
                self._record_drop(shape, ax, tpl[-1], dim, self._axis_size(tpl))
                tpl = tpl[:-1]
            if not tpl:
                out.append(None)
                continue
            used.update(tpl)
            out.append(tpl[0] if len(tpl) == 1 else tpl)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)


_state = threading.local()


def current_rules() -> Optional[AxisRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def constrain(x, axes: Sequence[Optional[str]]):
    """The identity, inside a rules context or not.  JAX constrains x's
    sharding by its logical axes (`with_sharding_constraint`); a process of
    the port holds whole tensors, so there is nothing to constrain."""
    return x


def make_rules(mesh: Mesh, *, profile: str = "tp", fsdp: bool = False,
               seq_parallel: bool = False, expert_data_shard: bool = False) -> AxisRules:
    """Parallelism profiles:
      "tp"  — megatron-style TP on "model" + DP on ("pod","data") [+FSDP]
      "dp"  — small-model profile: pure DP, only the vocab/cache_seq dims use
              the model axis
    """
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if profile == "dp":
        rules: Dict[str, AxisVal] = {
            # small models spread the batch over every axis; progressive
            # fallback drops "model" when it does not divide
            "batch": data_axes + ("model",),
            "heads": None,
            "kv_heads": None,
            "mlp": None,
            "vocab": "model",
            "expert": "model",
            "embed": None,
            "cache_seq": "model",
            "seq": None,
            "expert_cap": None,
            "layers": None,
            "head_dim": None,
        }
        return AxisRules(mesh, rules)
    rules = {
        "batch": data_axes if data_axes else None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": ("model", "data") if expert_data_shard else "model",
        "embed": (data_axes if fsdp else None),
        "cache_seq": "model",  # context-parallel decode
        "seq": ("model" if seq_parallel else None),
        "expert_cap": None,
        "layers": None,
        "head_dim": None,
    }
    return AxisRules(mesh, rules)


# ---------------------------------------------------------------------------
# Communication-overlapped collectives: the model-axis ring
# ---------------------------------------------------------------------------


def ring_topology(mesh: Mesh, axis: str = "model") -> Dict[str, Any]:
    """The bidirectional ring over one mesh axis: its size and the (src,
    dst) pairs of both directions (`ring_perm`, as the ring GEMMs use)."""
    from ..kernels.mx_collective_matmul import ring_perm

    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}; axes: {tuple(mesh.shape)}")
    size = int(mesh.shape[axis])
    return {"axis": axis, "size": size, "fwd": ring_perm(size),
            "bwd": ring_perm(size, reverse=True)}


@dataclasses.dataclass(frozen=True)
class CollectivePolicy:
    """Deployment decision for communication-overlapped TP projections.

    When active (see `collective_policy()`), `core.ops.linear(...,
    tp_mode=...)` routes eligible projections through the ring
    all-gather x matmul / matmul x reduce-scatter over `axis`'s ring."""

    mesh: Mesh
    axis: str = "model"
    direction: str = "bidir"  # "fwd" | "bwd" | "bidir"
    enabled: bool = True

    def __post_init__(self):
        if self.axis not in self.mesh.shape:
            raise ValueError(
                f"collective policy axis {self.axis!r} is not a mesh axis; "
                f"mesh has {tuple(self.mesh.shape)}")
        if self.direction not in ("fwd", "bwd", "bidir"):
            raise ValueError(f"unknown ring direction {self.direction!r}; "
                             "one of ('fwd', 'bwd', 'bidir')")

    @property
    def axis_size(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def ring(self):
        """The ring transport the collective GEMMs run over."""
        return self.mesh.ring(self.axis)

    def topology(self) -> Dict[str, Any]:
        return ring_topology(self.mesh, self.axis)


def autotune_collective_policy(mesh: Mesh, problems, *, axis: str = "model",
                               ici_bw: float, peak_flops: float) -> tuple:
    """Pick the ring direction from the `RingCollectiveGemm` overlap model
    instead of the fixed "bidir" default.

    ``problems`` is a sequence of (mode, GemmProblem) pairs (the layer's TP
    projections); ``ici_bw`` is the ring link's bytes/s.  Candidates are
    the two chunk schedules the ring GEMMs implement: "bidir" (each chunk
    split in half across both ring directions, per-link bytes halved) and
    "fwd" (whole chunks one way).  The model's overlapped time (first chunk
    GEMM, then P-1 rounds of max(compute, comm)) is summed over the problem
    set and the cheaper schedule wins; ties break toward "fwd" (fewer
    in-flight buffers).

    Returns (CollectivePolicy, report), the report holding the
    per-candidate times."""
    from ..core.transfer_model import RingCollectiveGemm

    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}; axes: {tuple(mesh.shape)}")
    size = int(mesh.shape[axis])
    problems = list(problems)
    candidates = {"fwd": False, "bidir": True}
    totals: Dict[str, float] = {}
    exposed: Dict[str, float] = {}
    for name, bidir in candidates.items():
        t = e = 0.0
        for mode, prob in problems:
            ring = RingCollectiveGemm(mode=mode, axis_size=size, bidirectional=bidir)
            t += ring.overlapped_time_s(prob, ici_bw=ici_bw, peak_flops=peak_flops)
            e += ring.exposed_comm_s(prob, ici_bw=ici_bw, peak_flops=peak_flops)
        totals[name] = t
        exposed[name] = e
    # strict improvement required: "fwd" wins ties
    chosen = "bidir" if totals["bidir"] < totals["fwd"] else "fwd"
    serialized = sum(
        RingCollectiveGemm(mode=mode, axis_size=size, bidirectional=candidates[chosen])
        .serialized_time_s(prob, ici_bw=ici_bw, peak_flops=peak_flops)
        for mode, prob in problems)
    report = {
        "axis": axis,
        "axis_size": size,
        "chosen_direction": chosen,
        "candidate_time_s": totals,
        "candidate_exposed_comm_s": exposed,
        "serialized_time_s": serialized,
        "autotuned": True,
        "n_problems": len(problems),
    }
    policy = CollectivePolicy(mesh=mesh, axis=axis, direction=chosen, enabled=size > 1)
    return policy, report


def current_collectives() -> Optional[CollectivePolicy]:
    pol = getattr(_state, "collectives", None)
    return pol if (pol is not None and pol.enabled) else None


@contextlib.contextmanager
def collective_policy(mesh: Optional[Mesh] = None, *, axis: str = "model",
                      direction: str = "bidir", enabled: bool = True,
                      policy: Optional[CollectivePolicy] = None):
    """Context under which eligible TP projections run as ring collective
    GEMMs.  Pass a mesh (plus axis / direction) or a prebuilt
    CollectivePolicy; `enabled=False` (or leaving the context) restores
    the single-device dispatch."""
    if policy is None:
        if mesh is None:
            raise ValueError("collective_policy needs a mesh or a policy")
        policy = CollectivePolicy(mesh=mesh, axis=axis, direction=direction,
                                  enabled=enabled)
    prev = getattr(_state, "collectives", None)
    _state.collectives = policy
    try:
        yield policy
    finally:
        _state.collectives = prev


# ---------------------------------------------------------------------------
# Tree-level helpers
# ---------------------------------------------------------------------------


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def tree_specs(rules: AxisRules, shape_tree, axes_tree):
    """The spec tree of a tree of shapes (tensors, "meta" ones included, or
    shape tuples) and the matching tree of logical-axes tuples (nested
    dicts, lists or tuples).  JAX's `tree_shardings` (a tree of
    `NamedSharding`s) has no counterpart: a process of the port holds whole
    tensors, and these specs are what `launch/dryrun.py` reads."""
    if isinstance(axes_tree, dict):
        return {k: tree_specs(rules, shape_tree[k], v) for k, v in axes_tree.items()}
    if _is_axes_leaf(axes_tree):
        shape = getattr(shape_tree, "shape", shape_tree)
        return rules.spec(tuple(shape), axes_tree)
    return type(axes_tree)(tree_specs(rules, s, a) for s, a in zip(shape_tree, axes_tree))
