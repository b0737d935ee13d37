"""Elastic scaling: resume a run on another mesh (port of
`repro/runtime/elastic.py`).

Checkpoints hold whole tensors (`checkpoint/manager.py`), so scaling is a
restore-side concern.  A process of the port holds whole tensors too (its
mesh is named axis sizes and their rings, `launch/mesh.py`), so where JAX
re-shards each leaf onto the new mesh's devices, the port restores each
leaf whole onto one device and gives the new mesh's `AxisRules`
(`parallel/sharding.make_rules`), which `use_rules` and the ring
collectives read.  The port's parameters carry no logical axes (JAX's
`Builder` "axes" mode), so there is no per-leaf placement to compute.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from ..checkpoint.manager import CheckpointManager
from ..core.device import resolve_device
from ..launch.mesh import Mesh
from ..parallel.sharding import AxisRules, make_rules


def shardings_for(model, opt, mesh: Mesh, cfg, dtype) -> Tuple[Any, Any, AxisRules]:
    """(parameter tree, optimizer-state tree, rules) for `mesh`: the trees
    on the "meta" device (shapes and dtypes, what a restore fills; JAX
    gives a `NamedSharding` per leaf here) and the mesh's rules."""
    rules = make_rules(mesh, profile=cfg.parallelism, fsdp=cfg.fsdp)
    aparams = model.init(0, device="meta", dtype=dtype)
    return aparams, opt.init(aparams), rules


def rescale(ckpt: CheckpointManager, model, opt, cfg, new_mesh: Mesh, dtype,
            step: Optional[int] = None, device="cuda"):
    """Restore the latest (or `step`) checkpoint for `new_mesh`, every leaf
    on `device` (the card unless "cpu" is asked for): (params, opt_state,
    step, rules), as JAX's returns."""
    aparams, aopt, rules = shardings_for(model, opt, new_mesh, cfg, dtype)
    state = ckpt.restore({"params": aparams, "opt": aopt, "step": 0}, step=step,
                         device=resolve_device(device))
    return state["params"], state["opt"], int(state["step"]), rules
