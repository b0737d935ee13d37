"""AdamW with decoupled weight decay, f32 moments, updates cast back to the
parameter's dtype (port of `repro/optim/adamw.py`).

The moments are f32 whatever the parameter dtype.  `update` keeps JAX's
order of operations: the gradients widened to f32, their global norm, the
clip by it, the moments, the bias corrections, the step with decoupled
weight decay, `p - lr * step` in f32 cast back to the parameter's dtype.
It is functional (new tensors); `update(..., inplace=True)` writes the same
values into the given parameters and moments under `torch.no_grad()`, the
port's counterpart of the launcher's `donate_argnums=(0, 1)`: the bits of
the functional form, without a second copy of the parameters and moments.
Trees are nested dicts of tensors; leaves are walked in JAX's order
(`core/tree.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..core import tree as tree_util


class AdamWState(NamedTuple):
    count: torch.Tensor  # () int32
    m: Any  # f32 tree like params
    v: Any  # f32 tree like params


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        """Zero moments in f32 on each parameter's device (a "meta" tree
        gives the shapes only)."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        first = tree_util.leaves(params)
        device = first[0].device if first else torch.device("cpu")
        return AdamWState(count=torch.zeros((), dtype=torch.int32, device=device),
                          m=tree_util.map(zeros, params), v=tree_util.map(zeros, params))

    def update(self, grads, state: AdamWState, params, *, inplace: bool = False
               ) -> Tuple[Any, AdamWState, dict]:
        """(new params, new state, {"grad_norm", "lr"}).  With `inplace`
        the returned params and state are the given trees, written in
        place."""
        with torch.no_grad():
            count = state.count + 1
            g32 = tree_util.map(lambda g: g.to(torch.float32), grads)
            gnorm = global_norm(g32)
            metrics = {"grad_norm": gnorm}
            scale = (None if self.grad_clip_norm is None
                     else torch.clamp(self.grad_clip_norm / (gnorm + 1e-9), max=1.0))
            c32 = count.to(torch.float32)
            b1c = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                               device=c32.device), c32)
            b2c = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                               device=c32.device), c32)
            lr = (self.lr(count) if callable(self.lr)
                  else torch.tensor(self.lr, dtype=torch.float32, device=c32.device))

            def moments(m_, v_, g):
                return (self.b1 * m_ + (1 - self.b1) * g,
                        self.b2 * v_ + (1 - self.b2) * g * g)

            def upd(p, m_, v_):
                mhat = m_ / b1c
                vhat = v_ / b2c
                step = mhat / (torch.sqrt(vhat) + self.eps)
                if self.weight_decay:
                    step = step + self.weight_decay * p.to(torch.float32)
                return (p.to(torch.float32) - lr * step).to(p.dtype)

            p_leaves = tree_util.leaves(params)
            m_leaves, v_leaves = tree_util.leaves(state.m), tree_util.leaves(state.v)
            new_p, new_m, new_v = [], [], []
            for p, m_, v_, g in zip(p_leaves, m_leaves, v_leaves, tree_util.leaves(g32)):
                if scale is not None:  # the clip, one leaf at a time
                    g = g * scale
                m1, v1 = moments(m_, v_, g)
                p1 = upd(p, m1, v1)
                if inplace:  # one leaf's temporaries at a time
                    m_.copy_(m1)
                    v_.copy_(v1)
                    p.copy_(p1)
                else:
                    new_p.append(p1)
                    new_m.append(m1)
                    new_v.append(v1)
            metrics["lr"] = lr
            if inplace:
                state.count.copy_(count)
                return params, state, metrics
            return (tree_util.unflatten(params, new_p),
                    AdamWState(count, tree_util.unflatten(state.m, new_m),
                               tree_util.unflatten(state.v, new_v)), metrics)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares in f32, the leaves
    added in JAX's order."""
    total = 0
    for x in tree_util.leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
