"""Minimal functional module system with the port's own seeded init
(counterpart of `repro/models/modules.py`).

A module is a frozen dataclass of hyperparameters implementing

    def build(self, mk: Builder) -> nested dict of tensors

where every leaf is created through `mk.param(name, shape, ...)` and
submodules through `mk.child` / `mk.stacked`.  Parameters are plain
tensors in nested dicts with the JAX package's layout (a linear weight is
(d_in, d_out); segment weights carry a leading layer axis), so a JAX
params pytree converts leaf by leaf (`models/convert.py`) and both
packages compute the same function.

Init uses the same distributions as the JAX `Builder.param`: normal x
1/sqrt(fan_in) for matrices, 0.02 for vectors and the embedding table,
ones for norms, zeros for biases.  Every leaf draws from its own
`torch.Generator`, seeded from (seed, parameter path), so a leaf's values do
not depend on build order.  The numbers differ from JAX's (threefry is not
reproduced); tests carry JAX weights across with `from_jax_params`.  On the
"meta" device the tree carries shapes only.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional, Sequence, Tuple

import torch


def _leaf_seed(seed: int, path: Sequence[str]) -> int:
    h = hashlib.md5(("/".join(path) + f"#{seed}").encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


@dataclasses.dataclass
class Builder:
    seed: int
    device: torch.device
    dtype: torch.dtype = torch.float32
    path: Tuple[str, ...] = ()

    def param(self, name: str, shape: Sequence[int], *, init: str = "normal",
              scale: Optional[float] = None) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if self.device.type == "meta" or init == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        if init != "normal":
            raise ValueError(f"unknown init {init!r}")
        s = scale if scale is not None else (
            1.0 / math.sqrt(shape[0]) if len(shape) >= 2 else 0.02)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_leaf_seed(self.seed, self.path + (name,)))
        x = torch.randn(shape, generator=gen, device=self.device,
                        dtype=torch.float32)
        return (x * s).to(self.dtype)

    def child(self, name: str, module: "Module"):
        return module.build(dataclasses.replace(self, path=self.path + (name,)))

    def stacked(self, name: str, module: "Module", n: int):
        """Parameters for `n` identical layers stacked on a leading layer
        axis; each layer has its own seed path."""
        layers = [module.build(dataclasses.replace(self, path=self.path + (name, str(i))))
                  for i in range(n)]
        return _stack(layers)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_slice(tree, i: int):
    """Layer i of a layer-stacked tree, as views (writes go through)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


class Module:
    """Base class; subclasses are dataclasses implementing build()."""

    def build(self, mk: Builder):
        raise NotImplementedError

    def init(self, seed: int = 0, *, device="cuda", dtype=torch.float32):
        """Seeded parameters on `device` ("cuda" unless asked otherwise;
        "meta" gives the shapes only)."""
        from ..core.device import resolve_device

        dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        return self.build(Builder(seed, dev, dtype))


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
