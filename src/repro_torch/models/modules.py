"""Minimal functional module system with the port's own seeded init
(counterpart of `repro/models/modules.py`).

A module is a frozen dataclass of hyperparameters implementing

    def build(self, mk: Builder) -> nested dict of tensors

where every leaf is created through `mk.param(name, shape, axes, ...)` and
submodules through `mk.child` / `mk.stacked`; `axes` are the leaf's
logical axes, as in JAX (`Module.axes()` gives their tree, which
`parallel/sharding.tree_specs` turns into specs).  Parameters are plain
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
"meta" device the tree carries shapes only (JAX's `abstract`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Optional, Sequence, Tuple

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
    # preallocated leaves by full parameter path (`stacked` fills each layer
    # of its stacks in place through these)
    into: Optional[Dict[Tuple[str, ...], torch.Tensor]] = None
    axes_only: bool = False  # build the tree of logical axes instead

    def param(self, name: str, shape: Sequence[int], axes: Sequence[Optional[str]], *,
              init: str = "normal", scale: Optional[float] = None) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if len(axes) != len(shape):
            raise ValueError(f"{self.path + (name,)}: shape {shape} vs axes {tuple(axes)}")
        if self.axes_only:
            return tuple(axes)
        out = None if self.into is None else self.into[self.path + (name,)]
        if self.device.type == "meta" or init == "zeros":
            return self._const(out, shape, 0.0)
        if init == "ones":
            return self._const(out, shape, 1.0)
        if init != "normal":
            raise ValueError(f"unknown init {init!r}")
        s = scale if scale is not None else (
            1.0 / math.sqrt(shape[0]) if len(shape) >= 2 else 0.02)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_leaf_seed(self.seed, self.path + (name,)))
        # f32 normals scaled in place (randn is normal_ on a fresh tensor, so
        # drawing into a preallocated f32 leaf gives the same bits)
        if out is not None and out.dtype == torch.float32:
            return out.normal_(generator=gen).mul_(s)
        x = torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
        x = x.mul_(s).to(self.dtype)
        return x if out is None else out.copy_(x)

    def _const(self, out, shape, value: float) -> torch.Tensor:
        if out is None:
            return torch.full(shape, value, dtype=self.dtype, device=self.device)
        return out.fill_(value)

    def child(self, name: str, module: "Module"):
        return module.build(dataclasses.replace(self, path=self.path + (name,)))

    def stacked(self, name: str, module: "Module", n: int):
        """Parameters for `n` identical layers stacked on a leading layer
        axis; each layer has its own seed path.  Each stacked leaf is
        allocated once and layer i is drawn into its slice, so a segment is
        never held twice (grok-1's 2 layers are 39 GB in f32).  Axes get a
        leading "layers" axis."""
        if self.axes_only:
            one = module.build(dataclasses.replace(self, path=self.path + (name, "0")))
            return _map(lambda a: ("layers",) + a, one)
        shapes = module.build(dataclasses.replace(
            self, device=torch.device("meta"), path=self.path + (name, "0"), into=None))
        stack = _map(lambda t: torch.empty((n, *t.shape), dtype=self.dtype,
                                           device=self.device), shapes)
        for i in range(n):
            path = self.path + (name, str(i))
            into = {path + k: v for k, v in _flatten(layer_slice(stack, i))}
            module.build(dataclasses.replace(self, path=path, into=into))
        return stack


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _flatten(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def param_device(params) -> torch.device:
    """The device of a parameter tree (its first leaf's)."""
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


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

    def axes(self):
        """The tree of each leaf's logical-axes tuple (JAX's `axes()`)."""
        return self.build(Builder(0, torch.device("meta"), axes_only=True))


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
