"""Carry JAX parameters across to the port.

`from_jax_params(tree, cfg, device)` takes the JAX `model.init(...)` pytree
as nested dicts of numpy arrays (e.g. `jax.tree.map(np.asarray, params)`)
and returns the port's parameter tree, so both packages compute the same
function.  The port keeps the JAX layout (linear weights (d_in, d_out),
segment weights stacked on a leading layer axis), so each leaf converts as
it is; the tree's keys and shapes are checked against the port's own.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .transformer import build_model


def _convert(tree, ref, path, device, dtype):
    if isinstance(ref, dict):
        if not isinstance(tree, dict) or set(tree) != set(ref):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{'/'.join(path) or '<root>'}: keys {got} != "
                             f"port keys {sorted(ref)}")
        return {k: _convert(tree[k], ref[k], path + (k,), device, dtype)
                for k in ref}
    arr = np.asarray(tree)
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != port shape "
                         f"{tuple(ref.shape)}")
    return torch.tensor(arr, dtype=torch.float32).to(device=device, dtype=dtype)


def from_jax_params(tree, cfg, device="cuda", dtype=torch.float32):
    """JAX params (nested dicts of numpy arrays) -> the port's params."""
    dev = resolve_device(device)
    ref = build_model(cfg).init(0, device="meta", dtype=dtype)
    return _convert(tree, ref, (), dev, dtype)
