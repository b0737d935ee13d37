"""Meshes of the port (counterpart of `repro/launch/mesh.py`'s `make_mesh`
and `single_device_mesh`).

A JAX mesh maps devices onto named axes.  A process of the port holds whole
tensors, so its mesh is the named axis sizes plus the ring transport of
each axis (`parallel/ring.py`): `LocalRing(size)` by default, every rank in
this process, or a `DistRing` over a process group passed in `rings`.
JAX's `make_production_mesh` (the TPU pod layout) has no counterpart.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

from ..parallel.ring import LocalRing


class Mesh:
    """Named axis sizes (`shape`, an ordered axis -> size dict as JAX's
    `Mesh.shape`) and the ring transport of each axis."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 rings: Optional[Mapping[str, object]] = None):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
        self.shape: Dict[str, int] = {a: int(n) for a, n in zip(axes, shape)}
        self.axis_names = tuple(axes)
        self._rings = dict(rings or {})
        for a, ring in self._rings.items():
            if a not in self.shape:
                raise ValueError(f"ring for {a!r}, which is not a mesh axis {self.axis_names}")
            if ring.size != self.shape[a]:
                raise ValueError(f"the {a!r} ring has {ring.size} ranks, the axis "
                                 f"{self.shape[a]}")

    def ring(self, axis: str):
        """The transport of `axis` (made on first use: a LocalRing)."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}; axes: {self.axis_names}")
        if axis not in self._rings:
            self._rings[axis] = LocalRing(self.shape[axis])
        return self._rings[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(shape, axes, *, rings: Optional[Mapping[str, object]] = None) -> Mesh:
    """A mesh of the given axis sizes (tests, small runs, one card)."""
    return Mesh(shape, axes, rings)


def single_device_mesh() -> Mesh:
    return Mesh((1, 1), ("data", "model"))
