"""Trees of tensors in JAX's leaf order (the port's counterpart of
`jax.tree.flatten` / `unflatten` / `map` for the trees training handles).

A tree is nested dicts, lists, tuples and `NamedTuple`s over leaves
(tensors, numpy arrays, Python numbers); None is an empty subtree, as in
JAX.  Leaves come in JAX's order: a dict's keys sorted, a sequence's
items (a `NamedTuple`'s fields) in order.  The optimizer's global norm,
the checkpoint's leaf files and the gradient sync all walk this order, so
their sums and files line up with the JAX package's.
"""
from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree) -> List[Any]:
    """The leaves of `tree`, in JAX's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


def unflatten(tree, new_leaves) -> Any:
    """`tree`'s structure over `new_leaves` (in `leaves(tree)`'s order)."""
    it = iter(new_leaves)
    out = _rebuild(tree, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


_END = object()


def _rebuild(tree, it):
    if tree is None:
        return None
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: built[k] for k in tree}  # the tree's own key order
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the tree holds")
    return leaf


def map(fn: Callable, tree, *rest) -> Any:  # noqa: A001 -- jax.tree.map's name
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])


def structure(tree) -> str:
    """A printable description of the tree's structure (the manifest's
    "treedef"; JAX writes its own `PyTreeDef` string there)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}" for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (f"{type(tree).__name__}("
                + ", ".join(f"{f}={structure(v)}" for f, v in zip(tree._fields, tree)) + ")")
    if isinstance(tree, (list, tuple)):
        br = "[]" if isinstance(tree, list) else "()"
        return br[0] + ", ".join(structure(v) for v in tree) + br[1]
    return "*"
