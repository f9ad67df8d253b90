"""Nested parameter containers: dicts, lists and tuples of tensors.

The port keeps model weights, LoRA adapters and optimizer moments as
plain nested containers (``{"layers": [{name: tensor}, ...]}``), so the
client axis stays an explicit leading tensor dimension and nothing is
hidden in a module hierarchy.  These helpers walk such trees.
"""
from __future__ import annotations

from typing import Callable, List


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


def _rebuild(seq, items: List):
    """A list or tuple of ``seq``'s type holding ``items``; a named
    tuple (an optimizer state) is built from its fields."""
    if hasattr(seq, "_fields"):
        return type(seq)(*items)
    return type(seq)(items)


def tree_leaves(tree) -> List:
    """Leaves in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves: List):
    """A tree of ``tree``'s structure holding ``leaves`` (``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return _rebuild(t, [build(v) for v in t])
        return next(it)

    return build(tree)
