"""Parameter trees: nested dicts, lists, tuples, NamedTuples and
dataclasses of tensors, walked in the JAX package's leaf order.

``jax.tree_util`` orders a dict's children by sorted key, a list's or
tuple's by index, a NamedTuple's by field and a dataclass registered as
the tuple of its fields (``TrainState``) by field.  The port flattens in
the same order, so a gradient's global norm sums its leaves in JAX's
order and a checkpoint's ``leaf_00000...`` names match JAX's.  Paths are
JAX's path strings: a dict key, a list index, ``.name`` for a NamedTuple
field and the field's index for a dataclass, joined by "/".
"""
from __future__ import annotations

import dataclasses
from typing import Callable


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def children(node):
    """[(path part, child)] of an inner node in JAX's order, or None for
    a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(str(i), getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    return None


def leaves_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] in JAX's order."""
    kids = children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for part, child in kids:
        out += leaves_with_paths(child, f"{prefix}/{part}" if prefix
                                 else part)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, new_leaves):
    """``like``'s structure with ``new_leaves`` (in ``leaves(like)``
    order) at its leaves."""
    it = iter(new_leaves)

    def build(node):
        kids = children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(c) for _, c in kids))
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for _, c in kids)
        return type(node)(*(build(c) for _, c in kids))

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(f: Callable, tree, *rest):
    """``f`` applied leaf by leaf over trees of one structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [f(*xs) for xs in zip(*flat)])
