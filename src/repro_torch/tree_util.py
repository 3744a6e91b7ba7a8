"""Pytrees of tensors in ``jax.tree_util``'s order, for the training path.

The reference package walks its parameter and optimizer trees with
``jax.tree_util``; the port keeps the same walk so that leaf lists line up
across the two packages (a checkpoint written by one restores in the
other, and sums over leaves add in the same order):

  * a ``dict`` or a :class:`repro_torch.models.layers.ParamTree` (the
    model) is a node whose children are its values in sorted-key order;
  * a ``tuple``, ``list`` or ``NamedTuple`` is a node whose children are
    its items in order;
  * ``None`` is a node with no children;
  * anything else (a tensor, an array, a number) is a leaf.

Unflattening gives back dicts, tuples, lists and NamedTuples of the same
type; a ``ParamTree`` comes back as the nested dict of its leaves.
"""
from __future__ import annotations

import torch.nn as nn


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """(kind, aux, children) of a node, or None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return "dict", tuple(keys), [node[k] for k in keys]
    if isinstance(node, nn.Module) and hasattr(node, "keys"):
        keys = sorted(node.keys())
        return "dict", tuple(keys), [node[k] for k in keys]
    if _is_namedtuple(node):
        return "namedtuple", type(node), list(node)
    if isinstance(node, (tuple, list)):
        return type(node).__name__, len(node), list(node)
    if node is None:
        return "none", None, []
    return None


def tree_flatten(tree):
    """``(leaves, treedef)`` in ``jax.tree_util.tree_flatten``'s order."""
    leaves = []

    def walk(node):
        kids = _children(node)
        if kids is None:
            leaves.append(node)
            return "leaf"
        kind, aux, children = kids
        return kind, aux, tuple(walk(c) for c in children)

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` with ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(d):
        if d == "leaf":
            return next(it)
        kind, aux, children = d
        items = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(aux, items))
        if kind == "namedtuple":
            return aux(*items)
        if kind == "tuple":
            return tuple(items)
        if kind == "list":
            return items
        return None

    out = build(treedef)
    rest = sum(1 for _ in it)
    if rest:
        raise ValueError(f"{rest} leaves left over for the tree")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which must have as many), rebuilt as ``tree``."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"trees differ: {len(leaves)} and {len(o)} "
                             "leaves")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def treedef_str(treedef) -> str:
    """A readable form of ``treedef`` (the port's own: a manifest records
    it and no restore reads it)."""
    if treedef == "leaf":
        return "*"
    kind, aux, children = treedef
    inner = ", ".join(treedef_str(c) for c in children)
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {treedef_str(c)}"
                               for k, c in zip(aux, children)) + "}"
    if kind == "namedtuple":
        return f"{aux.__name__}({inner})"
    if kind == "list":
        return f"[{inner}]"
    if kind == "none":
        return "None"
    return f"({inner}{',' if len(children) == 1 else ''})"
