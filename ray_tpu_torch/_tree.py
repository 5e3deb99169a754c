"""Maps over trees of nested dicts with tensors at the leaves, the shape
of the model's params, their gradients and the optimizer's moments."""

from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of nested dicts (and of same-shaped ``rest``),
    in insertion order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out
