"""Nested-dict parameter trees: leaves in the reference's order.

The port's parameters, optimizer state and checkpoints are nested dicts of
tensors, as the reference's pytrees are. JAX flattens a dict in sorted key
order; these helpers do the same, so a leaf's position and its path key
(``"params/blocks/attn/wq"``) match the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in sorted key order; paths join keys with "/"."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten_like(tree: Any, flat: list) -> Any:
    """A tree of ``tree``'s structure holding ``flat``, taken in the order
    of :func:`leaves`."""
    it = iter(flat)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        return next(it)
    out = fill(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten_like: more leaves than the tree holds")
    return out
