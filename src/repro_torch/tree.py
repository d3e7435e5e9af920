"""Nested dicts of tensors walked as ``jax.tree`` walks ``repro``'s
pytrees: dict keys in sorted order, so a reduction over the leaves (the
optimizers' global norm) adds them in ``repro``'s order."""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_leaves", "tree_leaves_up_to", "tree_map",
           "tree_unflatten"]


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, keys sorted (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_leaves_up_to(like, tree) -> list:
    """``tree``'s subtrees at the places of ``like``'s leaves, in
    :func:`tree_leaves`'s order (``treedef.flatten_up_to``)."""
    if isinstance(like, dict):
        return [x for k in sorted(like)
                for x in tree_leaves_up_to(like[k], tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree``; each of ``rest`` has ``tree``'s
    dicts, and at a leaf of ``tree`` any value (a subtree is passed whole,
    as ``flatten_up_to`` does)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list) -> Any:
    """``like``'s dicts with its leaves replaced, in :func:`tree_leaves`'s
    order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
