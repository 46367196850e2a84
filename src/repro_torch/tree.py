"""The port's pytrees: a tensor, or a nested dict of them.

The reference maps its optimizer, gossip and server bodies over any
pytree with ``jax.tree.map`` and flattens them in ``jax.tree.flatten``'s
order, which sorts dict keys at every level.  The port's parameters,
optimizer slots and residuals are only ever tensors or nested dicts of
tensors, so these few helpers cover them.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["tree_map", "sorted_leaves", "leaves", "build_tree"]


def _empty(tree) -> bool:
    """() is the 'no state' sentinel (sgd's optimizer state, an absent
    residual): a tree without leaves, as jax.tree sees it."""
    return isinstance(tree, tuple) and tree == ()


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``,
    which have its structure; a leaf is anything that is not a dict or
    the empty tuple ``()``, which maps to itself."""
    if _empty(tree):
        return ()
    if isinstance(tree, dict):
        return {key: tree_map(fn, value, *(r[key] for r in rest))
                for key, value in tree.items()}
    return fn(tree, *rest)


def sorted_leaves(tree, prefix=()):
    """(path, leaf) pairs in jax.tree.flatten's order for nested dicts; a
    bare leaf is the one pair ((), leaf), and ``()`` has none."""
    if _empty(tree):
        return
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for key in sorted(tree):
        yield from sorted_leaves(tree[key], prefix + (key,))


def leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`sorted_leaves` order."""
    return [leaf for _, leaf in sorted_leaves(tree)]


def build_tree(paths, values):
    """The tree with ``values`` at ``paths`` (the inverse of
    :func:`sorted_leaves`); the one empty path gives the bare leaf."""
    paths, values = list(paths), list(values)
    if paths == [()]:
        return values[0]
    tree: dict = {}
    for path, value in zip(paths, values):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree
