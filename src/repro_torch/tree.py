"""Nested dicts and lists of tensors: flatten in the JAX package's leaf order.

The port holds parameters, gradients, optimizer moments and checkpoint
trees as plain nested dicts (and lists, the port's per-layer ``layers``).
:func:`flatten` walks a tree in the order ``jax.tree_util`` does: a dict's
keys sorted, a list's items in order; anything else (a tensor, an array, a
number, a tuple such as :class:`repro_torch.convert.Stacked`) is a leaf.
That order is what makes the port's checkpoints and optimizer walk the
leaves as the reference does.
"""

from __future__ import annotations

from typing import Any, Callable


def flatten(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in JAX's order; ``path`` is the tuple of keys
    (a list item's key is its index as a string)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in flatten(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [item for i, v in enumerate(tree) for item in flatten(v, path + (str(i),))]
    return [(path, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(items) -> dict:
    """The nested dict of ``(path, leaf)`` pairs (dicts only: a list's items
    come back as a dict keyed by their index strings)."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves at the same place in rest)`` over the tree, keeping
    its dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)
