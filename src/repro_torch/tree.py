"""Nested-dict parameter trees: the port's stand-in for ``jax.tree``.

Parameters, gradients and optimizer states are plain dicts of tensors
(nested once for the layer stack), with exactly the JAX tree's keys.
Leaves are visited in sorted-key order, as ``jax.tree.leaves`` visits a
dict, so order-dependent reductions (the global-L2 clip norm) sum in the
reference's order. Tuples and lists are containers; ``()`` is the empty
tree (a stateless optimizer's state).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); containers are rebuilt."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_flatten_with_path(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in sorted-key order; a path is a tuple of keys."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_flatten_with_path(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, t in enumerate(tree):
            out.extend(tree_flatten_with_path(t, prefix + (i,)))
        return out
    return [(prefix, tree)]


def tree_unflatten(paths, leaves) -> dict:
    """The nested-dict tree with ``leaves`` at ``paths``: the inverse of
    ``tree_flatten_with_path`` for dict trees."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_rebuild(tree, new: dict, prefix: Tuple = ()):
    """``tree``'s containers with the leaf at each path taken from
    ``new`` (a dict from ``tree_flatten_with_path``'s paths)."""
    if isinstance(tree, dict):
        return {k: tree_rebuild(v, new, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_rebuild(t, new, prefix + (i,))
                          for i, t in enumerate(tree))
    return new[prefix]


def grad_leaves(tree) -> Tuple[List[Tuple], List[Any]]:
    """(paths, fresh autograd leaves with ``tree``'s values): the inputs
    of a ``torch.autograd.grad`` over a parameter tree, rebuilt into a
    tree by ``tree_unflatten(paths, leaves)``."""
    flat = tree_flatten_with_path(tree)
    return ([p for p, _ in flat],
            [x.detach().requires_grad_(True) for _, x in flat])


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_structure(tree):
    """A hashable description of the containers (not the leaves)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, tree_structure(tree[k]))
                              for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,
                tuple(tree_structure(t) for t in tree))
    return "*"


def tree_get(tree, path: Tuple):
    for k in path:
        tree = tree[k]
    return tree
