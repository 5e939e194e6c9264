"""Nested-dict trees in the reference's leaf order.

The reference keeps parameters, optimizer state and checkpoints as JAX
pytrees, and ``jax.tree.flatten`` visits a dict's keys in sorted order, a
list's or tuple's items in order, and ``None`` as an empty node.  These
helpers walk nested dicts, lists and tuples the same way, so that a tree
of tensors flattens to the leaves, in the order, that the reference's
tree of arrays flattens to (the checkpoint files depend on it).
"""

from __future__ import annotations

__all__ = ["tree_leaves", "tree_map", "tree_unflatten"]


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, list, tuple))


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), in a tree of ``tree``'s shape."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    leaves = list(leaves)
    if len(leaves) != len(tree_leaves(like)):
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{len(tree_leaves(like))}")
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
