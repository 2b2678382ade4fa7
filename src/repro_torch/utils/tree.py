"""Nested dicts, lists and tuples of tensors: the LM family's parameter,
optimizer-state and checkpoint trees.

Leaves come in ``jax.tree_util``'s order (dict keys sorted, sequences in
order), so a tree's flattened paths are the reference's checkpoint keys
and sums over leaves run in the reference's order.
"""
from __future__ import annotations


def tree_items(tree, path: tuple = ()):
    """Yield ``(path, leaf)`` in flattening order; a path holds dict keys
    and sequence indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_items(t, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(template, leaves):
    """``template``'s structure with ``leaves`` (in flattening order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, the structure kept;
    a path holds dict keys and sequence indices (``tree_items``')."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (k,))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, path + (i,))
                          for i, t in enumerate(tree))
    return fn(path, tree)
