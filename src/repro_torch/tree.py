"""Nested dict/list trees of tensors: the port's stand-in for pytrees.

Params, gradients and optimizer state are plain dicts (and, for an LM's
``layers``, lists) of tensors.  Leaves are visited in ``jax.tree``'s
order: dict keys sorted, list items by index, so a tree's flat order and
its leaf paths are the ones the JAX package gets for the same structure.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf), ...]``; a path is a tuple of dict keys and list
    indices."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a new tree.  ``fn``
    is called in :func:`leaves` order; dicts keep their key order."""
    if isinstance(tree, dict):
        out = {k: map_tree(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(like, flat: list):
    """A tree of ``like``'s structure holding ``flat``'s items in
    :func:`leaves` order."""
    it = iter(flat)
    out = map_tree(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
