"""Nested parameter trees of the port: dicts (keys in sorted order, as
jax orders them), lists, tuples and NamedTuples of tensors.  A `None` is an
empty subtree, as in jax: it holds no leaf and maps to `None`."""
from __future__ import annotations

from typing import Any, Callable


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    return list(enumerate(tree))


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), values))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*values)
    return type(tree)(values)


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree, path: tuple = ()) -> list:
    """[(path, leaf)] in order; a path is the tuple of keys, field names and
    indices down to the leaf."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(path, tree)]
    return [x for k, v in _children(tree)
            for x in leaves_with_paths(v, path + (k,))]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """fn over the leaves of `tree` (and the matching leaves of `rest`, of
    the same structure), in a tree of the same structure."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    kids = [[v for _, v in _children(r)] for r in rest]
    return _rebuild(tree, [tree_map(fn, v, *(k[i] for k in kids))
                           for i, (_, v) in enumerate(_children(tree))])


def unflatten(like, values: list) -> Any:
    """A tree of `like`'s structure whose leaves are `values`, in the order
    `leaves(like)` gives."""
    it = iter(values)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than leaves")
    return out
