"""Trees of tensors: the port's counterpart of ``jax.tree_util``.

Trees are nested dicts, lists, tuples and NamedTuples; anything else is a
leaf. Dict keys are walked in sorted order, as JAX does, so leaves line up
with the reference's, and ``None`` is an empty subtree.

The walks recurse through module functions, never through a nested
function that calls itself: such a function holds itself in its closure,
a reference cycle that would keep the leaves it saw alive until the
garbage collector runs.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(node, leaves: list) -> tuple:
    if node is None:
        return ("none",)
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_flatten(node[k], leaves) for k in keys))
    if _is_namedtuple(node):
        return ("namedtuple", type(node),
                tuple(_flatten(c, leaves) for c in node))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, tuple(_flatten(c, leaves) for c in node))
    leaves.append(node)
    return ("leaf",)


def tree_flatten(tree: PyTree) -> Tuple[list, tuple]:
    """(leaves, treedef); treedefs compare equal iff structures match."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _unflatten(d: tuple, it) -> PyTree:
    kind = d[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(d[1], d[2])}
    if kind == "namedtuple":
        return d[1](*[_unflatten(c, it) for c in d[2]])
    children = [_unflatten(c, it) for c in d[1]]
    return children if kind == "list" else tuple(children)


def tree_unflatten(treedef: tuple, leaves) -> PyTree:
    return _unflatten(treedef, iter(leaves))


def tree_leaves_with_path(tree: PyTree) -> list:
    """``[(path, leaf)]`` in ``tree_flatten`` order; a path is the tuple of
    dict keys, NamedTuple field names and sequence indices from the root
    (``jax.tree_util``'s ``DictKey``/``GetAttrKey``/``SequenceKey``)."""
    out: list = []
    _with_path(tree, (), out)
    return out


def _with_path(node, path: tuple, out: list) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _with_path(node[k], path + (k,), out)
    elif _is_namedtuple(node):
        for name, c in zip(node._fields, node):
            _with_path(c, path + (name,), out)
    elif isinstance(node, (list, tuple)):
        for i, c in enumerate(node):
            _with_path(c, path + (i,), out)
    else:
        out.append((path, node))


def tree_leaves(tree: PyTree) -> list:
    return tree_flatten(tree)[0]


def tree_map(f: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``f`` over corresponding leaves; every tree must share the structure
    of ``tree`` (``ValueError`` otherwise)."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError(f"tree structure mismatch: {treedef} vs {r_def}")
        others.append(r_leaves)
    return tree_unflatten(treedef, [f(*xs) for xs in zip(leaves, *others)])
