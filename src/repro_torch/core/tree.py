"""Trees of tensors: the port's counterpart of ``jax.tree_util``.

Trees are nested dicts, lists, tuples and NamedTuples; anything else is a
leaf. Dict keys are walked in sorted order, as JAX does, so leaves line up
with the reference's, and ``None`` is an empty subtree.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree: PyTree) -> Tuple[list, tuple]:
    """(leaves, treedef); treedefs compare equal iff structures match."""
    leaves: list = []

    def walk(node):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(walk(node[k]) for k in keys))
        if _is_namedtuple(node):
            return ("namedtuple", type(node), tuple(walk(c) for c in node))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, tuple(walk(c) for c in node))
        leaves.append(node)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(treedef: tuple, leaves) -> PyTree:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind == "namedtuple":
            return d[1](*[build(c) for c in d[2]])
        children = [build(c) for c in d[1]]
        return children if kind == "list" else tuple(children)

    return build(treedef)


def tree_leaves_with_path(tree: PyTree) -> list:
    """``[(path, leaf)]`` in ``tree_flatten`` order; a path is the tuple of
    dict keys, NamedTuple field names and sequence indices from the root
    (``jax.tree_util``'s ``DictKey``/``GetAttrKey``/``SequenceKey``)."""
    out: list = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif _is_namedtuple(node):
            for name, c in zip(node._fields, node):
                walk(c, path + (name,))
        elif isinstance(node, (list, tuple)):
            for i, c in enumerate(node):
                walk(c, path + (i,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


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
