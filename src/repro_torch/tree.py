"""Trees of tensors, as ``jax.tree`` walks them.

The port's state is nested dicts, lists, tuples and dataclasses
(``AdamWState``, ``TrainState``) of tensors.  :func:`flatten` lists their
leaves in ``jax.tree``'s order: dict keys sorted, sequences and dataclass
fields in order, ``None`` an empty subtree, anything else a leaf.  So the
same dict of arrays packs into the same pages in both packages
(``core/zero_bridge.py``), and :func:`leaves_with_path` names each leaf as
``jax.tree_util.keystr`` does (``.opt.m['embed']``, ``['layers'][0]``),
which keeps the checkpoint manifests of both packages alike.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

_LEAF = "*"


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _children(node):
    """(kind, key names, children) of an inner node; None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [node[k] for k in keys])
    if isinstance(node, (list, tuple)):
        return (type(node), list(range(len(node))), list(node))
    if _is_dataclass(node):
        names = [f.name for f in dataclasses.fields(node)]
        return (type(node), names, [getattr(node, n) for n in names])
    return None


def flatten(tree: Any) -> tuple[list, Any]:
    """-> (leaves, treedef)."""
    leaves: list = []

    def walk(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            leaves.append(node)
            return _LEAF
        kind, keys, children = kids
        return (kind, keys, [walk(c) for c in children])

    return leaves, walk(tree)


def unflatten(treedef: Any, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d is _LEAF:
            return next(it)
        kind, keys, children = d
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, built))
        if kind in (list, tuple):
            return kind(built)
        return kind(**dict(zip(keys, built)))

    return build(treedef)


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of ``rest`` (same structure)."""
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def leaves_with_path(tree: Any) -> list[tuple[str, Any]]:
    """[(path, leaf)] in :func:`flatten`'s order, each path as
    ``jax.tree_util.keystr`` writes it."""
    out: list = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        kind, keys, children = kids
        for key, child in zip(keys, children):
            if kind == "dict":
                step = f"[{key!r}]"
            elif kind in (list, tuple):
                step = f"[{key}]"
            else:
                step = f".{key}"
            walk(child, path + step)

    walk(tree, "")
    return out
