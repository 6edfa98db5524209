"""Nested dicts, lists and tuples of tensors or arrays, walked in JAX's
flatten order: dict keys sorted, sequences in order. A leaf's path is its
keys and indices joined by ``/``, as the reference's checkpoint manifest
writes them (``repro/training/checkpoint.py:40-52``).

The walks are module-level functions: a recursive closure would sit in a
reference cycle with what it captures (the leaves), which keeps a train
step's gradients alive until the cyclic collector runs."""
from __future__ import annotations

from typing import Any, Iterator, List, Tuple


def _children(node):
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _walk(node, prefix: Tuple[str, ...], paths: List[str], leaves: List[Any]):
    kids = _children(node)
    if kids is None:
        paths.append("/".join(prefix))
        leaves.append(node)
        return
    for key, child in kids:
        _walk(child, prefix + (key,), paths, leaves)


def flatten(tree) -> Tuple[List[str], List[Any]]:
    """``(paths, leaves)`` of ``tree`` in flatten order."""
    paths: List[str] = []
    leaves: List[Any] = []
    _walk(tree, (), paths, leaves)
    return paths, leaves


def _build(node, it: Iterator):
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def unflatten(like, leaves: List[Any]):
    """A tree of ``like``'s structure holding ``leaves`` in flatten order."""
    it = iter(leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
