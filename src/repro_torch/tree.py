"""Leaves of nested training state, in the order of the reference's
``jax.tree.leaves``: a dict's values by sorted key, a dataclass's fields
in declaration order, a tuple's or list's items in order, nothing for
``None``; anything else (a tensor, a numpy array or scalar) is a leaf.

Checkpoints store leaves by position (``leaf_00000``, ...), so this order
is what lets the reference read the port's published params and the
other way round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List


def _children(node: Any):
    """The node's children, or None when ``node`` is a leaf."""
    if isinstance(node, dict):
        return [node[key] for key in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [getattr(node, f.name) for f in dataclasses.fields(node)]
    if isinstance(node, (tuple, list)):
        return list(node)
    if node is None:
        return []
    return None


def leaves(tree: Any) -> List[Any]:
    """Every leaf of ``tree``, in the reference's order."""
    out: List[Any] = []
    children = _children(tree)
    if children is None:
        out.append(tree)
    else:
        for child in children:
            out.extend(leaves(child))
    return out


def unflatten(template: Any, new_leaves: List[Any]) -> Any:
    """``template``'s structure with its leaves replaced, in order, by
    ``new_leaves`` (as many as ``leaves(template)``)."""
    it = iter(new_leaves)
    out = _rebuild(template, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template holds")
    return out


def _rebuild(node: Any, it: Iterator[Any]) -> Any:
    if isinstance(node, dict):
        built = {key: _rebuild(node[key], it) for key in sorted(node)}
        return {key: built[key] for key in node}
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{
            f.name: _rebuild(getattr(node, f.name), it)
            for f in dataclasses.fields(node)})
    if isinstance(node, (tuple, list)):
        return type(node)(_rebuild(child, it) for child in node)
    if node is None:
        return None
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the template holds") from None
