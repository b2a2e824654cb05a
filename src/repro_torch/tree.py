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


def paths(tree: Any, prefix: str = "") -> List[str]:
    """Each leaf's path ('layers/mlp/w_gate': dict keys, dataclass field
    names and list or tuple indices joined by '/'), in ``leaves`` order."""
    if isinstance(tree, dict):
        named = [(str(key), tree[key]) for key in sorted(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        named = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, (tuple, list)):
        named = [(str(i), child) for i, child in enumerate(tree)]
    elif tree is None:
        named = []
    else:
        return [prefix]
    return [p for name, child in named
            for p in paths(child, f"{prefix}/{name}" if prefix else name)]


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


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``tree``'s structure with each leaf ``fn(leaf, *the same leaf of
    each of rest)`` (``jax.tree.map``)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])


def tree_stack(trees: List[Any], stack) -> Any:
    """Trees of one structure as one tree of their leaves stacked along
    a new leading axis by ``stack`` (``torch.stack``); None when
    ``trees`` is empty or holds None (what ``jax.lax.scan`` stacks)."""
    if not trees or trees[0] is None:
        return None
    return unflatten(trees[0], [stack(list(group)) for group in
                                zip(*(leaves(t) for t in trees))])
