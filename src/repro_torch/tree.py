"""Nested containers of tensors: leaf names, leaf order, rebuilding.

The port's stand-in for the part of ``jax.tree_util`` the reference's
checkpoint and gradient modules use.  A tree is nested dicts, lists,
tuples and named tuples; ``None`` holds no leaf; anything else is a
leaf.  The walk is ``jax.tree_util.tree_flatten_with_path``'s: dict keys
sorted (an ``OrderedDict`` keeps its order), sequences by index, named
tuples by field name, so :func:`leaf_paths` gives the reference's
``/``-joined leaf names in the reference's order.  ``is_leaf``, where
a function takes it, stops the walk at the nodes it accepts, as
``jax.tree_util``'s argument of that name does.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _keys(node: dict) -> list:
    return list(node) if isinstance(node, collections.OrderedDict) else sorted(node)


def _children(node) -> List[Tuple[str, Any]]:
    """(key, child) pairs of a container node in walk order."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in _keys(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    return [(str(i), c) for i, c in enumerate(node)]


IsLeaf = Optional[Callable[[Any], bool]]


def _is_node(x, is_leaf: IsLeaf = None) -> bool:
    return isinstance(x, (dict, list, tuple)) and not (is_leaf is not None and is_leaf(x))


def _walk(node, path: Tuple[str, ...], is_leaf: IsLeaf = None
          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if node is None:
        return
    if _is_node(node, is_leaf):
        for key, child in _children(node):
            yield from _walk(child, path + (key,), is_leaf)
    else:
        yield path, node


def leaf_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs: names ``/``-joined key paths, in walk order."""
    return [("/".join(path), leaf) for path, leaf in _walk(tree, ())]


def leaves(tree: PyTree, is_leaf: IsLeaf = None) -> List[Any]:
    return [leaf for _, leaf in _walk(tree, (), is_leaf)]


def _rebuild(node, it: Iterator[Any], is_leaf: IsLeaf = None):
    if node is None:
        return None
    if not _is_node(node, is_leaf):
        return next(it)
    if isinstance(node, dict):  # filled in walk order, keyed in the node's order
        done = {k: _rebuild(node[k], it, is_leaf) for k in _keys(node)}
        out = {k: done[k] for k in node}
        return collections.OrderedDict(out) if isinstance(node, collections.OrderedDict) else out
    items = [_rebuild(c, it, is_leaf) for _, c in _children(node)]
    if _is_namedtuple(node):
        return type(node)(*items)
    return type(node)(items)


def unflatten(template: PyTree, values: Sequence[Any], is_leaf: IsLeaf = None) -> PyTree:
    """``template``'s structure with its leaves replaced, in walk order,
    by ``values``."""
    it = iter(values)
    out = _rebuild(template, it, is_leaf)
    if next(it, it) is not it:
        raise ValueError("more values than the template has leaves")
    return out


def map_leaves(fn: Callable[[Any], Any], tree: PyTree, is_leaf: IsLeaf = None) -> PyTree:
    """``tree``'s structure with ``fn`` applied to every leaf."""
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree, is_leaf)], is_leaf)


def to_tensor(leaf: Any) -> torch.Tensor:
    """A leaf as a tensor: tensors as they are; numpy arrays and numbers
    through ``np.asarray`` (so a Python int is int64, as the reference
    stores it); bfloat16 arrays (ml_dtypes) through an int16 view, bit
    for bit."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr.view(np.int16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))
