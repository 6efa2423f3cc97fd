"""Flat-vector view of a model update held as a pytree.

The fusion kernels act on one flat vector per client, so an update given
as nested dicts / lists / tuples of tensors or ndarrays is flattened
leaf by leaf. The leaf order is JAX's, so that both packages flatten one
update to the same vector: a ``dict``'s keys are visited SORTED, while an
``OrderedDict`` (such as a ``state_dict``), a list or a tuple keeps its
own order, and ``None`` holds no leaf.
"""
from __future__ import annotations

import collections
from typing import Any, List

import numpy as np
import torch

from repro_torch.utils.dtypes import as_tensor, host_array, torch_dtype

PyTree = Any


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) or x is None


def _children(node) -> List[Any]:
    if node is None:
        return []
    if isinstance(node, dict):
        keys = list(node) if isinstance(node, collections.OrderedDict) \
            else sorted(node)
        return [node[k] for k in keys]
    return list(node)


def tree_leaves(tree: PyTree) -> List[Any]:
    """Every leaf of ``tree``, in JAX's leaf order."""
    if not _is_node(tree):
        return [tree]
    out: List[Any] = []
    for child in _children(tree):
        out.extend(tree_leaves(child))
    return out


def tree_unflatten(like: PyTree, leaves) -> PyTree:
    """A tree shaped like ``like`` whose leaves come from the iterator
    ``leaves``, in ``tree_leaves`` order."""
    if not _is_node(like):
        return next(leaves)
    if like is None:
        return None
    if isinstance(like, dict):
        keys = list(like) if isinstance(like, collections.OrderedDict) \
            else sorted(like)
        built = {k: tree_unflatten(like[k], leaves) for k in keys}
        return type(like)(built) if isinstance(
            like, collections.OrderedDict) else built
    items = [tree_unflatten(c, leaves) for c in like]
    if isinstance(like, list):
        return items
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def tree_to_flat_vector(tree: PyTree, dtype=None) -> torch.Tensor:
    """Concatenate every leaf, raveled, into one 1-D tensor on the first
    tensor leaf's device (the CPU for a tree of ndarrays)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=dtype or torch.float32)
    device = next((l.device for l in leaves if isinstance(l, torch.Tensor)),
                  None)
    vec = torch.cat([as_tensor(l, device).reshape(-1) for l in leaves])
    return vec if dtype is None else vec.to(dtype)


def flat_vector_to_tree(vec: torch.Tensor, like: PyTree) -> PyTree:
    """Inverse of :func:`tree_to_flat_vector` given a template tree: the
    leaves take the template's shapes and dtypes, on ``vec``'s device."""
    out = []
    offset = 0
    for leaf in tree_leaves(like):
        if isinstance(leaf, torch.Tensor):
            shape, dtype = leaf.shape, leaf.dtype
        else:
            arr = host_array(leaf)
            shape, dtype = arr.shape, torch_dtype(arr.dtype)
        n = int(np.prod(shape))
        out.append(vec[offset:offset + n].reshape(shape).to(dtype))
        offset += n
    return tree_unflatten(like, iter(out))
