"""Checkpointing, as ``repro.checkpoint.ckpt`` writes it: trees of
tensors <-> a single ``.npz`` plus a structure manifest, and
adaptive-controller state <-> a JSON sidecar.

``save_pytree`` / ``load_pytree`` key each leaf by its path in the tree,
the reference's names: dict keys, NamedTuple fields and sequence
indices joined with ``/`` (a ``state_dict``'s dotted names are one dict
key each). bf16 leaves are stored widened to fp32, as the reference
stores them, and ``load_pytree`` casts each array back to its template
leaf's dtype, so either package loads what the other wrote for the same
tree.

``save_controller_state`` / ``load_controller_state`` persist an
:class:`repro_torch.core.adaptive.AdaptiveController`'s learned arrival
curves (per-tenant models + the cross-tenant prior) next to the model
checkpoint, so an aggregator restart resumes with its learned gates
instead of re-learning from static-timeout rounds. The file is the
controller's ``state_dict`` as plain JSON at ``<path>.controller.json``,
the same name and keys as the reference package's, so either package
loads what the other wrote.
"""
from __future__ import annotations

import collections
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.utils.dtypes import host_array, is_bf16, to_device
from repro_torch.utils.pytree import tree_unflatten

PyTree = Any


def _paths_and_leaves(tree: PyTree, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[str, Any]]:
    """(key, leaf) of every leaf in ``tree_leaves`` order: dict keys
    sorted unless the dict is an ``OrderedDict``, NamedTuple fields by
    name, list and tuple items by index; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        keys = list(tree) if isinstance(tree, collections.OrderedDict) \
            else sorted(tree)
        items = [(str(k), tree[k]) for k in keys]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for name, child in items:
        out.extend(_paths_and_leaves(child, prefix + (name,)))
    return out


def _numpy(leaf) -> np.ndarray:
    """A leaf as the array the reference saves: bf16 widened to fp32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    arr = host_array(leaf)
    if is_bf16(arr.dtype):
        return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(arr)


def save_pytree(path: str, tree: PyTree) -> None:
    arrays = {k: _numpy(leaf) for k, leaf in _paths_and_leaves(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)
    manifest = {
        k: {"shape": list(v.shape), "dtype": str(v.dtype)}
        for k, v in arrays.items()
    }
    with open(path.removesuffix(".npz") + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def load_pytree(path: str, template: PyTree) -> PyTree:
    """Restore into the structure of ``template``: each leaf a tensor of
    the template leaf's dtype, on its device (the CPU for array
    leaves)."""
    npz = np.load(path if path.endswith(".npz") else path + ".npz")
    leaves = []
    for key, leaf in _paths_and_leaves(template):
        t = torch.from_numpy(np.array(npz[key]))
        if isinstance(leaf, torch.Tensor):
            leaves.append(t.to(device=leaf.device, dtype=leaf.dtype))
        else:
            like = to_device(host_array(leaf), torch.device("cpu"))
            leaves.append(t.to(like.dtype))
    return tree_unflatten(template, iter(leaves))


def _controller_path(path: str) -> str:
    """Canonical on-disk name: ``<path>.controller.json`` (``path`` may
    be the model checkpoint path — the controller state lands beside
    it)."""
    if path.endswith(".controller.json"):
        return path
    return path.removesuffix(".npz") + ".controller.json"


def save_controller_state(path: str, controller: Any) -> str:
    """Persist an ``AdaptiveController`` (or a raw ``state_dict``) as
    JSON at ``<path>.controller.json``. Returns the written path."""
    state = (
        controller.state_dict()
        if hasattr(controller, "state_dict") else controller
    )
    out = _controller_path(path)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(state, f, indent=1)
    return out


def load_controller_state(path: str, controller: Any = None) -> Dict:
    """Load controller state saved by :func:`save_controller_state` (by
    either package). Returns the raw state dict; with ``controller``
    given (anything exposing ``load_state_dict``), the state is also
    restored into it."""
    with open(_controller_path(path)) as f:
        state = json.load(f)
    if controller is not None:
        controller.load_state_dict(state)
    return state
