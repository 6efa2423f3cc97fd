"""Optimizers as (init, update) function pairs over trees of tensors, as
``repro.optim.optimizers``.

A tree is what ``repro_torch.utils.pytree`` walks: a ``state_dict``-like
``OrderedDict`` of tensors, nested dicts, lists or tuples. AdamW keeps
fp32 moments whatever the parameter dtype (bf16 training), cast to
``moment_dtype``; every update is computed in fp32 and cast back to the
parameter dtype on apply. The arithmetic is the reference's, step for
step: ``t = step + 1`` in fp32 with bias correction, decoupled decay
``u - lr * wd * p``, ``(p.f32 + u.f32).to(p.dtype)``, and ``1e-9`` in the
clip. Scalars (the rate, the bias corrections) are fp32 on the host, so
an update queues no device-to-host read.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.utils.pytree import tree_leaves, tree_map

PyTree = Any


def _f32(x) -> float:
    """A host scalar (python number, numpy or 0-d tensor) rounded to fp32,
    as a python float: what a weakly typed JAX scalar becomes beside an
    fp32 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).item()
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[..., Tuple[PyTree, PyTree]]
    # update(grads, state, step, params=None) -> (updates, new_state);
    # the caller applies them.


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(l.float().square().sum() for l in leaves))


def clip_by_global_norm(tree: PyTree, max_norm: float) -> PyTree:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda l: (l.float() * scale).to(l.dtype), tree)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def update(grads, state, step, params=None):
        del params
        step_lr = _f32(lr_fn(step))
        if momentum == 0.0:
            return tree_map(lambda g: -step_lr * g.float(), grads), state
        new_v = tree_map(lambda v, g: momentum * v + g.float(), state, grads)
        ups = tree_map(lambda v: -step_lr * v, new_v)
        return ups, new_v

    return Optimizer(init=init, update=update)


class AdamState(NamedTuple):
    m: PyTree
    v: PyTree


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    """``moment_dtype=torch.bfloat16`` halves optimizer-state memory at a
    small second-moment precision cost; updates still compute in fp32."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=moment_dtype,   # noqa: E731
                                  device=p.device)
        return AdamState(m=tree_map(z, params), v=tree_map(z, params))

    def update(grads, state, step, params=None):
        step_lr = _f32(lr_fn(step))
        t = np.float32(int(step)) + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)

        new_m = tree_map(
            lambda m, g: (b1 * m.float() + (1 - b1) * g.float()
                          ).to(moment_dtype), state.m, grads)
        new_v = tree_map(
            lambda v, g: (b2 * v.float() + (1 - b2) * g.float().square()
                          ).to(moment_dtype), state.v, grads)
        ups = tree_map(
            lambda m, v: -step_lr * (m.float() / bc1)
            / (torch.sqrt(v.float() / bc2) + eps), new_m, new_v)
        if weight_decay and params is not None:
            # decoupled (AdamW) decay
            lr_wd = _f32(np.float32(step_lr) * np.float32(weight_decay))
            ups = tree_map(lambda u, p: u - lr_wd * p.float(), ups, params)
        return ups, AdamState(m=new_m, v=new_v)

    return Optimizer(init=init, update=update)
