"""Fusion algorithm interface and the streaming reducer protocol.

A fusion consumes ``n`` client updates as a (n, P) matrix (the flat
layout of ``utils.pytree.tree_to_flat_vector``) with per-client weights
(n,) and produces one fused (P,) update.

``reducible`` fusions are a weighted sum over clients, so an engine can
fold (chunk, P) blocks into a (P,) fp32 carry instead of holding the
matrix. ``coordinatewise`` fusions (median, trimmed mean) act on each
coordinate given all client values for it. The reducer protocol, as in
``repro.core.fusion.base``:

* ``streamable``  — the fusion folds blocks into a bounded carry.
* ``weighted``    — the fold consumes client weights and staleness
  scales; order-statistic reducers set it False, and the engine then
  passes a 0/1 validity row and refuses per-row scales.
* ``init_state(dim, n_hint, device)``  -> tuple of tensors.
* ``fold_block(state, payload, weights, scale, partial=, carve=)``
  -> state; ``partial`` / ``carve`` let an engine inject its kernels.
* ``finalize(state)``  -> (P,); server-optimizer state advances here.
* ``state_signature(dim, n_hint)`` — hashable, mixed into step keys.
* ``state_nbytes(dim, n_hint)`` — carry footprint.
* ``discount_state(state, gamma)`` — staleness discount of a carry.

For the reducible family the state is the ``(weighted_sum, weight_sum)``
pair and finalize is ``combine``; the order-statistic carve's is in
``robust.py``.
"""
from __future__ import annotations

import abc
from typing import Callable, Optional, Tuple

import torch


def dequant_payload(payload, dim: int) -> torch.Tensor:
    """A compressed (codes, scales) payload as a dense (rows, dim) fp32
    block. codes: (rows, nblocks*blk) int8; scales: (rows, nblocks)
    fp32. Matches CompressedBlock.dequantize."""
    codes, scales = payload
    rows, pq = codes.shape
    nblocks = scales.shape[1]
    blk = pq // nblocks
    u = codes.float().reshape(rows, nblocks, blk)
    u = (u * scales[:, :, None]).reshape(rows, pq)
    return u[:, :dim]


class FusionAlgorithm(abc.ABC):
    """Base class. Subclasses hold hyperparameters and, for server
    optimizers, server state between rounds."""

    name: str = "base"
    reducible: bool = False
    coordinatewise: bool = False
    weighted: bool = True
    # the fusion needs each client's FULL-row norm before its weighted sum
    # (ClippedAvg): the distributed engine all-reduces squared row norms
    # over the parameter shards and calls ``partial_with_norms``
    needs_row_norms: bool = False

    @abc.abstractmethod
    def fuse(self, updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """updates: (n, P); weights: (n,) fp32. Returns (P,)."""

    # -- hooks for the reducible (map-reduce) path -------------------------
    def effective_weights(self, weights: torch.Tensor) -> torch.Tensor:
        """Normalize the weight semantics BEFORE any padding, so padded
        rows (weight 0) never contribute. IterAvg overrides to ones."""
        return weights

    def partial(self, updates: torch.Tensor, weights: torch.Tensor):
        """Local 'map' stage: returns (weighted_sum (P,), weight_sum ())."""
        raise NotImplementedError(f"{self.name} is not reducible")

    def partial_with_norms(self, updates: torch.Tensor,
                           weights: torch.Tensor, row_norms: torch.Tensor):
        """Like ``partial`` but given the exact full-row L2 norms (n,)."""
        raise NotImplementedError(f"{self.name} does not use row norms")

    def combine(self, weighted_sum: torch.Tensor, weight_sum: torch.Tensor):
        """Final 'reduce' stage after summing partials."""
        raise NotImplementedError(f"{self.name} is not reducible")

    # -- streaming reducer protocol ---------------------------------------
    @property
    def streamable(self) -> bool:
        return self.reducible

    def init_state(self, dim: int, n_hint: Optional[int] = None,
                   device=None):
        if not self.reducible:
            raise NotImplementedError(f"{self.name} is not streamable")
        del n_hint
        return (torch.zeros((dim,), dtype=torch.float32, device=device),
                torch.zeros((), dtype=torch.float32, device=device))

    def fold_block(self, state, payload, weights, scale=None, *,
                   partial: Optional[Callable] = None,
                   carve: Optional[Callable] = None):
        """Fold one (rows, P) block — a dense tensor or a compressed
        (codes, scales) pair — into ``state``. ``partial``/``carve`` are
        optional engine-supplied kernels."""
        del carve, scale
        if not self.reducible:
            raise NotImplementedError(f"{self.name} is not streamable")
        fn = partial if partial is not None else self.partial
        if isinstance(payload, tuple) and partial is None:
            payload = dequant_payload(payload, state[0].shape[0])
        wsum, tot = fn(payload, weights)
        return (state[0] + wsum, state[1] + tot)

    def finalize(self, state) -> torch.Tensor:
        if not self.reducible:
            raise NotImplementedError(f"{self.name} is not streamable")
        return self.combine(state[0], state[1])

    def state_signature(self, dim: int,
                        n_hint: Optional[int] = None) -> Tuple:
        if not self.reducible:
            raise NotImplementedError(f"{self.name} is not streamable")
        del n_hint
        return ("sum", dim)

    def state_nbytes(self, dim: int, n_hint: Optional[int] = None) -> int:
        if not self.reducible:
            raise NotImplementedError(f"{self.name} is not streamable")
        del n_hint
        return 4 * (dim + 1)

    def discount_state(self, state, gamma: float):
        if not self.reducible:
            raise NotImplementedError(f"{self.name} is not streamable")
        return (gamma * state[0], gamma * state[1])

    def __repr__(self) -> str:
        return f"<fusion:{self.name}>"


EPS = 1e-6  # the paper's epsilon in Eq. (1)
