"""Averaging-family fusions (paper §III-A).

FedAvg     — Eq. (1): M = sum_i w_i * u_i / (sum_i w_i + eps).
IterAvg    — unweighted mean.
GradAvg    — weighted gradient mean (the server applies it as a gradient).
ClippedAvg — per-update L2 clip to a threshold, then FedAvg.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.fusion.base import EPS, FusionAlgorithm


def _wsum(updates, weights):
    w = weights.float()
    return torch.einsum("np,n->p", updates.float(), w), w.sum()


class FedAvg(FusionAlgorithm):
    name = "fedavg"
    reducible = True

    def fuse(self, updates, weights):
        return self.combine(*self.partial(updates, weights))

    def partial(self, updates, weights):
        return _wsum(updates, weights)

    def combine(self, weighted_sum, weight_sum):
        return weighted_sum / (weight_sum + EPS)


class IterAvg(FusionAlgorithm):
    """Unweighted mean. ``effective_weights`` maps everything to 1 so the
    reduction is pad-safe (padded rows carry weight 0)."""

    name = "iteravg"
    reducible = True

    def effective_weights(self, weights):
        return torch.ones_like(weights, dtype=torch.float32)

    def fuse(self, updates, weights):
        w = self.effective_weights(
            weights if weights is not None
            else torch.ones((updates.shape[0],), device=updates.device)
        )
        return self.combine(*self.partial(updates, w))

    def partial(self, updates, weights):
        return _wsum(updates, weights)

    def combine(self, weighted_sum, weight_sum):
        return weighted_sum / (weight_sum + EPS)


class GradAvg(FedAvg):
    """FedAvg's reduction; the inputs are gradients and the server
    optimizer applies the fused result."""

    name = "gradavg"


@dataclasses.dataclass
class ClippedAvg(FusionAlgorithm):
    """L2-clip each update to ``clip_norm``, then weighted-average. Still
    reducible: the clip is per client (map side)."""

    clip_norm: float = 10.0
    name = "clippedavg"
    reducible = True

    def fuse(self, updates, weights):
        return self.combine(*self.partial(updates, weights))

    def partial(self, updates, weights):
        norms = torch.linalg.vector_norm(updates.float(), dim=1)
        return self.partial_with_norms(updates, weights, norms)

    def partial_with_norms(self, updates, weights, row_norms):
        scale = torch.clamp(self.clip_norm / (row_norms + EPS), max=1.0)
        return _wsum(updates.float() * scale[:, None], weights)

    def combine(self, weighted_sum, weight_sum):
        return weighted_sum / (weight_sum + EPS)
