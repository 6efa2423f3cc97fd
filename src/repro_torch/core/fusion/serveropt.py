"""Server-optimizer fusions: FedAvgM (server momentum) and FedAdam
(Reddi et al., Adaptive Federated Optimization). Both wrap GradAvg and
keep server state across rounds."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.fusion.averaging import GradAvg
from repro_torch.core.fusion.base import FusionAlgorithm


@dataclasses.dataclass
class FedAvgM(FusionAlgorithm):
    """Server momentum over the fused pseudo-gradient."""

    lr: float = 1.0
    momentum: float = 0.9
    name = "fedavgm"
    reducible = True

    def __post_init__(self):
        self._inner = GradAvg()
        self._velocity: Optional[torch.Tensor] = None

    def reset(self):
        self._velocity = None

    def partial(self, updates, weights):
        return self._inner.partial(updates, weights)

    def combine(self, weighted_sum, weight_sum):
        g = self._inner.combine(weighted_sum, weight_sum)
        v = g if self._velocity is None else (
            self.momentum * self._velocity + g
        )
        self._velocity = v
        return self.lr * v

    def fuse(self, updates, weights):
        return self.combine(*self.partial(updates, weights))


@dataclasses.dataclass
class FedAdam(FusionAlgorithm):
    """FedAdam server optimizer over the fused pseudo-gradient."""

    lr: float = 1e-2
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-3
    name = "fedadam"
    reducible = True

    def __post_init__(self):
        self._inner = GradAvg()
        self._m: Optional[torch.Tensor] = None
        self._v: Optional[torch.Tensor] = None
        self._t = 0

    def reset(self):
        self._m, self._v, self._t = None, None, 0

    def partial(self, updates, weights):
        return self._inner.partial(updates, weights)

    def combine(self, weighted_sum, weight_sum):
        g = self._inner.combine(weighted_sum, weight_sum)
        if self._m is None:
            self._m = torch.zeros_like(g)
            self._v = torch.zeros_like(g)
        self._t += 1
        self._m = self.b1 * self._m + (1 - self.b1) * g
        self._v = self.b2 * self._v + (1 - self.b2) * g * g
        mhat = self._m / (1 - self.b1 ** self._t)
        vhat = self._v / (1 - self.b2 ** self._t)
        return self.lr * mhat / (torch.sqrt(vhat) + self.eps)

    def fuse(self, updates, weights):
        return self.combine(*self.partial(updates, weights))
