"""Public wrappers for the fused-fusion kernels."""
from __future__ import annotations

import torch

from repro_torch.core.fusion.base import EPS
from repro_torch.kernels.fused_fusion.kernel import (
    weighted_sum,
    weighted_sum_dequant,
)


def fedavg_fused(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Paper Eq. (1) with the streaming weighted-sum kernel."""
    return weighted_sum(updates, weights) / (weights.sum() + EPS)


def fedavg_fused_dequant(codes: torch.Tensor, scales: torch.Tensor,
                         weights: torch.Tensor,
                         block: int = 2048) -> torch.Tensor:
    """Paper Eq. (1) straight from int8 codes + fp32 per-block scales:
    dequantization folds into the weighted-sum kernel, so the fp32
    update matrix never materializes."""
    wsum = weighted_sum_dequant(codes, scales, weights, block=block)
    return wsum / (weights.sum() + EPS)


def iteravg_fused(updates: torch.Tensor) -> torch.Tensor:
    n = updates.shape[0]
    w = torch.ones((n,), dtype=torch.float32, device=updates.device)
    return weighted_sum(updates, w) / (n + EPS)
