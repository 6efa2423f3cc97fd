"""Plain PyTorch versions of the fused weighted-sum kernels: what the
CPU path runs, and what the CUDA kernels are held against on the card."""
from __future__ import annotations

import torch


def weighted_sum_ref(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """updates (n, P), weights (n,) -> (P,) fp32 weighted sum."""
    return torch.einsum("np,n->p", updates.float(), weights.float())


def fedavg_ref(updates: torch.Tensor, weights: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """The paper's Eq. (1)."""
    return weighted_sum_ref(updates, weights) / (weights.float().sum() + eps)


def weighted_sum_dequant_ref(codes: torch.Tensor, scales: torch.Tensor,
                             weights: torch.Tensor,
                             block: int = 2048) -> torch.Tensor:
    """Dequantize int8 codes (n, Pq) with per-block fp32 scales
    (n, Pq // block), then weighted sum -> (Pq,) fp32."""
    n, Pq = codes.shape
    u = codes.float().reshape(n, Pq // block, block)
    u = (u * scales.float()[:, :, None]).reshape(n, Pq)
    return weighted_sum_ref(u, weights)
