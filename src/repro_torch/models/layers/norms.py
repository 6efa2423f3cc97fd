"""Normalization layers."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32, cast back to the input dtype.

    Uses the gemma-style ``(1 + scale)`` parameterization so zero-init
    scales are the identity transform.
    """
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)
