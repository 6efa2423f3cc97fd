"""Normalization layers."""
from __future__ import annotations

import torch


def at_least_fp32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or in its own dtype where that is wider: the dtype
    the norms, gates, states and loss are computed in. bf16, fp16 and
    fp32 give fp32; a float64 tree runs in float64 throughout."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32 (``at_least_fp32``), cast back to the
    input dtype.

    Uses the gemma-style ``(1 + scale)`` parameterization so zero-init
    scales are the identity transform.
    """
    x32 = at_least_fp32(x)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + at_least_fp32(scale))).to(x.dtype)


def group_norm(x: torch.Tensor, scale: torch.Tensor, n_groups: int,
               eps: float = 1e-6) -> torch.Tensor:
    """Per-head group norm of the Mamba gated-norm path, in fp32, cast
    back to the input dtype: x (..., d) normalized independently in
    ``n_groups`` equal groups, with the population variance (``jnp.var``
    has ddof 0; ``torch.var`` defaults to the unbiased estimate) and the
    ``(1 + scale)`` form."""
    *lead, d = x.shape
    g = at_least_fp32(x).reshape(*lead, n_groups, d // n_groups)
    mean = g.mean(dim=-1, keepdim=True)
    var = g.var(dim=-1, keepdim=True, correction=0)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * (1.0 + at_least_fp32(scale))).to(x.dtype)
