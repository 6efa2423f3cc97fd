"""Rotary position embeddings."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for half the head dimension (fp32)."""
    half = head_dim // 2
    exponents = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x`` of shape (B, T, H, D) by per-token ``positions`` (B, T).

    Split-halves convention (as in Llama/NeoX): rotate (x1, x2) ->
    (x1*cos - x2*sin, x2*cos + x1*sin), with the angles in fp32.
    """
    D = x.shape[-1]
    inv_freq = rope_frequencies(D, theta, device=x.device)     # (D/2,)
    angles = positions.float()[..., None] * inv_freq            # (B, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]                      # (B, T, 1, D/2)
    sin = torch.sin(angles)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., : D // 2], x32[..., D // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
