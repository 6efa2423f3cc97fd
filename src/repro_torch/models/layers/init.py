"""Seeded parameter initialisation, as ``repro``'s initialisers draw it:
a standard normal in fp32, scaled, then cast to the parameter dtype."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def normal_param(shape: Sequence[int], scale: float, dtype: torch.dtype,
                 device=None,
                 generator: Optional[torch.Generator] = None) -> nn.Parameter:
    """``normal(shape) * scale`` drawn in fp32 on ``device``; the
    generator must live on the same device."""
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return nn.Parameter((x * scale).to(dtype), requires_grad=False)


def zeros_param(shape: Sequence[int], dtype: torch.dtype,
                device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(tuple(shape), dtype=dtype, device=device),
                        requires_grad=False)
