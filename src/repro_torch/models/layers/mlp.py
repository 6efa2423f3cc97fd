"""SwiGLU MLP (the dense FFN of the transformer families)."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.layers.init import normal_param


class MLP(nn.Module):
    """w_gate, w_up (d, ff) and w_down (ff, d), as ``repro``'s MLPParams."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device=None, generator=None):
        super().__init__()
        mk = lambda shape, s: normal_param(shape, s, dtype, device, generator)  # noqa: E731
        s_in, s_out = d_model ** -0.5, d_ff ** -0.5
        self.w_gate = mk((d_model, d_ff), s_in)
        self.w_up = mk((d_model, d_ff), s_in)
        self.w_down = mk((d_ff, d_model), s_out)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """silu in fp32, cast to the input dtype, then the gated product."""
    g = x @ p.w_gate
    u = x @ p.w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p.w_down
