"""Public wrappers for the flash-attention kernels, and the differentiable
attention training runs.

``FlashAttentionFn`` is the port's counterpart of the reference model's
``blockwise_attention`` custom VJP (``repro/models/layers/attention.py``
:217-303): its forward saves q, k, v, the output and the rows'
logsumexp; its backward recomputes the probabilities from them. With
``plain=False`` both passes go through the kernels' wrappers, which
launch ``flash_attn_fwd`` / ``flash_attn_bwd`` on CUDA tensors (or
raise) and run ``attention_lse_ref`` / ``attention_bwd_ref`` on CPU
tensors; with ``plain=True`` they run the plain versions on any device
(the yardstick a caller passes explicitly).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
)

__all__ = ["FlashAttentionFn", "attention_train_ref", "flash_attention",
           "flash_attention_bwd", "flash_attention_train"]


class FlashAttentionFn(torch.autograd.Function):
    """(q, k, v, window, plain) -> out, differentiable in q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, plain: bool):
        if plain:
            out, lse = attention_lse_ref(q, k, v, window=window)
        else:
            out, lse = flash_attention(q, k, v, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.plain = window, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if ctx.plain:
            dq, dk, dv = attention_bwd_ref(q, k, v, out, lse, dout,
                                           window=ctx.window)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                             window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: int = 0) -> torch.Tensor:
    """Causal GQA attention as ``flash_attention`` computes it, with the
    backward kernel behind it (T == S)."""
    return FlashAttentionFn.apply(q, k, v, int(window), False)


def attention_train_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0) -> torch.Tensor:
    """The same function with the plain forward and backward, on any
    device."""
    return FlashAttentionFn.apply(q, k, v, int(window), True)
