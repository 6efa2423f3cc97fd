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
    """(q, k, v, causal, window, plain) -> out, differentiable in q, k and
    v: q (B, T, nq, hd) over k / v (B, S, nkv, hd), any T and S, causal
    or not."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, plain: bool):
        if plain:
            out, lse = attention_lse_ref(q, k, v, causal=causal,
                                         window=window)
        else:
            out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.plain = causal, window, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        bwd = attention_bwd_ref if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, dout, causal=ctx.causal,
                         window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """GQA attention as ``flash_attention`` computes it (causal by
    default, as the decoders call it; ``causal=False`` for an encoder or
    a cross attention of T positions over S keys), with the backward
    kernel behind it."""
    return FlashAttentionFn.apply(q, k, v, bool(causal), int(window), False)


def attention_train_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """The same function with the plain forward and backward, on any
    device."""
    return FlashAttentionFn.apply(q, k, v, bool(causal), int(window), True)
