"""Grouped-query attention: flash prefill and cached decode.

``repro``'s model computes attention in pure jnp (``blockwise_attention``
for prefill, ``decode_attention`` for a decode step) and checks its
Pallas kernels against that math. Here the kernels take those places:
prefill goes through the flash-attention kernel's wrapper and a decode
step through the flash-decode kernel's, each running its plain version
on CPU tensors. ``decode_attention`` stays as the plain decode path.

Training (``blockwise_attention``'s custom VJP) and ``cross_attention``
come with their slices; the sharding hooks are the identity on one card
and are dropped.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import NEG_INF, decode_attention
from repro_torch.models.layers.init import normal_param, zeros_param
from repro_torch.models.layers.rope import apply_rope

__all__ = ["NEG_INF", "Attention", "attention_output", "decode_attention",
           "flash_attention", "flash_decode", "init_attention", "project_qkv"]


class Attention(nn.Module):
    """wq (d, nq, hd), wk / wv (d, nkv, hd), wo (nq, hd, d) and, with
    ``qkv_bias``, bq (nq, hd), bk / bv (nkv, hd): ``repro``'s AttnParams
    in its shapes."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 qkv_bias: bool, dtype: torch.dtype, device=None,
                 generator=None):
        super().__init__()
        s_in = d_model ** -0.5
        s_out = (n_heads * head_dim) ** -0.5
        mk = lambda shape, s: normal_param(shape, s, dtype, device, generator)  # noqa: E731
        self.wq = mk((d_model, n_heads, head_dim), s_in)
        self.wk = mk((d_model, n_kv, head_dim), s_in)
        self.wv = mk((d_model, n_kv, head_dim), s_in)
        self.wo = mk((n_heads, head_dim, d_model), s_out)
        if qkv_bias:
            self.bq = zeros_param((n_heads, head_dim), dtype, device)
            self.bk = zeros_param((n_kv, head_dim), dtype, device)
            self.bv = zeros_param((n_kv, head_dim), dtype, device)
        else:
            self.bq = self.bk = self.bv = None


def init_attention(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   qkv_bias: bool, dtype: torch.dtype, device=None,
                   generator=None) -> Attention:
    return Attention(d_model, n_heads, n_kv, head_dim, qkv_bias, dtype,
                     device=device, generator=generator)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, T, d) x (d, n, h) -> (B, T, n, h), one matrix product."""
    d, n, h = w.shape
    return (x @ w.reshape(d, n * h)).view(*x.shape[:-1], n, h)


def project_qkv(p: Attention, x: torch.Tensor, positions: torch.Tensor,
                rope_theta: float):
    """x (B, T, d) -> q (B, T, nq, hd), k / v (B, T, nkv, hd), rope
    applied to q and k."""
    q, k, v = _project(x, p.wq), _project(x, p.wk), _project(x, p.wv)
    if p.bq is not None:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v.contiguous()


def attention_output(p: Attention, attn: torch.Tensor) -> torch.Tensor:
    """(B, T, nq, hd) @ wo -> (B, T, d)."""
    nq, hd, d = p.wo.shape
    B, T = attn.shape[:2]
    return attn.reshape(B, T, nq * hd) @ p.wo.reshape(nq * hd, d)
