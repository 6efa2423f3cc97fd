"""Plain PyTorch version of the flash-attention kernel: the naive full
softmax, as ``repro/kernels/flash_attention/ref.py`` computes it. What
the CPU path runs, and what the CUDA kernel is held against on the
card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(T: int, S: int, window: int, device=None) -> torch.Tensor:
    """(T, S) bool: query t may attend key s (positions from 0 on both)."""
    qpos = torch.arange(T, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """q (B, T, nq, hd), k/v (B, S, nkv, hd) -> (B, T, nq, hd) in q's
    dtype. Upcasts to fp32 and scales q before the dot; GQA groups the
    q heads over the kv heads without copying k or v."""
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    qf = q.float().reshape(B, T, nkv, group, hd) * hd ** -0.5
    s = torch.einsum("btngh,bsnh->bngts", qf, k.float())
    mask = attention_mask(T, S, window, device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngts,bsnh->btngh", p, v.float())
    return o.reshape(B, T, nq, hd).to(q.dtype)
