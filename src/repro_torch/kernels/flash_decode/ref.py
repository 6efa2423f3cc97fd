"""Plain PyTorch version of the flash-decode kernel: the model's
``decode_attention`` over the ring's live slots, as
``repro/kernels/flash_decode/ref.py`` re-exports it. What the CPU path
runs, and what the CUDA kernel is held against on the card."""
from __future__ import annotations

from typing import Union

import torch

NEG_INF = -1e30

Pos = Union[int, torch.Tensor]


def pos_tensor(pos: Pos, device) -> torch.Tensor:
    """``pos`` as a 0-d int32 tensor on ``device`` (a tensor already
    there is returned as is, with no copy and no host sync)."""
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1:
            raise ValueError(f"pos must hold one position, got "
                             f"{tuple(pos.shape)}")
        return pos.reshape(()).to(device=device, dtype=torch.int32)
    return torch.tensor(int(pos), dtype=torch.int32, device=device)


def ring_live(cache_len: int, pos: Pos, device=None) -> torch.Tensor:
    """(S,) bool: ring slot i is live after the token at ``pos`` was
    written, i.e. i <= pos or the ring has wrapped (pos >= S)."""
    if device is None and isinstance(pos, torch.Tensor):
        device = pos.device
    p = pos_tensor(pos, device)
    idx = torch.arange(cache_len, device=p.device)
    return (idx <= p) | (p >= cache_len)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     valid_mask: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a cache. q (B, 1, nq, hd), caches
    (B, S, nkv, hd), valid_mask (B, S) bool -> (B, 1, nq, hd) in q's
    dtype. Scores in fp32, scaled after the dot; the probabilities are
    cast to the cache dtype before the PV product, as the reference's
    bf16 path does."""
    B, _, nq, hd = q.shape
    nkv = k_cache.shape[2]
    group = nq // nkv
    qf = q.reshape(B, nkv, group, hd).float()
    s = torch.einsum("bngh,bsnh->bngs", qf, k_cache.float()) * hd ** -0.5
    s = torch.where(valid_mask[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngs,bsnh->bngh", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, nq, hd).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: Pos) -> torch.Tensor:
    """``decode_attention`` with the live slots taken from ``pos`` (the
    position of the token just written): slot i is live when i <= pos
    or the ring has wrapped (pos >= S)."""
    valid = ring_live(k_cache.shape[1], pos, device=q.device)
    return decode_attention(q, k_cache, v_cache,
                            valid[None, :].expand(q.shape[0], -1))
