"""Decode-time caches.

Attention layers hold (k, v) ring buffers: full-length for global layers,
window-length for sliding-window layers (what makes gemma3-style
long-context decode sub-quadratic in memory). Caches are per-layer
Python lists, so layer types and cache shapes may differ within a model.

Unlike ``repro``'s functional update, ``update_attn_cache`` writes the
new token into the ring IN PLACE (and returns the same cache): a decode
step then moves one token's keys and values per layer, not a copy of
the whole cache. ``pos`` may be a device tensor throughout, so a step
never waits on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_decode.ref import Pos, pos_tensor, ring_live

__all__ = ["AttnCache", "EncDecCache", "Pos", "cache_valid_mask",
           "init_attn_cache", "pos_tensor", "update_attn_cache"]


class AttnCache(NamedTuple):
    k: torch.Tensor  # (B, S_l, n_kv, hd) — keys stored pre-rotated (RoPE applied)
    v: torch.Tensor  # (B, S_l, n_kv, hd)


class EncDecCache(NamedTuple):
    """One decoder layer's caches of the encoder-decoder: its
    self-attention ring and the cross-attention keys / values of the
    encoder output (B, S_enc, nH, hd), no RoPE."""
    self_kv: AttnCache
    cross_k: torch.Tensor
    cross_v: torch.Tensor


def init_attn_cache(batch: int, length: int, n_kv: int, head_dim: int,
                    dtype: torch.dtype, device=None) -> AttnCache:
    shape = (batch, length, n_kv, head_dim)
    return AttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))


def update_attn_cache(cache: AttnCache, k_new: torch.Tensor,
                      v_new: torch.Tensor, pos: Pos) -> AttnCache:
    """Write one token's (k, v) at ring slot ``pos % S_l``, in place.

    k_new/v_new: (B, 1, n_kv, hd); pos: scalar (lockstep batch).
    """
    S = cache.k.shape[1]
    slot = torch.remainder(pos_tensor(pos, cache.k.device), S).reshape(1).long()
    cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
    return cache


def cache_valid_mask(cache_len: int, pos: Pos, batch: int) -> torch.Tensor:
    """(B, S_l) mask of live slots after ``pos + 1`` tokens have been
    written. Slots fill in order; once the ring wraps, every slot is
    live."""
    return ring_live(cache_len, pos)[None, :].expand(batch, cache_len)
