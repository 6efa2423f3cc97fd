"""Zamba2-style hybrid (arXiv:2411.15242): a Mamba2 backbone with ONE
shared transformer block (attention + MLP) whose weights are re-used at
every interleave point (after every ``hybrid_shared_every``-th Mamba
layer).

Prefill runs each Mamba layer's SSD through the SSD-scan kernel and the
shared block's attention through the flash-attention kernel (windowed);
a decode step carries each Mamba layer's (conv, ssm) state and gives
each shared-block call point its own ring KV cache, read by the
flash-decode kernel. ``loss`` trains: the scan through its forward and
backward kernels (``ssd_scan_train``), the shared block's attention
through flash attention's (``flash_attention_train``), each Mamba layer
and each call point of the shared block under ``torch.utils.checkpoint``
(as ``jax.checkpoint`` around the reference's ``m_body``), then the
chunked next-token loss against the tied embedding. ``repro`` stacks the
Mamba layers for ``lax.scan``; here they are an ``nn.ModuleList`` walked
by a plain loop.
"""
from __future__ import annotations

import types
from typing import Dict, List, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_chunk.ops import ssd_scan, ssd_scan_train
from repro_torch.models.base import (
    Model,
    embed_tokens,
    init_embedding,
    lm_logits,
    next_token_loss,
)
from repro_torch.models.cache import (
    AttnCache,
    Pos,
    init_attn_cache,
    pos_tensor,
    update_attn_cache,
)
from repro_torch.models.decoder import (
    DecodeAttention,
    PrefillAttention,
    layer_forward,
    layer_tensors,
)
from repro_torch.models.layers.attention import (
    attention_output,
    flash_attention,
    flash_attention_train,
    flash_decode,
    init_attention,
    project_qkv,
)
from repro_torch.models.layers.init import zeros_param
from repro_torch.models.layers.mamba2 import (
    SSD,
    Mamba2,
    Mamba2Cache,
    dims_from_config,
    init_mamba2_cache,
    mamba2_decode_step,
    mamba2_forward,
)
from repro_torch.models.layers.mlp import MLP, mlp
from repro_torch.models.layers.norms import rms_norm

ZambaCache = List[Union[Mamba2Cache, AttnCache]]


def segments(cfg: ModelConfig) -> List[int]:
    """Mamba-layer counts per segment; the shared block runs after every
    full segment (not after a trailing partial one)."""
    k = cfg.hybrid_shared_every
    if k == 0:
        return [cfg.n_layers]
    n_full = cfg.n_layers // k
    rem = cfg.n_layers - n_full * k
    return [k] * n_full + ([rem] if rem else [])


def call_points(cfg: ModelConfig) -> List[Tuple[int, int, bool]]:
    """(first layer, layer count, shared block after it) per segment."""
    out, off = [], 0
    k = cfg.hybrid_shared_every
    for seg_len in segments(cfg):
        out.append((off, seg_len, bool(k) and seg_len == k))
        off += seg_len
    return out


class MambaLayer(nn.Module):
    """The block-level RMSNorm scale and its Mamba2 cell."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.norm = zeros_param((cfg.d_model,), cfg.param_dtype, device)
        self.cell = Mamba2(dims_from_config(cfg), cfg.param_dtype,
                           device=device, generator=generator)


def _mamba_forward(cfg: ModelConfig, dims, layer, h: torch.Tensor,
                   ssd: SSD) -> torch.Tensor:
    x = rms_norm(h, layer.norm, cfg.norm_eps)
    return h + mamba2_forward(layer.cell, dims, x, ssd=ssd)


def _mamba_tensors(layer: MambaLayer) -> types.SimpleNamespace:
    """The layer's tensors as they are bound now (see
    ``decoder.layer_tensors``: a checkpointed layer recomputes from the
    tensors of the forward, the caller's under ``functional_call``)."""
    c = layer.cell
    return types.SimpleNamespace(
        norm=layer.norm,
        cell=types.SimpleNamespace(w_in=c.w_in, conv_w=c.conv_w,
                                   dt_bias=c.dt_bias, a_log=c.a_log,
                                   d_skip=c.d_skip,
                                   norm_scale=c.norm_scale, w_out=c.w_out))


class SharedBlock(nn.Module):
    """ln1, attention (no QKV bias), ln2, SwiGLU MLP: one copy, applied
    at every call point."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        dtype = cfg.param_dtype
        self.ln1 = zeros_param((cfg.d_model,), dtype, device)
        self.attn = init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, False, dtype,
                                   device=device, generator=generator)
        self.ln2 = zeros_param((cfg.d_model,), dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device=device,
                       generator=generator)


class Zamba(Model):
    """embed (vocab, d, tied), mamba (n_layers of norm + Mamba2 cell),
    final_norm (d,) and, with ``hybrid_shared_every``, the shared block:
    ``repro``'s ``init_zamba`` tree, in its shapes and init scales, drawn
    from ``generator`` (on ``device``)."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        if cfg.ssm is None:
            raise ValueError(f"{cfg.arch_id}: Zamba needs an SSMConfig")
        super().__init__(cfg)
        dtype = cfg.param_dtype
        self.embed = init_embedding(cfg.vocab, cfg.d_model, dtype,
                                    device=device, generator=generator)
        self.mamba = nn.ModuleList(
            MambaLayer(cfg, device=device, generator=generator)
            for _ in range(cfg.n_layers))
        self.final_norm = zeros_param((cfg.d_model,), dtype, device)
        self.shared = None
        if cfg.hybrid_shared_every:
            self.shared = SharedBlock(cfg, device=device, generator=generator)
        self.dims = dims_from_config(cfg)
        self.call_points = call_points(cfg)

    def hidden(self, tokens: torch.Tensor, ssd: SSD = ssd_scan,
               attention: PrefillAttention = flash_attention,
               remat: bool = False) -> torch.Tensor:
        """Embeds, runs the segments and the shared block between them,
        final norm -> hidden (B, T, d). The shared block is the decoder's
        layer (ln1, attention, ln2, SwiGLU MLP) at the config's window.
        With ``remat`` each Mamba layer and each call point of the shared
        block runs under ``torch.utils.checkpoint``: its activations are
        recomputed in backward, the scan and attention included."""
        cfg = self.config
        h = embed_tokens(self.embed, tokens)
        B, T = h.shape[:2]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=h.device)[None].expand(B, T)
        window = cfg.attn.sliding_window
        for off, seg_len, shared in self.call_points:
            for layer in self.mamba[off: off + seg_len]:
                if remat:
                    h = checkpoint(_mamba_forward, cfg, self.dims,
                                   _mamba_tensors(layer), h, ssd,
                                   use_reentrant=False)
                else:
                    h = _mamba_forward(cfg, self.dims, layer, h, ssd)
            if shared and remat:
                h, _ = checkpoint(layer_forward, cfg,
                                  layer_tensors(self.shared), h, positions,
                                  window, attention, use_reentrant=False)
            elif shared:
                h, _ = layer_forward(cfg, self.shared, h, positions, window,
                                     attention)
        return rms_norm(h, self.final_norm, cfg.norm_eps)

    def loss(self, batch: Dict[str, torch.Tensor], ssd: SSD = ssd_scan_train,
             attention: PrefillAttention = flash_attention_train,
             remat: bool = True):
        """(mean next-token CE, {"ce": loss}) of ``batch["tokens"]``
        against ``batch["labels"]`` with the tied embedding as the head,
        as ``repro.models.zamba.zamba_loss``."""
        h = self.hidden(batch["tokens"], ssd=ssd, attention=attention,
                        remat=remat)
        loss = next_token_loss(h, self.embed, None, batch["labels"])
        return loss, {"ce": loss}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], ssd: SSD = ssd_scan,
                attention: PrefillAttention = flash_attention
                ) -> torch.Tensor:
        """Last-position logits (B, vocab) fp32."""
        h = self.hidden(batch["tokens"], ssd=ssd, attention=attention)
        return lm_logits(h[:, -1:, :], self.embed, None)[:, 0]

    def init_cache(self, batch: int, length: int, dtype=None) -> ZambaCache:
        """[Mamba2 caches ... interleaved with the shared block's ring
        caches]: each call point has its own ring of ``min(length,
        window)`` slots (the weights are shared, the activations are
        not)."""
        cfg = self.config
        dtype = dtype or cfg.param_dtype
        dev = self.embed.device
        w = cfg.attn.sliding_window
        s_attn = min(length, w) if w > 0 else length
        caches: ZambaCache = []
        for _, seg_len, shared in self.call_points:
            caches.extend(init_mamba2_cache(batch, self.dims, dtype,
                                            device=dev)
                          for _ in range(seg_len))
            if shared:
                caches.append(init_attn_cache(batch, s_attn, cfg.n_kv_heads,
                                              cfg.resolved_head_dim, dtype,
                                              device=dev))
        return caches

    @torch.no_grad()
    def decode_step(self, cache: ZambaCache, token: torch.Tensor, pos: Pos,
                    attention: DecodeAttention = flash_decode,
                    ) -> Tuple[ZambaCache, torch.Tensor]:
        """One decode step. token (B, 1) int, pos the position of this
        token (int or device int tensor). Updates every cache in place;
        returns (cache, logits (B, vocab) fp32)."""
        cfg = self.config
        B = token.shape[0]
        h = embed_tokens(self.embed, token)                      # (B, 1, d)
        p = pos_tensor(pos, h.device)
        positions = p.expand(B, 1)
        ci = 0
        for off, seg_len, shared in self.call_points:
            for layer in self.mamba[off: off + seg_len]:
                x = rms_norm(h, layer.norm, cfg.norm_eps)
                _, y = mamba2_decode_step(layer.cell, self.dims, cache[ci], x)
                h = h + y
                ci += 1
            if shared:
                s, c = self.shared, cache[ci]
                x = rms_norm(h, s.ln1, cfg.norm_eps)
                q, k, v = project_qkv(s.attn, x, positions, cfg.rope_theta)
                update_attn_cache(c, k, v, p)
                h = h + attention_output(s.attn, attention(q, c.k, c.v, p))
                x = rms_norm(h, s.ln2, cfg.norm_eps)
                h = h + mlp(s.mlp, x)
                ci += 1
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        return cache, lm_logits(h, self.embed, None)[:, 0]
