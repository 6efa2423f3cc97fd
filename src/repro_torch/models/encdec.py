"""Whisper-style encoder-decoder (the audio family): ``repro``'s
``models/encdec.py`` as ``nn.Module``s.

The mel-spectrogram + conv front end is stubbed, as in ``repro``: the
input is precomputed frame embeddings (B, n_audio_frames, d). The
encoder is a bidirectional transformer over the frames (RoPE on its q /
k, attention through the flash-attention kernel's non-causal route);
each decoder layer runs causal self-attention, then cross-attention of
its positions over the encoder output (non-causal, T positions over S
frames, the same kernel), then the MLP. A decode step reads a
self-attention ring and the layer's cross-attention keys / values
(``EncDecCache``) through the flash-decode kernel: 2 launches a layer.

``repro``'s ``init_cache`` leaves the cross caches zero and its decode
step reads them as they are; nothing there fills them. Serving here
calls :meth:`EncDec.fill_cross_cache` with the encoder output first,
which writes each layer's keys and values of the encoder output
(``repro``'s ``_enc_kv``, here ``cross_kv``) into those slots in place. The
cross caches hold ``n_audio_frames`` slots, so :meth:`EncDec.encode`
takes exactly that many frames and raises on any other count.

``loss`` is ``repro``'s ``encdec_loss`` and is differentiable: its
attention is ``flash_attention_train`` (the forward and backward
kernels; the encoder's and the cross attention's backward take the
kernel's non-causal, cross-length instances), and with ``remat`` each
encoder layer and each decoder layer runs under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of both
bodies; a decoder layer's ``cross_kv`` of the encoder output runs inside
its checkpointed body, as ``_enc_kv`` does there, so the encoder's
gradient arrives through every layer's cross keys and values.
"""
from __future__ import annotations

import types
from typing import Dict, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import (
    Model,
    embed_tokens,
    init_embedding,
    lm_logits,
    next_token_loss,
)
from repro_torch.models.cache import (
    EncDecCache,
    Pos,
    init_attn_cache,
    pos_tensor,
    update_attn_cache,
)
from repro_torch.models.decoder import (
    DecodeAttention,
    PrefillAttention,
    attn_tensors,
    mlp_tensors,
)
from repro_torch.models.layers.attention import (
    Attention,
    attention_output,
    cross_attention,
    cross_decode,
    cross_kv,
    flash_attention,
    flash_attention_train,
    flash_decode,
    init_attention,
    project_qkv,
)
from repro_torch.models.layers.init import zeros_param
from repro_torch.models.layers.mlp import MLP, mlp
from repro_torch.models.layers.norms import rms_norm


def _attn(cfg: ModelConfig, n_kv: int, device, generator) -> Attention:
    return init_attention(cfg.d_model, cfg.n_heads, n_kv,
                          cfg.resolved_head_dim, False, cfg.param_dtype,
                          device=device, generator=generator)


class EncoderLayer(nn.Module):
    """ln1, attn (MHA, no bias), ln2, mlp: ``_init_enc_layer``'s tree."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        dtype = cfg.param_dtype
        self.ln1 = zeros_param((cfg.d_model,), dtype, device)
        self.attn = _attn(cfg, cfg.n_heads, device, generator)
        self.ln2 = zeros_param((cfg.d_model,), dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device=device,
                       generator=generator)


class DecoderLayer(nn.Module):
    """ln1, attn (n_kv_heads), lnx, xattn (MHA), ln2, mlp:
    ``_init_dec_layer``'s tree."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        dtype = cfg.param_dtype
        self.ln1 = zeros_param((cfg.d_model,), dtype, device)
        self.attn = _attn(cfg, cfg.n_kv_heads, device, generator)
        self.lnx = zeros_param((cfg.d_model,), dtype, device)
        self.xattn = _attn(cfg, cfg.n_heads, device, generator)
        self.ln2 = zeros_param((cfg.d_model,), dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device=device,
                       generator=generator)


def _positions(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, dtype=torch.int32, device=device)[None].expand(B, T)


def encoder_layer(cfg: ModelConfig, layer, h: torch.Tensor,
                  positions: torch.Tensor,
                  attention: PrefillAttention) -> torch.Tensor:
    """One encoder layer: bidirectional self-attention, then the MLP."""
    x = rms_norm(h, layer.ln1, cfg.norm_eps)
    q, k, v = project_qkv(layer.attn, x, positions, cfg.rope_theta)
    h = h + attention_output(layer.attn, attention(q, k, v, causal=False))
    return h + mlp(layer.mlp, rms_norm(h, layer.ln2, cfg.norm_eps))


def decoder_layer(cfg: ModelConfig, layer, h: torch.Tensor,
                  enc_out: torch.Tensor, positions: torch.Tensor,
                  attention: PrefillAttention) -> torch.Tensor:
    """One decoder layer: causal self-attention, cross-attention over the
    layer's ``cross_kv`` of the encoder output, then the MLP."""
    x = rms_norm(h, layer.ln1, cfg.norm_eps)
    q, k, v = project_qkv(layer.attn, x, positions, cfg.rope_theta)
    h = h + attention_output(layer.attn, attention(q, k, v, causal=True))
    ek, ev = cross_kv(layer.xattn, enc_out)
    h = h + cross_attention(layer.xattn, rms_norm(h, layer.lnx, cfg.norm_eps),
                            ek, ev, attention=attention)
    return h + mlp(layer.mlp, rms_norm(h, layer.ln2, cfg.norm_eps))


def enc_layer_tensors(layer: EncoderLayer) -> types.SimpleNamespace:
    """The encoder layer's tensors as they are bound now: what its
    checkpointed body recomputes from (``decoder.layer_tensors`` says
    why)."""
    return types.SimpleNamespace(ln1=layer.ln1, attn=attn_tensors(layer.attn),
                                 ln2=layer.ln2, mlp=mlp_tensors(layer.mlp))


def dec_layer_tensors(layer: DecoderLayer) -> types.SimpleNamespace:
    """The decoder layer's tensors as they are bound now."""
    return types.SimpleNamespace(
        ln1=layer.ln1, attn=attn_tensors(layer.attn), lnx=layer.lnx,
        xattn=attn_tensors(layer.xattn), ln2=layer.ln2,
        mlp=mlp_tensors(layer.mlp))


class EncDec(Model):
    """embed (vocab, d, tied head), enc_layers, enc_norm, dec_layers,
    final_norm: ``repro``'s ``init_encdec`` tree, in its shapes and init
    scales, drawn from ``generator`` (on ``device``)."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__(cfg)
        dtype = cfg.param_dtype
        self.embed = init_embedding(cfg.vocab, cfg.d_model, dtype,
                                    device=device, generator=generator)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, device=device, generator=generator)
            for _ in range(cfg.n_encoder_layers))
        self.enc_norm = zeros_param((cfg.d_model,), dtype, device)
        self.dec_layers = nn.ModuleList(
            DecoderLayer(cfg, device=device, generator=generator)
            for _ in range(cfg.n_layers))
        self.final_norm = zeros_param((cfg.d_model,), dtype, device)

    def encode(self, frames: torch.Tensor,
               attention: PrefillAttention = flash_attention,
               remat: bool = False) -> torch.Tensor:
        """frames (B, n_audio_frames, d), cast to the parameter dtype ->
        encoder output (B, n_audio_frames, d). ``attention`` (q, k, v,
        causal=) -> out: the kernel's wrapper, or its plain version, or a
        differentiable one. With ``remat`` each layer runs under
        ``torch.utils.checkpoint``."""
        cfg = self.config
        if frames.dim() != 3 or frames.shape[1:] != (cfg.n_audio_frames,
                                                     cfg.d_model):
            raise ValueError(
                f"{cfg.arch_id} encodes (B, {cfg.n_audio_frames}, "
                f"{cfg.d_model}) frames (the cross caches' length), got "
                f"{tuple(frames.shape)}")
        h = frames.to(self.embed.dtype)
        B, S = h.shape[:2]
        positions = _positions(B, S, h.device)
        for layer in self.enc_layers:
            if remat:
                h = checkpoint(encoder_layer, cfg, enc_layer_tensors(layer),
                               h, positions, attention, use_reentrant=False)
            else:
                h = encoder_layer(cfg, layer, h, positions, attention)
        return rms_norm(h, self.enc_norm, cfg.norm_eps)

    def decoder_forward(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                        attention: PrefillAttention = flash_attention,
                        remat: bool = False) -> torch.Tensor:
        """tokens (B, T) over the encoder output -> hidden (B, T, d) after
        the final norm: causal self-attention, cross-attention over
        the layer's ``cross_kv`` of the encoder output, MLP. With
        ``remat`` each layer, its ``cross_kv`` included, runs under
        ``torch.utils.checkpoint``."""
        cfg = self.config
        h = embed_tokens(self.embed, tokens)
        B, T = h.shape[:2]
        positions = _positions(B, T, h.device)
        for layer in self.dec_layers:
            if remat:
                h = checkpoint(decoder_layer, cfg, dec_layer_tensors(layer),
                               h, enc_out, positions, attention,
                               use_reentrant=False)
            else:
                h = decoder_layer(cfg, layer, h, enc_out, positions,
                                  attention)
        return rms_norm(h, self.final_norm, cfg.norm_eps)

    def loss(self, batch: Dict[str, torch.Tensor],
             attention: PrefillAttention = flash_attention_train,
             remat: bool = True):
        """(mean next-token CE, {"ce": it}) of ``batch["tokens"]`` against
        ``batch["labels"]`` given ``batch["audio_frames"]``, as
        ``repro``'s ``encdec_loss``: differentiable through
        ``attention`` (``flash_attention_train`` by default,
        ``attention_train_ref`` for the plain forward and backward), each
        layer under ``torch.utils.checkpoint`` with ``remat``."""
        enc_out = self.encode(batch["audio_frames"], attention=attention,
                              remat=remat)
        h = self.decoder_forward(batch["tokens"], enc_out,
                                 attention=attention, remat=remat)
        loss = next_token_loss(h, self.embed, None, batch["labels"])
        return loss, {"ce": loss}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                attention: PrefillAttention = flash_attention
                ) -> torch.Tensor:
        """Last-position logits (B, vocab) fp32 of ``batch["tokens"]``
        given ``batch["audio_frames"]``: 3 attention launches a layer
        pair (encoder, self, cross)."""
        enc_out = self.encode(batch["audio_frames"], attention=attention)
        h = self.decoder_forward(batch["tokens"], enc_out,
                                 attention=attention)
        return lm_logits(h[:, -1:, :], self.embed, None)[:, 0]

    def init_cache(self, batch: int, length: int,
                   dtype=None) -> List[EncDecCache]:
        """Per decoder layer: a ``length``-slot self-attention ring and
        zero cross keys / values (B, n_audio_frames, nH, hd), as
        ``repro``'s ``encdec_init_cache``; :meth:`fill_cross_cache`
        writes the encoder's into them."""
        cfg = self.config
        dtype = dtype or cfg.param_dtype
        dev = self.embed.device
        shape = (batch, cfg.n_audio_frames, cfg.n_heads,
                 cfg.resolved_head_dim)
        return [EncDecCache(
            self_kv=init_attn_cache(batch, length, cfg.n_kv_heads,
                                    cfg.resolved_head_dim, dtype, device=dev),
            cross_k=torch.zeros(shape, dtype=dtype, device=dev),
            cross_v=torch.zeros(shape, dtype=dtype, device=dev))
            for _ in range(cfg.n_layers)]

    @torch.no_grad()
    def fill_cross_cache(self, cache: List[EncDecCache],
                         enc_out: torch.Tensor) -> List[EncDecCache]:
        """Write each layer's ``cross_kv`` of ``enc_out`` (B,
        n_audio_frames, d) into its cross caches, in place; returns the
        same caches."""
        for layer, c in zip(self.dec_layers, cache):
            k, v = cross_kv(layer.xattn, enc_out)
            if k.shape != c.cross_k.shape:
                raise ValueError(f"encoder keys {tuple(k.shape)} do not fit "
                                 f"the cross cache {tuple(c.cross_k.shape)}")
            c.cross_k.copy_(k)
            c.cross_v.copy_(v)
        return cache

    @torch.no_grad()
    def decode_step(self, cache: List[EncDecCache], token: torch.Tensor,
                    pos: Pos, attention: DecodeAttention = flash_decode
                    ) -> Tuple[List[EncDecCache], torch.Tensor]:
        """One decode step: token (B, 1) at position ``pos`` (int or
        device int tensor). Writes the token's (k, v) into each layer's
        self-attention ring in place, attends the ring and the cross
        caches (every slot live) through ``attention`` (q, k, v, pos) ->
        out; returns (cache, logits (B, vocab) fp32)."""
        cfg = self.config
        B = token.shape[0]
        h = embed_tokens(self.embed, token)                      # (B, 1, d)
        p = pos_tensor(pos, h.device)
        positions = p.expand(B, 1)
        # the cross caches' last slot, on the device: every slot is live
        last = torch.full((), cfg.n_audio_frames - 1, dtype=torch.int32,
                          device=h.device)
        for layer, c in zip(self.dec_layers, cache):
            x = rms_norm(h, layer.ln1, cfg.norm_eps)
            q, k, v = project_qkv(layer.attn, x, positions, cfg.rope_theta)
            update_attn_cache(c.self_kv, k, v, p)
            h = h + attention_output(
                layer.attn, attention(q, c.self_kv.k, c.self_kv.v, p))
            h = h + cross_decode(layer.xattn,
                                 rms_norm(h, layer.lnx, cfg.norm_eps),
                                 c.cross_k, c.cross_v, last,
                                 attention=attention)
            h = h + mlp(layer.mlp, rms_norm(h, layer.ln2, cfg.norm_eps))
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        return cache, lm_logits(h, self.embed, None)[:, 0]
