"""Generic GQA decoder: the dense family.

Layers are an ``nn.ModuleList`` with a Python list of per-layer windows
(``repro`` stacks them for ``lax.scan``; PyTorch runs eagerly, so the
loop is plain). Prefill runs every layer's attention through the
flash-attention kernel; a decode step runs it through the flash-decode
kernel against per-layer ring caches, window-length for sliding-window
layers. ``loss`` runs the layers under ``torch.utils.checkpoint`` (as
``jax.checkpoint`` around the reference's scan body) with attention
through ``flash_attention_train`` (the forward and backward kernels),
then the chunked next-token loss. MoE layers come with their slice.
"""
from __future__ import annotations

import types
from typing import Callable, Dict, List, Optional, Tuple

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
    AttnCache,
    Pos,
    init_attn_cache,
    pos_tensor,
    update_attn_cache,
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
from repro_torch.models.layers.mlp import MLP, mlp
from repro_torch.models.layers.norms import rms_norm

# prefill attention: (q, k, v, window=) -> out, causal; decode attention:
# (q, k_cache, v_cache, pos) -> out. The kernels' wrappers by default; a
# caller may pass their plain versions to run the model without them.
# Training passes a differentiable one (flash_attention_train by
# default, attention_train_ref for the plain forward and backward).
PrefillAttention = Callable[..., torch.Tensor]
DecodeAttention = Callable[..., torch.Tensor]


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        dtype = cfg.param_dtype
        self.ln1 = zeros_param((cfg.d_model,), dtype, device)
        self.attn = init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, cfg.qkv_bias, dtype,
                                   device=device, generator=generator)
        self.ln2 = zeros_param((cfg.d_model,), dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device=device,
                       generator=generator)


def _layer_forward(cfg: ModelConfig, layer: DecoderLayer, h: torch.Tensor,
                   positions: torch.Tensor, window: int,
                   attention: PrefillAttention) -> torch.Tensor:
    x = rms_norm(h, layer.ln1, cfg.norm_eps)
    q, k, v = project_qkv(layer.attn, x, positions, cfg.rope_theta)
    h = h + attention_output(layer.attn, attention(q, k, v, window=window))
    x = rms_norm(h, layer.ln2, cfg.norm_eps)
    return h + mlp(layer.mlp, x)


def _layer_tensors(layer: DecoderLayer) -> types.SimpleNamespace:
    """The layer's tensors as they are bound now, in its attribute tree.
    A checkpointed layer recomputes from these: under
    ``torch.func.functional_call`` the module's attributes are the
    caller's tensors only until the call returns, before the backward
    recomputes."""
    a, m = layer.attn, layer.mlp
    return types.SimpleNamespace(
        ln1=layer.ln1, ln2=layer.ln2,
        attn=types.SimpleNamespace(wq=a.wq, wk=a.wk, wv=a.wv, wo=a.wo,
                                   bq=a.bq, bk=a.bk, bv=a.bv),
        mlp=types.SimpleNamespace(w_gate=m.w_gate, w_up=m.w_up,
                                  w_down=m.w_down))


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer window sizes (0 = global): the local:global pattern
    (gemma3: 5 local then 1 global)."""
    w, ratio = cfg.attn.sliding_window, cfg.attn.local_to_global
    if w == 0:
        return [0] * cfg.n_layers
    if ratio == 0:
        return [w] * cfg.n_layers
    return [0 if i % (ratio + 1) == ratio else w for i in range(cfg.n_layers)]


class Decoder(Model):
    """embed (vocab, d), layers, final_norm (d,) and, untied, head
    (d, vocab): ``repro``'s ``init_decoder`` tree, in its shapes and init
    scales, drawn from ``generator`` (on ``device``)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        if cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.arch_id}: MoE layers are not ported yet (ROADMAP "
                "modules item 9)")
        super().__init__(cfg)
        dtype = cfg.param_dtype
        self.embed = init_embedding(cfg.vocab, cfg.d_model, dtype,
                                    device=device, generator=generator)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device=device, generator=generator)
            for _ in range(cfg.n_layers))
        self.final_norm = zeros_param((cfg.d_model,), dtype, device)
        self.head = None
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(
                init_embedding(cfg.vocab, cfg.d_model, dtype, device=device,
                               generator=generator).t().contiguous(),
                requires_grad=False)
        self.windows = layer_windows(cfg)

    def hidden(self, tokens: torch.Tensor,
               attention: PrefillAttention = flash_attention,
               remat: bool = False) -> torch.Tensor:
        """Embeds, runs the layers, final norm -> hidden (B, T, d). With
        ``remat`` each layer runs under ``torch.utils.checkpoint``: its
        activations are recomputed in backward, attention included."""
        cfg = self.config
        h = embed_tokens(self.embed, tokens)
        B, T = h.shape[:2]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=h.device)[None].expand(B, T)
        for layer, window in zip(self.layers, self.windows):
            if remat:
                h = checkpoint(_layer_forward, cfg, _layer_tensors(layer), h,
                               positions, window, attention,
                               use_reentrant=False)
            else:
                h = _layer_forward(cfg, layer, h, positions, window,
                                   attention)
        return rms_norm(h, self.final_norm, cfg.norm_eps)

    def loss(self, batch: Dict[str, torch.Tensor],
             attention: PrefillAttention = flash_attention_train,
             remat: bool = True):
        """(mean next-token CE, {"ce": loss, "moe_aux": 0}) of
        ``batch["tokens"]`` against ``batch["labels"]``, as
        ``repro.models.decoder.decoder_loss``."""
        h = self.hidden(batch["tokens"], attention=attention, remat=remat)
        loss = next_token_loss(h, self.embed, self.head, batch["labels"])
        return loss, {"ce": loss,
                      "moe_aux": torch.zeros((), device=loss.device)}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                attention: PrefillAttention = flash_attention
                ) -> torch.Tensor:
        """Last-position logits (B, vocab) fp32."""
        h = self.hidden(batch["tokens"], attention=attention)
        return lm_logits(h[:, -1:, :], self.embed, self.head)[:, 0]

    def init_cache(self, batch: int, length: int,
                   dtype=None) -> List[AttnCache]:
        """Per-layer ring caches: ``length`` slots for global layers,
        ``min(length, window)`` for windowed ones."""
        cfg = self.config
        dtype = dtype or cfg.param_dtype
        return [init_attn_cache(batch, min(length, w) if w > 0 else length,
                                cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
                                device=self.embed.device)
                for w in self.windows]

    @torch.no_grad()
    def decode_step(self, cache: List[AttnCache], token: torch.Tensor,
                    pos: Pos, attention: DecodeAttention = flash_decode,
                    ) -> Tuple[List[AttnCache], torch.Tensor]:
        """One decode step. token (B, 1) int, pos the position of this
        token (int or device int tensor). Writes the token's (k, v) into
        each layer's ring in place; returns (cache, logits (B, vocab)
        fp32)."""
        cfg = self.config
        B = token.shape[0]
        h = embed_tokens(self.embed, token)                      # (B, 1, d)
        p = pos_tensor(pos, h.device)
        positions = p.expand(B, 1)
        for layer, c in zip(self.layers, cache):
            x = rms_norm(h, layer.ln1, cfg.norm_eps)
            q, k, v = project_qkv(layer.attn, x, positions, cfg.rope_theta)
            update_attn_cache(c, k, v, p)
            # windowed layers use ring caches, which bound the horizon
            h = h + attention_output(layer.attn, attention(q, c.k, c.v, p))
            x = rms_norm(h, layer.ln2, cfg.norm_eps)
            h = h + mlp(layer.mlp, x)
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        return cache, lm_logits(h, self.embed, self.head)[:, 0]
