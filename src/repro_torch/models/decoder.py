"""Generic GQA decoder: the dense and mixture-of-experts families.

Layers are an ``nn.ModuleList`` with a Python list of per-layer windows
(``repro`` stacks them for ``lax.scan``; PyTorch runs eagerly, so the
loop is plain). Prefill runs every layer's attention through the
flash-attention kernel; a decode step runs it through the flash-decode
kernel against per-layer ring caches, window-length for sliding-window
layers. ``loss`` runs the layers under ``torch.utils.checkpoint`` (as
``jax.checkpoint`` around the reference's scan body) with attention
through ``flash_attention_train`` (the forward and backward kernels),
then the chunked next-token loss. An MoE config's layers hold an
``MoE`` in place of the MLP: prefill and the loss run its scatter path,
a decode step its dense mix, and the loss adds the summed load-balance
loss, weighted, as ``repro.models.decoder.decoder_loss`` does. A
vision-language config (LLaVA-NeXT) is the same decoder with an image
prefix: ``hidden``, ``loss`` and ``prefill`` take precomputed patch
embeddings (the vision tower and projector are stubbed, as in
``repro``) and put them before the embedded tokens; the loss drops the
patch positions before the CE. A decode step stays text-only, as in
``repro``.
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
from repro_torch.models.layers.moe import MoE, moe
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
        if cfg.moe is not None:
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.moe.n_experts,
                           cfg.moe.n_shared, dtype, device=device,
                           generator=generator)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device=device,
                           generator=generator)


def _ffn(cfg: ModelConfig, layer, x: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's MLP, or its MoE with the load-balance loss."""
    if cfg.moe is not None:
        return moe(layer.moe, x, cfg.moe.top_k, cfg.moe.capacity_factor)
    return mlp(layer.mlp, x), None


def layer_forward(cfg: ModelConfig, layer: DecoderLayer, h: torch.Tensor,
                  positions: torch.Tensor, window: int,
                  attention: PrefillAttention
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(h, the MoE layer's load-balance loss, None for an MLP layer)."""
    x = rms_norm(h, layer.ln1, cfg.norm_eps)
    q, k, v = project_qkv(layer.attn, x, positions, cfg.rope_theta)
    h = h + attention_output(layer.attn, attention(q, k, v, window=window))
    y, aux = _ffn(cfg, layer, rms_norm(h, layer.ln2, cfg.norm_eps))
    return h + y, aux


def mlp_tensors(m) -> types.SimpleNamespace:
    """An ``MLP``'s tensors as they are bound now (see
    :func:`layer_tensors`)."""
    return types.SimpleNamespace(w_gate=m.w_gate, w_up=m.w_up,
                                 w_down=m.w_down)


def attn_tensors(a) -> types.SimpleNamespace:
    """An ``Attention``'s tensors as they are bound now (see
    :func:`layer_tensors`)."""
    return types.SimpleNamespace(wq=a.wq, wk=a.wk, wv=a.wv, wo=a.wo,
                                 bq=a.bq, bk=a.bk, bv=a.bv)


def layer_tensors(layer: DecoderLayer) -> types.SimpleNamespace:
    """The layer's tensors as they are bound now, in its attribute tree.
    A checkpointed layer recomputes from these: under
    ``torch.func.functional_call`` the module's attributes are the
    caller's tensors only until the call returns, before the backward
    recomputes."""
    out = types.SimpleNamespace(ln1=layer.ln1, ln2=layer.ln2,
                                attn=attn_tensors(layer.attn))
    m = getattr(layer, "moe", None)
    if m is None:
        out.mlp = mlp_tensors(layer.mlp)
    else:
        out.moe = types.SimpleNamespace(
            router=m.router, w_gate=m.w_gate, w_up=m.w_up, w_down=m.w_down,
            shared=None if m.shared is None else mlp_tensors(m.shared))
    return out


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
               patch_embeds: Optional[torch.Tensor] = None,
               attention: PrefillAttention = flash_attention,
               remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Embeds (after the patch prefix (B, P, d), cast to the hidden
        dtype, when given), runs the layers, final norm -> (hidden (B,
        P + T, d), the layers' summed MoE load-balance loss, 0 for dense
        layers); positions run 0 .. P + T - 1 across both, as ``repro``'s
        ``decoder_hidden``. With ``remat`` each layer runs under
        ``torch.utils.checkpoint``: its activations are recomputed in
        backward, attention included."""
        cfg = self.config
        h = embed_tokens(self.embed, tokens)
        if patch_embeds is not None:
            h = torch.cat([patch_embeds.to(h.dtype), h], dim=1)
        B, T = h.shape[:2]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=h.device)[None].expand(B, T)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for layer, window in zip(self.layers, self.windows):
            if remat:
                h, a = checkpoint(layer_forward, cfg, layer_tensors(layer),
                                  h, positions, window, attention,
                                  use_reentrant=False)
            else:
                h, a = layer_forward(cfg, layer, h, positions, window,
                                     attention)
            if a is not None:
                aux = aux + a
        return rms_norm(h, self.final_norm, cfg.norm_eps), aux

    def loss(self, batch: Dict[str, torch.Tensor],
             attention: PrefillAttention = flash_attention_train,
             remat: bool = True):
        """(mean next-token CE, plus for MoE ``router_aux_weight`` x the
        summed load-balance loss / n_layers; {"ce": that loss, "moe_aux":
        the summed load-balance loss}) of ``batch["tokens"]`` against
        ``batch["labels"]``, after ``batch["patch_embeds"]`` when the
        batch has them (their positions dropped before the CE), as
        ``repro.models.decoder.decoder_loss``."""
        cfg = self.config
        patches = batch.get("patch_embeds")
        h, aux = self.hidden(batch["tokens"], patch_embeds=patches,
                             attention=attention, remat=remat)
        if patches is not None:
            h = h[:, patches.shape[1]:, :]
        loss = next_token_loss(h, self.embed, self.head, batch["labels"])
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_weight * aux / cfg.n_layers
        return loss, {"ce": loss, "moe_aux": aux}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                attention: PrefillAttention = flash_attention
                ) -> torch.Tensor:
        """Last-position logits (B, vocab) fp32, after
        ``batch["patch_embeds"]`` when the batch has them."""
        h, _ = self.hidden(batch["tokens"],
                           patch_embeds=batch.get("patch_embeds"),
                           attention=attention)
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
            # one token a sequence: an MoE layer runs its dense mix
            y, _ = _ffn(cfg, layer, rms_norm(h, layer.ln2, cfg.norm_eps))
            h = h + y
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        return cache, lm_logits(h, self.embed, self.head)[:, 0]
