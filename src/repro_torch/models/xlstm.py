"""xLSTM language model (arXiv:2405.04517): mLSTM blocks with periodic
sLSTM blocks (the paper's xLSTM[a:b] ratio), a pre-norm residual stream
and a tied embedding head.

With ``slstm_every = k`` the blocks come in segments of k - 1 mLSTM
blocks and one sLSTM block (``slstm_every = 0``: mLSTM blocks only).
``repro`` stacks each kind for ``lax.scan`` (segments outer, the mLSTM
stack inner); here the blocks are one ``nn.ModuleList`` in block order,
walked by a plain loop. A decode step carries each block's recurrent
state, so the cache is O(1) in the context length. No block reaches a
kernel: the model's only kernel is the fusion's weighted sum.

``loss`` trains: each mLSTM block runs under ``torch.utils.checkpoint``
(as ``jax.checkpoint`` around the reference's ``m_body``), then the
chunked next-token loss against the tied embedding. The sLSTM blocks
are not checkpointed: the reference's outer checkpoint keeps a
``lax.scan`` body at one segment, which a Python loop does not need, and
recomputing a block's loop over time would add its ~20 host launches a
step to a host-bound step.
"""
from __future__ import annotations

import types
from typing import Dict, List, Tuple, Union

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
from repro_torch.models.cache import Pos
from repro_torch.models.layers.init import zeros_param
from repro_torch.models.layers.norms import rms_norm
from repro_torch.models.layers.xlstm_layers import (
    MLSTM,
    SLSTM,
    MLSTMState,
    SLSTMState,
    init_mlstm_state,
    init_slstm_state,
    mlstm_decode_step,
    mlstm_dims,
    mlstm_forward,
    slstm_decode_step,
    slstm_dims,
    slstm_forward,
)

XLSTMCache = List[Union[MLSTMState, SLSTMState]]


def _segment_shape(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_segments, mlstm_per_segment): ``slstm_every = k`` gives
    segments of k - 1 mLSTM + 1 sLSTM; k = 0 one segment of mLSTM."""
    k = cfg.xlstm.slstm_every
    if k == 0:
        return 1, cfg.n_layers
    if cfg.n_layers % k:
        raise ValueError(f"{cfg.arch_id}: {cfg.n_layers} layers do not "
                         f"divide into segments of {k}")
    return cfg.n_layers // k, k - 1


def block_kinds(cfg: ModelConfig) -> List[str]:
    """"mlstm" / "slstm" per block, in block order."""
    n_seg, m_per = _segment_shape(cfg)
    seg = ["mlstm"] * m_per + (["slstm"] if cfg.xlstm.slstm_every else [])
    return seg * n_seg


class Block(nn.Module):
    """The block-level RMSNorm scale and its mLSTM or sLSTM cell."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None,
                 generator=None):
        super().__init__()
        dtype = cfg.param_dtype
        self.kind = kind
        self.norm = zeros_param((cfg.d_model,), dtype, device)
        if kind == "mlstm":
            self.cell = MLSTM(mlstm_dims(cfg), dtype, device=device,
                              generator=generator)
        else:
            self.cell = SLSTM(slstm_dims(cfg), dtype, device=device,
                              generator=generator)


def _mlstm_block(cfg: ModelConfig, dims, block, h: torch.Tensor
                 ) -> torch.Tensor:
    x = rms_norm(h, block.norm, cfg.norm_eps)
    return h + mlstm_forward(block.cell, dims, x)


def _mlstm_tensors(block: Block) -> types.SimpleNamespace:
    """The mLSTM block's tensors as they are bound now (see
    ``decoder.layer_tensors``: a checkpointed block recomputes from the
    tensors of the forward, the caller's under ``functional_call``)."""
    c = block.cell
    return types.SimpleNamespace(
        norm=block.norm,
        cell=types.SimpleNamespace(w_up=c.w_up, w_z=c.w_z, conv_w=c.conv_w,
                                   w_q=c.w_q, w_k=c.w_k, w_v=c.w_v,
                                   w_if=c.w_if, b_if=c.b_if,
                                   gn_scale=c.gn_scale, w_out=c.w_out))


class XLSTM(Model):
    """embed (vocab, d, tied), final_norm (d,) and blocks (n_layers of
    norm + cell, in block order): ``repro``'s ``init_xlstm`` tree in its
    shapes and init scales, drawn from ``generator`` (on ``device``)."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        if cfg.xlstm is None:
            raise ValueError(f"{cfg.arch_id}: XLSTM needs an XLSTMConfig")
        super().__init__(cfg)
        dtype = cfg.param_dtype
        self.embed = init_embedding(cfg.vocab, cfg.d_model, dtype,
                                    device=device, generator=generator)
        self.final_norm = zeros_param((cfg.d_model,), dtype, device)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, device=device, generator=generator)
            for kind in block_kinds(cfg))
        self.mdims = mlstm_dims(cfg)
        self.sdims = slstm_dims(cfg)

    def hidden(self, tokens: torch.Tensor, remat: bool = False
               ) -> torch.Tensor:
        """Embeds, runs every block (h + cell(rms_norm(h))), final norm
        -> hidden (B, T, d). With ``remat`` each mLSTM block runs under
        ``torch.utils.checkpoint``: its activations are recomputed in
        backward."""
        cfg = self.config
        h = embed_tokens(self.embed, tokens)
        for block in self.blocks:
            if block.kind == "mlstm" and remat:
                h = checkpoint(_mlstm_block, cfg, self.mdims,
                               _mlstm_tensors(block), h, use_reentrant=False)
            elif block.kind == "mlstm":
                h = _mlstm_block(cfg, self.mdims, block, h)
            else:
                x = rms_norm(h, block.norm, cfg.norm_eps)
                h = h + slstm_forward(block.cell, self.sdims, x)
        return rms_norm(h, self.final_norm, cfg.norm_eps)

    def loss(self, batch: Dict[str, torch.Tensor], remat: bool = True):
        """(mean next-token CE, {"ce": loss}) of ``batch["tokens"]``
        against ``batch["labels"]`` with the tied embedding as the head,
        as ``repro.models.xlstm.xlstm_loss``."""
        h = self.hidden(batch["tokens"], remat=remat)
        loss = next_token_loss(h, self.embed, None, batch["labels"])
        return loss, {"ce": loss}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Last-position logits (B, vocab) fp32."""
        h = self.hidden(batch["tokens"])
        return lm_logits(h[:, -1:, :], self.embed, None)[:, 0]

    def init_cache(self, batch: int, length: int, dtype=None) -> XLSTMCache:
        """The recurrent states per block, in block order. ``length`` is
        unused: the state is O(1) in the context length. The mLSTM conv
        tails are in ``dtype`` (the model's by default), the rest fp32."""
        del length
        dtype = dtype or self.config.param_dtype
        dev = self.embed.device
        return [init_mlstm_state(batch, self.mdims, dtype, device=dev)
                if block.kind == "mlstm"
                else init_slstm_state(batch, self.sdims, device=dev)
                for block in self.blocks]

    @torch.no_grad()
    def decode_step(self, cache: XLSTMCache, token: torch.Tensor, pos: Pos
                    ) -> Tuple[XLSTMCache, torch.Tensor]:
        """One decode step. token (B, 1) int; ``pos`` is unused (the
        position lives in the states). Updates every state in place;
        returns (cache, logits (B, vocab) fp32)."""
        del pos
        cfg = self.config
        h = embed_tokens(self.embed, token)                      # (B, 1, d)
        for block, state in zip(self.blocks, cache):
            x = rms_norm(h, block.norm, cfg.norm_eps)
            if block.kind == "mlstm":
                _, y = mlstm_decode_step(block.cell, self.mdims, state, x)
            else:
                _, y = slstm_decode_step(block.cell, self.sdims, state, x)
            h = h + y
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        return cache, lm_logits(h, self.embed, None)[:, 0]
