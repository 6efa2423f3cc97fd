"""Shared model machinery: embeddings, the LM head, the losses, the Model
base."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.init import normal_param


def init_embedding(vocab: int, d: int, dtype: torch.dtype, device=None,
                   generator=None) -> nn.Parameter:
    return normal_param((vocab, d), d ** -0.5, dtype, device, generator)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embed[tokens]


def lm_logits(h: torch.Tensor, embed: torch.Tensor,
              head: Optional[torch.Tensor]) -> torch.Tensor:
    """h (B, T, d) -> (B, T, vocab) fp32: tied (embed.T) or separate head
    (d, vocab), in the parameter dtype, then cast."""
    logits = h @ head if head is not None else h @ embed.t()
    return logits.float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32. logits (B, T, V), labels (B, T)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


LOSS_CHUNK = 256


def _chunk_nll_sum(h: torch.Tensor, embed: torch.Tensor,
                   head: Optional[torch.Tensor], labels: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    logits = lm_logits(h, embed, head)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return ((logz - gold) * mask).sum()


def next_token_loss(h: torch.Tensor, embed: torch.Tensor,
                    head: Optional[torch.Tensor], labels: torch.Tensor,
                    chunk: int = LOSS_CHUNK) -> torch.Tensor:
    """Next-token CE without materializing full (B, T, V) logits, as
    ``repro.models.base.next_token_loss``: position t predicts
    labels[t + 1] and the last position is masked; the sequence goes in
    chunks of ``chunk`` positions (one chunk of T when T % chunk != 0),
    each chunk's logits built, consumed and rebuilt in backward
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` there), so peak
    logits memory is (B, chunk, V)."""
    B, T, _ = h.shape
    labels = labels.long()
    labels_shift = torch.cat([labels[:, 1:], labels.new_zeros((B, 1))], dim=1)
    mask = torch.ones((B, T), dtype=torch.float32, device=h.device)
    mask[:, -1] = 0.0
    if T % chunk:
        chunk = T
    s = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        s = s + checkpoint(_chunk_nll_sum, h[:, sl], embed, head,
                           labels_shift[:, sl], mask[:, sl],
                           use_reentrant=False)
    return s / torch.clamp(mask.sum(), min=1.0)


class Model(nn.Module):
    """What every family's model offers the training and serving paths; a
    family's module implements it and holds its parameters.

    loss(batch) -> (scalar loss, metrics dict)                  [train]
    prefill(batch) -> last-position logits (B, vocab) fp32
    init_cache(batch, length, dtype) -> per-layer caches
    decode_step(cache, token, pos) -> (cache, logits (B, vocab))

    ``repro``'s facade passes the parameter pytree to every call; here
    the module holds it (``state_dict()`` is the tree a federated round
    fuses), and ``forward`` is ``loss``, so that
    ``torch.func.functional_call(model, params, (batch,))`` evaluates the
    loss at a parameter tree of the caller's.
    """

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def loss(self, batch):
        raise NotImplementedError(
            f"{self.config.arch_id}: this family has no training loss in "
            "the port yet (ROADMAP modules item 6)")

    def forward(self, batch, **kwargs):
        return self.loss(batch, **kwargs)
