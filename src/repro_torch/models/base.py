"""Shared model machinery: embeddings, the LM head, the Model base."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

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


def next_token_loss(*args, **kwargs):
    raise NotImplementedError(
        "next_token_loss comes with the training slice (ROADMAP modules "
        "item 6)")


class Model(nn.Module):
    """What every family's model offers the serving path; a family's
    module implements it and holds its parameters.

    prefill(batch) -> last-position logits (B, vocab) fp32
    init_cache(batch, length, dtype) -> per-layer caches
    decode_step(cache, token, pos) -> (cache, logits (B, vocab))

    ``repro``'s facade passes the parameter pytree to every call; here
    the module holds it (``state_dict()`` is the tree a federated round
    fuses).
    """

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def loss(self, batch):
        raise NotImplementedError(
            "training losses come with the training slice (ROADMAP modules "
            "item 6)")
