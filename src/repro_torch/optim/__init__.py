"""Optimizers as plain functions over trees of tensors (as ``repro.optim``;
not ``torch.optim``, whose AdamW orders the decay and the casts
otherwise)."""
from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    sgd,
)
from repro_torch.optim.schedule import constant, cosine_decay, warmup_cosine

__all__ = [
    "Optimizer",
    "adamw",
    "sgd",
    "apply_updates",
    "global_norm",
    "clip_by_global_norm",
    "constant",
    "cosine_decay",
    "warmup_cosine",
]
