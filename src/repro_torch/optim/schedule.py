"""Learning-rate schedules (step -> lr), as ``repro.optim.schedule``: each
returns the rate as a 0-d fp32 tensor on the CPU, computed in fp32 as the
reference computes it under ``jit``."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(device="cpu", dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        frac = torch.clamp(_step(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return lr * (final_frac + (1 - final_frac) * cos)

    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        s = _step(step)
        warm = lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(s - warmup_steps))

    return fn
