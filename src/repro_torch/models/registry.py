"""Model registry: ModelConfig -> the family's Model."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import Model
from repro_torch.models.decoder import Decoder
from repro_torch.utils.device import DeviceLike, resolve_device

_LATER = {
    "moe": "16(d)", "vlm": "16(d)", "audio": "16(d)", "ssm": "16(b)/(d)",
    "hybrid": "16(b)",
}


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                seed: int = 0) -> Model:
    """The family's model with random weights on ``device`` (the card
    unless the CPU is asked for), drawn from a generator on the device
    seeded with ``seed``."""
    dev = resolve_device(device)
    if cfg.family != "dense":
        item = _LATER.get(cfg.family, "16")
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} family is not ported yet "
            f"(ROADMAP modules item {item})")
    generator = torch.Generator(device=dev).manual_seed(seed)
    return Decoder(cfg, device=dev, generator=generator)
