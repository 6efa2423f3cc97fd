"""Model registry: ModelConfig -> the family's Model."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import Model
from repro_torch.models.decoder import Decoder
from repro_torch.models.encdec import EncDec
from repro_torch.models.xlstm import XLSTM
from repro_torch.models.zamba import Zamba
from repro_torch.utils.device import DeviceLike, resolve_device


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                seed: int = 0) -> Model:
    """The family's model with random weights on ``device`` (the card
    unless the CPU is asked for), drawn from a generator on the device
    seeded with ``seed``: the decoder for ``dense``, ``moe`` and ``vlm``
    (patches are an input), the encoder-decoder for ``audio``, the xLSTM
    for ``ssm`` with an ``XLSTMConfig``, or the Mamba2 hybrid for
    ``hybrid`` (and ``ssm`` with a Mamba2 ``SSMConfig``), in
    ``repro``'s order."""
    dev = resolve_device(device)
    if cfg.family in ("dense", "moe", "vlm"):
        family = Decoder
    elif cfg.family == "audio":
        family = EncDec
    elif cfg.family == "ssm" and cfg.xlstm is not None:
        family = XLSTM
    elif cfg.family in ("ssm", "hybrid") and cfg.ssm is not None:
        family = Zamba
    else:
        raise ValueError(f"unknown family {cfg.family!r} for {cfg.arch_id}")
    generator = torch.Generator(device=dev).manual_seed(seed)
    return family(cfg, device=dev, generator=generator)
