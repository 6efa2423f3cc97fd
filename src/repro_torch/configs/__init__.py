"""Configurations: the paper's Table-I update sizes (``cnn_suite``) and
the model architectures the port serves, resolved by ``get_config``.

The architectures arrive with their families: this package holds the
dense decoders (Qwen2-0.5B, Qwen2.5-3B, Minitron-8B, Gemma3-1B), the
mixture-of-experts decoders (DeepSeek-MoE-16B, DBRX-132B), the Mamba2 /
shared-attention hybrid (Zamba2-1.2B), the vision-language decoder's
language backbone (LLaVA-NeXT-34B), the encoder-decoder (Whisper-small)
and the recurrent xLSTM (xLSTM-350M: mLSTM and sLSTM blocks).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.dbrx_132b import CONFIG as DBRX_132B
from repro_torch.configs.deepseek_moe_16b import CONFIG as DEEPSEEK_MOE_16B
from repro_torch.configs.gemma3_1b import CONFIG as GEMMA3_1B
from repro_torch.configs.llava_next_34b import CONFIG as LLAVA_NEXT_34B
from repro_torch.configs.minitron_8b import CONFIG as MINITRON_8B
from repro_torch.configs.qwen2_0_5b import CONFIG as QWEN2_0_5B
from repro_torch.configs.qwen2_5_3b import CONFIG as QWEN2_5_3B
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL
from repro_torch.configs.xlstm_350m import CONFIG as XLSTM_350M
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B

ARCHITECTURES: Dict[str, ModelConfig] = {
    c.arch_id: c for c in (QWEN2_0_5B, QWEN2_5_3B, MINITRON_8B, GEMMA3_1B,
                           DEEPSEEK_MOE_16B, DBRX_132B, ZAMBA2_1_2B,
                           LLAVA_NEXT_34B, WHISPER_SMALL, XLSTM_350M)
}


def get_config(arch_id: str) -> ModelConfig:
    """A registered architecture by id; ``<id>-smoke`` gives its
    ``reduced()`` variant."""
    base = arch_id[: -len("-smoke")] if arch_id.endswith("-smoke") else arch_id
    if base not in ARCHITECTURES:
        raise KeyError(f"unknown architecture {arch_id!r}; the port has "
                       f"{sorted(ARCHITECTURES)} (and their -smoke forms)")
    cfg = ARCHITECTURES[base]
    return cfg.reduced() if base != arch_id else cfg


__all__ = ["ARCHITECTURES", "ModelConfig", "get_config"]
