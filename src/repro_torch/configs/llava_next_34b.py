"""LLaVA-NeXT-34B backbone — anyres tiling VLM
[hf:llava-hf/llava-v1.6-mistral-7b-hf family, 34B variant].

VLM: the language backbone only (60L, d_model=7168, 56H GQA kv=8,
d_ff=20480, vocab=64000). The SigLIP/ViT tower + projector are stubbed,
as in ``repro``: the decoder takes precomputed patch embeddings of shape
(B, n_patch_tokens, d_model); anyres tiling yields up to 2880 patch
tokens (5 tiles x 576).
"""
from repro_torch.configs.base import AttnPattern, ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    qkv_bias=False,
    tie_embeddings=False,
    rope_theta=5_000_000.0,
    attn=AttnPattern(),
    # anyres: 5 tiles x 512 post-pool patch tokens; 2560 keeps the combined
    # (patches + text) sequence divisible by the 512-token attention tiles
    n_patch_tokens=2560,
    max_seq_len=32_768,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf (LLaVA-NeXT anyres)",
    supports_long_context=False,
)
