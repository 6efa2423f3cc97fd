"""Qwen2.5-3B — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family].

36L, d_model=2048, 16H GQA kv=2, d_ff=11008, vocab=151936.
"""
from repro_torch.configs.base import AttnPattern, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    attn=AttnPattern(),
    max_seq_len=32_768,
    citation="hf:Qwen/Qwen2.5-0.5B (Qwen2.5 series model card)",
    supports_long_context=False,
)
