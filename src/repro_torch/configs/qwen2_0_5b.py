"""Qwen2-0.5B — GQA with QKV bias [arXiv:2407.10671].

24L, d_model=896, 14H GQA kv=2, d_ff=4864, vocab=151936.
"""
from repro_torch.configs.base import AttnPattern, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    attn=AttnPattern(),
    max_seq_len=32_768,
    citation="arXiv:2407.10671 (Qwen2 technical report)",
    supports_long_context=False,
)
