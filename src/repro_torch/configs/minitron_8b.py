"""Minitron-8B — width/depth-pruned Nemotron-4 [arXiv:2407.14679].

Dense decoder, 32L, d_model=4096, 32 query heads with GQA (8 KV heads),
d_ff=16384, vocab=256000.
"""
from repro_torch.configs.base import AttnPattern, ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256000,
    head_dim=128,
    qkv_bias=False,
    tie_embeddings=False,
    rope_theta=10_000.0,
    attn=AttnPattern(),
    max_seq_len=32_768,
    citation="arXiv:2407.14679 (Minitron: compact LMs via pruning+distillation)",
    supports_long_context=False,
)
