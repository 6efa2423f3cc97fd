"""DeepSeekMoE-16B — fine-grained experts, 2 shared + 64 routed top-6
[arXiv:2401.06066].

28L, d_model=2048, 16H MHA (kv=16), per-expert d_ff=1408, vocab=102400.
"""
from repro_torch.configs.base import AttnPattern, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    head_dim=128,
    qkv_bias=False,
    tie_embeddings=False,
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, capacity_factor=1.25),
    attn=AttnPattern(),
    max_seq_len=16_384,
    citation="arXiv:2401.06066 (DeepSeekMoE: fine-grained expert specialization)",
    supports_long_context=False,
)
