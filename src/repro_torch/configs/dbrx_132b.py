"""DBRX-132B — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base].

40L, d_model=6144, 48H GQA kv=8, per-expert d_ff=10752, vocab=100352.
"""
from repro_torch.configs.base import AttnPattern, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    head_dim=128,
    qkv_bias=False,
    tie_embeddings=False,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=4, n_shared=0, capacity_factor=1.25),
    attn=AttnPattern(),
    max_seq_len=32_768,
    citation="hf:databricks/dbrx-base (16-expert top-4 fine-grained MoE)",
    supports_long_context=False,
)
