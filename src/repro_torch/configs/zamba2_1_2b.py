"""Zamba2-1.2B — Mamba2 backbone + shared attention block [arXiv:2411.15242].

38 Mamba2 layers, d_model=2048; a single SHARED transformer block
(32H MHA kv=32 + MLP d_ff=8192) whose weights are reused at every
interleave point (every 6th Mamba layer), ssm_state=64, vocab=32000.
"""
from repro_torch.configs.base import AttnPattern, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    head_dim=64,
    qkv_bias=False,
    tie_embeddings=True,
    rope_theta=10_000.0,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk=256),
    hybrid_shared_every=6,
    attn=AttnPattern(sliding_window=2048),  # shared block attends windowed
    max_seq_len=1_048_576,
    citation="arXiv:2411.15242 (Zamba2 suite: SSM-hybrid)",
    supports_long_context=True,  # Mamba2 state + windowed shared attention
)
