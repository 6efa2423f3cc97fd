"""Gemma3-1B — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt].

26L, d_model=1152, 4H GQA kv=1, d_ff=6912, vocab=262144. Five consecutive
sliding-window (1024) layers per one global layer.
"""
from repro_torch.configs.base import AttnPattern, ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    head_dim=256,
    qkv_bias=False,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    attn=AttnPattern(sliding_window=1024, local_to_global=5),
    max_seq_len=131_072,
    citation="hf:google/gemma-3-1b-pt (Gemma 3 model card)",
    supports_long_context=True,  # sliding-window KV cache bounds memory
)
