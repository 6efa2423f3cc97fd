"""Whisper-small — encoder-decoder ASR backbone [arXiv:2212.04356].

12 encoder + 12 decoder layers, d_model=768, 12H MHA (kv=12), d_ff=3072,
vocab=51865. The mel-spectrogram + 2x conv1d frontend is stubbed, as in
``repro``: the model takes precomputed frame embeddings (B,
n_audio_frames, 768), 30 s of audio at 50 Hz after the conv stride-2.
"""
from repro_torch.configs.base import AttnPattern, ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    n_layers=12,             # decoder layers
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    head_dim=64,
    qkv_bias=False,
    tie_embeddings=True,
    rope_theta=10_000.0,     # decoder uses learned pos in the paper; rope here
    attn=AttnPattern(),
    n_audio_frames=1536,  # 30 s @ 50 Hz = 1500, padded to the 512-tile grid
    max_seq_len=32_768,
    citation="arXiv:2212.04356 (Whisper: robust speech recognition)",
    supports_long_context=False,
)
