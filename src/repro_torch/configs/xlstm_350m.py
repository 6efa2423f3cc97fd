"""xLSTM-350M — sLSTM + mLSTM blocks [arXiv:2405.04517].

24 blocks, d_model=1024, 4 heads, vocab=50304. d_ff=0: xLSTM blocks carry
their own up-projections (mLSTM pre-up-projection, sLSTM gated FFN), so
there is no separate transformer MLP. The paper's xLSTM[7:1] block
ratio: every 8th block is an sLSTM block, the rest are mLSTM.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=256,
    tie_embeddings=True,
    xlstm=XLSTMConfig(
        slstm_every=8,
        mlstm_qk_dim_factor=0.5,
        mlstm_v_dim_factor=1.0,
        proj_factor=1.3334,
        chunk=256,
    ),
    max_seq_len=1_048_576,
    citation="arXiv:2405.04517 (xLSTM: Extended LSTM)",
    supports_long_context=True,  # recurrent state: O(1) in context length
)
