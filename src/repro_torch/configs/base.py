"""Architecture descriptors for the model stack.

A copy of ``repro/configs/base.py``'s ``ModelConfig`` and the pattern /
family dataclasses it holds, with ``param_dtype`` as a ``torch.dtype``.
``reduced()`` gives the smoke variant (2 layers, d_model <= 256) that
the CPU tests run; ``num_params()`` is the analytic count, equal to the
sum over the built model's parameters. The dry-run shapes
(``InputShape`` / ``input_specs``) come with the dry-run tooling.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0           # always-on shared experts (DeepSeekMoE)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64         # N in Mamba2 / SSD
    head_dim: int = 64          # P (channels per SSM head)
    n_ssm_heads: int = 0        # derived if 0: d_inner // head_dim
    expand: int = 2             # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256            # SSD chunk length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 7        # an sLSTM block every k-th block (0 = none)
    mlstm_qk_dim_factor: float = 0.5
    mlstm_v_dim_factor: float = 1.0
    proj_factor: float = 1.3334  # sLSTM ffn up-projection factor
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class AttnPattern:
    """Per-layer attention pattern.

    sliding_window > 0 with local_to_global k > 0: layers whose index
    % (k+1) != k attend within the window, every (k+1)-th layer is
    global (gemma3's 5:1). sliding_window > 0 and local_to_global == 0:
    every layer is windowed.
    """

    sliding_window: int = 0
    local_to_global: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # derived if 0
    qkv_bias: bool = False
    tie_embeddings: bool = True
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    attn: AttnPattern = AttnPattern()
    hybrid_shared_every: int = 0
    n_encoder_layers: int = 0
    n_patch_tokens: int = 0
    n_audio_frames: int = 0
    max_seq_len: int = 8_192
    dtype: str = "bfloat16"
    citation: str = ""
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def param_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def num_params(self) -> int:
        """Analytic parameter count (equal to the built model's)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.vocab * d
        head = 0 if self.tie_embeddings else self.vocab * d
        total = emb + head + d  # final norm

        def attn_params(dm, nq, nkv, h, bias):
            p = dm * nq * h + 2 * dm * nkv * h + nq * h * dm
            if bias:
                p += (nq + 2 * nkv) * h
            return p

        def mlp_params(dm, ff):
            return 3 * dm * ff  # SwiGLU: gate, up, down

        if self.family == "ssm" and self.xlstm is not None:
            x = self.xlstm
            n_s = self.n_layers // x.slstm_every if x.slstm_every else 0
            n_m = self.n_layers - n_s
            return total + n_m * self._mlstm_params() \
                + n_s * self._slstm_params()

        if self.family in ("ssm", "hybrid") and self.ssm is not None:
            total += self.n_layers * (self._mamba2_params() + self.d_model)
            if self.family == "hybrid" and self.hybrid_shared_every:
                total += (2 * self.d_model
                          + attn_params(d, n_q, n_kv, hd, False)
                          + mlp_params(d, self.d_ff))
            return total

        per_layer = 2 * d  # two RMSNorms
        per_layer += attn_params(d, n_q, n_kv, hd, self.qkv_bias)
        if self.moe is not None:
            m = self.moe
            per_layer += d * m.n_experts            # router
            per_layer += (m.n_experts + m.n_shared) * mlp_params(d, self.d_ff)
        else:
            per_layer += mlp_params(d, self.d_ff)
        total += self.n_layers * per_layer

        if self.n_encoder_layers:
            enc_layer = (2 * d + attn_params(d, n_q, n_q, hd, False)
                         + mlp_params(d, self.d_ff))
            total += self.n_encoder_layers * enc_layer + d
            total += self.n_layers * (d + attn_params(d, n_q, n_kv, hd, False))
        return total

    def _mamba2_params(self) -> int:
        s = self.ssm
        d_inner = s.expand * self.d_model
        n_heads = s.n_ssm_heads or (d_inner // s.head_dim)
        p = self.d_model * (2 * d_inner + 2 * s.state_dim + n_heads)  # w_in
        p += s.conv_width * (d_inner + 2 * s.state_dim)               # conv_w
        p += n_heads * 3                     # dt_bias, a_log, d_skip
        p += d_inner                         # gated norm
        p += d_inner * self.d_model          # w_out
        return p

    def _mlstm_params(self) -> int:
        x = self.xlstm
        d = self.d_model
        d_inner = 2 * d
        d_qk = int(d_inner * x.mlstm_qk_dim_factor)
        d_v = int(d_inner * x.mlstm_v_dim_factor)
        nh = self.n_heads
        p = d                        # block-level RMSNorm
        p += 2 * d * d_inner         # w_up, w_z
        p += 4 * d_inner             # conv_w
        p += 2 * d_inner * d_qk      # w_q, w_k
        p += d_inner * d_v           # w_v
        p += d_inner * 2 * nh + 2 * nh  # w_if, b_if
        p += d_v                     # group norm
        p += d_v * d                 # w_out
        return p

    def _slstm_params(self) -> int:
        x = self.xlstm
        d = self.d_model
        nh = self.n_heads
        hd = d // nh
        p = d                   # block-level RMSNorm
        p += 4 * d * d          # w_in (i, f, z, o)
        p += 4 * nh * hd * hd   # block-diagonal recurrent kernels
        p += 4 * d              # biases
        p += d                  # group norm
        up = int(d * x.proj_factor)
        p += d * up * 2 + up * d  # gated ffn
        return p

    def reduced(self) -> "ModelConfig":
        """Same family, tiny dims: 2 layers, d_model <= 256, <= 4 experts."""
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, min(n_heads,
                          self.n_kv_heads if self.n_kv_heads else n_heads))
        if self.n_kv_heads == self.n_heads:
            n_kv = n_heads
        kw: Dict = dict(
            arch_id=self.arch_id + "-smoke",
            family=self.family,
            n_layers=2,
            d_model=min(self.d_model, 256),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 1024),
            head_dim=32,
            qkv_bias=self.qkv_bias,
            tie_embeddings=self.tie_embeddings,
            rope_theta=self.rope_theta,
            attn=self.attn if self.attn.sliding_window == 0 else AttnPattern(
                sliding_window=16, local_to_global=self.attn.local_to_global
            ),
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            n_patch_tokens=8 if self.n_patch_tokens else 0,
            n_audio_frames=16 if self.n_audio_frames else 0,
            max_seq_len=128,
            dtype="float32",
            citation=self.citation,
            supports_long_context=self.supports_long_context,
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                n_experts=4, top_k=min(2, self.moe.top_k),
                n_shared=min(1, self.moe.n_shared),
                capacity_factor=self.moe.capacity_factor,
            )
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2,
                                  conv_width=4, chunk=16)
        if self.xlstm is not None:
            kw["xlstm"] = XLSTMConfig(slstm_every=2, mlstm_qk_dim_factor=0.5,
                                      mlstm_v_dim_factor=1.0, chunk=16)
        if self.family == "hybrid":
            kw["hybrid_shared_every"] = 1
        return ModelConfig(**kw)
