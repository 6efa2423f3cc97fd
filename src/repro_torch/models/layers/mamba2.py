"""Mamba2 (SSD — state-space duality) block.

Chunked SSD for prefill and training: the intra-chunk decay-masked C·Bᵀ
term and the inter-chunk state recurrence, both inside the SSD kernel
(its wrapper by default; a caller may pass the plain version, and
training passes ``ssd_scan_train``, the forward and backward kernels
behind an autograd function). An O(1)-state recurrent
step for decode, in plain PyTorch (``repro`` has no decode kernel
either).

Follows ``repro/models/layers/mamba2.py``: the minimal SSD formulation of
Dao & Gu (arXiv:2405.21060) with a single B/C group shared across heads
(ngroups=1), causal depthwise conv on (x, B, C), softplus dt with a
per-head bias, and a gated group norm.

Unlike ``repro``'s functional step, ``mamba2_decode_step`` updates the
cache's ``conv`` window and ``state`` IN PLACE (and returns the same
cache), as ``models/cache.update_attn_cache`` does for the rings.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels.ssd_chunk.ops import ssd_scan
from repro_torch.models.layers.init import normal_param
from repro_torch.models.layers.norms import at_least_fp32, group_norm

# (lam, Bm, Cm, xdt, chunk=) -> y (B, T, H, P) fp32: the kernel's wrapper
# by default; ``kernels/ssd_chunk/ref.ssd_scan_ref`` is the plain version.
# Training passes a differentiable one (``ops.ssd_scan_train``, or
# ``ops.ssd_scan_train_ref`` for the plain forward and backward).
SSD = Callable[..., torch.Tensor]


class Mamba2Dims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int
    state: int
    conv_width: int
    chunk: int


def dims_from_config(cfg) -> Mamba2Dims:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = s.n_ssm_heads or (d_inner // s.head_dim)
    return Mamba2Dims(
        d_model=cfg.d_model,
        d_inner=d_inner,
        n_heads=n_heads,
        head_dim=s.head_dim,
        state=s.state_dim,
        conv_width=s.conv_width,
        chunk=s.chunk,
    )


class Mamba2(nn.Module):
    """w_in (d, 2·d_inner + 2N + H), conv_w (W, d_inner + 2N), dt_bias /
    a_log / d_skip (H,) kept in fp32 whatever the model dtype,
    norm_scale (d_inner,) and w_out (d_inner, d): ``repro``'s
    Mamba2Params in its shapes and init scales."""

    def __init__(self, dims: Mamba2Dims, dtype: torch.dtype, device=None,
                 generator=None):
        super().__init__()
        d, di, H, N, W = (dims.d_model, dims.d_inner, dims.n_heads,
                          dims.state, dims.conv_width)
        mk = lambda shape, s: normal_param(shape, s, dtype, device, generator)  # noqa: E731
        fp32 = lambda v: nn.Parameter(  # noqa: E731
            torch.full((H,), v, dtype=torch.float32, device=device),
            requires_grad=False)
        self.w_in = mk((d, 2 * di + 2 * N + H), d ** -0.5)
        self.conv_w = mk((W, di + 2 * N), 0.3)
        self.dt_bias = fp32(-3.0)   # softplus ~= 0.05
        self.a_log = fp32(0.0)      # A = -exp(0) = -1
        self.d_skip = fp32(1.0)
        self.norm_scale = nn.Parameter(
            torch.zeros((di,), dtype=dtype, device=device),
            requires_grad=False)
        self.w_out = mk((di, d), di ** -0.5)


def _split_in(proj: torch.Tensor, dims: Mamba2Dims):
    di, N = dims.d_inner, dims.state
    z = proj[..., :di]
    xbc = proj[..., di: 2 * di + 2 * N]
    dt = proj[..., 2 * di + 2 * N:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time: xbc (B, T, C), conv_w (W, C);
    the taps summed in the input dtype, then silu in fp32."""
    W = conv_w.shape[0]
    T = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = torch.zeros_like(xbc)
    for k in range(W):
        out = out + pad[:, k: k + T, :] * conv_w[k]
    return F.silu(at_least_fp32(out)).to(xbc.dtype)


def _gate_out(p: Mamba2, dims: Mamba2Dims, y: torch.Tensor, z: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """Gated group norm and the out projection: y (B, T, d_inner)."""
    y = y.to(dtype) * F.silu(z.float()).to(dtype)
    y = group_norm(y, p.norm_scale, n_groups=dims.n_heads)
    return y @ p.w_out


def mamba2_forward(p: Mamba2, dims: Mamba2Dims, x: torch.Tensor,
                   ssd: SSD = ssd_scan) -> torch.Tensor:
    """x (B, T, d_model) -> (B, T, d_model). The SSD runs in chunks of
    ``dims.chunk`` steps, or of T when that does not divide T."""
    B, T, _ = x.shape
    di, H, P, N = dims.d_inner, dims.n_heads, dims.head_dim, dims.state

    proj = x @ p.w_in
    z, xbc, dt_raw = _split_in(proj, dims)
    xbc = _causal_conv(xbc, p.conv_w)
    xs = xbc[..., :di].reshape(B, T, H, P)
    Bm = xbc[..., di: di + N].float().contiguous()            # (B, T, N)
    Cm = xbc[..., di + N:].float().contiguous()               # (B, T, N)
    dt = F.softplus(dt_raw.float() + p.dt_bias)               # (B, T, H)
    A = -torch.exp(p.a_log)                                   # (H,)
    lam = dt * A                                              # log-decay (<0)
    xdt = xs.float() * dt[..., None]                          # (B, T, H, P)

    y = ssd(lam, Bm, Cm, xdt, chunk=dims.chunk)               # (B, T, H, P)
    y = y + xs.float() * p.d_skip[None, None, :, None]
    return _gate_out(p, dims, y.reshape(B, T, di), z, x.dtype)


# -- decode -----------------------------------------------------------------


class Mamba2Cache(NamedTuple):
    conv: torch.Tensor   # (B, W-1, d_inner + 2N) last inputs
    state: torch.Tensor  # (B, H, N, P) fp32


def init_mamba2_cache(batch: int, dims: Mamba2Dims, dtype: torch.dtype,
                      device=None) -> Mamba2Cache:
    return Mamba2Cache(
        conv=torch.zeros((batch, dims.conv_width - 1,
                          dims.d_inner + 2 * dims.state), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, dims.n_heads, dims.state, dims.head_dim),
                          dtype=torch.float32, device=device),
    )


def mamba2_decode_step(p: Mamba2, dims: Mamba2Dims, cache: Mamba2Cache,
                       x: torch.Tensor) -> Tuple[Mamba2Cache, torch.Tensor]:
    """x (B, 1, d_model), one token -> (cache, y (B, 1, d_model)). The
    cache's conv window and state are updated in place."""
    B = x.shape[0]
    di, H, P, N = dims.d_inner, dims.n_heads, dims.head_dim, dims.state
    proj = x @ p.w_in
    z, xbc_new, dt_raw = _split_in(proj, dims)
    window = torch.cat([cache.conv, xbc_new], dim=1)          # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", window, p.conv_w)[:, None, :]
    xbc = F.silu(conv_out.float()).to(x.dtype)

    xs = xbc[..., :di].reshape(B, H, P)
    Bm = xbc[:, 0, di: di + N].float()                        # (B, N)
    Cm = xbc[:, 0, di + N:].float()
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)         # (B, H)
    dec = torch.exp(dt * -torch.exp(p.a_log))                 # (B, H)
    xdt = xs.float() * dt[..., None]                          # (B, H, P)

    state = cache.state
    state.mul_(dec[..., None, None]).add_(
        torch.einsum("bn,bhp->bhnp", Bm, xdt))
    y = torch.einsum("bn,bhnp->bhp", Cm, state)
    y = y + xs.float() * p.d_skip[None, :, None]
    out = _gate_out(p, dims, y.reshape(B, 1, di), z, x.dtype)
    cache.conv.copy_(window[:, 1:, :])
    return cache, out
