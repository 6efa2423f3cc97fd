"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise-
parallel) and sLSTM (scalar memory, block-diagonal recurrence, a loop
over time).

Follows ``repro/models/layers/xlstm_layers.py`` form for form: the mLSTM
runs in the chunkwise formulation (intra-chunk parallel tiles and an
inter-chunk state carry) with the paper's log-domain stabilizer ``m``,
started at 0; the sLSTM computes its input pre-activations for every
time step in one fp32 product, then loops over time on the device with
all heads at once. Neither reaches a kernel of the port: ``repro`` has
no Pallas kernel for either cell.

Products in this file keep the reference's operand dtypes: the model's
dtype for the projections, fp32 for the gates, the recurrences and the
sLSTM's input pre-activations (``at_least_fp32``: the forward of a
float64 tree runs in float64 throughout). The three-operand
contractions of the reference are written as a product and one batched
matmul each, never through ``torch.einsum``'s planner, which may build
a (B, L, L, nh, hv) intermediate.

Unlike the reference's functional steps, ``mlstm_decode_step`` and
``slstm_decode_step`` update the state's tensors IN PLACE (and return
the same state), as ``mamba2_decode_step`` does. Nothing else here
writes in place, so the forward path (``mlstm_forward``,
``slstm_forward``) is differentiable, the fp32 gate leaves included.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.layers.init import normal_param, zeros_param
from repro_torch.models.layers.mamba2 import _causal_conv
from repro_torch.models.layers.norms import at_least_fp32, group_norm

NEG = -1e30

# ===========================================================================
# mLSTM
# ===========================================================================


class MLSTMDims(NamedTuple):
    d_model: int
    d_inner: int
    d_qk: int
    d_v: int
    n_heads: int
    chunk: int

    @property
    def h_qk(self) -> int:
        return self.d_qk // self.n_heads

    @property
    def h_v(self) -> int:
        return self.d_v // self.n_heads


def mlstm_dims(cfg) -> MLSTMDims:
    x = cfg.xlstm
    d_inner = 2 * cfg.d_model
    return MLSTMDims(
        d_model=cfg.d_model,
        d_inner=d_inner,
        d_qk=int(d_inner * x.mlstm_qk_dim_factor),
        d_v=int(d_inner * x.mlstm_v_dim_factor),
        n_heads=cfg.n_heads,
        chunk=x.chunk,
    )


class MLSTM(nn.Module):
    """w_up / w_z (d, d_inner), conv_w (4, d_inner), w_q / w_k (d_inner,
    d_qk), w_v (d_inner, d_v), w_if (d_inner, 2 nh) and b_if (2 nh,) kept
    in fp32 whatever the model dtype (the input and forget gates'
    pre-activations; the forget half of b_if starts at 3.0), gn_scale
    (d_v,) and w_out (d_v, d): ``repro``'s MLSTMParams in its shapes and
    init scales."""

    def __init__(self, dims: MLSTMDims, dtype: torch.dtype, device=None,
                 generator=None):
        super().__init__()
        d, di, nh = dims.d_model, dims.d_inner, dims.n_heads
        mk = lambda shape, s, dt=dtype: normal_param(  # noqa: E731
            shape, s, dt, device, generator)
        self.w_up = mk((d, di), d ** -0.5)
        self.w_z = mk((d, di), d ** -0.5)
        self.conv_w = mk((4, di), 0.3)
        self.w_q = mk((di, dims.d_qk), di ** -0.5)
        self.w_k = mk((di, dims.d_qk), di ** -0.5)
        self.w_v = mk((di, dims.d_v), di ** -0.5)
        self.w_if = mk((di, 2 * nh), di ** -0.5, torch.float32)
        # forget-gate bias init positive: long memory at init
        b_if = torch.zeros((2 * nh,), dtype=torch.float32, device=device)
        b_if[nh:] = 3.0
        self.b_if = nn.Parameter(b_if, requires_grad=False)
        self.gn_scale = zeros_param((dims.d_v,), dtype, device)
        self.w_out = mk((dims.d_v, d), dims.d_v ** -0.5)


def _gates(p: MLSTM, nh: int, xc: torch.Tensor):
    """(i_raw, f_log), each (..., nh) fp32: xc in fp32 times w_if plus
    b_if, the forget half through log-sigmoid."""
    gates = at_least_fp32(xc) @ p.w_if + p.b_if
    return gates[..., :nh], F.logsigmoid(gates[..., nh:])


def _mlstm_qkvif(p: MLSTM, dims: MLSTMDims, x: torch.Tensor):
    """x (B, T, d) -> q, k (B, T, nh, h_qk), v (B, T, nh, h_v), i_raw,
    f_log (B, T, nh) fp32, z and xb (B, T, d_inner). q and k come from
    the convolved branch, v from the branch before the conv."""
    B, T, _ = x.shape
    nh = dims.n_heads
    xb = x @ p.w_up
    z = x @ p.w_z
    xc = _causal_conv(xb, p.conv_w)      # taps summed in x's dtype, silu
    q = (xc @ p.w_q).reshape(B, T, nh, dims.h_qk)
    k = (xc @ p.w_k).reshape(B, T, nh, dims.h_qk)
    v = (xb @ p.w_v).reshape(B, T, nh, dims.h_v)
    i_raw, f_log = _gates(p, nh, xc)
    return q, k, v, i_raw, f_log, z, xb


def _mlstm_out(p: MLSTM, dims: MLSTMDims, h: torch.Tensor, z: torch.Tensor
               ) -> torch.Tensor:
    """h (B, T, d_v) in the model dtype -> group norm per head, times
    silu(z) (its first d_v channels), out projection."""
    h = group_norm(h, p.gn_scale, n_groups=dims.n_heads)
    h = h * F.silu(at_least_fp32(z)).to(h.dtype)[..., : h.shape[-1]]
    return h @ p.w_out


def _mlstm_chunk(q, k, v, i, f, C, n, m, causal):
    """One chunk of the scan, heads leading: q, k (B, nh, L, h_qk) fp32
    (q scaled), v (B, nh, L, h_v), i, f (B, nh, L); the carry C (B, nh,
    h_qk, h_v), n (B, nh, h_qk), m (B, nh). Returns (C, n, m, h (B, nh,
    L, h_v))."""
    b = torch.cumsum(f, dim=-1)                         # (B, nh, L)
    # intra-chunk log weights D[t, s] = b_t - b_s + i_s  (s <= t)
    D = b[..., :, None] - b[..., None, :] + i[..., None, :]
    D = torch.where(causal, D, torch.full_like(D, NEG))
    d_state = b + m[..., None]                          # inter-chunk term
    m_t = torch.maximum(D.amax(dim=-1), d_state)        # (B, nh, L)
    w = torch.exp(D - m_t[..., None])                   # (B, nh, t, s)
    sc = torch.exp(d_state - m_t)                       # (B, nh, L)
    qk = q @ k.transpose(-1, -2)                        # (B, nh, t, s)
    num = (qk * w) @ v + (q @ C) * sc[..., None]
    nvec = w @ k + n[..., None, :] * sc[..., None]
    den = torch.maximum((q * nvec).sum(dim=-1).abs(), torch.exp(-m_t))
    h = num / den[..., None]

    # carry update (log domain)
    btot = b[..., -1]
    g = b[..., -1:] - b + i                             # decay-to-end + i
    m_new = torch.maximum(m + btot, g.amax(dim=-1))
    wC = torch.exp(g - m_new[..., None])                # (B, nh, L)
    decay = torch.exp(m + btot - m_new)
    kw = k * wC[..., None]
    C = C * decay[..., None, None] + kw.transpose(-1, -2) @ v
    n = n * decay[..., None] + kw.sum(dim=-2)
    return C, n, m_new, h


def mlstm_forward(p: MLSTM, dims: MLSTMDims, x: torch.Tensor
                  ) -> torch.Tensor:
    """Chunkwise-parallel mLSTM. x (B, T, d) -> (B, T, d). Chunks of
    ``L = min(chunk, T)`` steps, and ONE chunk of T when T % L != 0 (the
    reference's rule: the stabilizer makes the numerics depend on the
    chunking). The carry starts at C = n = 0, m = 0."""
    B, T, _ = x.shape
    nh, hq, hv = dims.n_heads, dims.h_qk, dims.h_v
    L = min(dims.chunk, T)
    if T % L:
        L = T
    q, k, v, i_raw, f_log, z, _ = _mlstm_qkvif(p, dims, x)
    heads = lambda a: a.transpose(1, 2)   # noqa: E731  (B, nh, T, ...)
    qf = heads(at_least_fp32(q) * hq ** -0.5)
    kf, vf = heads(at_least_fp32(k)), heads(at_least_fp32(v))
    ih, fh = heads(i_raw), heads(f_log)
    f32 = dict(dtype=qf.dtype, device=x.device)
    C = torch.zeros((B, nh, hq, hv), **f32)
    n = torch.zeros((B, nh, hq), **f32)
    m = torch.zeros((B, nh), **f32)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    hs = []
    for c0 in range(0, T, L):
        sl = slice(c0, c0 + L)
        C, n, m, h = _mlstm_chunk(qf[:, :, sl], kf[:, :, sl], vf[:, :, sl],
                                  ih[..., sl], fh[..., sl], C, n, m, causal)
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(B, T, nh * hv)
    return _mlstm_out(p, dims, h.to(x.dtype), z)


class MLSTMState(NamedTuple):
    C: torch.Tensor      # (B, nh, h_qk, h_v) matrix memory (scaled by exp(-m))
    n: torch.Tensor      # (B, nh, h_qk) normalizer
    m: torch.Tensor      # (B, nh) running log stabilizer
    conv: torch.Tensor   # (B, 3, d_inner) conv tail, in the model dtype


def init_mlstm_state(batch: int, dims: MLSTMDims, dtype: torch.dtype,
                     device=None) -> MLSTMState:
    nh = dims.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        C=torch.zeros((batch, nh, dims.h_qk, dims.h_v), **f32),
        n=torch.zeros((batch, nh, dims.h_qk), **f32),
        m=torch.zeros((batch, nh), **f32),
        conv=torch.zeros((batch, 3, dims.d_inner), dtype=dtype, device=device),
    )


def mlstm_decode_step(p: MLSTM, dims: MLSTMDims, state: MLSTMState,
                      x: torch.Tensor) -> Tuple[MLSTMState, torch.Tensor]:
    """One recurrent step. x (B, 1, d) -> (state, (B, 1, d)); the
    state's tensors are updated in place. The conv here is one
    contraction over the 4-slot window, summed in fp32 and rounded once
    to the model dtype, where the chunked forward rounds after each tap,
    as in the reference (the two differ in bf16 only)."""
    B = x.shape[0]
    nh, hq, hv = dims.n_heads, dims.h_qk, dims.h_v
    xb = x @ p.w_up
    z = x @ p.w_z
    window = torch.cat([state.conv, xb], dim=1)          # (B, 4, d_inner)
    conv = (window.float() * p.conv_w.float()).sum(dim=1, keepdim=True)
    xc = F.silu(conv.to(x.dtype).float()).to(x.dtype)
    q = (xc @ p.w_q).reshape(B, nh, hq)
    k = (xc @ p.w_k).reshape(B, nh, hq).float()
    v = (xb @ p.w_v).reshape(B, nh, hv).float()
    i_raw, f_log = _gates(p, nh, xc[:, 0])

    m_new = torch.maximum(f_log + state.m, i_raw)
    i = torch.exp(i_raw - m_new)
    f = torch.exp(f_log + state.m - m_new)
    qf = q.float() * hq ** -0.5
    state.C.mul_(f[..., None, None]).add_(
        i[..., None, None] * (k[..., :, None] * v[..., None, :]))
    state.n.mul_(f[..., None]).add_(i[..., None] * k)
    state.m.copy_(m_new)
    state.conv.copy_(window[:, 1:])
    num = (qf[..., None, :] @ state.C)[..., 0, :]         # (B, nh, hv)
    den = torch.maximum((qf * state.n).sum(dim=-1).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, nh * hv).to(x.dtype)
    return state, _mlstm_out(p, dims, h, z)


# ===========================================================================
# sLSTM
# ===========================================================================


class SLSTMDims(NamedTuple):
    d_model: int
    n_heads: int
    up: int

    @property
    def h(self) -> int:
        return self.d_model // self.n_heads


def slstm_dims(cfg) -> SLSTMDims:
    return SLSTMDims(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        up=int(cfg.d_model * cfg.xlstm.proj_factor),
    )


class SLSTM(nn.Module):
    """w_in (d, 4d) for the i, f, z, o pre-activations, r (nh, 4, hd, hd)
    the block-diagonal recurrence and b (4d,) kept in fp32 whatever the
    model dtype (the forget quarter of b starts at 3.0), gn_scale (d,),
    and the gated FFN w_gate / w_upp (d, up), w_down (up, d):
    ``repro``'s SLSTMParams in its shapes and init scales."""

    def __init__(self, dims: SLSTMDims, dtype: torch.dtype, device=None,
                 generator=None):
        super().__init__()
        d, nh, hd = dims.d_model, dims.n_heads, dims.h
        mk = lambda shape, s, dt=dtype: normal_param(  # noqa: E731
            shape, s, dt, device, generator)
        self.w_in = mk((d, 4 * d), d ** -0.5)
        self.r = mk((nh, 4, hd, hd), hd ** -0.5, torch.float32)
        b = torch.zeros((4 * d,), dtype=torch.float32, device=device)
        b[d: 2 * d] = 3.0     # forget-gate bias positive
        self.b = nn.Parameter(b, requires_grad=False)
        self.gn_scale = zeros_param((d,), dtype, device)
        self.w_gate = mk((d, dims.up), d ** -0.5)
        self.w_upp = mk((d, dims.up), d ** -0.5)
        self.w_down = mk((dims.up, d), dims.up ** -0.5)


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, nh, hd) fp32
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor


def init_slstm_state(batch: int, dims: SLSTMDims, device=None,
                     dtype: torch.dtype = torch.float32) -> SLSTMState:
    shape = (batch, dims.n_heads, dims.h)
    z = lambda v: torch.full(shape, v, dtype=dtype,  # noqa: E731
                             device=device)
    return SLSTMState(c=z(0.0), n=z(1e-6), m=z(0.0), h=z(0.0))


def _recurrent(r: torch.Tensor) -> torch.Tensor:
    """r (nh, 4, hd, hd) as (nh, hd, 4 hd): one batched product per step
    gives every gate's recurrent term for all heads."""
    nh, _, hd, _ = r.shape
    return r.permute(0, 2, 1, 3).reshape(nh, hd, 4 * hd)


def _slstm_cell(r2: torch.Tensor, state: SLSTMState,
                pre: torch.Tensor) -> SLSTMState:
    """pre (B, 4d) fp32: the input pre-activation (x w_in + b). Adds the
    recurrence, ``einsum("bhx,hgxy->bghy", h, r)`` as one batched
    product over heads (``r2 = _recurrent(r)``), and advances the cell
    one step (a new state; the old one is untouched)."""
    B = pre.shape[0]
    nh, hd = state.h.shape[1:]
    rec = torch.bmm(state.h.transpose(0, 1), r2)        # (nh, B, 4 hd)
    g = pre.view(B, 4, nh, hd) + rec.view(nh, B, 4, hd).permute(1, 2, 0, 3)
    i_raw, f_raw, z_raw, o_raw = g.unbind(dim=1)
    f_log = F.logsigmoid(f_raw)
    m_new = torch.maximum(f_log + state.m, i_raw)
    i = torch.exp(i_raw - m_new)
    f = torch.exp(f_log + state.m - m_new)
    c = f * state.c + i * torch.tanh(z_raw)
    n = f * state.n + i
    # torch.maximum, not torch.clamp: at n == 1e-6 it passes half the
    # gradient to each side, as jnp.maximum does (clamp passes it all)
    h = torch.sigmoid(o_raw) * c / torch.maximum(n, n.new_tensor(1e-6))
    return SLSTMState(c=c, n=n, m=m_new, h=h)


def _slstm_ffn(p: SLSTM, dims: SLSTMDims, h: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """h (B, T, d) fp32 cell outputs -> group norm per head in ``dtype``,
    then the gated FFN with ``jax.nn.gelu``'s default tanh form."""
    h = group_norm(h.to(dtype), p.gn_scale, n_groups=dims.n_heads)
    gte = h @ p.w_gate
    up = h @ p.w_upp
    y = F.gelu(at_least_fp32(gte), approximate="tanh").to(dtype) * up
    return y @ p.w_down


def slstm_forward(p: SLSTM, dims: SLSTMDims, x: torch.Tensor
                  ) -> torch.Tensor:
    """x (B, T, d) -> (B, T, d): the input pre-activations of every step
    in one fp32 product, then a loop over time on x's device."""
    B, T, d = x.shape
    pre = at_least_fp32(x) @ at_least_fp32(p.w_in) + p.b  # (B, T, 4d)
    r2 = _recurrent(p.r)
    state = init_slstm_state(B, dims, device=x.device, dtype=pre.dtype)
    hs = []
    for t in range(T):
        state = _slstm_cell(r2, state, pre[:, t])
        hs.append(state.h)
    h = torch.stack(hs, dim=1).reshape(B, T, d)
    return _slstm_ffn(p, dims, h, x.dtype)


def slstm_decode_step(p: SLSTM, dims: SLSTMDims, state: SLSTMState,
                      x: torch.Tensor) -> Tuple[SLSTMState, torch.Tensor]:
    """One recurrent step. x (B, 1, d) -> (state, (B, 1, d)); the
    state's tensors are updated in place."""
    B = x.shape[0]
    pre = x[:, 0].float() @ p.w_in.float() + p.b
    new = _slstm_cell(_recurrent(p.r), state, pre)
    for old, val in zip(state, new):
        old.copy_(val)
    return state, _slstm_ffn(p, dims, new.h.reshape(B, 1, dims.d_model),
                             x.dtype)
