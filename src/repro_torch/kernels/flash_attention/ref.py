"""Plain PyTorch versions of the flash-attention kernels: the naive full
softmax, as ``repro/kernels/flash_attention/ref.py`` computes it, the
same forward returning its logsumexp, and the backward of the reference
model's ``blockwise_attention`` custom VJP
(``repro/models/layers/attention.py:217-303``). What the CPU path runs,
and what the CUDA kernels are held against on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(T: int, S: int, window: int, device=None) -> torch.Tensor:
    """(T, S) bool: query t may attend key s (positions from 0 on both)."""
    qpos = torch.arange(T, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """q (B, T, nq, hd), k/v (B, S, nkv, hd) -> (B, T, nq, hd) in q's
    dtype. Upcasts to fp32 and scales q before the dot; GQA groups the
    q heads over the kv heads without copying k or v."""
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    qf = q.float().reshape(B, T, nkv, group, hd) * hd ** -0.5
    s = torch.einsum("btngh,bsnh->bngts", qf, k.float())
    mask = attention_mask(T, S, window, device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngts,bsnh->btngh", p, v.float())
    return o.reshape(B, T, nq, hd).to(q.dtype)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int = 0):
    """(out (B, T, nq, hd) in q's dtype, lse (B, nq, T) fp32): the
    reference model's forward, ``blockwise_attention``'s ``_forward`` in
    one tile. Scores are fp32 dot products scaled after the dot; lse =
    max + log(sum), the sum floored at 1e-30; p enters PV rounded to v's
    dtype, as ``p.astype(v_blk.dtype)`` does there. fp64 inputs are
    computed in fp64 (for ``gradcheck``), the rest in fp32."""
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    ct = _compute_dtype(q)
    qf = q.to(ct).reshape(B, T, nkv, group, hd)
    s = torch.einsum("btngh,bsnh->bngts", qf, k.to(ct)) * hd ** -0.5
    mask = attention_mask(T, S, window, device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    lsafe = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bngts,bsnh->btngh", p.to(v.dtype).to(ct), v.to(ct))
    o = o / lsafe.permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(lsafe)).reshape(B, nq, T)
    return o.reshape(B, T, nq, hd).to(q.dtype).contiguous(), lse


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, window: int = 0):
    """(dq, dk, dv) in the input dtype: the reference VJP's math in one
    tile. p = exp(s - lse) recomputed from the saved lse (B, nq, T),
    delta = rowsum(dout * out) in fp32, dv = p^T dout, dp = dout v^T,
    ds = p (dp - delta) scale, dq = ds k, dk = ds^T q; p and ds are
    rounded to the input dtype before the products they feed, as
    ``pb`` and ``dsb`` are there (``:258-266``)."""
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    scale = hd ** -0.5
    dt, ct = q.dtype, _compute_dtype(q)
    qf = q.to(ct).reshape(B, T, nkv, group, hd)
    dof = dout.to(ct).reshape(B, T, nkv, group, hd)
    kf, vf = k.to(ct), v.to(ct)
    s = torch.einsum("btngh,bsnh->bngts", qf, kf) * scale
    mask = attention_mask(T, S, window, device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - lse.to(ct).reshape(B, nkv, group, T)[..., None])
    delta = (dof * out.to(ct).reshape(B, T, nkv, group, hd)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)                       # (B, n, g, T)
    dv = torch.einsum("bngts,btngh->bsnh", p.to(dt).to(ct), dof)
    dp = torch.einsum("btngh,bsnh->bngts", dof, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(dt).to(ct)
    dq = torch.einsum("bngts,bsnh->btngh", ds, kf)
    dk = torch.einsum("bngts,btngh->bsnh", ds, qf)
    return (dq.reshape(B, T, nq, hd).to(dt), dk.to(k.dtype),
            dv.to(v.dtype))
