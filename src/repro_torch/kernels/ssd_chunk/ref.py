"""Plain PyTorch versions of the SSD (Mamba2) chunked scan: the per-lane
oracle ``ssd_chunk_ref`` of ``repro/kernels/ssd_chunk/ref.py`` and the
full ``ssd_scan`` semantics of ``repro/kernels/ssd_chunk/ops.py``,
computed as ``repro/models/layers/mamba2.py``'s ``chunk_step`` does
(every lane at once, B and C shared across heads). What the CPU path
runs, and what the CUDA kernel is held against on the card."""
from __future__ import annotations

from typing import Tuple

import torch


def chunk_len(T: int, chunk: int) -> int:
    """The chunk length the scan uses: ``min(chunk, T)``, or the whole
    sequence (``L = T``) when that does not divide T."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    L = min(chunk, T)
    return T if L == 0 or T % L else L


def cumulative_decay(lam: torch.Tensor, dim: int) -> torch.Tensor:
    """The cumulative log-decay ``cumsum(lam)`` along ``dim``, summed in
    float64 and rounded to fp32 once. ``repro`` sums in fp32, whose
    rounding depends on the order of addition (sequential or a tree): at
    |cum| ~ 20 two orders move an output of magnitude ~1 by 2e-4. The
    kernel takes the same float64 prefix sums, so the two agree to the
    last bit of every decay whatever order either adds in."""
    return torch.cumsum(lam.double(), dim=dim).float()


def ssd_chunk_ref(lam: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                  xdt: torch.Tensor, h0: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One lane: lam (nc, L); Bm / Cm (nc, L, N); xdt (nc, L, P); h0
    (N, P). Returns (y (nc, L, P), h_final (N, P)), fp32."""
    nc, L = lam.shape
    causal = torch.ones((L, L), dtype=torch.bool, device=lam.device).tril()
    h = h0.float()
    ys = []
    for c in range(nc):
        lam_, B_, C_, x_ = (a[c].float() for a in (lam, Bm, Cm, xdt))
        cum = cumulative_decay(lam_, 0)                       # (L,)
        cb = C_ @ B_.t()                                      # (L, L)
        decay = torch.exp(cum[:, None] - cum[None, :])
        w = cb * decay.masked_fill(~causal, 0.0)
        y = w @ x_
        y = y + (C_ * torch.exp(cum)[:, None]) @ h
        dte = torch.exp(cum[-1] - cum)                        # (L,)
        S = torch.einsum("l,lm,lp->mp", dte, B_, x_)
        h = h * torch.exp(cum[-1]) + S
        ys.append(y)
    return torch.stack(ys), h


def ssd_scan_ref(lam: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 xdt: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """lam (B, T, H); Bm / Cm (B, T, N); xdt (B, T, H, P) -> y
    (B, T, H, P) fp32, chunk length ``chunk_len(T, chunk)``."""
    B, T, H = lam.shape
    N, P = Bm.shape[-1], xdt.shape[-1]
    L = chunk_len(T, chunk)
    nc = T // L if L else 0
    lam_c = lam.float().reshape(B, nc, L, H)
    B_c = Bm.float().reshape(B, nc, L, N)
    C_c = Cm.float().reshape(B, nc, L, N)
    x_c = xdt.float().reshape(B, nc, L, H, P)
    causal = torch.ones((L, L), dtype=torch.bool,
                        device=lam.device).tril()[None, :, :, None]
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=lam.device)
    ys = []
    for c in range(nc):
        lam_, B_, C_, x_ = lam_c[:, c], B_c[:, c], C_c[:, c], x_c[:, c]
        cum = cumulative_decay(lam_, 1)                       # (B, L, H)
        # intra-chunk: W[t, s] = C_t . B_s * exp(cum_t - cum_s), s <= t
        cb = torch.einsum("btm,bsm->bts", C_, B_)             # (B, L, L)
        decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
        w = cb[..., None] * decay.masked_fill(~causal, 0.0)   # (B, t, s, H)
        y = torch.einsum("btsh,bshp->bthp", w, x_)
        # inter-chunk: y[t] += C_t . h_chunk_start * exp(cum_t)
        y = y + torch.einsum("btm,bhmp,bth->bthp", C_, h, torch.exp(cum))
        # state update to the chunk end
        dte = torch.exp(cum[:, -1:, :] - cum)                 # (B, L, H)
        S = torch.einsum("blh,blm,blhp->bhmp", dte, B_, x_)
        h = h * torch.exp(cum[:, -1, :])[..., None, None] + S
        ys.append(y)
    if not ys:
        return torch.zeros((B, T, H, P), dtype=torch.float32,
                           device=lam.device)
    return torch.stack(ys, dim=1).reshape(B, T, H, P)
