"""Plain PyTorch versions of the SSD (Mamba2) chunked scan: the per-lane
oracle ``ssd_chunk_ref`` of ``repro/kernels/ssd_chunk/ref.py`` and the
full ``ssd_scan`` semantics of ``repro/kernels/ssd_chunk/ops.py``,
computed as ``repro/models/layers/mamba2.py``'s ``chunk_step`` does
(every lane at once, B and C shared across heads), and ``ssd_scan_bwd_ref``,
its gradients in closed form (what ``jax.vjp`` of ``chunk_step`` gives).
What the CPU path runs, and what the CUDA kernels are held against on the
card."""
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


def _suffix_sum64(v: torch.Tensor, dim: int) -> torch.Tensor:
    """sum_{t >= i} v_t along ``dim``, in float64."""
    return torch.flip(torch.cumsum(torch.flip(v.double(), (dim,)), dim),
                      (dim,))


def ssd_scan_bwd_ref(lam: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                     xdt: torch.Tensor, dy: torch.Tensor, *, chunk: int = 256
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The gradients (dlam, dBm, dCm, dxdt) of ``sum(ssd_scan_ref(lam, Bm,
    Cm, xdt, chunk=chunk) * dy)``, fp32, in closed form. Per lane and
    chunk, with ``cum`` the chunk's prefix sums (``cumulative_decay``), h
    the chunk-start state, G the gradient of the chunk-end state (0 after
    the last chunk), ``e_s = exp(cum_last - cum_s)``, ``M_ts = (C_t . B_s)
    exp(cum_t - cum_s)`` and ``D_ts = dy_t . x_s`` for s <= t:

        dx_s  = sum_{t>=s} M_ts dy_t + e_s G^T B_s
        dC_t  = sum_{s<=t} exp(cum_t - cum_s) D_ts B_s + exp(cum_t) h dy_t
        dB_s  = sum_{t>=s} exp(cum_t - cum_s) D_ts C_t + e_s G x_s
        dh    = exp(cum_last) G + sum_t exp(cum_t) C_t (x) dy_t

    (dB, dC summed over the heads; dh is G of the chunk before). dlam_i =
    sum_{t>=i} dcum_t, taken term by term so that nothing cancels: with
    Z_ts = D_ts M_ts (s < t), iota_t = exp(cum_t) C_t . h dy_t and sigma_s
    = e_s B_s . G x_s,

        dlam_i = sum_{t>=i} iota_t + [i >= 1] sum_{t>=i} (sum_{s<t} Z_ts
                 - sum_{t'>t} Z_t't) + sum_{s<i} sigma_s
                 + exp(cum_last) <G, h>,

    the sums over steps in float64 and rounded once: the Z terms of dlam_0
    cancel exactly (no pair crosses i = 0), the state terms telescope.
    Every exponent is a difference cum_t - cum_s with s <= t, or cum_t."""
    B, T, H = lam.shape
    N, P = Bm.shape[-1], xdt.shape[-1]
    dev = lam.device
    L = chunk_len(T, chunk)
    nc = T // L if L else 0
    if nc == 0:
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
        return z(B, T, H), z(B, T, N), z(B, T, N), z(B, T, H, P)
    f = lambda a, *s: a.float().reshape(B, nc, L, *s)  # noqa: E731
    lam_c, B_c, C_c = f(lam, H), f(Bm, N), f(Cm, N)
    x_c, dy_c = f(xdt, H, P), f(dy, H, P)
    cum = cumulative_decay(lam_c, 2)                           # (B, nc, L, H)
    last = cum[:, :, -1, :]                                    # (B, nc, H)
    # the chunk-start states, handed on as the forward hands them
    hs = []
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=dev)
    for c in range(nc):
        hs.append(h)
        dte = torch.exp(last[:, c, None, :] - cum[:, c])
        S = torch.einsum("blh,blm,blhp->bhmp", dte, B_c[:, c], x_c[:, c])
        h = h * torch.exp(last[:, c])[..., None, None] + S
    ones = torch.ones((L, L), dtype=torch.bool, device=dev)
    causal = ones.tril()[None, :, :, None]
    strict = ones.tril(-1)[None, :, :, None]
    G = torch.zeros((B, H, N, P), dtype=torch.float32, device=dev)
    outs = [None] * nc
    for c in reversed(range(nc)):
        cum_, B_, C_, x_, dy_ = cum[:, c], B_c[:, c], C_c[:, c], x_c[:, c], \
            dy_c[:, c]
        hc = hs[c]
        # E[t, s] = exp(cum_t - cum_s), s <= t: the mask before exp
        diff = cum_[:, :, None, :] - cum_[:, None, :, :]      # (B, t, s, H)
        E = torch.exp(diff.masked_fill(~causal, float("-inf")))
        cb = torch.einsum("btm,bsm->bts", C_, B_)
        W = cb[..., None] * E
        D = torch.einsum("bthp,bshp->btsh", dy_, x_)
        Q = D * E
        Z = (D * W).masked_fill(~strict, 0.0)
        es = torch.exp(last[:, c, None, :] - cum_)             # (B, L, H)
        ec = torch.exp(cum_)
        u = torch.einsum("bhnp,bshp->bshn", G, x_)             # G x_s
        v = torch.einsum("bhnp,bthp->bthn", hc, dy_)           # h dy_t
        dx = torch.einsum("btsh,bthp->bshp", W, dy_) \
            + es[..., None] * torch.einsum("bsn,bhnp->bshp", B_, G)
        dB = torch.einsum("btsh,btn->bsn", Q, C_) \
            + torch.einsum("bsh,bshn->bsn", es, u)
        dC = torch.einsum("btsh,bsn->btn", Q, B_) \
            + torch.einsum("bth,bthn->btn", ec, v)
        iota = ec * torch.einsum("btn,bthn->bth", C_, v)
        sigma = es * torch.einsum("bsn,bshn->bsh", B_, u)
        gh = torch.exp(last[:, c]) * torch.einsum("bhnp,bhnp->bh", G, hc)
        intra = _suffix_sum64(Z.sum(2).double() - Z.sum(1).double(), 1)
        intra[:, 0] = 0.0
        before = torch.cumsum(sigma.double(), 1) - sigma.double()
        dlam = _suffix_sum64(iota, 1) + intra + before \
            + gh.double()[:, None, :]
        outs[c] = (dlam.float(), dB, dC, dx)
        G = G * torch.exp(last[:, c])[..., None, None] \
            + torch.einsum("bth,btn,bthp->bhnp", ec, C_, dy_)
    cat = lambda i, *s: torch.stack([o[i] for o in outs], 1).reshape(B, T, *s)  # noqa: E731
    return cat(0, H), cat(1, N), cat(2, N), cat(3, H, P)
