"""Plain PyTorch versions of the robust-fusion kernels, the twins of
``repro/kernels/robust_fusion/ref.py``: what the CPU path runs, what the
fusions' dense ``fuse`` and reference fold call, and what the CUDA
kernels are held against on the card.

The order is ``jnp.sort``'s: NaN after every number, -0 equal to +0, and
equal values kept in input order (``torch.sort(stable=True)`` gives the
same)."""
from __future__ import annotations

import torch


def _sorted(updates: torch.Tensor) -> torch.Tensor:
    return torch.sort(updates.float(), dim=0, stable=True).values


def coordmedian_ref(updates: torch.Tensor) -> torch.Tensor:
    """(n, P) -> (P,) per-coordinate median (fp32), as ``jnp.median``:
    the mean of the two middle values for even n, taken as
    ``(a + b) * 0.5``, and NaN for a coordinate that holds a NaN."""
    n = updates.shape[0]
    s = _sorted(updates)
    mid = n // 2
    med = s[mid] if n % 2 else (s[mid - 1] + s[mid]) * 0.5
    return torch.where(torch.isnan(s[-1]), s[-1], med)


def trimmedmean_ref(updates: torch.Tensor, trim: int) -> torch.Tensor:
    """(n, P) -> (P,) mean of each coordinate with the ``trim`` smallest
    and largest values dropped."""
    n = updates.shape[0]
    s = _sorted(updates)
    if trim > 0:
        s = s[trim: n - trim]
    return s.mean(dim=0)


def topk_carve_ref(block, valid, ssum, topk, botk):
    """The streaming carve fold: merge a (c, P) block into the carry
    (ssum (P,), topk (K, P) ascending, botk (K, P) ascending). Rows with
    ``valid == 0`` are masked to -/+inf: such a +inf survives only in
    place of a NaN in botk, as NaN sorts after it. Returns fresh
    (ssum, topk, botk)."""
    u = block.float()
    k_cap = topk.shape[0]
    vm = (valid > 0)[:, None]
    ssum = ssum + torch.where(vm, u, 0.0).sum(dim=0)
    hi = torch.where(vm, u, -torch.inf)
    topk = _sorted(torch.cat([topk, hi], dim=0))[-k_cap:]
    lo = torch.where(vm, u, torch.inf)
    botk = _sorted(torch.cat([botk, lo], dim=0))[:k_cap]
    return ssum, topk, botk
