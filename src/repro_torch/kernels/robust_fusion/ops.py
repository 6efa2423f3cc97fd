"""Public wrappers for the robust-fusion kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels.robust_fusion.kernel import (
    coord_median,
    topk_carve,
    trimmed_mean,
)
from repro_torch.kernels.robust_fusion.ref import topk_carve_ref

__all__ = [
    "coord_median",
    "trimmed_mean",
    "topk_carve",
    "topk_carve_ref",
    "carve_stream_dense",
]


def carve_stream_dense(updates: torch.Tensor, trim: int, *, chunk: int = 8,
                       use_kernel: bool = True) -> torch.Tensor:
    """Dense-parity harness, the twin of ``repro``'s: stream a dense
    (n, P) matrix through the carve fold in (chunk, P) blocks and
    finalize. Equals ``trimmedmean_ref(updates, trim)``; trim =
    (n - 1) // 2 gives the median. The ragged last block is folded as it
    is (the kernel reads only its rows); ``use_kernel=False`` takes the
    plain fold."""
    n, p = updates.shape
    if not 2 * trim < n:
        raise ValueError(f"trim {trim} too large for n={n}")
    k_cap = max(trim, 1)
    dev = updates.device
    ssum = torch.zeros((p,), dtype=torch.float32, device=dev)
    topk = torch.full((k_cap, p), -torch.inf, device=dev)
    botk = torch.full((k_cap, p), torch.inf, device=dev)
    fold = topk_carve if use_kernel else topk_carve_ref
    for i in range(0, n, chunk):
        blk = updates[i: i + chunk].contiguous()
        valid = torch.ones((blk.shape[0],), dtype=torch.float32, device=dev)
        ssum, topk, botk = fold(blk, valid, ssum, topk, botk)
    s = ssum
    if trim > 0:
        s = s - topk[k_cap - trim:].sum(dim=0) - botk[:trim].sum(dim=0)
    return s / float(n - 2 * trim)
