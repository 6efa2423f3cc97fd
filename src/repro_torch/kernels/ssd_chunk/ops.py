"""Public wrappers for the SSD chunked-scan kernels: ``ssd_scan`` over
(B, T, H, ...) tensors, as ``repro/kernels/ssd_chunk/ops.py`` names it,
and the differentiable scan training runs.
The kernels take the whole scan (B and C shared across heads, the state
handed from chunk to chunk on the card), so no lane layout is built
here.

``SSDScanFn`` is the port's counterpart of what ``jax.vjp`` makes of the
reference model's scan (``repro/models/layers/mamba2.py`` ``chunk_step``):
its forward saves the inputs and, on the card, the forward kernel's
prefix sums, chunk-start states and scores C·Bᵀ; its backward computes
every gradient from them. With ``plain=False`` both passes go through the kernels'
wrappers, which launch ``ssd_chunk_fwd`` / ``ssd_chunk_bwd`` on CUDA
tensors (or raise) and run ``ssd_scan_ref`` / ``ssd_scan_bwd_ref`` on
CPU tensors; with ``plain=True`` they run the plain versions on any
device (the yardstick a caller passes explicitly).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk as ssd_scan
from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_bwd
from repro_torch.kernels.ssd_chunk.ref import ssd_scan_bwd_ref, ssd_scan_ref

__all__ = ["SSDScanFn", "ssd_chunk_bwd", "ssd_scan", "ssd_scan_train",
           "ssd_scan_train_ref"]


class SSDScanFn(torch.autograd.Function):
    """(lam, Bm, Cm, xdt, chunk, plain) -> y, differentiable in lam, Bm,
    Cm and xdt."""

    @staticmethod
    def forward(ctx, lam, Bm, Cm, xdt, chunk: int, plain: bool):
        saved = None
        if plain:
            y = ssd_scan_ref(lam, Bm, Cm, xdt, chunk=chunk)
        else:
            y, saved = ssd_scan(lam, Bm, Cm, xdt, chunk=chunk,
                                return_saved=True)
        cum, states, scores = saved if saved is not None \
            else (None, None, None)
        ctx.save_for_backward(lam, Bm, Cm, xdt, cum, states, scores)
        ctx.chunk, ctx.plain = chunk, plain
        return y

    @staticmethod
    def backward(ctx, dy):
        lam, Bm, Cm, xdt, cum, states, scores = ctx.saved_tensors
        if ctx.plain:
            grads = ssd_scan_bwd_ref(lam, Bm, Cm, xdt, dy, chunk=ctx.chunk)
        else:
            grads = ssd_chunk_bwd(
                lam, Bm, Cm, xdt, dy, chunk=ctx.chunk,
                saved=None if cum is None else (cum, states, scores))
        return (*grads, None, None)


def ssd_scan_train(lam: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   xdt: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """The scan as ``ssd_scan`` computes it, with the backward kernel
    behind it (every input fp32)."""
    return SSDScanFn.apply(lam, Bm, Cm, xdt, int(chunk), False)


def ssd_scan_train_ref(lam: torch.Tensor, Bm: torch.Tensor,
                       Cm: torch.Tensor, xdt: torch.Tensor, *,
                       chunk: int = 256) -> torch.Tensor:
    """The same function with the plain forward and backward, on any
    device."""
    return SSDScanFn.apply(lam, Bm, Cm, xdt, int(chunk), True)
