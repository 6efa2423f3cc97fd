"""Hopper kernel for one-token GQA attention over a ring KV cache.

``flash_decode`` replaces ``repro/kernels/flash_decode/kernel.py``
``flash_decode``. It is CUDA C++ in ``csrc/flash_decode.cu`` (its header
says what bounds it and what the design does about it), built by
``kernels/_build.py`` at first use: one launch of thread-block clusters,
one cluster of :func:`split_plan` CTAs per (batch, kv head) and tile of
:func:`head_tile` of its q heads, whose CTAs split the live slots and
merge in distributed shared memory.

On a CPU tensor the wrapper returns its plain version from ``ref.py``; on
a CUDA tensor it launches the kernel on the current stream or raises. It
checks device, dtype, shape and contiguity first, on either device, and
on the card the 16-byte alignment of q and the caches. ``LAUNCHES``
counts kernel launches, one per wrapper call that reached the card.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.flash_attention.kernel import DTYPE_CODES, check_heads
from repro_torch.kernels.flash_decode.ref import Pos, flash_decode_ref, pos_tensor
from repro_torch.utils.device import sm_count

LAUNCHES: Dict[str, int] = {"flash_decode": 0}
_COUNT_LOCK = threading.Lock()

MAX_SPLITS = 8        # CTAs of a portable cluster
MIN_SPLIT_SLOTS = 32  # cache slots a split is planned to hold at least
MAX_HEAD_TILE = 8     # q heads of one kv head a cluster takes at most


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _library() -> ctypes.CDLL:
    lib = load_library("flash_decode")
    if lib.flash_decode_fwd.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.flash_decode_fwd.argtypes = [ptr] * 5 + [i64] * 8 + [ptr]
        lib.flash_decode_fwd.restype = ctypes.c_int
        lib.flash_decode_max_active_clusters.argtypes = [i64] * 4 + [ptr]
        lib.flash_decode_max_active_clusters.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernel library now instead of at first launch."""
    _library()


def split_plan(S: int, bk: int, sm_count: int) -> int:
    """CTAs a cluster (1, 2, 4 or 8) for a cache of ``S`` slots and
    ``bk`` = B * nkv clusters: the smallest power of two that puts at
    least one CTA on each of the card's ``sm_count`` SMs, capped at 8
    and at ceil(S / 32). It reads no position, so the host never waits
    on the card; the CTAs split the live slots at run time."""
    cap = min(MAX_SPLITS, -(-S // MIN_SPLIT_SLOTS))
    splits = 1
    while splits * 2 <= cap and splits * bk < sm_count:
        splits *= 2
    return splits


def head_tile(group: int, ctas: int, sm_count: int) -> int:
    """q heads of one kv head a cluster takes (1, 2, 4 or 8), where
    ``ctas`` = splits * B * nkv: the smallest power of two that holds
    the group (at most 8), halved while twice the CTAs still fit on the
    card's ``sm_count`` SMs. A thin grid (Qwen2: 8 clusters of 8; Gemma3's
    MQA: 1) so spreads its heads over more SMs, each tile reading the
    same kv rows (from L2 after the first)."""
    tile = 1
    while tile < min(group, MAX_HEAD_TILE):
        tile *= 2
    while tile > 1 and 2 * ctas * -(-group // tile) <= sm_count:
        tile //= 2
    return tile


def check_aligned(**tensors: torch.Tensor) -> None:
    """The kernel reads q and the caches 16 bytes at a time: each base
    pointer must be 16-byte aligned (row strides, hd * elem bytes, are)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned, its data "
                             f"starts at {t.data_ptr():#x}")


def max_active_clusters(head_dim: int, dtype: torch.dtype, tile: int,
                        splits: int) -> int:
    """How many clusters of ``splits`` CTAs of the kernel for (head_dim,
    dtype, head tile) fit on the current card at once."""
    lib = _library()
    n = ctypes.c_int(0)
    err = lib.flash_decode_max_active_clusters(
        head_dim, DTYPE_CODES[dtype], tile, splits, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA "
                           f"error {err}")
    return n.value


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: Pos) -> torch.Tensor:
    """q (B, 1, nq, hd) against caches (B, S, nkv, hd) -> (B, 1, nq, hd)
    in q's dtype. ``pos`` is the position of the token just written (an
    int, or an int tensor of one element, kept on the device so a step
    never syncs): slot i is live when i <= pos or the ring has wrapped
    (pos >= S). Any S."""
    check_heads(q, k_cache, v_cache, q_len=1)
    if isinstance(pos, torch.Tensor) and pos.device != q.device:
        raise ValueError(f"pos on {pos.device}, q on {q.device}")
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, pos)
    B, _, nq, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    if S == 0:
        raise ValueError("flash_decode needs a cache of at least one slot")
    check_aligned(q=q, k_cache=k_cache, v_cache=v_cache)
    p = pos_tensor(pos, q.device)
    out = torch.empty_like(q)
    if B == 0:
        return out
    sms = sm_count(q.device)
    splits = split_plan(S, B * nkv, sms)
    group = nq // nkv
    tile = head_tile(group, splits * B * nkv, sms)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_decode_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), p.data_ptr(),
            out.data_ptr(), B, S, nkv, group, hd, DTYPE_CODES[q.dtype],
            splits, tile, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_decode_fwd launch failed: CUDA error {err}")
    _count("flash_decode")
    return out
