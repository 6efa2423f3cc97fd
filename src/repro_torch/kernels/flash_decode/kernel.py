"""Hopper kernel for one-token GQA attention over a ring KV cache.

``flash_decode`` replaces ``repro/kernels/flash_decode/kernel.py``
``flash_decode``. It is CUDA C++ in ``csrc/flash_decode.cu`` (its header
says what bounds it and what the design does about it), built by
``kernels/_build.py`` at first use: a partial pass over sequence chunks
and a combine pass, counted as one launch.

On a CPU tensor the wrapper returns its plain version from ``ref.py``; on
a CUDA tensor it launches the kernel on the current stream or raises. It
checks device, dtype, shape and contiguity first, on either device.
``LAUNCHES`` counts kernel launches, one per wrapper call that reached
the card.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.flash_attention.kernel import DTYPE_CODES, check_heads
from repro_torch.kernels.flash_decode.ref import Pos, flash_decode_ref, pos_tensor

LAUNCHES: Dict[str, int] = {"flash_decode": 0}
_COUNT_LOCK = threading.Lock()


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
        lib.flash_decode_fwd.argtypes = [ptr] * 7 + [i64] * 8 + [ptr]
        lib.flash_decode_fwd.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernel library now instead of at first launch."""
    _library()


def chunk_len(head_dim: int) -> int:
    """Cache slots per block of the partial pass (as in the CUDA source)."""
    return 64 if head_dim <= 128 else 32


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
    group = nq // nkv
    chunk = chunk_len(hd)
    n_chunks = -(-S // chunk)
    p = pos_tensor(pos, q.device)
    out = torch.empty_like(q)
    if B == 0:
        return out
    ws_acc = torch.empty((B * nkv, n_chunks, group, hd), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((B * nkv, n_chunks, group, 2), dtype=torch.float32,
                        device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_decode_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), p.data_ptr(),
            out.data_ptr(), ws_acc.data_ptr(), ws_ml.data_ptr(),
            B, S, nkv, group, hd, DTYPE_CODES[q.dtype], chunk, n_chunks,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_decode_fwd launch failed: CUDA error {err}")
    _count("flash_decode")
    return out
