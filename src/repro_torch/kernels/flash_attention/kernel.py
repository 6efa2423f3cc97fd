"""Hopper kernel for causal GQA flash attention (prefill).

``flash_attention`` replaces ``repro/kernels/flash_attention/kernel.py``
``flash_attention``. It is CUDA C++ in ``csrc/flash_attention.cu`` (its
header says what bounds it and what the design does about it), built by
``kernels/_build.py`` at first use. The one entry point routes by dtype:
bf16 / fp16 go to a FlashAttention-2 kernel on the tensor cores
(``mma.sync``, 64-row query tiles), fp32 to a kernel on the CUDA cores
whose query tile :func:`fp32_query_tile` picks.

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
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.utils.device import sm_count

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
_COUNT_LOCK = threading.Lock()

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (32, 64, 128, 256)
HALF_BLOCK_Q = 64     # query rows of a tensor-core block


def fp32_query_tile(B: int, T: int, nq: int, sm_count: int) -> int:
    """Query rows of an fp32 block: 64, or 32 when 64-row tiles would
    put fewer than two blocks on each of the card's ``sm_count`` SMs
    (Gemma3's hd-256 local layer: 80 blocks on 132 SMs). A row's
    arithmetic is the same for both."""
    return 64 if -(-T // 64) * nq * B >= 2 * sm_count else 32


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _library() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    if lib.flash_attn_fwd.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.flash_attn_fwd.argtypes = [ptr] * 4 + [i64] * 9 + [ptr]
        lib.flash_attn_fwd.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernel library now instead of at first launch."""
    _library()


def check_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_len=None) -> None:
    """Shared checks of the attention kernels: q (B, T, nq, hd) and k / v
    (B, S, nkv, hd) of one float dtype on one device, contiguous, with
    nq a multiple of nkv and hd one the kernels are built for."""
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be (B, T, nq, hd) and k, v (B, S, nkv, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, T, nq, hd = q.shape
    if q_len is not None and T != q_len:
        raise ValueError(f"q must hold {q_len} position(s), got {T}")
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if k.shape[2] == 0 or nq % k.shape[2]:
        raise ValueError(f"{nq} q heads do not group over {k.shape[2]} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of fp32 / bf16 / fp16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the attention kernels take CPU or CUDA tensors, "
                         f"got {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Causal GQA attention with an optional sliding window (0 = none):
    q (B, T, nq, hd), k / v (B, S, nkv, hd) -> (B, T, nq, hd) in q's
    dtype, the kv head of q head h being h // (nq // nkv). Any T and S;
    positions count from 0 in both."""
    check_heads(q, k, v)
    window = int(window)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, window=window)
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    if S == 0:
        raise ValueError("flash_attention needs at least one key")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned q, k, v")
    block_q = (fp32_query_tile(B, T, nq, sm_count(q.device))
               if q.dtype == torch.float32 else HALF_BLOCK_Q)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, S, nq, nkv, hd, DTYPE_CODES[q.dtype], window, block_q,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    _count("flash_attention")
    return out
