"""Hopper kernel for GQA flash attention (prefill, encoder and cross
attention), causal or not.

``flash_attention`` replaces ``repro/kernels/flash_attention/kernel.py``
``flash_attention``. It is CUDA C++ in ``csrc/flash_attention.cu`` (its
header says what bounds it and what the design does about it), built by
``kernels/_build.py`` at first use. The one entry point routes by dtype:
bf16 / fp16 go to a FlashAttention-2 kernel on the tensor cores
(``mma.sync``, 64-row query tiles), fp32 to a kernel on the CUDA cores
whose query tile :func:`fp32_query_tile` picks. ``causal`` picks a
template instance of either route: the decoders' causal self-attention,
or the encoder-decoder's non-causal encoder and cross attention (T
decoder positions over S encoder frames).

On a CPU tensor the wrapper returns its plain version from ``ref.py``; on
a CUDA tensor it launches the kernel on the current stream or raises. It
checks device, dtype, shape and contiguity first, on either device.
``LAUNCHES`` counts kernel launches, one per wrapper call that reached
the card.

``flash_attention(..., return_lse=True)`` also returns the rows'
logsumexp, (B, nq, T) fp32, which the forward kernel writes only when
asked (the serving path passes a null pointer). ``flash_attention_bwd``
is the backward of the reference model's ``blockwise_attention`` custom
VJP (``repro/models/layers/attention.py:217-303``; that VJP has no
Pallas kernel) at every (causal, T, S, window) the forward takes:
``flash_attn_bwd`` in the same source, four device kernels a call (delta
= rowsum(dO * O) over T; dK / dV partials per q head and key tile of S;
dQ per q head and query tile of T; the partials summed over each kv
head's group in a fixed order), with no float atomics, so two calls
give bitwise-equal gradients. ``causal`` picks a template instance of
its tile kernels, as in the forward. It is bound by operations (10 * hd FLOPs
a live score, bf16 at 989 TFLOP/s). bf16 / fp16 run its dK / dV and dQ
kernels on the tensor cores (``mma.sync``, p and ds fed from the fp32
accumulators as the next product's operands, rounded once to the input
dtype as the reference rounds them); fp32 runs the same plan on the
tensor cores in three TF32 passes (``mma.sync.m16n8k8``, each operand
split into hi + lo and multiplied as lo.hi + hi.lo + hi.hi, as exact as
fp32 FMAs). S and dP are recomputed in both tile kernels, so that dQ
needs no sum across blocks. :func:`bwd_tiles`, :func:`dkdv_query_tiles`
and :func:`dq_key_tiles` mirror the tile kernels' tiles and loop bounds
in every dtype; :data:`BWD_TILE_KERNELS` names each dtype's tile
kernels. Its CPU path is ``attention_bwd_ref``.

``NONCAUSAL_LAUNCHES`` counts the launches of either entry point that
took its non-causal instances (each also counts in ``LAUNCHES``).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)
from repro_torch.utils.device import sm_count

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}
NONCAUSAL_LAUNCHES: Dict[str, int] = {"flash_attention": 0,
                                      "flash_attention_bwd": 0}
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


# the backward's device kernels: the tile kernels by dtype (one instance a
# head dim), and two that every dtype runs (one instance a dtype)
BWD_TILE_KERNELS = {
    torch.float32: ("bwd_dkdv_split_kernel", "bwd_dq_split_kernel"),
    torch.bfloat16: ("bwd_dkdv_mma_kernel", "bwd_dq_mma_kernel"),
    torch.float16: ("bwd_dkdv_mma_kernel", "bwd_dq_mma_kernel"),
}
BWD_COMMON_KERNELS = ("bwd_delta_kernel", "bwd_group_sum_kernel")


def bwd_instances() -> List[Tuple[str, torch.dtype, int, Optional[bool]]]:
    """(kernel, dtype, head dim or 0, causal or None) of every
    device-kernel instance the backward builds: ``flash_attn_bwd``
    dispatches each dtype of ``DTYPE_CODES``, and its tile kernels each
    head dim of ``HEAD_DIMS``, causal and not."""
    out = []
    for dt in DTYPE_CODES:
        out += [(name, dt, 0, None) for name in BWD_COMMON_KERNELS]
        out += [(name, dt, hd, causal) for name in BWD_TILE_KERNELS[dt]
                for hd in HEAD_DIMS for causal in (True, False)]
    return out


def bwd_route(dtype: torch.dtype) -> str:
    """Where ``flash_attn_bwd``'s dK / dV and dQ kernels run for
    ``dtype``: fp32 takes three TF32 products for each one."""
    return ("tensor cores (mma.sync)" if dtype in (torch.bfloat16,
                                                   torch.float16)
            else "tensor cores (mma.sync, 3 x TF32)")


def bwd_tiles(hd: int) -> Tuple[int, int, int]:
    """(rows, bq, bk) of the backward's tile kernels at head dim ``hd``,
    in every dtype (``BwdMmaCfg`` in ``csrc/flash_attention.cu``; fp32
    keeps the plan at twice the bytes, ``BwdSplitCfg``): the keys a dK /
    dV block and the queries a dQ block own (16 a warp, 4 warps; at hd
    256 two warps, four in fp32, share each 16 rows and split the head
    dim), the query tile a dK / dV block streams, and the key tile a dQ
    block streams."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    return (32 if hd == 256 else 64, 64 if hd <= 64 else 32,
            64 if hd <= 128 else 32)


def dkdv_query_tiles(k0: int, T: int, window: int, hd: int, *,
                     S: Optional[int] = None, causal: bool = True) -> range:
    """The query tiles (of ``bwd_tiles(hd)[1]`` rows, over T queries)
    that the dK / dV block of keys ``k0 ..`` (of S, T by default) visits,
    in order: from the one holding the diagonal (the first, when not
    ``causal``) to the window's far edge seen from the block's last row
    (causal) or its last key before S (the CUDA loop bounds)."""
    rows, bq, _ = bwd_tiles(hd)
    S = T if S is None else S
    n_qt = -(-T // bq)
    last = k0 + rows if causal else min(k0 + rows, S)
    hi = n_qt if window <= 0 else min(n_qt, (last - 2 + window) // bq + 1)
    return range(k0 // bq if causal else 0, hi)


def dq_key_tiles(q0: int, T: int, window: int, hd: int, *,
                 S: Optional[int] = None, causal: bool = True) -> range:
    """The key tiles (of ``bwd_tiles(hd)[2]`` keys, over S keys, T by
    default) that the dQ block of queries ``q0 ..`` (of T) visits, in
    order: from the window's near edge to the diagonal, or to the last
    tile of S when not ``causal`` (the CUDA loop bounds)."""
    rows, _, bk = bwd_tiles(hd)
    S = T if S is None else S
    n_kt = -(-S // bk)
    q_last = min(q0 + rows, T) - 1
    hi = min(n_kt, q_last // bk + 1) if causal else n_kt
    lo = (q0 - window + 1) // bk if window > 0 and q0 - window + 1 > 0 else 0
    return range(lo, hi)


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
            NONCAUSAL_LAUNCHES[name] = 0


def _count(name: str, causal: bool) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if not causal:
            NONCAUSAL_LAUNCHES[name] += 1


def _library() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    if lib.flash_attn_fwd.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.flash_attn_fwd.argtypes = [ptr] * 5 + [i64] * 10 + [ptr]
        lib.flash_attn_fwd.restype = ctypes.c_int
        lib.flash_attn_bwd.argtypes = [ptr] * 11 + [i64] * 9 + [ptr]
        lib.flash_attn_bwd.restype = ctypes.c_int
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
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """GQA attention with an optional sliding window (0 = none): q (B, T,
    nq, hd), k / v (B, S, nkv, hd) -> (B, T, nq, hd) in q's dtype, the kv
    head of q head h being h // (nq // nkv). Any T and S; positions count
    from 0 in both. Query t attends key s when s <= t (``causal``, the
    default) or for every s (``causal=False``), and, with a window, when
    also t - s < window (one-sided, as the Pallas kernel: without
    ``causal`` every key after t stays live). With ``return_lse``
    returns ``(out, lse)``, lse (B, nq, T) fp32 the rows' logsumexp of
    the scaled scores (what the backward recomputes p from)."""
    check_heads(q, k, v)
    window = int(window)
    causal = bool(causal)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        if return_lse:
            return attention_lse_ref(q, k, v, causal=causal, window=window)
        return attention_ref(q, k, v, causal=causal, window=window)
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, nq, T), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B == 0 or T == 0:
        return (out, lse) if return_lse else out
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
            lse.data_ptr() if return_lse else None,
            B, T, S, nq, nkv, hd, DTYPE_CODES[q.dtype], window, int(causal),
            block_q,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    _count("flash_attention", causal)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of :func:`flash_attention` in the input dtype, from
    its inputs, its output, its lse (B, nq, T) fp32 and the output's
    gradient ``dout``: the reference VJP's math, p and ds rounded to the
    input dtype before the products they feed, fp32 accumulation. Takes
    every (``causal``, T, S, ``window``) the forward takes: q (B, T, nq,
    hd), k / v (B, S, nkv, hd). A key that no live query reaches gets
    dk = dv = 0. On CUDA tensors it launches ``flash_attn_bwd`` or
    raises."""
    check_heads(q, k, v)
    window = int(window)
    causal = bool(causal)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(q.shape)} "
                             f"{q.dtype} tensor on {q.device}")
    if tuple(lse.shape) != (B, nq, T) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous ({B}, {nq}, {T}) fp32 "
                         f"tensor on {q.device}")
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                 window=window)
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd needs 16-byte aligned q, k, v, "
                         "out, dout")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or T == 0 or S == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, nq, T), dtype=torch.float32, device=q.device)
    # fp32 dK / dV partials of each q head, summed over the group after
    group = nq // nkv
    work = (torch.empty((2, B, S, nq, hd), dtype=torch.float32,
                        device=q.device) if group > 1 else None)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(),
            work.data_ptr() if work is not None else None,
            B, T, S, nq, nkv, hd, DTYPE_CODES[q.dtype], window, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: CUDA error {err}")
    _count("flash_attention_bwd", causal)
    return dq, dk, dv
