"""Hopper kernels for the streaming weighted-sum fusion.

``weighted_sum`` replaces ``repro/kernels/fused_fusion/kernel.py``
``weighted_sum_pallas`` and ``weighted_sum_dequant`` replaces
``weighted_sum_dequant_pallas``. Both are CUDA C++ in
``csrc/fused_fusion.cu`` (its header says what bounds them and what the
design does about it), built by ``kernels/_build.py`` at first use.

On a CPU tensor a wrapper returns its plain version from ``ref.py``; on a
CUDA tensor it launches the kernel on the current stream or raises. Both
check device, dtype, shape and contiguity first, on either device.
``LAUNCHES`` counts kernel launches, one per wrapper call that reached the
card.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.fused_fusion.ref import (
    weighted_sum_dequant_ref,
    weighted_sum_ref,
)
from repro_torch.utils.device import sm_count

LAUNCHES: Dict[str, int] = {"weighted_sum": 0, "weighted_sum_dequant": 0}
_COUNT_LOCK = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS = 256          # threads per block, as in the CUDA source
# the dequant kernel's layout, as in the CUDA source: a lane's vector of
# DQ_VEC codes, DQ_VECTORS of them a thread, 32 * DQ_VEC columns apart
DQ_VEC = 4
DQ_VECTORS = 4
DQ_WARP_COLS = 32 * DQ_VEC * DQ_VECTORS
DQ_BLOCK_COLS = _THREADS // 32 * DQ_WARP_COLS


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _library() -> ctypes.CDLL:
    lib = load_library("fused_fusion")
    if lib.fused_wsum_dequant.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.fused_wsum.argtypes = [ptr] * 4 + [i64] * 6 + [ptr]
        lib.fused_wsum.restype = ctypes.c_int
        lib.fused_wsum_dequant.argtypes = [ptr] * 5 + [i64] * 6 + [ptr]
        lib.fused_wsum_dequant.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernel library now instead of at first launch."""
    _library()


def _device_of(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_fusion kernels take CPU or CUDA tensors, "
                         f"got {dev}")
    return dev


def _contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _row_splits(n: int, tiles: int, sms: int) -> Tuple[int, int]:
    """(splits, rows per split): split the rows over a second grid
    dimension when the ``tiles`` column tiles alone give fewer than about
    two blocks per SM."""
    target = 2 * sms
    if n <= 1 or tiles >= target:
        return 1, max(n, 1)
    rows = -(-n // min(n, -(-target // tiles)))
    return -(-n // rows), rows


class DequantPlan(NamedTuple):
    """The launch of ``weighted_sum_dequant``. ``scale`` says where the
    kernel forms w[i] * s[i, b]: ``"thread"`` once a row (a warp's
    DQ_WARP_COLS columns share one quantization block), ``"vector"`` once
    a row and vector, ``"element"`` per element, codes read a byte at a
    time (the block or the codes' alignment is not a multiple of DQ_VEC).
    Column tile x of split y covers columns [x * DQ_BLOCK_COLS, (x + 1) *
    DQ_BLOCK_COLS) of rows [y * rows_per_split, (y + 1) * rows_per_split)
    (both cut at the edge); more than one split adds the splits' partial
    sums in a second launch."""
    scale: str
    blocks: int
    splits: int
    rows_per_split: int


def dequant_plan(n: int, Pq: int, blk: int, sm_count: int,
                 aligned: bool = True) -> DequantPlan:
    """The plan for (n, Pq) codes in quantization blocks of ``blk`` on a
    card of ``sm_count`` SMs; ``aligned``: the codes start 4-byte
    aligned."""
    if not (aligned and Pq % DQ_VEC == 0 and blk % DQ_VEC == 0):
        scale = "element"
    else:
        scale = "thread" if blk % DQ_WARP_COLS == 0 else "vector"
    blocks = -(-Pq // DQ_BLOCK_COLS)
    return DequantPlan(scale, blocks, *_row_splits(n, blocks, sm_count))


def _check(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def weighted_sum(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """out[p] = sum_i w[i] * u[i, p] -> (P,) fp32. updates (n, P) fp32,
    bf16 or fp16; weights (n,) fp32; both contiguous."""
    if updates.dim() != 2:
        raise ValueError(f"updates must be (n, P), got {tuple(updates.shape)}")
    n, P = updates.shape
    if tuple(weights.shape) != (n,):
        raise ValueError(f"weights must be ({n},), got {tuple(weights.shape)}")
    if updates.dtype not in _DTYPE_CODES:
        raise TypeError(f"updates dtype {updates.dtype} not in fp32/bf16/fp16")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be fp32, got {weights.dtype}")
    _contiguous(updates=updates, weights=weights)
    dev = _device_of(updates, weights)
    if dev.type == "cpu":
        return weighted_sum_ref(updates, weights)
    lib = _library()
    out = torch.empty((P,), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    vec = 16 // updates.element_size()
    vectorized = P % vec == 0 and updates.data_ptr() % 16 == 0
    splits, rows = _row_splits(n, -(-P // (_THREADS * vec)), sm_count(dev))
    ws = torch.empty((splits, P), dtype=torch.float32, device=dev) \
        if splits > 1 else None
    with torch.cuda.device(dev):
        err = lib.fused_wsum(
            updates.data_ptr(), weights.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            n, P, _DTYPE_CODES[updates.dtype], splits, rows,
            int(vectorized), torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(err, "fused_wsum")
    _count("weighted_sum")
    return out


def weighted_sum_dequant(codes: torch.Tensor, scales: torch.Tensor,
                         weights: torch.Tensor,
                         block: int = 2048) -> torch.Tensor:
    """out[p] = sum_i w[i] * s[i, p // block] * q[i, p] over the padded
    parameter axis -> (Pq,) fp32 (callers slice [:dim]). codes (n, Pq)
    int8 with Pq a multiple of ``block``; scales (n, Pq // block) fp32;
    weights (n,) fp32; all contiguous."""
    if codes.dim() != 2:
        raise ValueError(f"codes must be (n, Pq), got {tuple(codes.shape)}")
    n, Pq = codes.shape
    block = int(block)
    if block < 1 or Pq % block:
        raise ValueError(f"codes width {Pq} not a multiple of block {block}")
    if tuple(scales.shape) != (n, Pq // block):
        raise ValueError(f"scales must be ({n}, {Pq // block}), "
                         f"got {tuple(scales.shape)}")
    if tuple(weights.shape) != (n,):
        raise ValueError(f"weights must be ({n},), got {tuple(weights.shape)}")
    if codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    if scales.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("scales and weights must be fp32")
    _contiguous(codes=codes, scales=scales, weights=weights)
    dev = _device_of(codes, scales, weights)
    if dev.type == "cpu":
        return weighted_sum_dequant_ref(codes, scales, weights, block=block)
    lib = _library()
    out = torch.empty((Pq,), dtype=torch.float32, device=dev)
    if Pq == 0:
        return out
    plan = dequant_plan(n, Pq, block, sm_count(dev),
                        aligned=codes.data_ptr() % DQ_VEC == 0)
    ws = torch.empty((plan.splits, Pq), dtype=torch.float32, device=dev) \
        if plan.splits > 1 else None
    with torch.cuda.device(dev):
        err = lib.fused_wsum_dequant(
            codes.data_ptr(), scales.data_ptr(), weights.data_ptr(),
            out.data_ptr(), ws.data_ptr() if ws is not None else None,
            n, Pq, block, plan.splits, plan.rows_per_split,
            int(plan.scale != "element"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(err, "fused_wsum_dequant")
    _count("weighted_sum_dequant")
    return out
