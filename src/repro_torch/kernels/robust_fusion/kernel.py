"""Hopper kernels for the order-statistic fusions.

``topk_carve`` replaces ``repro/kernels/robust_fusion/kernel.py``
``topk_carve_pallas``, ``trimmed_mean`` replaces ``trimmedmean_pallas``
and ``coord_median`` replaces ``coordmedian_pallas``. All three are CUDA
C++ in ``csrc/robust_fusion.cu`` (its header says what bounds them and
what the design does about it), built by ``kernels/_build.py`` at first
use.

On a CPU tensor a wrapper returns its plain version from ``ref.py``; on a
CUDA tensor it launches the kernel on the current stream or raises. Each
checks device, dtype, shape and contiguity first, on either device.
``LAUNCHES`` counts kernel launches, one per wrapper call that reached
the card.

``topk_carve`` updates the carry IN PLACE on the card (and returns the
same three tensors), which saves writing a second 2*K*P fp32 carry per
block; on the CPU it returns fresh tensors, as the reference does. For
K <= 32 a warp of 32 columns inserts with integer min / max on order keys
(the fast route) until it meets a -0 or a NaN, then with fp32 compares
(the exact route); ``carve_routes`` says which the data take.

``trimmed_mean`` and ``coord_median`` take one of two routes by n (see
``dense_route``): a register sorting network per column for n <= 128, a
warp-parallel radix select per column beyond, staged in shared memory
while the block's keys fit there.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.robust_fusion.ref import (
    coordmedian_ref,
    topk_carve_ref,
    trimmedmean_ref,
)

LAUNCHES: Dict[str, int] = {"topk_carve": 0, "trimmed_mean": 0,
                            "coord_median": 0}
_COUNT_LOCK = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the carve's register route, as in the CUDA source: its window sizes KM
# (the smallest that holds K) and the rows a thread loads before it
# inserts them; K past the last window merges in device memory
CARVE_WINDOWS = (1, 2, 4, 8, 16, 24, 32)
CARVE_GROUP = 4


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _library() -> ctypes.CDLL:
    lib = load_library("robust_fusion")
    if lib.robust_dense_route.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.robust_topk_carve.argtypes = [ptr] * 5 + [i64] * 4 + [ptr]
        lib.robust_topk_carve.restype = ctypes.c_int
        lib.robust_trimmed_mean.argtypes = [ptr] * 2 + [i64] * 4 + [ptr]
        lib.robust_trimmed_mean.restype = ctypes.c_int
        lib.robust_coord_median.argtypes = [ptr] * 2 + [i64] * 3 + [ptr]
        lib.robust_coord_median.restype = ctypes.c_int
        lib.robust_dense_route.argtypes = [i64, ctypes.POINTER(i64)]
        lib.robust_dense_route.restype = ctypes.c_int64
    return lib


def build() -> None:
    """Build and load the kernel library now instead of at first launch."""
    _library()


class DenseRoute(NamedTuple):
    """The route of the dense kernels for n rows: ``"register"`` (a
    sorting network over ``nb`` values per thread), ``"warp_staged"`` (a
    warp's radix select over keys staged in ``smem_bytes`` of shared
    memory per block, with ``lane_keys`` of them held in each lane's
    registers, or 0 when every pass reads shared memory) or
    ``"warp_streamed"`` (the same select reading device memory on every
    pass)."""
    route: str
    nb: int = 0
    smem_bytes: int = 0
    lane_keys: int = 0


_ROUTES = ("register", "warp_staged", "warp_streamed")


def dense_route(n: int, device=None) -> DenseRoute:
    """The route ``trimmed_mean`` and ``coord_median`` take for n rows on
    ``device`` (the current card by default)."""
    param = (ctypes.c_int64 * 2)()
    with torch.cuda.device(device):
        route = _ROUTES[_library().robust_dense_route(int(n), param)]
    if route == "register":
        return DenseRoute(route, nb=param[0])
    return DenseRoute(route, smem_bytes=param[0], lane_keys=param[1])


def _device_of(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"robust_fusion kernels take CPU or CUDA tensors, "
                         f"got {dev}")
    return dev


def _check_updates(updates: torch.Tensor, what: str) -> None:
    if updates.dim() != 2:
        raise ValueError(f"{what} must be (rows, P), got "
                         f"{tuple(updates.shape)}")
    if updates.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} dtype {updates.dtype} not in fp32/bf16/fp16")
    if not updates.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def carve_window(K: int) -> int:
    """The register window KM that ``topk_carve`` gives K, or 0 when K
    goes to the merge in device memory."""
    return next((km for km in CARVE_WINDOWS if K <= km), 0)


def _keyless(x: torch.Tensor) -> torch.Tensor:
    """The values an order key cannot carry exactly: -0 and NaN."""
    return torch.isnan(x) | ((x == 0) & torch.signbit(x))


def carve_routes(block: torch.Tensor, valid: torch.Tensor,
                 topk: torch.Tensor, botk: torch.Tensor) -> Dict[str, float]:
    """Which route the register carve takes on these inputs (a block of
    at least one row), by warp (32 adjacent columns) and group of
    CARVE_GROUP rows: ``fast_warps``, the share of warps that insert
    every row on the fast route, and ``fast_groups``, the share of (warp,
    row group) steps on it. A warp leaves the fast route for good at its
    carry or at the first group in which a column holds a -0 or a NaN in
    a valid row. On any device; nothing is launched."""
    c, P = block.shape
    W, G = -(-P // 32), -(-c // CARVE_GROUP)
    pad = torch.nn.functional.pad
    carry = pad(_keyless(topk).any(0) | _keyless(botk).any(0), (0, W * 32 - P))
    odd = pad(_keyless(block.float()) & (valid > 0)[:, None],
              (0, W * 32 - P, 0, G * CARVE_GROUP - c))
    groups = odd.reshape(G, CARVE_GROUP, W, 32).any(3).any(1)      # (G, W)
    fast = ~(carry.reshape(W, 32).any(1) | (groups.cumsum(0) > 0))
    return {"fast_warps": fast[-1].float().mean().item(),
            "fast_groups": fast.float().mean().item()}


def topk_carve(block: torch.Tensor, valid: torch.Tensor, ssum: torch.Tensor,
               topk: torch.Tensor, botk: torch.Tensor):
    """Merge a (c, P) block (fp32, bf16 or fp16) into the carry: ssum
    (P,), ascending topk and botk (K, P), all fp32 and contiguous; valid
    (c,) fp32, rows with ``valid <= 0`` left out. Returns (ssum, topk,
    botk): the carry itself, updated in place, on the card."""
    _check_updates(block, "block")
    c, P = block.shape
    if topk.dim() != 2 or topk.shape[0] < 1 or topk.shape[1] != P:
        raise ValueError(f"topk must be (K >= 1, {P}), got "
                         f"{tuple(topk.shape)}")
    K = topk.shape[0]
    if tuple(botk.shape) != (K, P) or tuple(ssum.shape) != (P,):
        raise ValueError(f"carry shapes ssum {tuple(ssum.shape)}, botk "
                         f"{tuple(botk.shape)} do not match topk ({K}, {P})")
    if tuple(valid.shape) != (c,):
        raise ValueError(f"valid must be ({c},), got {tuple(valid.shape)}")
    for name, t in (("valid", valid), ("ssum", ssum), ("topk", topk),
                    ("botk", botk)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = _device_of(block, valid, ssum, topk, botk)
    if dev.type == "cpu":
        return topk_carve_ref(block, valid, ssum, topk, botk)
    lib = _library()
    if P == 0:
        return ssum, topk, botk
    with torch.cuda.device(dev):
        err = lib.robust_topk_carve(
            block.data_ptr(), valid.data_ptr(), ssum.data_ptr(),
            topk.data_ptr(), botk.data_ptr(), c, P, K,
            _DTYPE_CODES[block.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(err, "robust_topk_carve")
    _count("topk_carve")
    return ssum, topk, botk


def trimmed_mean(updates: torch.Tensor, trim: int) -> torch.Tensor:
    """(n, P) fp32 / bf16 / fp16, contiguous -> (P,) fp32: per column,
    the mean of the values left after dropping the ``trim`` smallest and
    ``trim`` largest (0 <= trim, 2 * trim < n)."""
    _check_updates(updates, "updates")
    n, P = updates.shape
    trim = int(trim)
    if trim < 0 or 2 * trim >= n:
        raise ValueError(f"trim {trim} must satisfy 0 <= trim and "
                         f"2 * trim < n = {n}")
    dev = _device_of(updates)
    if dev.type == "cpu":
        return trimmedmean_ref(updates, trim)
    lib = _library()
    out = torch.empty((P,), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.robust_trimmed_mean(
            updates.data_ptr(), out.data_ptr(), n, P, trim,
            _DTYPE_CODES[updates.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(err, "robust_trimmed_mean")
    _count("trimmed_mean")
    return out


def coord_median(updates: torch.Tensor) -> torch.Tensor:
    """(n >= 1, P) fp32 / bf16 / fp16, contiguous -> (P,) fp32
    per-column median; even n gives (a + b) * 0.5 of the two middle
    values, and a column holding a NaN gives NaN."""
    _check_updates(updates, "updates")
    n, P = updates.shape
    if n < 1:
        raise ValueError("coord_median needs at least one row")
    dev = _device_of(updates)
    if dev.type == "cpu":
        return coordmedian_ref(updates)
    lib = _library()
    out = torch.empty((P,), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.robust_coord_median(
            updates.data_ptr(), out.data_ptr(), n, P,
            _DTYPE_CODES[updates.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(err, "robust_coord_median")
    _count("coord_median")
    return out
