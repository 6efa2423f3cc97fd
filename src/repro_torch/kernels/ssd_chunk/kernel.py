"""Hopper kernels for the SSD (Mamba2) chunked scan.

``ssd_chunk`` replaces ``repro/kernels/ssd_chunk/kernel.py``
``ssd_chunk_pallas`` with its wrapper ``ops.py`` ``ssd_scan``. It is CUDA
C++ in ``csrc/ssd_chunk.cu`` (its header says what bounds it and what
the design does about it), built by ``kernels/_build.py`` at first use.
A call runs :func:`device_kernels` device kernels: one block per (batch,
chunk, tile of :func:`head_tile` heads) takes the float64 prefix sums of
the log-decays, the chunk's state increment and its share of the scores
C·Bᵀ (``ssd_state_kernel``); a thread per state element hands the (N, P)
state from chunk to chunk (``ssd_handoff_kernel``); one block per
(64-row tile, chunk, batch, head tile) computes its rows of y
(``ssd_out_kernel``). Every product runs on the tensor cores in three
TF32 passes. The wrapper allocates the fp32 workspaces (prefix sums,
scores, chunk-start states) with ``torch.empty`` and pads bf16 / fp16
rows to 16 bytes; with ``return_saved`` it hands back the prefix sums,
the chunk-start states and the scores.

``ssd_chunk_bwd`` is the scan's backward (no ``pallas_call`` of the
reference: ``jax.vjp`` of its ``chunk_step``), fp32 only, from the
forward's saved prefix sums, states and scores: :func:`bwd_device_kernels`
device kernels (the increments of the state's gradient and their reverse
hand-off, a row and a column kernel over the causal tile pairs, the
float64 scans into dlam, the head sums of dB and dC), every product on
the tensor cores in three TF32 passes.

On a CPU tensor the wrapper returns its plain version from ``ref.py``; on
a CUDA tensor it launches the kernels on the current stream or raises. It
checks device, dtype, shape and contiguity first, on either device.
``LAUNCHES`` counts wrapper calls that reached the card, one per call.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.ssd_chunk.ref import (
    chunk_len,
    ssd_scan_bwd_ref,
    ssd_scan_ref,
)
from repro_torch.utils.device import sm_count

LAUNCHES: Dict[str, int] = {"ssd_chunk": 0, "ssd_chunk_bwd": 0}
_COUNT_LOCK = threading.Lock()

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_STATE = 128      # N, padded to 16 / 32 / 64 / 128 in shared memory
MAX_HEAD_DIM = 64    # P, padded to 64
ROW_TILE = 64        # steps a block of the output kernel takes


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _library() -> ctypes.CDLL:
    lib = load_library("ssd_chunk")
    if lib.ssd_chunk_fwd.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.ssd_chunk_fwd.argtypes = [ptr] * 8 + [i64] * 8 + [ptr]
        lib.ssd_chunk_fwd.restype = ctypes.c_int
        lib.ssd_chunk_bwd.argtypes = [ptr] * 15 + [i64] * 6 + [ptr]
        lib.ssd_chunk_bwd.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernel library now instead of at first launch."""
    _library()


def device_kernels(T: int, chunk: int = 256) -> int:
    """Device kernels one call runs: the prefix sums and state increments,
    the hand-off of the state from chunk to chunk (when there are two
    chunks or more), and the output."""
    return 3 if T // chunk_len(T, chunk) > 1 else 2


def bwd_device_kernels(T: int, chunk: int = 256) -> int:
    """Device kernels one backward call runs: the state gradient's
    increments and their hand-off (when there are two chunks or more),
    the row and column kernels, dlam, and the head sums."""
    return 6 if T // chunk_len(T, chunk) > 1 else 4


def state_pad(N: int) -> int:
    """N padded to the kernels' state tile: 16, 32, 64 or 128."""
    pad = 16
    while pad < N:
        pad *= 2
    return pad


def head_tile(batch: int, chunks: int, row_tiles: int, heads: int,
              sm_count: int) -> int:
    """Heads a block of the state and output kernels takes (2 or 1): two
    when they divide ``heads`` and the output grid still gives every one
    of the card's ``sm_count`` SMs a block. A state block shares each B
    tile between its heads, an output block each column tile's scores."""
    if heads % 2 == 0 and batch * chunks * row_tiles * heads // 2 >= sm_count:
        return 2
    return 1


def check_inputs(lam: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 xdt: torch.Tensor) -> None:
    """lam (B, T, H) of a float dtype; Bm, Cm (B, T, N) and xdt
    (B, T, H, P) of one of fp32 / bf16 / fp16; all contiguous, on one
    device; 1 <= N <= 128 and 1 <= P <= 64."""
    if lam.dim() != 3 or Bm.dim() != 3 or xdt.dim() != 4 \
            or tuple(Cm.shape) != tuple(Bm.shape):
        raise ValueError(f"lam must be (B, T, H), Bm / Cm (B, T, N) and xdt "
                         f"(B, T, H, P); got {tuple(lam.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}, "
                         f"{tuple(xdt.shape)}")
    B, T, H = lam.shape
    if tuple(Bm.shape[:2]) != (B, T) or tuple(xdt.shape[:3]) != (B, T, H):
        raise ValueError(f"Bm {tuple(Bm.shape)} / xdt {tuple(xdt.shape)} do "
                         f"not match lam {tuple(lam.shape)}")
    N, P = Bm.shape[2], xdt.shape[3]
    if not (1 <= N <= MAX_STATE and 1 <= P <= MAX_HEAD_DIM):
        raise ValueError(f"state {N} / head dim {P} outside the kernel's "
                         f"1..{MAX_STATE} / 1..{MAX_HEAD_DIM}")
    if not lam.dtype.is_floating_point:
        raise TypeError(f"lam must be floating point, got {lam.dtype}")
    if Bm.dtype not in DTYPE_CODES or Cm.dtype != Bm.dtype \
            or xdt.dtype != Bm.dtype:
        raise TypeError(f"Bm, Cm, xdt must share one of fp32 / bf16 / fp16; "
                        f"got {Bm.dtype}, {Cm.dtype}, {xdt.dtype}")
    for name, t in (("lam", lam), ("Bm", Bm), ("Cm", Cm), ("xdt", xdt)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (lam.device == Bm.device == Cm.device == xdt.device):
        raise ValueError(f"lam, Bm, Cm, xdt on {lam.device}, {Bm.device}, "
                         f"{Cm.device}, {xdt.device}")
    if lam.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the SSD kernel takes CPU or CUDA tensors, got "
                         f"{lam.device}")


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """A bf16 / fp16 tensor whose rows (last dimension) the kernels copy
    16 bytes at a time: padded with zeros to a multiple of 8 elements,
    and copied when its data is not 16-byte aligned. Zero columns of B, C
    and x add nothing to y; y's padded columns are dropped."""
    pad = -t.shape[-1] % 8
    if pad:
        return torch.nn.functional.pad(t, (0, pad))
    return t if t.data_ptr() % 16 == 0 else t.clone()


Saved = Optional[Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]]


def ssd_chunk(lam: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
              xdt: torch.Tensor, *, chunk: int = 256,
              return_saved: bool = False):
    """The SSD scan: lam (B, T, H) log-decays, Bm / Cm (B, T, N) shared
    across heads, xdt (B, T, H, P) dt-scaled inputs -> y (B, T, H, P)
    fp32, in chunks of ``chunk_len(T, chunk)`` steps (the whole sequence
    when ``chunk`` does not divide T). lam is taken in fp32. With
    ``return_saved``, (y, saved): on the card ``saved`` is (the prefix
    sums (B, H, nc, Lpad), the chunk-start states (B, nc - 1, H, N_pad,
    64) or None for one chunk, the scores C·Bᵀ of every (batch, chunk,
    tile pair) (B, nc, RT (RT + 1) / 2, 64, 64)), what ``ssd_chunk_bwd``
    takes; None on the CPU and for empty inputs. The scores hold
    B * nc * RT (RT + 1) / 2 * 16 KB (RT = ceil(L / 64)): 2.6 MB at the
    Zamba2-1.2B layer, but 0.54 GB at B 4, L = T = 8191."""
    check_inputs(lam, Bm, Cm, xdt)
    L = chunk_len(lam.shape[1], int(chunk))
    if lam.device.type == "cpu":
        y = ssd_scan_ref(lam, Bm, Cm, xdt, chunk=chunk)
        return (y, None) if return_saved else y
    B, T, H = lam.shape
    P_out = xdt.shape[3]
    if B == 0 or T == 0 or H == 0:
        y = torch.empty((B, T, H, P_out), dtype=torch.float32,
                        device=lam.device)
        return (y, None) if return_saved else y
    if Bm.dtype != torch.float32:
        Bm, Cm, xdt = (_rows16(t) for t in (Bm, Cm, xdt))
    N, P = Bm.shape[2], xdt.shape[3]
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=lam.device)
    nc, row_tiles = T // L, -(-L // ROW_TILE)
    n_pad = state_pad(N)
    tile = head_tile(B, nc, row_tiles, H, sm_count(lam.device))
    lam32 = lam.float()
    cum = torch.empty((B, H, nc, row_tiles * ROW_TILE), dtype=torch.float32,
                      device=lam.device)
    pairs = row_tiles * (row_tiles + 1) // 2
    scores = torch.empty((B, nc, pairs, ROW_TILE, ROW_TILE),
                         dtype=torch.float32, device=lam.device)
    states = (torch.empty((B, nc - 1, H, n_pad, MAX_HEAD_DIM),
                          dtype=torch.float32, device=lam.device)
              if nc > 1 else None)
    lib = _library()
    with torch.cuda.device(lam.device):
        err = lib.ssd_chunk_fwd(
            lam32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), xdt.data_ptr(),
            y.data_ptr(), cum.data_ptr(), scores.data_ptr(),
            None if states is None else states.data_ptr(),
            B, T, H, N, P, L, tile, DTYPE_CODES[Bm.dtype],
            torch.cuda.current_stream(lam.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_chunk_fwd launch failed: CUDA error {err}")
    _count("ssd_chunk")
    y = y if P == P_out else y[..., :P_out].contiguous()
    return (y, (cum, states, scores)) if return_saved else y


def ssd_chunk_bwd(lam: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                  xdt: torch.Tensor, dy: torch.Tensor, *, chunk: int = 256,
                  saved: Saved = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The gradients (dlam (B, T, H), dBm, dCm (B, T, N), dxdt (B, T, H,
    P)) of ``ssd_chunk``'s y against dy (B, T, H, P), fp32. Every input is
    fp32 (the model feeds the scan fp32); dy may be non-contiguous. On the
    card ``saved`` is what ``ssd_chunk(..., return_saved=True)`` returned
    for the same inputs and chunk (the backward reads the forward's
    scores C·Bᵀ instead of forming them again); on the CPU the plain
    version ``ssd_scan_bwd_ref`` runs and ``saved`` is not read."""
    check_inputs(lam, Bm, Cm, xdt)
    if tuple(dy.shape) != tuple(xdt.shape) or dy.device != xdt.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} does not "
                         f"match xdt {tuple(xdt.shape)} on {xdt.device}")
    for name, t in (("lam", lam), ("Bm", Bm), ("Cm", Cm), ("xdt", xdt),
                    ("dy", dy)):
        if t.dtype != torch.float32:
            raise TypeError(f"the SSD backward takes fp32 only; {name} is "
                            f"{t.dtype}")
    dy = dy.contiguous()
    B, T, H = lam.shape
    N, P = Bm.shape[2], xdt.shape[3]
    L = chunk_len(T, int(chunk))
    if lam.device.type == "cpu":
        return ssd_scan_bwd_ref(lam, Bm, Cm, xdt, dy, chunk=chunk)
    dev = lam.device
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    if B == 0 or T == 0 or H == 0:
        return zeros(B, T, H), zeros(B, T, N), zeros(B, T, N), \
            zeros(B, T, H, P)
    nc, n_pad = T // L, state_pad(N)
    row_tiles = -(-L // ROW_TILE)
    Lpad, pairs = row_tiles * ROW_TILE, row_tiles * (row_tiles + 1) // 2
    if saved is None:
        raise ValueError("ssd_chunk_bwd on the card needs the forward's "
                         "saved prefix sums, states and scores: pass "
                         "ssd_chunk(..., return_saved=True)'s")
    cum, states, scores = saved
    if tuple(cum.shape) != (B, H, nc, Lpad) or (
            nc > 1 and (states is None or tuple(states.shape) != (
                B, nc - 1, H, n_pad, MAX_HEAD_DIM))) \
            or tuple(scores.shape) != (B, nc, pairs, ROW_TILE, ROW_TILE):
        raise ValueError(f"saved prefix sums {tuple(cum.shape)} / states "
                         f"{None if states is None else tuple(states.shape)} "
                         f"/ scores {tuple(scores.shape)} are not the "
                         f"forward's of inputs {tuple(xdt.shape)} at L = {L}")
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    dlam, dB, dC, dx = empty(B, T, H), empty(B, T, N), empty(B, T, N), \
        empty(B, T, H, P)
    g_ws = empty(B, nc - 1, H, n_pad, MAX_HEAD_DIM) if nc > 1 else None
    part = empty(4, B, H, nc, Lpad)
    dB_part, dC_part = empty(B, T, H, N), empty(B, T, H, N)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.ssd_chunk_bwd(
            Bm.data_ptr(), Cm.data_ptr(), xdt.data_ptr(), dy.data_ptr(),
            cum.data_ptr(), scores.data_ptr(), ptr(states), dlam.data_ptr(),
            dB.data_ptr(),
            dC.data_ptr(), dx.data_ptr(), ptr(g_ws), part.data_ptr(),
            dB_part.data_ptr(), dC_part.data_ptr(), B, T, H, N, P, L,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd launch failed: CUDA error {err}")
    _count("ssd_chunk_bwd")
    return dlam, dB, dC, dx
