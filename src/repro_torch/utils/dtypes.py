"""Host arrays for the float types numpy lacks, and host-to-device copies.

numpy has no bfloat16 of its own (the JAX package borrows ``ml_dtypes``'
one, which the card's machine does not have). So the port keeps bf16
rows on the host as their raw 16-bit words under the structured dtype
``BF16`` — a numpy dtype that stacks, slices, saves and loads like any
other — and views them as ``torch.bfloat16`` after the copy to the
device. The disk spool names the type ``"bfloat16"`` in its ``.dtype``
sidecar, as the JAX package does, so spools stay byte-compatible.
"""
from __future__ import annotations

import numpy as np
import torch

BF16 = np.dtype([("bfloat16", "<u2")])


def is_bf16(dtype) -> bool:
    """``BF16``, or ``ml_dtypes``' bfloat16 where that is registered."""
    dt = np.dtype(dtype)
    return dt == BF16 or (dt.kind == "V" and dt.names is None
                          and dt.itemsize == 2 and dt.name == "bfloat16")


def dtype_name(dtype) -> str:
    """The name the disk spool's ``.dtype`` sidecar stores."""
    return "bfloat16" if is_bf16(dtype) else np.dtype(dtype).name


def dtype_from_name(name: str) -> np.dtype:
    """Inverse of :func:`dtype_name`, without numpy knowing bfloat16."""
    return BF16 if name == "bfloat16" else np.dtype(name)


def host_dtype(x) -> np.dtype:
    """The host (numpy) dtype of an array or of a tensor's elements."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return BF16
        return torch.empty((0,), dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def fold_dtype(x) -> np.dtype:
    """The dtype dense updates are folded in (see updates_to_device)."""
    dt = host_dtype(x)
    if is_bf16(dt):
        return BF16
    if dt in (np.float32, np.float16):
        return dt
    return np.dtype(np.float32)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a host dtype; ``BF16`` words (or ml_dtypes'
    bfloat16) are ``torch.bfloat16``."""
    if is_bf16(dtype):
        return torch.bfloat16
    return torch.from_numpy(np.empty((0,), np.dtype(dtype))).dtype


def host_array(x) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array, bf16 as
    ``BF16`` words."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(BF16)
        return x.numpy()
    arr = np.asarray(x)
    if arr.dtype != BF16 and is_bf16(arr.dtype):
        return np.ascontiguousarray(arr).view(np.uint16).view(BF16)
    return arr


def to_device(x, device: torch.device) -> torch.Tensor:
    """Copy a host array (or move a tensor) to ``device`` in its own
    dtype, contiguous; ``BF16`` words arrive as ``torch.bfloat16``."""
    if isinstance(x, torch.Tensor):
        return x.to(device).contiguous()
    arr = np.asarray(x)
    if not arr.flags.writeable:   # torch.from_numpy wants writable memory
        arr = arr.copy()
    arr = np.asarray(arr, order="C")   # keeps 0-d arrays 0-d
    if is_bf16(arr.dtype):
        raw = arr.view(np.int16)
        return torch.from_numpy(raw).to(device).view(torch.bfloat16)
    return torch.from_numpy(arr).to(device)


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor as it is (moved to ``device`` when one is given), or an
    array-like, bf16 included, copied to ``device`` (the CPU by default)
    in its own dtype."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return to_device(host_array(x), torch.device("cpu") if device is None
                     else device)


def updates_to_device(x, device: torch.device) -> torch.Tensor:
    """Dense client updates on ``device`` in a float type the fusions
    take: fp32 / bf16 / fp16 stay, fp64 is computed in fp32 as the JAX
    package does with x64 off (cast on the host, halving the copy), and
    integers and bools become fp32."""
    if isinstance(x, torch.Tensor):
        t = x.to(device)
        if t.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            t = t.float()
        return t.contiguous()
    arr = np.asarray(x)
    if not is_bf16(arr.dtype) and arr.dtype not in (np.float32, np.float16):
        arr = arr.astype(np.float32)
    return to_device(arr, device)
