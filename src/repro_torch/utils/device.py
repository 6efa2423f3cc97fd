"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` and ``"cuda"`` (or ``"cuda:<i>"``) give the card and raise
    ``RuntimeError`` when PyTorch sees none; the CPU is used only when
    asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' (--device cpu) to run on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the work queued on ``device``'s current stream (no-op on
    the CPU, whose tensor ops finish before they return)."""
    if device is not None and device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of CUDA ``device``, asked once; the
    kernels' wrappers size their grids by it."""
    return torch.cuda.get_device_properties(device).multi_processor_count
