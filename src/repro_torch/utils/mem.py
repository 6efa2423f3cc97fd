"""Hardware constants and memory math for the planner and the roofline."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-card hardware model used by the planner and the roofline."""

    name: str
    peak_flops_bf16: float  # FLOP/s, dense tensor cores
    hbm_bytes: int          # device memory per card
    hbm_bw: float           # device memory bytes/s
    onchip_bytes: int       # on-chip tier (L2) per card
    nvlink_bw: float        # bytes/s each way to the other cards
    sm_count: int


# NVIDIA's H100 SXM data sheet (dense rates, 700 W).
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bytes=80 * 10**9,
    hbm_bw=3.35e12,
    onchip_bytes=50 * 10**6,
    nvlink_bw=450e9,
    sm_count=132,
)


def hardware_spec(device=None) -> HardwareSpec:
    """The data-sheet spec, with name, memory size and SM count read from
    the card itself when ``device`` is a CUDA device."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return H100_SXM
    props = torch.cuda.get_device_properties(dev)
    return dataclasses.replace(
        H100_SXM, name=props.name, hbm_bytes=int(props.total_memory),
        sm_count=int(props.multi_processor_count),
    )


def bytes_to_human(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} PiB"
