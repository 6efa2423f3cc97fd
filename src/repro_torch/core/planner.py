"""Engine selection (paper Algorithm 1 + §III-D3) as a roofline cost
model over one GPU's memory hierarchy.

For a workload (w_s, n) and a fusion the planner estimates the single-card
plan's time as

  ingest  — bytes from the store to device memory over the host-to-device
            link (``store_bw``),
  memory  — one streaming pass over S = w_s * n at the device-memory rate
            (two for sort-based fusions, which re-read),
  compute — fusion FLOPs over the peak rate (negligible for averaging:
            ~2 FLOPs per element, far below the memory knee),
  compile — the step build a cold engine pays before any byte moves,

and reports it as a feasible plan when S fits device memory or the fusion
streams. The distributed and hierarchical plans of ``repro.core.planner``
wait for the port of the distributed engine.
"""
from __future__ import annotations

import dataclasses
from typing import Collection, Dict, List

from repro_torch.core.fusion.base import FusionAlgorithm
from repro_torch.core.workload import HBM_HEADROOM, Workload, WorkloadClass, classify
from repro_torch.utils.mem import H100_SXM, HardwareSpec

# Pageable host-to-device copy rate of one streamed Resnet50 block (91 MB),
# as chip_smoke.py measures it on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit: 5.9 to 8.0 GB/s over four runs. Store ingest crosses this link.
H2D_BYTES_PER_S = 6.5e9


@dataclasses.dataclass(frozen=True)
class Plan:
    engine: str               # "local"
    workload_class: WorkloadClass
    est_seconds: float
    breakdown: Dict[str, float]
    feasible: bool
    reason: str = ""


@dataclasses.dataclass
class Planner:
    hw: HardwareSpec = H100_SXM
    store_bw: float = H2D_BYTES_PER_S
    # reuse term: an engine without a built step for this round's shape
    # pays the build (and, on the first kernel round, the nvcc build of
    # the library) before any byte moves, so warm engines cost less
    compile_overhead: float = 50e-3

    def candidate_plans(self, load: Workload, fusion: FusionAlgorithm,
                        warm_engines: Collection[str] = ()) -> List[Plan]:
        s = float(load.total_bytes)
        hbm_cap = self.hw.hbm_bytes * HBM_HEADROOM
        mem_t = s / self.hw.hbm_bw
        passes = 1.0 if fusion.reducible else 2.0
        compile_t = 0.0 if "local" in warm_engines else self.compile_overhead
        return [Plan(
            engine="local",
            workload_class=classify(load, self.hw),
            est_seconds=s / self.store_bw + passes * mem_t + compile_t,
            breakdown={
                "ingest": s / self.store_bw,
                "memory": passes * mem_t,
                "compute": 2 * load.num_params * load.n_clients
                / self.hw.peak_flops_bf16,
                "collective": 0.0,
                "compile": compile_t,
            },
            feasible=s <= hbm_cap or fusion.streamable,
            reason="streams client chunks" if s > hbm_cap else "fits HBM",
        )]

    def plan(self, load: Workload, fusion: FusionAlgorithm,
             warm_engines: Collection[str] = ()) -> Plan:
        plans = [
            p for p in self.candidate_plans(load, fusion, warm_engines)
            if p.feasible
        ]
        if not plans:
            raise MemoryError(
                f"no feasible engine for S={load.total_bytes} bytes "
                f"({load.n_clients} x {load.update_bytes})"
            )
        return min(plans, key=lambda p: p.est_seconds)
