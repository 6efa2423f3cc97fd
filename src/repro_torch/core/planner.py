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

Beyond engine choice the planner owns the round-timing economics, as in
``repro.core.planner``: ``overlap_estimate`` / ``prefer_async`` cost the
monitor-overlapped round against the serialized one
(``async_round="auto"``), and ``round_objective`` is the cost-vs-staleness
trade-off the adaptive controller minimizes. ``round_objective`` is the
reference's arithmetic; ``prefer_async`` plans with this planner's
``store_bw`` (the measured host-to-device rate), so on the same load an
``"auto"`` decision may differ from the reference's, which models the
store at 819 GB/s.
"""
from __future__ import annotations

import dataclasses
from typing import Collection, Dict, List, Tuple

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
    # async-round residue: what cannot hide under the monitor wait — the
    # close-time drain of the last partial block plus the final combine
    overlap_drain_seconds: float = 5e-3

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

    # -- async overlap costing (Algorithm 1, straggler wait) -----------------
    def overlap_estimate(
        self, plan: Plan, expected_wait: float
    ) -> Tuple[float, float]:
        """(serialized_seconds, overlapped_seconds) for a store round whose
        monitor is expected to wait ``expected_wait`` for stragglers.
        Serialized: wait, then ingest and fuse — wait + est. Overlapped:
        ingest and fold stream under the wait as arrivals land —
        max(wait, est) plus the close-time drain residue."""
        serialized = expected_wait + plan.est_seconds
        overlapped = (
            max(expected_wait, plan.est_seconds) + self.overlap_drain_seconds
        )
        return serialized, overlapped

    def round_objective(
        self,
        expected_wait: float,
        inclusion: float,
        cost_bias: float,
        horizon: float,
        est_seconds: float = 0.0,
    ) -> float:
        """The cost-vs-efficiency trade-off the adaptive controller
        minimizes (the paper's user-managed knob, §V): a convex blend of
        the overlapped round wall-clock for closing after
        ``expected_wait`` seconds (``max(wait, est_seconds)`` plus the
        drain residue, normalized by ``horizon``, the static timeout) and
        the staleness ``1 - inclusion``. ``cost_bias`` in [0, 1]: 0
        optimizes wall-clock alone, 1 inclusion alone. Lower is better."""
        overlapped = (
            max(expected_wait, est_seconds) + self.overlap_drain_seconds
        )
        t_norm = min(overlapped, horizon) / max(horizon, 1e-9)
        return (1.0 - cost_bias) * t_norm + cost_bias * (1.0 - inclusion)

    def prefer_async(
        self,
        load: Workload,
        fusion: FusionAlgorithm,
        expected_wait: float,
        warm_engines: Collection[str] = (),
    ) -> bool:
        """True when the overlapped round model beats the serialized one,
        i.e. when the monitor wait dominates the drain residue. Only
        streamable fusions can fold while stragglers write."""
        if not fusion.streamable:
            return False
        plan = self.plan(load, fusion, warm_engines)
        serialized, overlapped = self.overlap_estimate(plan, expected_wait)
        return overlapped < serialized

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
