"""Trace-driven workload generation — ``repro.workload`` without JAX.

Numpy-only copies of the JAX package's generator and replay: the same
spec and seed give the same ``WorkloadTrace``, the same canonical JSON
bytes, the same ``trace_hash`` and the same ``trace_payload`` bits in
both packages; replay writes into the port's ``UpdateStore``.
The workload is a first-class, seeded, serializable object:

  * ``arrivals`` — ``ArrivalProcess`` hierarchy (uniform / Poisson /
    bursty / lognormal heavy-tail / diurnal), each turning a seeded
    Generator into one round's client-arrival offsets; returning fewer
    than ``n`` offsets models dropout.
  * ``sizes`` — ``SizeDistribution`` (fixed / lognormal /
    per-model-config via the Table-I CNN suite): params per update,
    sampled once per tenant.
  * ``churn`` — ``TenantChurn``: cold-start tenants joining (and
    leaving) mid-soak, scheduled or Poisson-random.
  * ``regime`` — ``RegimeSchedule``: piecewise arrival regimes with
    exact round boundaries, for mid-run shifts.
  * ``trace`` — ``WorkloadSpec.build(seed)`` compiles the above into a
    ``WorkloadTrace`` (every round, tenant, client offset and weight),
    serializable to/from a canonical JSON file bit-for-bit; identical
    seeds hash identically (``trace_hash``).
  * ``replay`` — drives a trace against a live ``UpdateStore`` on a
    real or scripted clock, with deterministic payloads.

The classifier in ``repro_torch.core.workload`` (the paper's Algorithm 1
condition) is re-exported here so ``repro_torch.workload`` is the single
import point for "what load is this" AND "generate that load".
"""
from repro_torch.core.workload import (           # noqa: F401  (re-export)
    HBM_HEADROOM,
    Workload,
    WorkloadClass,
    classify,
    max_clients_single_node,
)
from repro_torch.workload.arrivals import (       # noqa: F401
    ArrivalProcess,
    BurstyArrivals,
    DiurnalArrivals,
    LognormalArrivals,
    PoissonArrivals,
    UniformArrivals,
    arrival_from_dict,
)
from repro_torch.workload.churn import TenantChurn, churn_from_dict  # noqa: F401
from repro_torch.workload.regime import Regime, RegimeSchedule       # noqa: F401
from repro_torch.workload.replay import (         # noqa: F401
    replay_round,
    start_writer,
    trace_payload,
)
from repro_torch.workload.sizes import (          # noqa: F401
    FixedSize,
    LognormalSize,
    ModelConfigSize,
    SizeDistribution,
    size_from_dict,
)
from repro_torch.workload.trace import (          # noqa: F401
    ClientEvent,
    RoundTrace,
    TenantRound,
    WorkloadSpec,
    WorkloadTrace,
    build_trace,
)

__all__ = [
    "HBM_HEADROOM",
    "Workload",
    "WorkloadClass",
    "classify",
    "max_clients_single_node",
    "ArrivalProcess",
    "UniformArrivals",
    "PoissonArrivals",
    "BurstyArrivals",
    "LognormalArrivals",
    "DiurnalArrivals",
    "arrival_from_dict",
    "SizeDistribution",
    "FixedSize",
    "LognormalSize",
    "ModelConfigSize",
    "size_from_dict",
    "TenantChurn",
    "churn_from_dict",
    "Regime",
    "RegimeSchedule",
    "ClientEvent",
    "TenantRound",
    "RoundTrace",
    "WorkloadSpec",
    "WorkloadTrace",
    "build_trace",
    "replay_round",
    "start_writer",
    "trace_payload",
]
