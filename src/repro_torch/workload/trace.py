"""Trace compilation + canonical serialization.

``WorkloadSpec.build(seed)`` expands the generator stack (regimes x
sizes x churn) into a ``WorkloadTrace``: every round, every active
tenant, every arriving client's offset and weight. Determinism is
per-stream: each (round, tenant) gets its own
``default_rng([seed, stream, round, crc32(tenant)])``, so traces are
reproducible bit-for-bit and insensitive to iteration order.

Serialization is CANONICAL — ``canonical_json`` is the one string form
(sorted keys, compact separators), ``to_json`` writes exactly it, and
``trace_hash`` is its sha256 — so "identical seed => identical trace
file" is a byte-level guarantee, not a float-tolerance one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.workload.churn import TenantChurn, churn_from_dict
from repro_torch.workload.regime import RegimeSchedule
from repro_torch.workload.sizes import FixedSize, SizeDistribution, size_from_dict

TRACE_VERSION = 1

# independent seed streams: churn schedule / per-tenant size /
# per-(round, tenant) arrivals+weights / replay payloads
_CHURN_STREAM = 1
_SIZE_STREAM = 2
_ROUND_STREAM = 3
PAYLOAD_STREAM = 4


def _crc(name: str) -> int:
    # crc32, not hash(): streams must be stable across processes
    return zlib.crc32(name.encode())


@dataclasses.dataclass(frozen=True)
class ClientEvent:
    """One client's write: arrives ``offset`` seconds after round open."""

    client_id: str
    offset: float
    weight: float


@dataclasses.dataclass(frozen=True)
class TenantRound:
    tenant: str
    expected: int     # the gate's denominator (dropped clients included)
    dim: int          # params per update for this tenant
    regime: str       # regime name in force this round
    events: Tuple[ClientEvent, ...]


@dataclasses.dataclass(frozen=True)
class RoundTrace:
    index: int
    tenants: Tuple[TenantRound, ...]

    def tenant(self, name: str) -> TenantRound:
        for tr in self.tenants:
            if tr.tenant == name:
                return tr
        raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """The generator stack; ``build(seed)`` compiles it to a trace."""

    tenants: Tuple[str, ...]
    n_clients: int
    rounds: int
    regimes: RegimeSchedule
    sizes: SizeDistribution = dataclasses.field(default_factory=FixedSize)
    churn: Optional[TenantChurn] = None
    weight_range: Tuple[float, float] = (1.0, 7.0)

    def build(self, seed: int) -> "WorkloadTrace":
        churn_rng = np.random.default_rng([seed, _CHURN_STREAM])
        churn_active = (
            self.churn.schedule(churn_rng, self.rounds)
            if self.churn is not None
            else [[] for _ in range(self.rounds)]
        )
        dims: Dict[str, int] = {}

        def dim_for(tenant: str) -> int:
            if tenant not in dims:
                srng = np.random.default_rng(
                    [seed, _SIZE_STREAM, _crc(tenant)])
                dims[tenant] = int(self.sizes.sample(srng))
            return dims[tenant]

        rounds = []
        for r in range(self.rounds):
            regime = self.regimes.at(r)
            active = list(self.tenants) + churn_active[r]
            tenant_rounds = []
            for t in active:
                rng = np.random.default_rng(
                    [seed, _ROUND_STREAM, r, _crc(t)])
                offsets = np.sort(np.asarray(
                    regime.arrivals.sample(rng, self.n_clients,
                                           round_index=r),
                    dtype=np.float64))
                lo, hi = self.weight_range
                weights = rng.uniform(lo, hi, size=len(offsets))
                events = tuple(
                    ClientEvent(f"client{i:05d}", float(o), float(w))
                    for i, (o, w) in enumerate(zip(offsets, weights))
                )
                tenant_rounds.append(TenantRound(
                    tenant=t, expected=self.n_clients, dim=dim_for(t),
                    regime=regime.name, events=events,
                ))
            rounds.append(RoundTrace(index=r, tenants=tuple(tenant_rounds)))
        return WorkloadTrace(seed=seed, spec=self.to_dict(),
                             rounds=tuple(rounds))

    def to_dict(self) -> dict:
        return {
            "tenants": list(self.tenants),
            "n_clients": self.n_clients,
            "rounds": self.rounds,
            "regimes": self.regimes.to_dict(),
            "sizes": self.sizes.to_dict(),
            "churn": self.churn.to_dict() if self.churn else None,
            "weight_range": list(self.weight_range),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSpec":
        return cls(
            tenants=tuple(d["tenants"]),
            n_clients=int(d["n_clients"]),
            rounds=int(d["rounds"]),
            regimes=RegimeSchedule.from_dict(d["regimes"]),
            sizes=size_from_dict(d["sizes"]),
            churn=(churn_from_dict(d["churn"])
                   if d.get("churn") else None),
            weight_range=tuple(d.get("weight_range", (1.0, 7.0))),
        )


@dataclasses.dataclass(frozen=True)
class WorkloadTrace:
    seed: int
    spec: dict
    rounds: Tuple[RoundTrace, ...]

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    def to_dict(self) -> dict:
        return {
            "version": TRACE_VERSION,
            "seed": self.seed,
            "spec": self.spec,
            "rounds": [
                {
                    "index": rt.index,
                    "tenants": [
                        {
                            "tenant": tr.tenant,
                            "expected": tr.expected,
                            "dim": tr.dim,
                            "regime": tr.regime,
                            "events": [[e.client_id, e.offset, e.weight]
                                       for e in tr.events],
                        }
                        for tr in rt.tenants
                    ],
                }
                for rt in self.rounds
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadTrace":
        version = d.get("version")
        if version != TRACE_VERSION:
            raise ValueError(f"trace version {version!r} != "
                             f"{TRACE_VERSION}")
        return cls(
            seed=int(d["seed"]),
            spec=d["spec"],
            rounds=tuple(
                RoundTrace(
                    index=int(rt["index"]),
                    tenants=tuple(
                        TenantRound(
                            tenant=tr["tenant"],
                            expected=int(tr["expected"]),
                            dim=int(tr["dim"]),
                            regime=tr["regime"],
                            events=tuple(
                                ClientEvent(cid, float(off), float(w))
                                for cid, off, w in tr["events"]
                            ),
                        )
                        for tr in rt["tenants"]
                    ),
                )
                for rt in d["rounds"]
            ),
        )

    def canonical_json(self) -> str:
        """THE string form: sorted keys, compact separators. Hash and
        file contents both derive from it."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def trace_hash(self) -> str:
        return hashlib.sha256(
            self.canonical_json().encode()).hexdigest()

    def to_json(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.canonical_json())
            f.write("\n")
        return path

    @classmethod
    def from_json(cls, path: str) -> "WorkloadTrace":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def build_trace(spec: WorkloadSpec, seed: int) -> WorkloadTrace:
    """Module-level convenience mirror of ``spec.build(seed)``."""
    return spec.build(seed)
