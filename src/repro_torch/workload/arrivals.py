"""Arrival processes — when, within a round, each client's update lands.

Each process turns a seeded ``numpy.random.Generator`` into ONE round's
client-arrival offsets (seconds from round open, sorted ascending).
Returning fewer than ``n`` offsets models client dropout: absent
clients never write, and the round's gate has to decide how long to
wait for them — exactly the regime the adaptive controller targets.

All processes are frozen dataclasses. ``to_dict`` emits a plain dict
(a ``kind`` tag plus the constructor fields) and ``arrival_from_dict``
reconstitutes it bit-identically — the contract the trace file format
(``repro_torch.workload.trace``) is built on. Sampling must depend only on
``(rng, n, round_index)`` so a trace built twice from one seed is
byte-identical.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, Tuple, Type

import numpy as np

_REGISTRY: Dict[str, Type["ArrivalProcess"]] = {}


def register_arrival(cls):
    """Class decorator: adds the process to the ``kind`` registry that
    ``arrival_from_dict`` dispatches on."""
    _REGISTRY[cls.kind] = cls
    return cls


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Base: one round's arrival offsets from a seeded Generator."""

    kind: ClassVar[str] = "base"

    def sample(self, rng: np.random.Generator, n: int,
               round_index: int = 0) -> np.ndarray:
        """Offsets (seconds from round open) for the clients that DO
        arrive this round, sorted ascending, length <= n."""
        raise NotImplementedError

    def to_dict(self) -> dict:
        d: dict = {"kind": self.kind}
        # pure-JSON values only (tuples -> lists), so the in-memory
        # dict equals its JSON round-trip, not just hash-equals it
        d.update({k: list(v) if isinstance(v, tuple) else v
                  for k, v in dataclasses.asdict(self).items()})
        return d


def arrival_from_dict(d: dict) -> "ArrivalProcess":
    """Inverse of ``to_dict`` for every registered process."""
    d = dict(d)
    kind = d.pop("kind")
    if kind not in _REGISTRY:
        raise ValueError(f"unknown arrival kind {kind!r} "
                         f"(known: {sorted(_REGISTRY)})")
    cls = _REGISTRY[kind]
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{kind}: unknown fields {sorted(unknown)}")
    # JSON has no tuples: window/range fields come back as lists
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    return cls(**kw)


@register_arrival
@dataclasses.dataclass(frozen=True)
class UniformArrivals(ArrivalProcess):
    """Evenly spaced over ``spread`` seconds — the benchmarks' classic
    ``(i+1) * spread / n`` schedule. ``arrive_frac < 1`` drops the
    tail (the latest clients never show)."""

    kind: ClassVar[str] = "uniform"

    spread: float = 1.0
    arrive_frac: float = 1.0

    def sample(self, rng, n, round_index=0):
        arrive = max(int(n * self.arrive_frac), 1)
        return np.linspace(self.spread / n, self.spread, n)[:arrive]


@register_arrival
@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals at ``rate`` clients/second (exponential
    inter-arrival gaps)."""

    kind: ClassVar[str] = "poisson"

    rate: float = 10.0
    arrive_frac: float = 1.0

    def sample(self, rng, n, round_index=0):
        arrive = max(int(n * self.arrive_frac), 1)
        gaps = rng.exponential(1.0 / self.rate, size=arrive)
        return np.cumsum(gaps)


@register_arrival
@dataclasses.dataclass(frozen=True)
class BurstyArrivals(ArrivalProcess):
    """A front-loaded burst with dropout: ``arrive_frac`` of the fleet
    lands uniformly inside ``window`` (fractions of ``spread``), the
    rest never arrive — the scenario where a static full-inclusion
    gate burns its whole timeout every round."""

    kind: ClassVar[str] = "bursty"

    spread: float = 1.0
    arrive_frac: float = 0.9
    window: Tuple[float, float] = (0.05, 0.15)

    def sample(self, rng, n, round_index=0):
        arrive = max(int(n * self.arrive_frac), 1)
        lo, hi = self.window
        burst = rng.uniform(lo * self.spread, hi * self.spread,
                            size=arrive)
        return np.sort(burst)


@register_arrival
@dataclasses.dataclass(frozen=True)
class LognormalArrivals(ArrivalProcess):
    """Heavy-tailed: most clients early (median at ``median_frac *
    spread``), a long straggler tail clipped to ``spread``;
    ``drop_clients`` of the fleet never arrive."""

    kind: ClassVar[str] = "lognormal"

    spread: float = 1.0
    sigma: float = 0.6
    median_frac: float = 0.2
    drop_clients: int = 2

    def sample(self, rng, n, round_index=0):
        arrive = max(n - self.drop_clients, 1)
        body = rng.lognormal(mean=math.log(self.median_frac * self.spread),
                             sigma=self.sigma, size=arrive)
        return np.sort(np.clip(body, 0.0, self.spread))


@register_arrival
@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Non-homogeneous Poisson over one ``period``-second window with a
    sinusoidal rate between ``base_rate`` and ``peak_rate`` (thinning
    sampler). ``round_advance`` shifts the phase every round, so a
    soak sweeps through peak and trough traffic — clients that don't
    arrive before the window closes are dropped."""

    kind: ClassVar[str] = "diurnal"

    period: float = 4.0
    base_rate: float = 2.0
    peak_rate: float = 16.0
    phase: float = 0.0
    round_advance: float = 0.125

    def rate_at(self, t: float, phase: float) -> float:
        cyc = 0.5 * (1.0 - math.cos(
            2.0 * math.pi * (t / self.period + phase)))
        return self.base_rate + (self.peak_rate - self.base_rate) * cyc

    def sample(self, rng, n, round_index=0):
        lam_max = max(self.peak_rate, self.base_rate, 1e-12)
        phase = self.phase + round_index * self.round_advance
        out = []
        t = 0.0
        while len(out) < n:
            t += rng.exponential(1.0 / lam_max)
            if t >= self.period:
                break
            if rng.uniform() * lam_max <= self.rate_at(t, phase):
                out.append(t)
        return np.asarray(out, dtype=np.float64)
