"""Update-size distributions — params per client update, per tenant.

A tenant's clients all train one model, so the dimension is sampled
ONCE per tenant (the engines require homogeneous P within a round);
across tenants the sizes vary per the distribution. Same
``to_dict`` / ``size_from_dict`` contract as the arrival processes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, Tuple, Type

import numpy as np

from repro_torch.configs.cnn_suite import CNN_SUITE

_REGISTRY: Dict[str, Type["SizeDistribution"]] = {}


def register_size(cls):
    _REGISTRY[cls.kind] = cls
    return cls


@dataclasses.dataclass(frozen=True)
class SizeDistribution:
    """Base: one tenant's update dimension from a seeded Generator."""

    kind: ClassVar[str] = "base"

    def sample(self, rng: np.random.Generator) -> int:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d: dict = {"kind": self.kind}
        # pure-JSON values only (tuples -> lists), matching the
        # arrival processes' round-trip contract
        d.update({k: list(v) if isinstance(v, tuple) else v
                  for k, v in dataclasses.asdict(self).items()})
        return d


def size_from_dict(d: dict) -> "SizeDistribution":
    d = dict(d)
    kind = d.pop("kind")
    if kind not in _REGISTRY:
        raise ValueError(f"unknown size kind {kind!r} "
                         f"(known: {sorted(_REGISTRY)})")
    cls = _REGISTRY[kind]
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{kind}: unknown fields {sorted(unknown)}")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    return cls(**kw)


@register_size
@dataclasses.dataclass(frozen=True)
class FixedSize(SizeDistribution):
    kind: ClassVar[str] = "fixed"

    dim: int = 20_000

    def sample(self, rng):
        return self.dim


@register_size
@dataclasses.dataclass(frozen=True)
class LognormalSize(SizeDistribution):
    """Median ``median_dim`` params with multiplicative spread
    ``sigma`` — mixed fleets where some tenants run much bigger
    models, floored at ``min_dim``."""

    kind: ClassVar[str] = "lognormal"

    median_dim: int = 20_000
    sigma: float = 0.5
    min_dim: int = 64

    def sample(self, rng):
        dim = self.median_dim * math.exp(self.sigma * rng.normal())
        return max(int(round(dim)), self.min_dim)


@register_size
@dataclasses.dataclass(frozen=True)
class ModelConfigSize(SizeDistribution):
    """Pick a Table-I CNN workload per tenant; ``scale`` divides its
    parameter count so benches stay tractable (the CNN suite is
    10^6-10^7 params)."""

    kind: ClassVar[str] = "model_config"

    models: Tuple[str, ...] = ("CNN1.3", "CNN4.6")
    scale: int = 1000

    def __post_init__(self):
        unknown = [m for m in self.models if m not in CNN_SUITE]
        if unknown:
            raise ValueError(f"unknown CNN suite models {unknown} "
                             f"(known: {sorted(CNN_SUITE)})")

    def sample(self, rng):
        name = self.models[int(rng.integers(len(self.models)))]
        return max(CNN_SUITE[name].num_params // self.scale, 1)
