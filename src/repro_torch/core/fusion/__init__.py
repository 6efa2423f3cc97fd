"""Fusion algorithm library (IBMFL-compatible set + robust extensions),
the registry of ``repro.core.fusion``."""
from repro_torch.core.fusion.averaging import ClippedAvg, FedAvg, GradAvg, IterAvg
from repro_torch.core.fusion.base import EPS, FusionAlgorithm
from repro_torch.core.fusion.robust import (
    CoordMedian,
    GeometricMedian,
    Krum,
    TrimmedMean,
    Zeno,
)
from repro_torch.core.fusion.serveropt import FedAdam, FedAvgM

REGISTRY = {
    "fedavg": FedAvg,
    "iteravg": IterAvg,
    "gradavg": GradAvg,
    "clippedavg": ClippedAvg,
    "coordmedian": CoordMedian,
    "trimmedmean": TrimmedMean,
    "krum": Krum,
    "zeno": Zeno,
    "geomedian": GeometricMedian,
    "fedavgm": FedAvgM,
    "fedadam": FedAdam,
}


def get_fusion(name: str, **kw) -> FusionAlgorithm:
    return REGISTRY[name](**kw)


__all__ = [
    "EPS",
    "FusionAlgorithm",
    "FedAvg",
    "IterAvg",
    "GradAvg",
    "ClippedAvg",
    "CoordMedian",
    "TrimmedMean",
    "Krum",
    "Zeno",
    "GeometricMedian",
    "FedAvgM",
    "FedAdam",
    "REGISTRY",
    "get_fusion",
]
