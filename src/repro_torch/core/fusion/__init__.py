"""Fusion algorithms: the reducer protocol and the sum family. The
order-statistic and Byzantine-robust fusions of ``repro`` are not yet
ported (ROADMAP, modules item 10)."""
from repro_torch.core.fusion.averaging import ClippedAvg, FedAvg, GradAvg, IterAvg
from repro_torch.core.fusion.base import EPS, FusionAlgorithm
from repro_torch.core.fusion.serveropt import FedAdam, FedAvgM

REGISTRY = {
    "fedavg": FedAvg,
    "iteravg": IterAvg,
    "gradavg": GradAvg,
    "clippedavg": ClippedAvg,
    "fedavgm": FedAvgM,
    "fedadam": FedAdam,
}

# fusions of repro.core.fusion.REGISTRY that wait for a later port
_NOT_YET_PORTED = ("coordmedian", "trimmedmean", "krum", "zeno", "geomedian")


def get_fusion(name: str, **kw) -> FusionAlgorithm:
    if name in _NOT_YET_PORTED:
        raise ValueError(f"fusion {name!r} is not yet ported to repro_torch "
                         "(ROADMAP: robust fusions)")
    return REGISTRY[name](**kw)


__all__ = [
    "EPS",
    "FusionAlgorithm",
    "FedAvg",
    "IterAvg",
    "GradAvg",
    "ClippedAvg",
    "FedAvgM",
    "FedAdam",
    "REGISTRY",
    "get_fusion",
]
