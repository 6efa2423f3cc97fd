"""The aggregation service: workload classes, planner, store, monitor,
local and distributed engines, fusions, quantized transport, secure masking, and the
round schedulers.

The names below are exported as ``repro.core`` exports them, loaded on
first use, so importing one submodule (the numpy-only workload
classifier, say) does not import the service.
"""
import importlib

_EXPORTS = {
    "AdaptiveController": "adaptive",
    "ArrivalModel": "adaptive",
    "ClosePolicy": "adaptive",
    "DistributedEngine": "distributed",
    "REGISTRY": "fusion",
    "FusionAlgorithm": "fusion",
    "get_fusion": "fusion",
    "LocalEngine": "local",
    "Monitor": "monitor",
    "MonitorResult": "monitor",
    "Plan": "planner",
    "Planner": "planner",
    "SecureMasking": "secure",
    "AggregationService": "service",
    "FairRoundScheduler": "service",
    "RoundReport": "service",
    "RoundScheduler": "service",
    "DEFAULT_TENANT": "store",
    "QuotaExceededError": "store",
    "SpoolTailer": "store",
    "StoreStats": "store",
    "TenantQuota": "store",
    "UpdateStore": "store",
    "Workload": "workload",
    "WorkloadClass": "workload",
    "classify": "workload",
    "max_clients_single_node": "workload",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
