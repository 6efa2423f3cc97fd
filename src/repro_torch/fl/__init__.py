"""Federated-learning runtime of the port: clients, server rounds, and the
Edge deployment's server.

``Client`` trains locally and emits an update, ``FederatedServer`` runs
rounds of selection, local training and fusion through the
``AggregationService``, and ``EdgeAggregatorServer`` composes the HTTP
ingest front-end (``repro_torch.serving``) with the fair round scheduler
over one store-backed service.
"""
from repro_torch.fl.client import Client
from repro_torch.fl.server import (
    EdgeAggregatorServer,
    FederatedServer,
    RoundResult,
)

__all__ = [
    "Client",
    "EdgeAggregatorServer",
    "FederatedServer",
    "RoundResult",
]
