"""Federated-learning runtime of the port: the Edge deployment's server.

``EdgeAggregatorServer`` composes the HTTP ingest front-end
(``repro_torch.serving``) with the fair round scheduler over one
store-backed ``AggregationService``. The reference's ``Client``,
``FederatedServer`` and ``RoundResult`` train models; they come with the
training substrate (ROADMAP, modules to port, item 6).
"""
from repro_torch.fl.server import EdgeAggregatorServer

__all__ = ["EdgeAggregatorServer"]
