"""FL servers: orchestrate rounds through the AggregationService, as
``repro.fl.server``.

``FederatedServer`` is deliberately thin — client selection, broadcast,
collect, aggregate, apply — because the aggregation SERVICE is the
paper's object of study. The server consumes RoundReports (which
engine ran, monitor state, seamless-transition routing) and exposes
them to benchmarks. Its parameters are a ``state_dict``-keyed tree of
tensors on the model's device; the FedAvg of the clients' updates runs
the weighted-sum kernel on the card.

``EdgeAggregatorServer`` is the Edge deployment composition: one
``repro_torch.serving.IngestServer`` (HTTP uploads with admission
control) feeding one ``UpdateStore``, with rounds admitted through a
``FairRoundScheduler`` on one shared ``AggregationService`` — the
object ``repro_torch.launch.serve`` runs. Uploads land on the host; the
rounds run on the service's device, each tenant's on its own CUDA
stream.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.service import (
    AggregationService,
    FairRoundScheduler,
    RoundReport,
)
from repro_torch.data.loader import FederatedLoader
from repro_torch.fl.client import Client
from repro_torch.models.base import Model
from repro_torch.utils.pytree import tree_map

PyTree = Any


@dataclasses.dataclass
class RoundResult:
    round_idx: int
    mean_client_loss: float
    report: RoundReport
    n_selected: int


class FederatedServer:
    """Rounds of: select clients, train each from the global params, fuse
    their updates through ``service``, apply. ``params`` (a
    ``state_dict``-keyed tree, e.g. the JAX package's initial weights
    carried across by ``convert.decoder_state_from_numpy``) starts the
    run; by default the model's own parameters (``repro``'s server draws
    them from ``model.init(PRNGKey(rng_seed))``; here ``build_model``'s
    seed made them)."""

    def __init__(
        self,
        model: Model,
        clients: Sequence[Client],
        loader: FederatedLoader,
        service: AggregationService,
        rng_seed: int = 0,
        clients_per_round: Optional[int] = None,
        params: Optional[PyTree] = None,
    ):
        self.model = model
        self.clients = list(clients)
        self.loader = loader
        self.service = service
        self.rng = np.random.default_rng(rng_seed)
        self.clients_per_round = clients_per_round or len(self.clients)
        if params is None:
            params = model.state_dict()
        self.params = collections.OrderedDict(
            (k, v.detach()) for k, v in params.items())
        self.results: List[RoundResult] = []

    def run_round(self, round_idx: int) -> RoundResult:
        sel = self.rng.choice(
            len(self.clients), size=self.clients_per_round, replace=False
        )
        updates, weights, losses = [], [], []
        send_delta = any(self.clients[i].send_delta for i in sel)
        for i in sel:
            c = self.clients[i]
            batch_fn = lambda s, c=c: self.loader.client_batch(  # noqa: E731
                c.client_id, round_idx * 1000 + s
            )
            upd, loss = c.train_round(self.params, batch_fn, round_idx)
            updates.append(upd)
            weights.append(self.loader.client_weight(c.client_id))
            losses.append(loss)

        fused, report = self.service.aggregate(
            updates=updates, weights=weights, template=self.params,
        )
        del updates
        with torch.no_grad():
            if send_delta:
                # pseudo-gradient: apply fused delta to the global weights
                self.params = tree_map(
                    lambda p, d: (p.float() + d.float()).to(p.dtype),
                    self.params, fused)
            else:
                self.params = tree_map(
                    lambda p, f: f.to(device=p.device, dtype=p.dtype),
                    self.params, fused)
        res = RoundResult(
            round_idx=round_idx,
            mean_client_loss=float(np.mean(losses)),
            report=report,
            n_selected=len(sel),
        )
        self.results.append(res)
        return res

    def run(self, n_rounds: int) -> List[RoundResult]:
        return [self.run_round(r) for r in range(n_rounds)]


class EdgeAggregatorServer:
    """The network-facing aggregator: HTTP ingest + fair round
    admission over ONE AggregationService.

    Composition, not new machinery: an ``IngestServer`` (token auth,
    rate limits, quota pre-checks, batched ``IngestQueue`` commits)
    lands uploads in ``service.store``; a ``FairRoundScheduler``
    admits rounds with weighted-fair tenant selection under a
    concurrency cap. ``tokens`` maps bearer token -> tenant.

        svc = AggregationService(fusion="fedavg", store=UpdateStore(),
                                 threshold_frac=1.0, monitor_timeout=5)
        with EdgeAggregatorServer(svc, {"tok-a": "appA"}) as edge:
            ...clients POST to edge.url...
            fused, report = edge.run_round("appA", expected_clients=48)

    ``frontend_kwargs`` pass through to ``IngestServer`` (rate, burst,
    queue_size, batch_max, read_timeout, max_body_bytes, ...);
    scheduler knobs are explicit."""

    def __init__(
        self,
        service: AggregationService,
        tokens: Dict[str, str],
        host: str = "127.0.0.1",
        port: int = 0,
        max_running: int = 2,
        weights: Optional[Dict[str, float]] = None,
        capacity_bytes: Optional[int] = None,
        **frontend_kwargs,
    ):
        # imported here: repro_torch.fl must stay importable without the
        # serving layer's http machinery loaded for in-process use
        from repro_torch.serving.frontend import IngestServer

        if service.store is None:
            raise ValueError(
                "EdgeAggregatorServer needs a store-backed service "
                "(AggregationService(store=UpdateStore(...)))"
            )
        self.service = service
        self.frontend = IngestServer(
            service.store, tokens, host=host, port=port,
            **frontend_kwargs,
        )
        self.scheduler = FairRoundScheduler(
            service, max_running=max_running, weights=weights,
            capacity_bytes=capacity_bytes,
        )

    @property
    def port(self) -> int:
        return self.frontend.port

    @property
    def url(self) -> str:
        return self.frontend.url

    def submit_round(self, tenant: str, **aggregate_kwargs):
        """Queue one round through the fair scheduler (Future of
        ``(fused, RoundReport)``)."""
        return self.scheduler.submit(
            tenant, from_store=True, **aggregate_kwargs
        )

    def run_round(self, tenant: str, **aggregate_kwargs):
        """One tenant's round, synchronously."""
        return self.submit_round(tenant, **aggregate_kwargs).result()

    def run_rounds(
        self, tenants: Sequence[str], **aggregate_kwargs
    ) -> Dict[str, Tuple[PyTree, RoundReport]]:
        """A fair fan-out across tenants; waits for all."""
        futs = {t: self.submit_round(t, **aggregate_kwargs)
                for t in tenants}
        return {t: f.result() for t, f in futs.items()}

    def metrics(self) -> dict:
        out = self.frontend.metrics()
        out["rounds_admitted"] = len(self.scheduler.admission_order())
        out["rounds_running"] = len(self.scheduler.running())
        return out

    def close(self) -> None:
        self.scheduler.shutdown()
        self.frontend.close()

    def __enter__(self) -> "EdgeAggregatorServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
