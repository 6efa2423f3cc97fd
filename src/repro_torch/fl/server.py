"""The Edge aggregator server, as ``repro.fl.server.EdgeAggregatorServer``.

``EdgeAggregatorServer`` is the Edge deployment composition: one
``repro_torch.serving.IngestServer`` (HTTP uploads with admission
control) feeding one ``UpdateStore``, with rounds admitted through a
``FairRoundScheduler`` on one shared ``AggregationService`` — the
object ``repro_torch.launch.serve`` runs. Uploads land on the host; the
rounds run on the service's device, each tenant's on its own CUDA
stream.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.core.service import (
    AggregationService,
    FairRoundScheduler,
    RoundReport,
)

PyTree = Any


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
