"""Serve the aggregator over HTTP: the Edge ingest front-end + fair
round scheduling, driven end to end by a replayed workload trace, on the
GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --tenants 2 \\
      --clients 12 --dim 4000 --rounds 2 --spread 0.3

Starts an ``EdgeAggregatorServer`` (token-authenticated uploads,
per-tenant rate limits, quota pre-checks, batched IngestQueue commits
— ``repro_torch.serving``), then replays a seeded ``WorkloadSpec`` trace
where every client is a REAL HTTP uploader (``HttpStoreClient`` over a
socket, one keep-alive connection per tenant writer), and runs each
tenant's round through the weighted-fair scheduler while uploads are
still landing. The flags are ``repro.launch.serve``'s, and one seed
gives both packages the same trace and payloads.

``--compress`` uploads int8 codes + fp32 scales frames instead of
dense fp32; ``--rate``/``--burst`` turn on per-tenant token buckets
(shed uploads retry on Retry-After and still land — watch the
``shed_429`` counter); ``--quota-updates``/``--quota-bytes`` install
store quotas that both the admission gate and the store enforce.
Rounds fold through the CUDA kernels (``--local-strategy kernel``, the
default; ``torch`` is the plain PyTorch baseline). ``--device cpu``
runs on the CPU with the kernels' plain versions; the default is the
card, and the command fails without one.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core import AggregationService, UpdateStore
from repro_torch.fl import EdgeAggregatorServer
from repro_torch.serving import HttpStoreClient
from repro_torch.utils.mem import bytes_to_human
from repro_torch.workload import (
    FixedSize,
    RegimeSchedule,
    UniformArrivals,
    WorkloadSpec,
    start_writer,
)


def build_spec(args) -> WorkloadSpec:
    return WorkloadSpec(
        tenants=tuple(f"app{i}" for i in range(args.tenants)),
        n_clients=args.clients,
        rounds=args.rounds,
        regimes=RegimeSchedule.single(
            UniformArrivals(spread=args.spread)
        ),
        sizes=FixedSize(dim=args.dim),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="HTTP ingest front-end + fair round scheduling "
                    "over one AggregationService."
    )
    ap.add_argument("--tenants", type=int, default=2,
                    help="tenant count (tokens are tok-app0, tok-app1, "
                         "...)")
    ap.add_argument("--clients", type=int, default=12,
                    help="HTTP uploaders per tenant per round")
    ap.add_argument("--dim", type=int, default=4_000,
                    help="update parameter count P")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--spread", type=float, default=0.3,
                    help="seconds each round's uploads are spread over")
    ap.add_argument("--compress", action="store_true",
                    help="upload int8 codes + fp32 scales frames "
                         "(client-side quantization, error feedback)")
    ap.add_argument("--fusion", default="fedavg")
    ap.add_argument("--threshold-frac", type=float, default=1.0,
                    help="close the round at this fraction of clients")
    ap.add_argument("--timeout", type=float, default=10.0,
                    help="round gate deadline")
    ap.add_argument("--max-running", type=int, default=2,
                    help="rounds admitted concurrently by the fair "
                         "scheduler")
    ap.add_argument("--rate", type=float, default=None,
                    help="per-tenant upload token-bucket rate "
                         "(uploads/s; None disables rate limiting)")
    ap.add_argument("--burst", type=float, default=None,
                    help="token-bucket burst (defaults to --rate)")
    ap.add_argument("--quota-updates", type=int, default=None,
                    help="per-tenant resident-update quota on the store")
    ap.add_argument("--quota-bytes", type=int, default=None,
                    help="per-tenant resident-byte quota on the store")
    ap.add_argument("--queue-size", type=int, default=256,
                    help="IngestQueue bound (backpressure horizon)")
    ap.add_argument("--batch-max", type=int, default=32,
                    help="max uploads per batched store commit")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0: ephemeral)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--local-strategy", default="kernel",
                    choices=["kernel", "torch"],
                    help="the CUDA kernels or the plain PyTorch baseline")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None):
    """Serve the trace; returns ``(rounds, metrics)``: each round's
    ``{tenant: (fused, RoundReport)}`` and the server's ``metrics()``
    after the last round."""
    args = parse_args(argv)
    store = UpdateStore()
    svc = AggregationService(
        fusion=args.fusion, store=store,
        local_strategy=args.local_strategy,
        threshold_frac=args.threshold_frac,
        monitor_timeout=args.timeout, compress=args.compress,
        device=args.device,
    )
    tenants = [f"app{i}" for i in range(args.tenants)]
    tokens = {f"tok-{t}": t for t in tenants}
    if args.quota_updates is not None or args.quota_bytes is not None:
        for t in tenants:
            store.set_quota(t, max_updates=args.quota_updates,
                            max_bytes=args.quota_bytes,
                            policy="reject")
    trace = build_spec(args).build(args.seed)
    rounds = []
    with EdgeAggregatorServer(
        svc, tokens, port=args.port, max_running=args.max_running,
        rate=args.rate, burst=args.burst,
        queue_size=args.queue_size, batch_max=args.batch_max,
    ) as edge:
        print(f"[serve] listening on {edge.url} tenants={tenants} "
              f"dim={args.dim} device={svc.device} "
              f"frame={'int8+scales' if args.compress else 'fp32'}")
        for rt in trace.rounds:
            t0 = time.time()
            writers, clients = [], []
            for tr in rt.tenants:
                cli = HttpStoreClient(
                    "127.0.0.1", edge.port, token=f"tok-{tr.tenant}",
                )
                clients.append(cli)
                transform = (
                    (lambda cid, u, _t=tr.tenant:
                     svc.compress_update(cid, u, tenant=_t))
                    if args.compress else None
                )
                writers.append(start_writer(
                    None, tr, args.seed, transform=transform,
                    writer=cli.write,
                ))
            results = edge.run_rounds(
                [tr.tenant for tr in rt.tenants],
                expected_clients=args.clients,
            )
            for w, cli in zip(writers, clients):
                w.join()
                cli.close()
            for t, (fused, report) in sorted(results.items()):
                if report.empty:
                    print(f"[serve] round={rt.index} tenant={t} empty "
                          "round (monitor timed out with no arrivals)")
                    continue
                print(f"[serve] round={rt.index} tenant={t} "
                      f"engine={report.plan.engine} "
                      f"included={report.n_clients}/{args.clients} "
                      f"ingest={bytes_to_human(report.bytes_ingested)} "
                      f"fuse={report.fuse_seconds:.3f}s "
                      f"fused[:3]={fused[:3].cpu().numpy()}")
            store.clear()   # synchronous rounds don't consume
            print(f"[serve] round={rt.index} wall="
                  f"{time.time() - t0:.2f}s")
            rounds.append(results)
        m = edge.metrics()
        print(f"[serve] uploads={m.get('accepted', 0)} "
              f"batches={m.get('batches', 0)} "
              f"max_batch={m.get('max_batch', 0)} "
              f"shed_429={m.get('shed_429', 0)} "
              f"backpressure={m.get('backpressure', 0)} "
              f"admission_order={edge.scheduler.admission_order()}")
    return rounds, m


if __name__ == "__main__":
    main()
