"""Standalone aggregation command over the paper's Table-I CNN workloads,
on the GPU.

Simulates n clients writing updates of a chosen model size to the
UpdateStore, runs the monitor, and fuses with the service — the paper's
end-to-end flow (Fig. 12/13) in one command:

  PYTHONPATH=src python -m repro_torch.launch.aggregate --model Resnet50 \\
      --clients 48

Client data is generated exactly as ``repro.launch.aggregate`` does, so
one ``--seed`` gives both packages the same updates. ``--async-rounds``
overlaps fusion with the straggler wait: a writer thread spreads client
arrivals over ``--spread`` seconds while the service folds blocks off the
arrival stream. ``--adaptive`` closes rounds on the learned gate, which
optimizes ``--cost-bias`` (0 = fastest rounds, 1 = maximum inclusion);
run several ``--rounds`` to watch the report's ``gate=`` move from
``static`` to ``learned``. ``--compress``
quantizes every client write to int8 codes + fp32 per-block scales (per-
tenant error feedback) and the round folds them with the dequant kernel.
``--concurrent-tenants K`` runs tenants ``app0..app{K-1}`` on ONE store
and ONE service: their writers land while every round is open, and a
``RoundScheduler`` worker a tenant runs the K rounds at once, each on
its tenant's CUDA stream, with ``--device-concurrency`` folds on the
card at a time (default 1); each report line names its tenant, and in
round 0 one tenant pays the step build (``compile``) for all.
``--quota-updates`` / ``--quota-bytes`` / ``--quota-policy`` bound each
tenant's share of the store. ``--device cpu`` runs on the CPU with the kernels' plain versions; the
default is the card, and the command fails without one.
"""
from __future__ import annotations

import argparse
import threading
import time
import zlib

import numpy as np

from repro_torch.configs.cnn_suite import CNN_SUITE
from repro_torch.core.service import AggregationService, RoundScheduler
from repro_torch.core.store import QuotaExceededError, UpdateStore
from repro_torch.core.workload import Workload, classify
from repro_torch.utils.mem import bytes_to_human


def _gate_str(report) -> str:
    pol = report.close_policy
    if not pol:
        return "static"
    return (f"{pol.source}(frac={pol.threshold_frac:.2f} "
            f"deadline={pol.deadline:.2f}s)")


def _report_line(report) -> str:
    """One round's outcome, labeled with its tenant."""
    st = report.store_stats
    stats = (f" writes={st.writes} wbytes={st.bytes_written}"
             f" evictions={st.evictions}") if st is not None else ""
    for note in report.notes:
        stats += f" note={note!r}"
    phases = " ".join(f"{k}={v:.4f}s"
                      for k, v in report.phase_seconds.items())
    return (f"[aggregate] tenant={report.tenant} "
            f"engine={report.plan.engine} "
            f"class={report.plan.workload_class.value} "
            f"streamed={report.streamed} "
            f"monitor_ready={report.monitor.ready} "
            f"gate={_gate_str(report)} "
            f"ingest={bytes_to_human(report.bytes_ingested)} "
            f"fuse={report.fuse_seconds:.3f}s "
            f"overlap={report.overlap_seconds:.3f}s "
            f"compile={report.phase_seconds.get('compile', 0.0):.3f}s "
            f"phases=[{phases}] "
            f"est={report.plan.est_seconds:.4f}s(model) "
            f"route_next_to_store={report.route_next_to_store}"
            + stats)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="End-to-end aggregation rounds over the UpdateStore "
                    "on the GPU (paper Fig. 12/13)."
    )
    ap.add_argument("--model", default="CNN4.6", choices=sorted(CNN_SUITE),
                    help="Table-I CNN workload (sets the update size)")
    ap.add_argument("--clients", type=int, default=32,
                    help="simulated clients writing one update each")
    ap.add_argument("--fusion", default="fedavg",
                    help="fusion algorithm (repro_torch.core.fusion.REGISTRY)")
    ap.add_argument("--local-strategy", default="kernel",
                    choices=["kernel", "torch"],
                    help='"kernel" (CUDA kernels) or "torch" (baseline)')
    ap.add_argument("--compress", action="store_true",
                    help="quantize client writes to int8 codes + fp32 "
                         "per-block scales (error feedback per tenant)")
    ap.add_argument("--threshold-frac", type=float, default=0.8,
                    help="gate: close at this fraction of clients")
    ap.add_argument("--timeout", type=float, default=5.0,
                    help="static gate deadline (and learned-deadline cap)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--async-rounds", action="store_true",
                    help="fold arrivals while stragglers write "
                         "(monitor-overlapped round)")
    ap.add_argument("--spread", type=float, default=1.0,
                    help="seconds over which async-round client arrivals "
                         "are spread")
    ap.add_argument("--adaptive", action="store_true",
                    help="learn the arrival curve and close rounds with "
                         "the adaptive controller's policy")
    ap.add_argument("--cost-bias", type=float, default=0.5,
                    help="adaptive knob in [0,1]: 0 optimizes round "
                         "wall-clock, 1 optimizes update inclusion")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds to run (adaptive gates need >1 to learn)")
    ap.add_argument("--tenant", default="default",
                    help="tenant label for writes and rounds")
    ap.add_argument("--concurrent-tenants", type=int, default=0,
                    help="run this many tenants' rounds concurrently on "
                         "one store and service via the RoundScheduler "
                         "(overrides --tenant)")
    ap.add_argument("--device-concurrency", type=int, default=1,
                    help="bound on concurrent device execution across "
                         "tenants' rounds")
    ap.add_argument("--quota-updates", type=int, default=None,
                    help="per-tenant resident-update budget")
    ap.add_argument("--quota-bytes", type=int, default=None,
                    help="per-tenant resident-byte budget")
    ap.add_argument("--quota-policy", default="reject",
                    choices=["reject", "evict"],
                    help="over-budget writes: reject or evict the oldest")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Run the rounds; returns each round's ``[(fused, report), ...]``,
    one pair a tenant."""
    args = parse_args(argv)
    spec = CNN_SUITE[args.model]
    n_params = spec.num_params
    store = UpdateStore()
    svc = AggregationService(
        fusion=args.fusion, store=store,
        local_strategy=args.local_strategy,
        threshold_frac=args.threshold_frac, monitor_timeout=args.timeout,
        adaptive=args.adaptive, cost_bias=args.cost_bias,
        compress=args.compress, device=args.device,
        device_concurrency=args.device_concurrency,
    )
    tenants = (
        [f"app{i}" for i in range(args.concurrent_tenants)]
        if args.concurrent_tenants else [args.tenant]
    )
    if args.quota_updates is not None or args.quota_bytes is not None:
        for t in tenants:
            store.set_quota(t, max_updates=args.quota_updates,
                            max_bytes=args.quota_bytes,
                            policy=args.quota_policy)
    load = Workload.for_params(n_params, args.clients,
                               compressed=args.compress)
    print(f"[aggregate] model={args.model} "
          f"w_s={bytes_to_human(load.update_bytes)} n={args.clients} "
          f"S={bytes_to_human(load.total_bytes)} "
          f"class={classify(load, svc.hw).value} device={svc.device}"
          + (f" adaptive(cost_bias={args.cost_bias})" if args.adaptive
             else "")
          + (f" tenants={tenants}" if len(tenants) > 1 else ""))
    scheduler = RoundScheduler(svc) if args.concurrent_tenants else None
    # arrivals land while the rounds are open: the overlapped round, or a
    # serialized wait the controller can observe an arrival curve from;
    # with several tenants every tenant's writer runs under every round
    overlapped = args.async_rounds or args.adaptive \
        or args.concurrent_tenants > 0
    out = []
    try:
        for rnd in range(args.rounds):
            out.append(_run_round(args, rnd, svc, store, tenants,
                                  scheduler, overlapped, n_params))
    finally:
        if scheduler is not None:
            scheduler.shutdown()
    return out


def _run_round(args, rnd, svc, store, tenants, scheduler, overlapped,
               n_params) -> list:
    """One round of every tenant: write, fuse, print the report lines."""
    t0 = time.time()
    write_lat = []
    rejected = []

    def write_all(tenant):
        pause = args.spread / max(args.clients, 1) if overlapped else 0.0
        # the same seeded stream per (seed, round, tenant) as
        # repro.launch.aggregate, so both packages fuse the same updates
        trng = np.random.default_rng(
            args.seed + rnd * 1009 + zlib.crc32(tenant.encode())
        )
        for i in range(args.clients):
            if pause:
                time.sleep(pause)
            u = trng.normal(size=(n_params,)).astype(np.float32)
            if args.compress:
                u = svc.compress_update(f"client{i:05d}", u, tenant=tenant)
            try:
                write_lat.append(
                    store.write(f"client{i:05d}", u,
                                weight=float(trng.integers(1, 100)),
                                tenant=tenant)
                )
            except QuotaExceededError:
                rejected.append(tenant)

    kw = dict(from_store=True, expected_clients=args.clients)
    if overlapped:
        kw["async_round"] = args.async_rounds
        writers = [threading.Thread(target=write_all, args=(t,), daemon=True)
                   for t in tenants]
        for w in writers:
            w.start()
        try:
            if scheduler is not None:
                # every tenant's round runs now on its scheduler worker
                results = scheduler.run_round(tenants, **kw)
                reports = [results[t] for t in tenants]
            else:
                reports = [svc.aggregate(tenant=t, **kw) for t in tenants]
        finally:
            for w in writers:
                w.join()
    else:
        for t in tenants:
            write_all(t)
        reports = [svc.aggregate(tenant=t, **kw) for t in tenants]
    if not args.async_rounds:
        for t in tenants:
            store.clear(tenant=t)   # serialized rounds don't consume
    avg_write = np.mean(write_lat) * 1e3 if write_lat else 0.0
    print(f"[aggregate] round={rnd} {len(write_lat)} updates written "
          f"(modeled avg write {avg_write:.1f} ms, "
          f"wall {time.time() - t0:.2f}s)"
          + (f" [{len(rejected)} writes rejected by quota]"
             if rejected else ""))
    for fused, report in reports:
        if report.empty:
            print(f"[aggregate] tenant={report.tenant} empty round "
                  "(monitor timed out with no arrivals)")
            continue
        print(_report_line(report))
        print(f"[aggregate] tenant={report.tenant} "
              f"fused[:5]={fused[:5].cpu().numpy()}")
    return reports


if __name__ == "__main__":
    main()
