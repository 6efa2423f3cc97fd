"""End-to-end federated training driver, as ``repro.launch.train``.

Trains a reduced variant of a decoder architecture, of the Mamba2 /
shared-attention hybrid or of xLSTM (or the full one with
``--full-config``) with the full stack: synthetic non-IID data ->
per-client local SGD steps -> AggregationService (FedAvg through the
weighted-sum kernel) -> global model update.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --rounds 20 --clients 8 --local-steps 2 --fusion fedavg
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch zamba2-1.2b
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch xlstm-350m

On the card (``--device cuda``, the default) each local step runs the
attention through the forward and backward flash-attention kernels
and, for ``--arch zamba2-1.2b``, every Mamba2 layer's scan through the
SSD scan's forward and backward kernels, and the round's fusion through
the fusion kernels (``--local-strategy kernel``; ``torch`` is the plain
baseline of the fusion). ``--arch xlstm-350m`` trains the reduced
``xlstm-350m-smoke`` (one mLSTM and one sLSTM block); its local steps
reach no kernel, its rounds the weighted sum. ``--device cpu`` runs
every kernel's plain version.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.core.service import AggregationService
from repro_torch.data import FederatedLoader, SyntheticLM
from repro_torch.fl import Client, FederatedServer
from repro_torch.models import build_model
from repro_torch.optim import sgd


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="End-to-end federated training of a decoder, the "
                    "Mamba2 hybrid or xLSTM")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--clients-per-round", type=int, default=None)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.25)
    ap.add_argument("--fusion", default="fedavg")
    ap.add_argument("--local-strategy", default="kernel",
                    choices=["kernel", "torch"],
                    help='"kernel" (CUDA kernels) or "torch" (baseline)')
    ap.add_argument("--skew", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not reduced) architecture config")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> FederatedServer:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced() if not args.arch.endswith("-smoke") else cfg
    model = build_model(cfg, device=args.device, seed=args.seed)
    gen = SyntheticLM(vocab=cfg.vocab, seed=args.seed, skew=args.skew)
    loader = FederatedLoader(
        gen=gen, n_clients=args.clients, batch=args.batch,
        seq_len=args.seq_len,
    )
    send_delta = args.fusion in ("gradavg", "fedavgm", "fedadam")
    clients = [
        Client(
            client_id=i, model=model, optimizer=sgd(args.lr),
            local_steps=args.local_steps, send_delta=send_delta,
        )
        for i in range(args.clients)
    ]
    service = AggregationService(
        fusion=args.fusion, local_strategy=args.local_strategy,
        device=args.device,
    )
    server = FederatedServer(
        model=model, clients=clients, loader=loader, service=service,
        rng_seed=args.seed, clients_per_round=args.clients_per_round,
    )
    print(f"[train] arch={cfg.arch_id} params={cfg.num_params():,} "
          f"clients={args.clients} fusion={args.fusion} "
          f"device={service.device}", flush=True)
    t0 = time.time()
    for r in range(args.rounds):
        res = server.run_round(r)
        print(
            f"[round {r:3d}] loss={res.mean_client_loss:.4f} "
            f"engine={res.report.plan.engine} "
            f"class={res.report.plan.workload_class.value} "
            f"fuse={res.report.fuse_seconds*1e3:.1f}ms", flush=True
        )
    print(f"[train] done in {time.time()-t0:.1f}s; "
          f"loss {server.results[0].mean_client_loss:.4f} -> "
          f"{server.results[-1].mean_client_loss:.4f}", flush=True)
    if args.save:
        save_pytree(args.save, server.params)
        print(f"[train] saved params to {args.save}", flush=True)
    return server


if __name__ == "__main__":
    main()
