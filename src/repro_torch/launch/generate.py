"""Serve a federated model: fuse K client models with FedAvg, then prefill
a prompt and decode from it with per-layer caches (KV rings; for the
Mamba2 layers of Zamba2, the conv window and SSM state; for xLSTM's
blocks, their recurrent states).

    PYTHONPATH=src python -m repro_torch.launch.generate --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.generate \
        --arch qwen2-0.5b-smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.generate --arch zamba2-1.2b
    PYTHONPATH=src python -m repro_torch.launch.generate \
        --arch qwen2.5-3b --clients 2
    PYTHONPATH=src python -m repro_torch.launch.generate \
        --arch deepseek-moe-16b --clients 0
    PYTHONPATH=src python -m repro_torch.launch.generate \
        --arch dbrx-132b-smoke --clients 0
    PYTHONPATH=src python -m repro_torch.launch.generate \
        --arch whisper-small --clients 2
    PYTHONPATH=src python -m repro_torch.launch.generate \
        --arch xlstm-350m --clients 2

The serving half of ``examples/serve_federated_model.py``: the clients'
models (``state_dict``-shaped trees; local training comes with the
training slice) are fused through ``AggregationService.aggregate`` and
the fused tree applied as ``repro.fl.FederatedServer.run_round`` does;
then ``generate`` teacher-forces the prompt through ``decode_step`` and
decodes greedily. The families are the dense decoders (Qwen2-0.5B,
Qwen2.5-3B, Minitron-8B, Gemma3-1B), the mixture-of-experts decoders
(DeepSeek-MoE-16B, and DBRX-132B, whose 264 GB in bf16 fit no single
80 GB card: its -smoke form serves), the Mamba2 / shared-attention
hybrid (Zamba2-1.2B), the recurrent xLSTM (xLSTM-350M: its cache is
the blocks' states, O(1) in the context, and neither prefill nor a
decode step reaches a kernel) and the encoder-decoder (Whisper-small):
for it the CLI makes seeded
frames (B, n_audio_frames, d), encodes them, fills the decoder's cross
caches from the encoder output and serves the prompt over them. On the
card the fusion runs the weighted-sum kernel; prefill runs the
flash-attention kernel (and, for Zamba2, the SSD-scan kernel in every
Mamba2 layer; for Whisper, its non-causal route in the encoder and the
cross attention); each decode step runs the flash-decode kernel. The
CLI also checks that ``prefill``'s last-position logits agree with the
teacher-forced ones (for an MoE model they agree where the prompt's
prefill drops no assignment at the config's capacity factor).
LLaVA-NeXT-34B is no CLI arch: its image patches enter prefill only,
and ``repro``'s decode step takes none, so a teacher-forced prompt
would not see them; given its id, the CLI serves the text backbone
alone, without patches.

The in-memory fusion holds every client in the model's dtype twice
(the tree and its flat row), the stacked rows, and an fp32 sum and
result: about 9x a bf16 model for 2 clients. Qwen2.5-3B fuses 2 clients
on one 80 GB card; a Minitron-8B or DeepSeek-MoE-16B client does not fit
beside its model there, so ``--clients 0`` serves the seeded model
without a fusion round.
"""
from __future__ import annotations

import argparse
import collections
import time
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.service import AggregationService, RoundReport
from repro_torch.models import Model, build_model
from repro_torch.utils.device import resolve_device, synchronize


def fuse_clients(model: Model, clients: Sequence,
                 weights=None) -> Tuple[torch.Tensor, RoundReport]:
    """One FedAvg round over the clients' models, applied to ``model`` in
    place: each parameter becomes the fused value cast to its dtype.
    Clients are mappings keyed like
    ``model.state_dict()`` (taken in its order) or flat vectors in that
    order. Returns the fused flat fp32 vector and the round's report."""
    template = model.state_dict()
    svc = AggregationService(fusion="fedavg", device=model.device)
    updates = [
        collections.OrderedDict((k, c[k]) for k in template)
        if isinstance(c, Mapping) else c
        for c in clients
    ]
    fused, report = svc.aggregate(updates=updates, weights=weights)
    offset = 0
    with torch.no_grad():
        for p in template.values():
            f = fused[offset:offset + p.numel()].view(p.shape).to(p.device)
            offset += p.numel()
            p.copy_(f)
    if offset != fused.numel():
        raise ValueError(f"fused vector holds {fused.numel()} values, the "
                         f"model {offset}")
    return fused, report


def perturbed_clients(model: Model, n: int, seed: int,
                      scale: float = 0.01) -> List[collections.OrderedDict]:
    """``n`` client models: the global model plus seeded normal noise of
    std ``scale`` (drawn in fp32 on the model's device, then cast)."""
    g = torch.Generator(device=model.device).manual_seed(seed)
    out = []
    for _ in range(n):
        out.append(collections.OrderedDict(
            (k, (p.float() + scale * torch.randn(
                p.shape, generator=g, device=p.device)).to(p.dtype))
            for k, p in model.state_dict().items()))
    return out


@torch.no_grad()
def generate(model: Model, prompt: torch.Tensor, n_new: int, cache_len: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             return_logits: bool = False, cache=None):
    """Greedy (or temperature) decoding. prompt (B, T0) int on the model's
    device -> (B, T0 + n_new) tokens; with ``return_logits`` also the
    (B, n_new, vocab) fp32 logits each new token was chosen from.

    The prompt is teacher-forced through ``decode_step`` (cache warm-up),
    as the reference's example does. Positions are device tensors, so no
    step waits on the host. ``cache`` defaults to
    ``model.init_cache(B, cache_len)``; an encoder-decoder passes its
    caches with the cross keys and values filled (``fill_cross_cache``)."""
    B, T0 = prompt.shape
    dev = prompt.device
    if cache is None:
        cache = model.init_cache(B, cache_len)
    positions = torch.arange(T0 + n_new, dtype=torch.int32, device=dev)
    logits = None
    for t in range(T0):
        cache, logits = model.decode_step(cache, prompt[:, t:t + 1],
                                          positions[t])

    def pick(lg):
        if temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)
        return lg.argmax(dim=-1, keepdim=True)

    cur = pick(logits)
    out, seen = [cur], [logits]
    for i in range(n_new - 1):
        cache, logits = model.decode_step(cache, cur, positions[T0 + i])
        cur = pick(logits)
        out.append(cur)
        seen.append(logits)
    tokens = torch.cat([prompt.long()] + out, dim=1)
    if return_logits:
        return tokens, torch.stack(seen, dim=1)
    return tokens


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Fuse K client models with FedAvg, then prefill and "
                    "decode from the fused model.")
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="model id, or <id>-smoke for the reduced config")
    ap.add_argument("--clients", type=int, default=4,
                    help="client models fused before serving; 0 serves "
                         "the seeded model as it is")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev, seed=args.seed)
    if args.clients:
        clients = perturbed_clients(model, args.clients, seed=args.seed + 1)
        weights = np.random.default_rng(args.seed).integers(
            1, 100, size=args.clients).astype(np.float32)
        fused, report = fuse_clients(model, clients, weights)
        del clients, fused
        print(f"[serve] {cfg.arch_id}: fused {report.n_clients} clients x "
              f"{cfg.num_params()} params engine={report.plan.engine} "
              f"fuse={report.fuse_seconds:.3f}s")
    else:
        print(f"[serve] {cfg.arch_id}: {cfg.num_params()} params, no "
              "fusion round (--clients 0)")

    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(args.batch, args.prompt_len))).to(dev)
    cache_len = args.prompt_len + args.new_tokens
    batch, cache = {"tokens": prompt}, None
    if cfg.family == "audio":
        batch["audio_frames"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.n_audio_frames, cfg.d_model),
            dtype=np.float32)).to(dev)
        with torch.no_grad():
            cache = model.fill_cross_cache(
                model.init_cache(args.batch, cache_len),
                model.encode(batch["audio_frames"]))
    t0 = time.perf_counter()
    last = model.prefill(batch)
    synchronize(dev)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens, logits = generate(model, prompt, args.new_tokens,
                              cache_len=cache_len, cache=cache,
                              return_logits=True)
    synchronize(dev)
    steps = args.prompt_len + args.new_tokens - 1
    per_step = (time.perf_counter() - t0) / max(steps, 1)
    diff = (logits[:, 0] - last).abs().max().item()
    note = ""
    if cfg.moe is not None:
        note = (f" (MoE: prefill drops assignments past capacity factor "
                f"{cfg.moe.capacity_factor:g}, a decode step none)")
    print(f"[serve] prefill {args.batch}x{args.prompt_len}: "
          f"{prefill_s * 1e3:.3f} ms; decode {per_step * 1e3:.3f} ms/step; "
          f"prefill vs teacher-forced logits max_abs_diff={diff:.3e}{note}")
    print(f"[serve] generated {args.new_tokens} tokens/seq")
    print("[serve] tokens:", tokens[0].tolist())


if __name__ == "__main__":
    main()
