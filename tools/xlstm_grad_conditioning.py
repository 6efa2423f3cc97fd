"""How far does rounding move xLSTM-350M's loss gradient, as the cut of
its depth and the length of its batch grow, and which block moves it?

Run from the repo root, on a CUDA machine or (``--device cpu``, at
the reduced ``--arch xlstm-350m-smoke``) on the host:

    python3 tools/xlstm_grad_conditioning.py [--device cpu] [--arch A] \
        [CUT ...]

A CUT is ``BLOCKS:SLSTM_EVERY:BxT`` (default: ``8:8:2x256 8:8:2x512
24:8:4x512``): the arch (by default xLSTM-350M, at full width) cut to
BLOCKS blocks, an sLSTM block every SLSTM_EVERY (0: none; BLOCKS must
be a multiple of it), one batch of B sequences of T tokens (xLSTM-350M
has chunks of 256, so T = 512 carries the mLSTM state across a chunk).
The weights come from ``chip_smoke.SEED`` in bf16, as ``chip_smoke.py``'s
phase 9 (h) builds them; every other tree is those same weights cast.
For each cut it takes the loss and the gradient of every leaf
(``chip_smoke._step_grads``, remat on, as a ``Client`` step):

- ``f64``: the tree in float64 (the port computes a float64 tree in
  float64 throughout), the reference for the next four;
- ``f64@1e-7``: float64 at weights moved by seeded relative noise
  uniform in +-1e-7, against ``f64``: its ``gain`` (the gradient's
  relative error over 1e-7) is how far the exact gradient moves for a
  relative move of the weights, the amplification that rounding meets;
- ``fp32``: in fp32 with TF32 off, as ``chip_smoke.py`` runs;
- ``tf32``: in fp32 with TF32 on for matmuls and cuDNN;
- ``bf16``: the model dtype bf16 (gates and states fp32);
- ``fp32@1ulp`` and ``fp32@2^-9``: fp32 at weights moved by seeded
  relative noise uniform in +-2^-24 and +-2^-9, against the unmoved
  fp32 step: how far one rounding of the weights in fp32, or half a bf16
  step, moves the gradient;
- ``bf16 vs fp32``: what ``chip_smoke.py`` holds.

Each line gives the loss's relative difference, the whole gradient's
cosine, its relative error ||a - b|| / ||b||, the global norm's relative
difference and the worst leaf's cosine. Then, for ``fp32`` against
``f64`` and for ``bf16`` against ``f64``, each block's output (the cell's
output before the residual add) relative error, over the first and the
last eighth of the sequence: the block where the error grows, and
whether it grows along the sequence.
"""
import collections
import dataclasses
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))

DEFAULT_CUTS = ("8:8:2x256", "8:8:2x512", "24:8:4x512")


def _compare(what, loss_a, g_a, loss_b, g_b, move=None):
    from chip_smoke import _leaf_cosines

    cos, nrel, whole = _leaf_cosines(g_a, g_b)
    diff = ref = 0.0
    for k, a in g_a.items():
        b = g_b[k].double()
        diff += (a.double() - b).square().sum().item()
        ref += b.square().sum().item()
    worst = min(cos, key=cos.get)
    err = math.sqrt(diff / ref)
    gain = f"; gain {err / move:.1f}" if move else ""
    print(f"  {what}: loss rel {abs(loss_a - loss_b) / abs(loss_b):.3e}; "
          f"whole cosine {whole:.6f}; rel error {err:.3e}{gain}; "
          f"global-norm rel {nrel:.3e}; worst leaf {worst} "
          f"{cos[worst]:.6f}", flush=True)


def _block_errors(what, outs, ref):
    """Each block's output against the reference's, over the first and
    the last eighth of the sequence."""
    parts = []
    for i, ((kind, y), (_, y0)) in enumerate(zip(outs, ref)):
        T = y0.shape[1]
        e = T // 8
        errs = []
        for sl in (slice(0, e), slice(T - e, T)):
            a, b = y[:, sl].double(), y0[:, sl].double()
            errs.append(((a - b).norm() / b.norm()).item())
        parts.append(f"{i}{kind[0]} {errs[0]:.1e}/{errs[1]:.1e}")
    print(f"  {what} block outputs rel error, first/last eighth: "
          + "; ".join(parts), flush=True)


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("cuts", nargs="*", default=list(DEFAULT_CUTS))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import SEED, _step_grads
    from repro_torch.configs import get_config
    from repro_torch.fl.client import batch_to_device
    from repro_torch.models import build_model
    from repro_torch.models import xlstm as txm
    from repro_torch.models.xlstm import XLSTM

    import numpy as np

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0) if cuda
          else f"host, {torch.get_num_threads()} threads", flush=True)
    base = get_config(args.arch)
    outs = []
    real = txm.mlstm_forward, txm.slstm_forward

    def recording(kind, fn):
        def wrapped(p, dims, x):
            y = fn(p, dims, x)
            outs.append((kind, y.detach()))
            return y
        return wrapped

    def grads(cfg, params, batch, record=False):
        outs.clear()
        if record:
            txm.mlstm_forward = recording("mlstm", real[0])
            txm.slstm_forward = recording("slstm", real[1])
        try:
            loss, g = _step_grads(XLSTM(cfg, device="meta"), params, batch)
        finally:
            txm.mlstm_forward, txm.slstm_forward = real
        if cuda:
            torch.cuda.synchronize()
        return loss.item(), g, list(outs)

    def moved(params, scale, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return collections.OrderedDict(
            (k, v * (1 + (torch.rand(v.shape, generator=gen, device=dev,
                                     dtype=v.dtype) * 2 - 1) * scale))
            for k, v in params.items())

    for cut in args.cuts:
        blocks, every, bt = cut.split(":")
        B, T = (int(v) for v in bt.split("x"))
        xl = dataclasses.replace(base.xlstm, slstm_every=int(every))
        cfg = dataclasses.replace(base, n_layers=int(blocks), xlstm=xl,
                                  dtype="bfloat16")
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev, seed=SEED)
        kinds = "".join(b.kind[0] for b in model.blocks)
        print(f"cut {cut}: blocks {kinds}, {cfg.num_params()} params",
              flush=True)
        params = model.state_dict()
        del model
        tokens = np.random.default_rng(SEED + 14).integers(
            0, cfg.vocab, size=(B, T))
        batch = batch_to_device({"tokens": tokens, "labels": tokens}, dev)
        cast = lambda d: collections.OrderedDict(  # noqa: E731
            (k, v.to(d)) for k, v in params.items())
        f32cfg = dataclasses.replace(cfg, dtype="float32")
        l64, g64, o64 = grads(f32cfg, cast(torch.float64), batch, True)
        lg, gg, _ = grads(f32cfg, moved(cast(torch.float64), 1e-7,
                                        SEED + 18), batch)
        _compare("f64@1e-7 (seed 18) vs f64", lg, gg, l64, g64, move=1e-7)
        del gg
        p32 = cast(torch.float32)
        l32, g32, o32 = grads(f32cfg, p32, batch, True)
        if cuda:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                ltf, gtf, _ = grads(f32cfg, p32, batch)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            _compare("tf32 vs f64", ltf, gtf, l64, g64)
            del gtf
        l16, g16, o16 = grads(cfg, params, batch, True)
        _compare("fp32 vs f64", l32, g32, l64, g64)
        _compare("bf16 vs f64", l16, g16, l64, g64)
        _compare("bf16 vs fp32", l16, g16, l32, g32)
        del g16, g64
        for name, scale, seed in (("fp32@1ulp", 2.0 ** -24, SEED + 16),
                                  ("fp32@1ulp", 2.0 ** -24, SEED + 17),
                                  ("fp32@2^-9", 2.0 ** -9, SEED + 15)):
            lm, gm, _ = grads(f32cfg, moved(p32, scale, seed), batch)
            _compare(f"{name} (seed {seed}) vs fp32", lm, gm, l32, g32)
            del gm
        _block_errors("fp32 vs f64", o32, o64)
        _block_errors("bf16 vs f64", o16, o64)
        del g32, o32, o64, o16, params, p32
        if cuda:
            torch.cuda.empty_cache()
        print(f"cut {cut}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
