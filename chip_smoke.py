#!/usr/bin/env python3
"""Smoke test of repro_torch on one NVIDIA GPU.

    python chip_smoke.py

Phase 0 requires a CUDA device, prints the card's name and power limit as
``nvidia-smi`` gives them, and builds the CUDA kernels from
``src/repro_torch/csrc`` (one nvcc per source, side by side). Phase 1
holds each kernel against its plain PyTorch version on the card at the
shapes the main path gives it and at edge shapes, and times kernel,
plain version, library call and one block's host-to-device copy. Phase 2
drives the main path — synchronous FedAvg store rounds through
``AggregationService`` at Table-I widths (Resnet50 x 48 fp32 and
int8-compressed, CNN4.6 x 256, an in-memory CNN4.6 x 64 round, and the
``repro_torch.launch.aggregate`` CLI). Phase 3 drives the robust path on
the same data — TrimmedMean and CoordMedian rounds, streamed through the
top-k carve or dense through the trimmed-mean and median kernels as
``robust_state_budget`` routes them, compressed, through the CLI and
the torch strategy. Phases 2 and 3 check every fused vector against a
float64 numpy reference and count kernel launches, each with the counts
set to 0 just before it. The second-to-last line is ``{"kernels":
[...]}`` and the last ``{"ok": true, "device": {...}}``. Any failed
check raises, and the script then exits non-zero without printing a
result; so does a machine without a card, or a directory that holds this
file alone.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

SEED = 0
FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores (data sheet)
TIMING_REPS = 25
SPIN_CYCLES = 2_000_000   # about 1 ms of SM clock: covers the host launch path
TOL = {"fp32": 2e-5, "half": 2e-2}   # rtol of the reference's kernel tests
ORACLE_COLS = 1 << 20   # float64 order-statistic oracles, a slice at a time
QUANTILE_MAX = 1 << 24  # torch.quantile refuses larger inputs


def _ms_median(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, one CUDA-event pair per run.
    A spin kernel queued first keeps the card busy while the host queues
    the run, so the events time the device work and not the wrapper's
    host-side checks and launch."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(nbytes: float, flops: float, hbm_bw: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    t_bytes, t_ops = nbytes / hbm_bw, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _check_close(got, want, rtol, atol, what):
    import numpy as np

    got = np.asarray(got, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{what}: shape {got.shape} vs {want.shape} "
                             "or non-finite values")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    return float(np.max(np.abs(got - want)))


def _eq1_f64(rows, weights):
    """Paper Eq. (1) in float64 numpy over an iterable of rows, one row
    at a time."""
    import numpy as np

    acc = None
    for r, w in zip(rows, weights):
        term = float(w) * np.asarray(r, np.float64)
        acc = term if acc is None else acc + term
    return acc / (float(np.sum(np.asarray(weights, np.float64))) + 1e-6)


def phase_kernels(dev, hbm_bw, resnet_p, cnn_p, host_row):
    """Every kernel against its plain version at the main path's shapes;
    times kernel, plain version and library call, and one block's
    host-to-device copy against its kernel."""
    import numpy as np
    import torch

    from repro_torch.core.compress import BLOCK
    from repro_torch.kernels.fused_fusion import kernel, ref

    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = {"weighted_sum": [], "weighted_sum_dequant": []}
    half = {torch.bfloat16: "bf16", torch.float16: "fp16"}
    for n, p, dt, label in [
        (1, resnet_p, torch.float32, "Resnet50 block"),
        (14, cnn_p, torch.float32, "CNN4.6 block"),
        (37, 5003, torch.float32, "row split + ragged tail"),
        (37, 5003, torch.bfloat16, "row split + ragged tail"),
        (37, 5003, torch.float16, "row split + ragged tail"),
    ]:
        u = torch.randn((n, p), generator=g, device=dev).to(dt)
        w = torch.randint(1, 100, (n,), generator=g, device=dev).float()
        out = kernel.weighted_sum(u, w)
        want = ref.weighted_sum_ref(u, w)
        torch.cuda.synchronize()
        rtol = TOL["half"] if dt in half else TOL["fp32"]
        err = (out - want).abs().max().item()
        torch.testing.assert_close(out, want, rtol=rtol, atol=rtol * 10)
        wl = w.to(dt)
        bound_ms, bound_by = _bound(n * p * u.element_size() + 4 * n + 4 * p,
                                    2.0 * n * p, hbm_bw)
        cases["weighted_sum"].append({
            "shape": [n, p], "dtype": half.get(dt, "fp32"), "what": label,
            "max_abs_err": err, "rtol": rtol,
            "ms": _ms_median(lambda: kernel.weighted_sum(u, w)),
            "plain_ms": _ms_median(lambda: ref.weighted_sum_ref(u, w)),
            "library_ms": _ms_median(lambda: torch.mv(u.t(), wl)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        print(f"[phase1] weighted_sum {json.dumps(cases['weighted_sum'][-1])}",
              flush=True)
        del u, w, wl, out, want
    for n, pq, blk, label in [
        (2, -(-resnet_p // BLOCK) * BLOCK, BLOCK, "compressed Resnet50 block"),
        (65, 384, 128, "row split + small block"),
    ]:
        q = torch.randint(-127, 128, (n, pq), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand((n, pq // blk), generator=g, device=dev) * 1e-2 + 1e-4
        w = torch.randint(1, 100, (n,), generator=g, device=dev).float()
        out = kernel.weighted_sum_dequant(q, s, w, block=blk)
        want = ref.weighted_sum_dequant_ref(q, s, w, block=blk)
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        torch.testing.assert_close(out, want, rtol=TOL["fp32"], atol=1e-4)
        bound_ms, bound_by = _bound(
            n * pq + 4 * n * (pq // blk) + 4 * n + 4 * pq,
            2.0 * n * pq + n * (pq // blk), hbm_bw)
        cases["weighted_sum_dequant"].append({
            "shape": [n, pq], "block": blk, "what": label,
            "max_abs_err": err, "rtol": TOL["fp32"],
            "ms": _ms_median(
                lambda: kernel.weighted_sum_dequant(q, s, w, block=blk)),
            "plain_ms": _ms_median(
                lambda: ref.weighted_sum_dequant_ref(q, s, w, block=blk)),
            "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        print("[phase1] weighted_sum_dequant "
              f"{json.dumps(cases['weighted_sum_dequant'][-1])}", flush=True)
        del q, s, w, out, want

    # one Resnet50 block as the store yields it: stacked into pageable
    # host memory, copied once to the card, then folded. The pinned copy
    # is what a pinned staging buffer would give (not used by the port).
    w1 = torch.ones((1,), device=dev)
    stacks, copies, pinned_copies = [], [], []
    pinned = torch.empty((1, host_row.shape[0]), dtype=torch.float32,
                         pin_memory=True)
    for _ in range(7):
        t0 = time.perf_counter()
        block = np.stack([host_row])
        stacks.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        u = torch.from_numpy(block).to(dev)
        torch.cuda.synchronize()
        copies.append(time.perf_counter() - t0)
        pinned.copy_(torch.from_numpy(block))
        t0 = time.perf_counter()
        u = pinned.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        pinned_copies.append(time.perf_counter() - t0)
    h2d_ms = statistics.median(copies[2:]) * 1e3
    copy = {"block_bytes": int(block.nbytes),
            "stack_ms": statistics.median(stacks[2:]) * 1e3,
            "h2d_ms": h2d_ms,
            "h2d_bytes_per_s": block.nbytes / (h2d_ms * 1e-3),
            "h2d_pinned_ms": statistics.median(pinned_copies[2:]) * 1e3,
            "kernel_ms": _ms_median(lambda: kernel.weighted_sum(u, w1))}
    copy["h2d_over_kernel"] = copy["h2d_ms"] / copy["kernel_ms"]
    print(f"[phase1] resnet50_block_copy {json.dumps(copy)}", flush=True)
    return cases


def _sort_compares(n: int) -> float:
    """The fewest compares that sort n values: ceil(log2(n!))."""
    return math.ceil(math.lgamma(n + 1) / math.log(2)) if n > 1 else 0


def _bits_equal(a, b) -> bool:
    import torch

    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _special(u, n):
    """Signed infinities, NaN, signed zeros and ties in a few columns."""
    u[0, ::7] = float("inf")
    u[-1, ::5] = -float("inf")
    u[n // 2, ::11] = float("nan")
    u[1, 3::13] = -0.0
    u[:, 1::19] = 1.5


def phase_robust_kernels(dev, hbm_bw, resnet_p, cnn_p):
    """The order-statistic kernels against their plain versions: carve
    buffers bit for bit, the dense statistics to the reference's
    tolerances; times kernel, plain version and library yardstick."""
    import torch

    from repro_torch.kernels.robust_fusion import kernel as rk
    from repro_torch.kernels.robust_fusion import ref as rref

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    names = {torch.float32: "fp32", torch.bfloat16: "bf16",
             torch.float16: "fp16"}
    cases = {"topk_carve": [], "trimmed_mean": [], "coord_median": []}
    for c, p, k, dt, label in [
        (1, resnet_p, 4, torch.float32, "Resnet50 x 48 TrimmedMean block"),
        (14, cnn_p, 23, torch.float32, "CNN4.6 x 48 CoordMedian block"),
        (6, 5003, 1, torch.float32, "K = 1, ragged valid"),
        (9, 3001, 40, torch.float32, "K > 32: merge in device memory"),
        (7, 1029, 3, torch.bfloat16, "bf16"),
        (7, 1029, 3, torch.float16, "fp16"),
        (8, 2000, 5, torch.float32, "inf, NaN, signed zeros, ties"),
        (12, 1000, 40, torch.float32, "K > 32 with specials, ragged"),
    ]:
        u = torch.randn((c, p), generator=g, device=dev)
        if "specials" in label or "NaN" in label:
            _special(u, c)
        u = u.to(dt)
        valid = torch.ones((c,), device=dev)
        if "ragged" in label:
            valid[1::3] = 0.0
        base = torch.randn((2 * k, p), generator=g, device=dev).sort(0).values
        topk, botk = base[k:].contiguous(), base[:k].contiguous()
        topk[: k // 2] = -float("inf")    # a half-filled carry
        botk[k - k // 2:] = float("inf")
        ssum = torch.randn((p,), generator=g, device=dev)
        del base
        want = rref.topk_carve_ref(u, valid, ssum, topk, botk)
        got = rk.topk_carve(u, valid, ssum.clone(), topk.clone(), botk.clone())
        torch.cuda.synchronize()
        if not (_bits_equal(got[1], want[1]) and _bits_equal(got[2], want[2])):
            raise AssertionError(f"topk_carve {label}: buffers differ")
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5,
                                   equal_nan=True)
        err = torch.nan_to_num((got[0] - want[0]).abs(), nan=0.0).max().item()
        del got, want
        rows = int((valid > 0).sum().item())
        bound_ms, bound_by = _bound(
            c * p * u.element_size() + 8 * p + 16 * k * p + 4 * c,
            3.0 * rows * p, hbm_bw)
        stacked = torch.cat([topk, u.float()])   # the yardstick's input
        cases["topk_carve"].append({
            "shape": [c, p], "K": k, "dtype": names[dt], "what": label,
            "max_abs_err": err, "buffers": "bit-equal", "rtol": 1e-5,
            "ms": _ms_median(lambda: rk.topk_carve(u, valid, ssum, topk, botk)),
            "plain_ms": _ms_median(
                lambda: rref.topk_carve_ref(u, valid, ssum, topk, botk)),
            "library_ms": _ms_median(lambda: torch.topk(stacked, k, dim=0)),
            "library": "torch.topk of [topk; block] (top half only)",
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        print(f"[phase1] topk_carve {json.dumps(cases['topk_carve'][-1])}",
              flush=True)
        del u, valid, topk, botk, ssum, stacked
    for name, n, p, trim, dt, label in [
        ("trimmed_mean", 48, resnet_p, 4, torch.float32,
         "Resnet50 x 48 TrimmedMean(0.1)"),
        ("coord_median", 48, resnet_p, None, torch.float32,
         "Resnet50 x 48 CoordMedian (even n)"),
        ("coord_median", 47, 100_003, None, torch.float32, "odd n"),
        ("coord_median", 17, 4096, None, torch.bfloat16, "bf16"),
        ("coord_median", 33, 1000, None, torch.float16, "fp16"),
        ("coord_median", 48, 5000, None, torch.float32,
         "inf, NaN, signed zeros, ties"),
        ("coord_median", 2048, 4096, None, torch.float32,
         "past the shared-memory tile: radix select"),
        ("trimmed_mean", 49, 3000, 7, torch.float16, "fp16, odd n"),
        ("trimmed_mean", 20, 513, 5, torch.bfloat16, "bf16"),
        ("trimmed_mean", 48, 5000, 4, torch.float32,
         "inf, NaN, signed zeros, ties"),
        ("trimmed_mean", 2048, 4096, 204, torch.float32,
         "past the shared-memory tile: radix select"),
    ]:
        u = torch.randn((n, p), generator=g, device=dev)
        if "NaN" in label:
            _special(u, n)
        u = u.to(dt)
        if name == "coord_median":
            run = lambda: rk.coord_median(u)             # noqa: E731
            plain = lambda: rref.coordmedian_ref(u)      # noqa: E731
            tol = 1e-6
            if u.numel() <= QUANTILE_MAX:
                library = lambda: torch.quantile(u.float(), 0.5, dim=0)  # noqa: E731
                lib_what = "torch.quantile(u, 0.5, dim=0)"
            else:
                library = None
                lib_what = (f"none: torch.quantile refuses inputs over "
                            f"{QUANTILE_MAX} elements")
        else:
            run = lambda: rk.trimmed_mean(u, trim)       # noqa: E731
            plain = lambda: rref.trimmedmean_ref(u, trim)  # noqa: E731
            tol = 1e-5
            library = lambda: torch.sort(u, dim=0)       # noqa: E731
            lib_what = "torch.sort(u, dim=0), the sort alone"
        got, want = run(), plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                   equal_nan=True)
        err = torch.nan_to_num((got - want).abs(), nan=0.0).max().item()
        del got, want
        adds = 0 if trim is None else n - 2 * trim
        bound_ms, bound_by = _bound(n * p * u.element_size() + 4 * p,
                                    float(p) * (_sort_compares(n) + adds),
                                    hbm_bw)
        cases[name].append({
            "shape": [n, p], "trim": trim, "dtype": names[dt], "what": label,
            "path": ("shared-memory tile of "
                     f"{rk.dense_tile(n, dev)} columns"
                     if rk.dense_tile(n, dev) else "radix select"),
            "max_abs_err": err, "rtol": tol,
            "ms": _ms_median(run), "plain_ms": _ms_median(plain),
            "library_ms": _ms_median(library) if library else None,
            "library": lib_what,
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        print(f"[phase1] {name} {json.dumps(cases[name][-1])}", flush=True)
        del u, run, plain, library
    torch.cuda.empty_cache()
    return cases


def _all_launches():
    from repro_torch.kernels.fused_fusion import kernel
    from repro_torch.kernels.robust_fusion import kernel as rk

    return {**kernel.LAUNCHES, **rk.LAUNCHES}


def _reset_launches():
    from repro_torch.kernels.fused_fusion import kernel
    from repro_torch.kernels.robust_fusion import kernel as rk

    kernel.reset_launches()
    rk.reset_launches()


def _launch_delta(before):
    now = _all_launches()
    return {k: now[k] - before[k] for k in now}


def _store_round(svc, expected, what, phase="phase2", streamed=True):
    from repro_torch.launch.aggregate import _report_line

    before = _all_launches()
    t0 = time.perf_counter()
    fused, report = svc.aggregate(from_store=True, expected_clients=expected)
    wall = time.perf_counter() - t0
    delta = _launch_delta(before)
    print(f"[{phase}] {what}: wall={wall:.3f}s launches={delta}", flush=True)
    print(f"[{phase}] {_report_line(report)}", flush=True)
    if report.empty or report.n_clients != expected \
            or report.streamed is not streamed:
        raise AssertionError(f"{what}: {report}")
    return fused, report, delta


def phase_main_path(dev, U, W, Uc, Wc, cu_rows):
    """The port's main path, through the entry points a user calls."""
    import numpy as np
    import torch

    from repro_torch.configs.cnn_suite import CNN_SUITE
    from repro_torch.core.service import AggregationService
    from repro_torch.core.store import UpdateStore
    from repro_torch.launch import aggregate as cli
    from repro_torch.utils.pytree import tree_to_flat_vector

    # Resnet50 x 48 fp32: one client per 64 MiB block
    store = UpdateStore()
    for i in range(U.shape[0]):
        store.write(f"client{i:05d}", U[i], weight=float(W[i]))
    svc = AggregationService(store=store)
    fused, report, delta = _store_round(svc, U.shape[0],
                                        "Resnet50 x 48 fp32 store round")
    blocks = -(-U.shape[0] // svc._chunk_rows(U.shape[0], 4 * U.shape[1]))
    if delta["weighted_sum"] < blocks:
        raise AssertionError(f"{delta} launches for {blocks} blocks")
    err = _check_close(fused.cpu().numpy(), _eq1_f64(U, W), 2e-5, 1e-6,
                       "Resnet50 x 48 fp32 vs float64 Eq. 1")
    print(f"[phase2] Resnet50 x 48 fp32: blocks={blocks} max_abs_err={err}",
          flush=True)

    # CNN4.6 x 256: 14-row blocks, ragged last block; the torch strategy
    # (the baseline engine) must agree and launch no kernel
    store = UpdateStore()
    for i in range(Uc.shape[0]):
        store.write(f"client{i:05d}", Uc[i], weight=float(Wc[i]))
    svc = AggregationService(store=store)
    fused, report, delta = _store_round(svc, Uc.shape[0],
                                        "CNN4.6 x 256 fp32 store round")
    blocks = -(-Uc.shape[0] // svc._chunk_rows(Uc.shape[0], 4 * Uc.shape[1]))
    if delta["weighted_sum"] < blocks:
        raise AssertionError(f"{delta} launches for {blocks} blocks")
    err = _check_close(fused.cpu().numpy(), _eq1_f64(Uc, Wc), 2e-5, 1e-6,
                       "CNN4.6 x 256 vs float64 Eq. 1")
    print(f"[phase2] CNN4.6 x 256: blocks={blocks} max_abs_err={err}",
          flush=True)
    base = AggregationService(store=store, local_strategy="torch")
    fused_t, _, delta_t = _store_round(base, Uc.shape[0],
                                       "CNN4.6 x 256 torch strategy")
    if any(delta_t.values()):
        raise AssertionError(f"torch strategy launched kernels: {delta_t}")
    torch.testing.assert_close(fused_t, fused, rtol=2e-5, atol=1e-6)

    # Resnet50 x 48 int8-compressed: 2-row blocks through the dequant fold
    store = UpdateStore()
    for i, cu in enumerate(cu_rows):
        store.write(f"client{i:05d}", cu, weight=float(W[i]))
    svc = AggregationService(store=store, compress=True)
    fused, report, delta = _store_round(svc, len(cu_rows),
                                        "Resnet50 x 48 compressed store round")
    blocks = -(-len(cu_rows) // svc._chunk_rows(
        len(cu_rows), svc._row_bytes(U.shape[1], np.int8)))
    if delta["weighted_sum_dequant"] < blocks:
        raise AssertionError(f"{delta} launches for {blocks} blocks")
    err = _check_close(
        fused.cpu().numpy(),
        _eq1_f64((cu.dequantize() for cu in cu_rows), W), 2e-5, 1e-6,
        "Resnet50 x 48 compressed vs float64 dequantize-then-Eq. 1")
    print(f"[phase2] Resnet50 x 48 compressed: blocks={blocks} "
          f"bytes_ingested={report.bytes_ingested} max_abs_err={err}",
          flush=True)

    # in-memory dense round, CNN4.6 x 64, updates as CUDA tensors and the
    # result unflattened into the model's pytree
    spec = CNN_SUITE["CNN4.6"]
    template = {name: torch.zeros(shape, device=dev)
                for name, shape in spec.leaves}
    rows = torch.from_numpy(Uc[:64]).to(dev)
    svc = AggregationService()
    before = _all_launches()
    t0 = time.perf_counter()
    tree, report = svc.aggregate(updates=list(rows), weights=Wc[:64],
                                 template=template)
    wall = time.perf_counter() - t0
    delta = _launch_delta(before)
    print(f"[phase2] CNN4.6 x 64 in-memory round: wall={wall:.3f}s "
          f"launches={delta} phases={report.phase_seconds}", flush=True)
    if delta["weighted_sum"] < 1 or set(tree) != set(template):
        raise AssertionError(f"in-memory round: {delta}, {sorted(tree)}")
    err = _check_close(tree_to_flat_vector(tree).cpu().numpy(),
                       _eq1_f64(Uc[:64], Wc[:64]), 2e-5, 1e-6,
                       "CNN4.6 x 64 in-memory vs float64 Eq. 1")
    print(f"[phase2] CNN4.6 x 64 in-memory: max_abs_err={err}", flush=True)
    del rows

    # the CLI, as a user runs it
    before = _all_launches()
    t0 = time.perf_counter()
    cli.main(["--model", "CNN4.6", "--clients", "16", "--seed", str(SEED)])
    delta = _launch_delta(before)
    print(f"[phase2] CLI CNN4.6 x 16: wall={time.perf_counter() - t0:.3f}s "
          f"launches={delta}", flush=True)
    if delta["weighted_sum"] < 1:
        raise AssertionError(f"CLI round launched no kernel: {delta}")


def _order_stats_f64(rows, *stats):
    """Each of ``stats`` (a function of the float64 values sorted along
    axis 1, one row per coordinate) over an (n, P) matrix, computed one
    column slice at a time so the host holds one slice in float64."""
    import numpy as np

    P = rows.shape[1]
    outs = [np.empty((P,), np.float64) for _ in stats]
    for lo in range(0, P, ORACLE_COLS):
        s = np.sort(np.ascontiguousarray(rows[:, lo:lo + ORACLE_COLS].T,
                                         dtype=np.float64), axis=1)
        for out, stat in zip(outs, stats):
            out[lo:lo + ORACLE_COLS] = stat(s)
    return outs


def _trimmed_f64(trim):
    return lambda s: s[:, trim:s.shape[1] - trim].mean(axis=1)


def _median_f64(s):
    import numpy as np

    return np.median(s, axis=1)


def _fill(rows):
    from repro_torch.core.store import UpdateStore

    store = UpdateStore()
    for i, row in enumerate(rows):
        store.write(f"client{i:05d}", row)
    return store


def phase_robust_path(dev, U, Uc, cu_rows):
    """The robust rounds through the entry points a user calls: streamed
    or dense as ``robust_state_budget`` routes them, each fused vector
    against a float64 numpy oracle."""
    import numpy as np
    import torch

    from repro_torch.core.fusion import get_fusion
    from repro_torch.core.service import AggregationService
    from repro_torch.launch import aggregate as cli

    n, P = U.shape
    trim = get_fusion("trimmedmean", beta=0.1).trim_count(n)
    t0 = time.perf_counter()
    want_tm, want_med = _order_stats_f64(U, _trimmed_f64(trim), _median_f64)
    print(f"[phase3] Resnet50 x {n} oracles seconds="
          f"{time.perf_counter() - t0:.3f}", flush=True)

    # TrimmedMean(0.1) Resnet50 x 48: K = 4, a 819 MB carry, streamed
    # under a 1 GiB budget, one client per block
    store = _fill(U)
    svc = AggregationService(fusion=get_fusion("trimmedmean", beta=0.1),
                             store=store, robust_state_budget=1 << 30)
    fused, _, delta = _store_round(
        svc, n, "TrimmedMean Resnet50 x 48 streamed", phase="phase3")
    if delta["topk_carve"] < n or delta["trimmed_mean"]:
        raise AssertionError(f"streamed TrimmedMean launches {delta}")
    err = _check_close(fused.cpu().numpy(), want_tm, 1e-5, 1e-5,
                       "TrimmedMean Resnet50 x 48 streamed vs float64")
    print(f"[phase3] TrimmedMean Resnet50 x 48 streamed: max_abs_err={err}",
          flush=True)

    # the same round at the default 64 MiB budget: the dense fallback,
    # with the reference's note, one trimmed_mean launch over 4.4 GB
    svc = AggregationService(fusion=get_fusion("trimmedmean", beta=0.1),
                             store=store)
    fused, report, delta = _store_round(
        svc, n, "TrimmedMean Resnet50 x 48 dense fallback",
        phase="phase3", streamed=False)
    need = 4 * (P * (1 + 2 * trim) + 1)
    note = (f"robust stream fallback: trimmedmean carve state needs "
            f"{need / (1 << 20):.1f} MiB for n={n}, P={P} (budget "
            f"{svc.robust_state_budget / (1 << 20):.1f} MiB) — routed to the "
            "dense path")
    if report.notes != (note,) or delta["trimmed_mean"] != 1 \
            or delta["topk_carve"]:
        raise AssertionError(f"dense fallback: {report.notes} {delta}")
    err = _check_close(fused.cpu().numpy(), want_tm, 1e-5, 1e-5,
                       "TrimmedMean Resnet50 x 48 dense vs float64")
    print(f"[phase3] TrimmedMean Resnet50 x 48 dense: max_abs_err={err}",
          flush=True)
    del store, svc, fused

    # CoordMedian Resnet50 x 48: K = 23 would need 4.3 GB of carry, so
    # the round reads dense; n is even
    store = _fill(U)
    svc = AggregationService(fusion="coordmedian", store=store)
    fused, report, delta = _store_round(
        svc, n, "CoordMedian Resnet50 x 48 dense", phase="phase3",
        streamed=False)
    if delta["coord_median"] != 1 or not report.notes:
        raise AssertionError(f"dense CoordMedian: {report.notes} {delta}")
    err = _check_close(fused.cpu().numpy(), want_med, 1e-6, 1e-6,
                       "CoordMedian Resnet50 x 48 vs float64")
    print(f"[phase3] CoordMedian Resnet50 x 48: max_abs_err={err}",
          flush=True)
    del store, svc, fused, want_tm, want_med

    # CoordMedian CNN4.6 x 48 under 256 MiB: 14-row blocks and a ragged
    # last block of 6, K = 23, a 206 MiB carry; the torch strategy must
    # agree and launch no kernel
    Uc48 = Uc[:n]
    (want_c,) = _order_stats_f64(Uc48, _median_f64)
    store = _fill(Uc48)
    svc = AggregationService(fusion="coordmedian", store=store,
                             robust_state_budget=256 << 20)
    fused_k, _, delta = _store_round(
        svc, n, "CoordMedian CNN4.6 x 48 streamed", phase="phase3")
    blocks = -(-n // svc._chunk_rows(n, 4 * Uc.shape[1]))
    if delta["topk_carve"] < blocks:
        raise AssertionError(f"{delta} carve launches for {blocks} blocks")
    err = _check_close(fused_k.cpu().numpy(), want_c, 1e-5, 1e-5,
                       "CoordMedian CNN4.6 x 48 streamed vs float64")
    print(f"[phase3] CoordMedian CNN4.6 x 48: blocks={blocks} "
          f"max_abs_err={err}", flush=True)
    base = AggregationService(fusion="coordmedian", store=store,
                              robust_state_budget=256 << 20,
                              local_strategy="torch")
    fused_t, _, delta_t = _store_round(
        base, n, "CoordMedian CNN4.6 x 48 torch strategy", phase="phase3")
    if any(delta_t.values()):
        raise AssertionError(f"torch strategy launched kernels: {delta_t}")
    torch.testing.assert_close(fused_t, fused_k, rtol=1e-5, atol=1e-5)
    del store, svc, base, fused_k, fused_t

    # TrimmedMean Resnet50 x 48 int8-compressed under 1 GiB: each block
    # is dequantized on the card, then carved
    deq = np.stack([cu.dequantize() for cu in cu_rows])
    (want_q,) = _order_stats_f64(deq, _trimmed_f64(trim))
    del deq
    store = _fill(cu_rows)
    svc = AggregationService(fusion=get_fusion("trimmedmean", beta=0.1),
                             store=store, compress=True,
                             robust_state_budget=1 << 30)
    fused, report, delta = _store_round(
        svc, n, "TrimmedMean Resnet50 x 48 compressed streamed",
        phase="phase3")
    blocks = -(-n // svc._chunk_rows(n, svc._row_bytes(P, np.int8)))
    if delta["topk_carve"] < blocks:
        raise AssertionError(f"{delta} carve launches for {blocks} blocks")
    err = _check_close(fused.cpu().numpy(), want_q, 1e-5, 1e-5,
                       "compressed TrimmedMean vs float64 dequantize-then-"
                       "trimmed-mean")
    print(f"[phase3] TrimmedMean Resnet50 x 48 compressed: blocks={blocks} "
          f"bytes_ingested={report.bytes_ingested} max_abs_err={err}",
          flush=True)
    del store, svc, fused

    # the CLI, as a user runs it
    before = _all_launches()
    t0 = time.perf_counter()
    cli.main(["--model", "CNN4.6", "--clients", "16", "--fusion",
              "trimmedmean", "--seed", str(SEED)])
    delta = _launch_delta(before)
    print(f"[phase3] CLI CNN4.6 x 16 trimmedmean: "
          f"wall={time.perf_counter() - t0:.3f}s launches={delta}",
          flush=True)
    if delta["topk_carve"] < 1:
        raise AssertionError(f"CLI robust round launched no carve: {delta}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.cnn_suite import CNN_SUITE
    from repro_torch.core.compress import CompressedUpdate, quantize
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.fused_fusion import kernel
    from repro_torch.kernels.robust_fusion import kernel as rk
    from repro_torch.utils.mem import hardware_spec

    # float32 products in full precision: the torch-strategy einsums and
    # the torch.mv yardstick are compared and timed without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- phase 0 ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    hw = hardware_spec(dev)
    print(f"[phase0] torch={torch.__version__} cuda={torch.version.cuda} "
          f"device={torch.cuda.get_device_name(0)} sms={hw.sm_count} "
          f"hbm_bytes={hw.hbm_bytes}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:   # one nvcc per source, together
        for done in [pool.submit(kernel.build), pool.submit(rk.build)]:
            done.result()
    print(f"[phase0] kernel build seconds={time.perf_counter() - t0:.3f}",
          flush=True)

    # -- data, made from the seed on the card ---------------------------
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    resnet_p = CNN_SUITE["Resnet50"].num_params
    cnn_p = CNN_SUITE["CNN4.6"].num_params
    U_dev = torch.randn((48, resnet_p), generator=g, device=dev)
    W = torch.randint(1, 100, (48,), generator=g, device=dev).float().cpu().numpy()
    U = U_dev.cpu().numpy()
    blk = 2048
    cu_rows = []
    for i in range(U_dev.shape[0]):
        q, s = quantize(U_dev[i], blk)
        codes = np.zeros(s.shape[0] * blk, np.int8)
        codes[:resnet_p] = q.cpu().numpy()
        cu_rows.append(CompressedUpdate(codes=codes, scales=s.cpu().numpy(),
                                        dim=resnet_p))
    del U_dev, q, s
    Uc = torch.randn((256, cnn_p), generator=g, device=dev).cpu().numpy()
    Wc = torch.randint(1, 100, (256,), generator=g,
                       device=dev).float().cpu().numpy()
    print(f"[data] seconds={time.perf_counter() - t0:.3f}", flush=True)

    # -- phase 1 ---------------------------------------------------------
    t0 = time.perf_counter()
    cases = phase_kernels(dev, hw.hbm_bw, resnet_p, cnn_p, U[0])
    cases.update(phase_robust_kernels(dev, hw.hbm_bw, resnet_p, cnn_p))
    print(f"[phase1] seconds={time.perf_counter() - t0:.3f}", flush=True)

    # -- phase 2: the FedAvg rounds ---------------------------------------
    _reset_launches()
    t0 = time.perf_counter()
    phase_main_path(dev, U, W, Uc, Wc, cu_rows)
    launches = {k: v for k, v in _all_launches().items()
                if k in kernel.LAUNCHES}
    print(f"[phase2] seconds={time.perf_counter() - t0:.3f} "
          f"launches={launches}", flush=True)

    # -- phase 3: the robust rounds ---------------------------------------
    _reset_launches()
    t0 = time.perf_counter()
    phase_robust_path(dev, U, Uc, cu_rows)
    robust = {k: v for k, v in _all_launches().items() if k in rk.LAUNCHES}
    print(f"[phase3] seconds={time.perf_counter() - t0:.3f} "
          f"launches={robust}", flush=True)
    launches.update(robust)
    missing = [k for k, v in launches.items() if v == 0]
    if missing or robust["topk_carve"] < U.shape[0]:
        raise AssertionError(f"main path never launched {missing}: "
                             f"{launches}")

    replaces = {
        "weighted_sum": "src/repro/kernels/fused_fusion/kernel.py:61",
        "weighted_sum_dequant": "src/repro/kernels/fused_fusion/kernel.py:128",
        "topk_carve": "src/repro/kernels/robust_fusion/kernel.py:84",
        "trimmed_mean": "src/repro/kernels/robust_fusion/kernel.py:132",
        "coord_median": "src/repro/kernels/robust_fusion/kernel.py:43",
    }
    kernels = []
    for name, runs in cases.items():
        main_case = runs[0]   # the main path's block shape
        source = "robust_fusion" if name in rk.LAUNCHES else "fused_fusion"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in runs),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "shape": main_case["shape"],
            "cases": runs,
        })
    print(f"[total] seconds={time.perf_counter() - t_start:.3f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
