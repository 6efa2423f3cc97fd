#!/usr/bin/env python3
"""Smoke test of repro_torch on one NVIDIA GPU.

    python chip_smoke.py

Phase 0 requires a CUDA device, prints the card's name and power limit as
``nvidia-smi`` gives them, builds the CUDA kernels from
``src/repro_torch/csrc`` (one nvcc per source, side by side), counts
the attention library's tensor-core, async-copy and ldmatrix
instructions in its SASS, and the decode library's 16-byte loads and
copies and cluster barriers, its registers and spills (``ptxas -v``) and
how many 8-CTA clusters fit on the card, and the SSD library's TF32
tensor-core products and asynchronous copies, its registers and spills
(none allowed), and each carve and dequant instance's registers and
spills (none allowed), the dequant's stores and the carve's integer min
/ max in their SASS. Phase 1
holds each kernel against its plain PyTorch version on the card at the
shapes the main path gives it and at edge shapes, and times kernel,
plain version, library call and one block's host-to-device copy; each
carve case prints the share of warps its data keep on the fast route,
and the dequant's Resnet50 case the time of the fold's carry add that
follows it. Phase 2
drives the main path — synchronous FedAvg store rounds through
``AggregationService`` at Table-I widths (Resnet50 x 48 fp32 and
int8-compressed, CNN4.6 x 256, an in-memory CNN4.6 x 64 round, and the
``repro_torch.launch.aggregate`` CLI). Phase 3 drives the robust path on
the same data — TrimmedMean and CoordMedian rounds, streamed through the
top-k carve or dense through the trimmed-mean and median kernels as
``robust_state_budget`` routes them, compressed, through the CLI and
the torch strategy. Phases 2 and 3 check every fused vector against a
float64 numpy reference and count kernel launches, each with the counts
set to 0 just before it. Phase 1 also holds the flash-attention and
flash-decode kernels against their plain versions (with
``scaled_dot_product_attention`` timed as a yardstick; each decode case
prints its split plan, checks that two calls agree bit for bit and
times the wrapper's host time per call too), and phase 4
drives the serving path through ``build_model`` and
``repro_torch.launch.generate``: a FedAvg fusion of 4 full-width
Qwen2-0.5B bf16 clients, a 4 x 1024 prefill and cached decoding; fp32
Qwen2-0.5B and Gemma3-1B (6 of its 26 layers) prefills checked against
the same prompts teacher-forced through the decode step and against the
plain attention path. Phase 0 also counts the SSD output kernel's
instruction mix in its SASS and times ``mma.sync`` TF32 alone, the
ceiling of the SSD kernels' products. Phase 1 also holds the SSD
chunked-scan kernels against their plain version (two calls bit-equal,
the device kernels of a call and each one's device time from the
profiler, the Zamba2 layer also at a head tile of 1), and phase 5
serves the hybrid the same way:
a FedAvg fusion of 2 full-width, full-depth Zamba2-1.2B bf16 clients
checked against float64 Eq. 1 a parameter at a time, a 4 x 1024 prefill
(38 SSD-scan and 6 flash-attention launches) and cached decoding (6
flash-decode launches a step, each one device kernel in the profiler);
fp32 Zamba2-1.2B (12 of its 38 layers)
prefills of 2 x 512 and 1 x 300 checked against teacher-forced decoding
and the plain SSD and attention; and the generate CLI. Phase 6, run
right after phase 3 on the same data, drives the async and adaptive
rounds while writer threads land the clients: two Resnet50 x 48 rounds
with a staleness discount of 0.5 whose second folds the first's
stragglers on its discounted carry, an async and a serialized round
over one writer (their walls side by side), int8 and CoordMedian
async rounds, adaptive CNN4.6 rounds of a fleet where some clients
never write (the learned gate must close them before the timeout, and
a service that loads the saved controller must resume its gate), and
the async adaptive CLI. Phase 7, run after phase 6 on the same data,
drives concurrent tenants on one service: four tenants' Resnet50
rounds (three fp32, one int8) over 1.0 s writers through a
``RoundScheduler`` at device concurrency 1 and 2, four serialized rounds
and four separate services, walls side by side, shared against isolated
vectors, and a profiled round printing the CUDA streams of the
tenants' fold kernels; a ``FairRoundScheduler`` under a running cap, a
tenant weight and a host-staging capacity; a ``secure=`` IterAvg round
over rows masked on the card; a ``repro_torch.workload`` trace (three
tenants of 32 CNN4.6 clients, a bursty regime with dropout from round
4) replayed through the static and the learned gate; and the
``--concurrent-tenants`` CLI. Phase 8, run after phase 7 on the same
data, drives the Edge serving path: an ``EdgeAggregatorServer``
(``repro_torch.serving``'s HTTP front-end and the fair scheduler) over
a ``compress=True`` FedAvg service takes three tenants' 12 Resnet50
uploads each over HTTP (fp32, bf16 and int8 frames, writers over 1.0
s), the socket rounds of fp32 and int8 frames against in-process
rounds (bitwise), a truncated frame (400) and a frame over the default
64 MiB cap (413) that land nothing, a streamed TrimmedMean round of 48
CNN4.6 uploads, and the serve CLI, fp32 and rate-limited int8. Phase 0
also prints the registers and spills of the attention backward's
instances (exactly the set ``kernel.bwd_instances`` names; no spill
allowed) and the tensor-core products (HMMA) of each dK / dV and dQ
instance (none may lack them; the fp32 ones must be TF32,
HMMA.1688.F32.TF32), and phase 1 holds ``flash_attention_bwd`` against
``attention_bwd_ref`` at the training shapes and at edge shapes that
launch every fp32 instance (hd 32 to 256; two calls bitwise equal; the
device kernels of a call and their times at the four large shapes;
fp32 cases give the bound at the CUDA cores' FMA rate and at a third of
phase 0's mma.sync TF32 rate), beside the backward of
``scaled_dot_product_attention``. Phase 9, last, trains full-width
Qwen2-0.5B bf16: (a) one local step through the attention kernels
(exactly 48 forward and 24 backward launches) against the same step
through the plain attention, timed and profiled; (b) two FedAvg rounds
of 4 clients through ``FederatedServer`` and a gradavg round, each
round's fused params against float64 Eq. 1; (c) ``save_pytree`` /
``load_pytree`` of the trained params, bitwise; (d)
``repro_torch.launch.train``; and (e) (a)'s step for full-width
Gemma3-1B in fp32 on 1 x 1280 tokens (52 forward and 26 backward
launches; loss within 1e-4 relative, every gradient leaf at cosine
0.9999 or more). Phase 10, run after phase 8 on the same data, drives
the distributed engine and the mesh service over NCCL at world size 1
((1, 1) and (1, 1, 1) meshes, every collective called): FedAvg, IterAvg
and ClippedAvg Resnet50 x 48 map-reduce rounds against float64 Eq. 1,
TrimmedMean and CoordMedian through the all-to-all against float64
order statistics, Krum, Zeno and GeometricMedian at CNN4.6 x 64 against
the local engine, the fp32, hierarchical, int8 and TrimmedMean Resnet50
streams off ``UpdateStore.iter_chunks`` (exactly 48 / 48 / 24 / 48
launches), a store round and two gamma 0.5 async rounds through
``AggregationService(mesh=)``, and a carry handed from a ``LocalEngine``
stream into the mesh engine; each case prints both engines' walls
(median of 5), its launches and NCCL's share of its device time.
Phases 2-10
each start with the launch counts at 0, and every serving run must
launch exactly what its prefills, decode steps and fusions take. The
second-to-last line is ``{"kernels": [...]}`` and the last
``{"ok": true, "device": {...}}``. Any failed check raises, and the
script then exits non-zero without printing a result; so does a
machine without a card, or a directory that holds this file alone.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

SEED = 0
FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores (data sheet)
HALF_FLOPS = 989e12     # H100 SXM bf16 / fp16 tensor cores, dense (data sheet)
TIMING_REPS = 25
SPIN_CYCLES = 2_000_000   # about 1 ms of SM clock: covers the host launch path
TOL = {"fp32": 2e-5, "half": 2e-2}   # rtol of the reference's kernel tests
ORACLE_COLS = 1 << 20   # float64 order-statistic oracles, a slice at a time
QUANTILE_MAX = 1 << 24  # torch.quantile refuses larger inputs
REG_MAX = 128           # the dense kernels' register route takes n <= this


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


def _bound(nbytes: float, flops: float, hbm_bw: float,
           peak_flops: float = FP32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the type's peak rate (fp32 unless given)."""
    t_bytes, t_ops = nbytes / hbm_bw, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _check_close(got, want, rtol, atol, what):
    import numpy as np

    got = np.asarray(got, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{what}: shape {got.shape} vs {want.shape} "
                             "or non-finite values")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    return float(np.max(np.abs(got - want)))


def _wsum_f64(rows, weights):
    """(sum_i w_i * u_i, sum_i w_i) in float64 numpy over an iterable of
    rows, one row at a time, accumulated in place."""
    import numpy as np

    acc = tmp = None
    tot = 0.0
    for r, w in zip(rows, weights):
        r = np.asarray(r)
        if acc is None:
            acc, tmp = np.zeros(r.shape, np.float64), np.empty(r.shape,
                                                               np.float64)
        np.multiply(r, float(w), out=tmp, dtype=np.float64)
        acc += tmp
        tot += float(w)
    return acc, tot


def _eq1_f64(rows, weights):
    """Paper Eq. (1) in float64 numpy over an iterable of rows, one row
    at a time."""
    acc, tot = _wsum_f64(rows, weights)
    return acc / (tot + 1e-6)


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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, pq, blk, label in [
        (2, -(-resnet_p // BLOCK) * BLOCK, BLOCK, "compressed Resnet50 block"),
        (65, 384, 128, "row split + small block"),
        (3, 100 * 1001, 100, "Pq not a multiple of 16, a scale a vector"),
        (3, 6 * 50_001, 6, "block not a multiple of 4: a scale an element"),
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
        case = {
            "shape": [n, pq], "block": blk, "what": label,
            "plan": kernel.dequant_plan(n, pq, blk, sms)._asdict(),
            "max_abs_err": err, "rtol": TOL["fp32"],
            "ms": _ms_median(
                lambda: kernel.weighted_sum_dequant(q, s, w, block=blk)),
            "plain_ms": _ms_median(
                lambda: ref.weighted_sum_dequant_ref(q, s, w, block=blk)),
            "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        if n == 2:
            # the reducible fold's carry add after each launch
            # (core/fusion/base.py: state[0] + wsum[:dim]), not fused
            carry = torch.zeros((resnet_p,), device=dev)
            case["fold_add_ms"] = _ms_median(lambda: carry + out[:resnet_p])
            case["fold_add_bound_ms"] = _bound(12 * resnet_p, resnet_p,
                                               hbm_bw)[0]
        cases["weighted_sum_dequant"].append(case)
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


def _route_text(route) -> str:
    if route.route == "register":
        return f"register sorting network, NB = {route.nb}"
    if route.route == "warp_staged":
        held = (f"{route.lane_keys} keys a lane in registers"
                if route.lane_keys else "passes over shared memory")
        return (f"warp select over keys staged in shared memory "
                f"({route.smem_bytes} bytes a block; {held})")
    return "warp select, each pass from device memory"


_NAMES = {"torch.float32": "fp32", "torch.bfloat16": "bf16",
          "torch.float16": "fp16"}


def phase_carve_kernel(dev, hbm_bw, resnet_p, cnn_p):
    """The carve against its plain version, buffers bit for bit; times
    kernel, plain version and library yardstick, and says which share of
    the register route's warps the data keep on the fast route."""
    import torch

    from repro_torch.kernels.robust_fusion import kernel as rk
    from repro_torch.kernels.robust_fusion import ref as rref

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = {"topk_carve": []}
    for c, p, k, dt, label in [
        (1, resnet_p, 4, torch.float32, "Resnet50 x 48 TrimmedMean block"),
        (14, cnn_p, 23, torch.float32, "CNN4.6 x 48 CoordMedian block"),
        (6, 5003, 1, torch.float32, "K = 1, ragged valid"),
        (9, 3001, 40, torch.float32, "K > 32: merge in device memory"),
        (7, 1029, 3, torch.bfloat16, "bf16"),
        (7, 1029, 3, torch.float16, "fp16"),
        (8, 2000, 5, torch.float32, "inf, NaN, signed zeros, ties"),
        (12, 1000, 40, torch.float32, "K > 32 with specials, ragged"),
        (14, cnn_p, 23, torch.float32,
         "1% of values -0: the exact route"),
        (14, cnn_p, 24, torch.float32, "K = 24, the window full"),
        (14, cnn_p, 32, torch.float32, "K = 32, the largest window"),
        (33, 100_003, 16, torch.float32,
         "c = 33: the last row group holds one row"),
        (9, 3001, 4, torch.float32,
         "NaN in botk's carry, ragged: masked rows displace it"),
        (9, 3001, 40, torch.float32,
         "K > 32, NaN in botk's carry, ragged: masked rows displace it"),
    ]:
        u = torch.randn((c, p), generator=g, device=dev)
        if "specials" in label or "NaN" in label:
            _special(u, c)
        if "-0" in label:
            u[torch.rand((c, p), generator=g, device=dev) < 0.01] = -0.0
        u = u.to(dt)
        valid = torch.ones((c,), device=dev)
        if "ragged" in label:
            valid[1::3] = 0.0
        base = torch.randn((2 * k, p), generator=g, device=dev).sort(0).values
        topk, botk = base[k:].contiguous(), base[:k].contiguous()
        topk[: k // 2] = -float("inf")    # a half-filled carry
        botk[k - k // 2:] = float("inf")
        if "botk's carry" in label:   # NaN sorts last: the carry stays sorted
            botk[-1, ::3] = float("nan")
            botk[-2:, ::7] = float("nan")
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
        routes = rk.carve_routes(u, valid, topk, botk) \
            if rk.carve_window(k) else "K > 32: merge in device memory"
        cases["topk_carve"].append({
            "shape": [c, p], "K": k, "dtype": _NAMES[str(dt)], "what": label,
            "routes": routes,
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
    return cases


def phase_robust_kernels(dev, hbm_bw, resnet_p, cnn_p):
    """The dense order statistics against their plain versions, to the
    reference's tolerances, on both routes; times kernel, plain version
    and library yardstick."""
    import torch

    from repro_torch.kernels.robust_fusion import kernel as rk
    from repro_torch.kernels.robust_fusion import ref as rref

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = {"trimmed_mean": [], "coord_median": []}
    if rk.dense_route(REG_MAX, dev).route != "register" \
            or rk.dense_route(REG_MAX + 1, dev).route == "register":
        raise AssertionError(f"the register route does not end at n = "
                             f"{REG_MAX}")
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
        ("coord_median", 2048, 4096, None, torch.float32, "n = 2048"),
        ("trimmed_mean", 49, 3000, 7, torch.float16, "fp16, odd n"),
        ("trimmed_mean", 20, 513, 5, torch.bfloat16, "bf16"),
        ("trimmed_mean", 48, 5000, 4, torch.float32,
         "inf, NaN, signed zeros, ties"),
        ("trimmed_mean", 2048, 4096, 204, torch.float32, "n = 2048"),
        # the routes' edges: n = 1-3, the register route's last n and the
        # warp route's first, ragged column groups, past the staging limit
        ("trimmed_mean", 1, 5003, 0, torch.float32, "n = 1"),
        ("coord_median", 1, 5003, None, torch.float32, "n = 1"),
        ("trimmed_mean", 2, 5003, 0, torch.float32, "n = 2"),
        ("coord_median", 2, 5003, None, torch.float32, "n = 2"),
        ("trimmed_mean", 3, 5003, 1, torch.float32, "n = 3"),
        ("coord_median", 3, 5003, None, torch.float32, "n = 3"),
        ("trimmed_mean", REG_MAX, 100_003, 12, torch.float32,
         "register route's largest n"),
        ("coord_median", REG_MAX, 100_003, None, torch.float32,
         "register route's largest n"),
        ("trimmed_mean", REG_MAX + 1, 100_003, 12, torch.float32,
         "warp route's smallest n"),
        ("coord_median", REG_MAX + 1, 100_003, None, torch.float32,
         "warp route's smallest n"),
        ("trimmed_mean", 256, cnn_p, 25, torch.float32,
         "CNN4.6 x 256 TrimmedMean(0.1)"),
        ("coord_median", 256, cnn_p, None, torch.float32,
         "CNN4.6 x 256 CoordMedian"),
        ("trimmed_mean", 2048, 4096, 204, torch.float32,
         "inf, NaN, signed zeros, ties"),
        ("coord_median", 2048, 4096, None, torch.float32,
         "inf, NaN, signed zeros, ties"),
        ("trimmed_mean", 2048, 4096, 204, torch.bfloat16, "bf16"),
        ("coord_median", 2048, 4096, None, torch.bfloat16, "bf16"),
        ("trimmed_mean", 300, 4099, 30, torch.float32,
         "P = 4,099: a ragged 8-column group"),
        ("coord_median", 300, 4099, None, torch.float32,
         "P = 4,099: a ragged 8-column group"),
        ("trimmed_mean", 1000, 20_000, 100, torch.float32,
         "32 keys a lane in registers"),
        ("coord_median", 1000, 20_000, None, torch.float32,
         "32 keys a lane in registers"),
        ("trimmed_mean", 10_000, 1000, 1000, torch.float32,
         "past the staging limit: device-memory passes"),
        ("coord_median", 10_000, 1000, None, torch.float32,
         "past the staging limit: device-memory passes"),
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
                library = lambda: torch.sort(u, dim=0)   # noqa: E731
                lib_what = (f"torch.sort(u, dim=0), the sort alone: "
                            f"torch.quantile refuses inputs over "
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
            "shape": [n, p], "trim": trim, "dtype": _NAMES[str(dt)],
            "what": label,
            "path": _route_text(rk.dense_route(n, dev)),
            "max_abs_err": err, "rtol": tol,
            "ms": _ms_median(run), "plain_ms": _ms_median(plain),
            "library_ms": _ms_median(library),
            "library": lib_what,
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        print(f"[phase1] {name} {json.dumps(cases[name][-1])}", flush=True)
        del u, run, plain, library
    torch.cuda.empty_cache()
    return cases


def _kernel_modules():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.fused_fusion import kernel
    from repro_torch.kernels.robust_fusion import kernel as rk
    from repro_torch.kernels.ssd_chunk import kernel as sk

    return kernel, rk, fa, fd, sk


def _all_launches():
    out = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def _reset_launches():
    for mod in _kernel_modules():
        mod.reset_launches()


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

    # the same round with the weights as a CUDA tensor
    before = _all_launches()
    fused, report = svc.aggregate(updates=list(rows),
                                  weights=torch.from_numpy(Wc[:64]).to(dev))
    delta = _launch_delta(before)
    if delta["weighted_sum"] < 1:
        raise AssertionError(f"CUDA-weights round: {delta}")
    err = _check_close(fused.cpu().numpy(), _eq1_f64(Uc[:64], Wc[:64]),
                       2e-5, 1e-6, "CNN4.6 x 64 CUDA-tensor weights vs "
                       "float64 Eq. 1")
    print(f"[phase2] CNN4.6 x 64 in-memory, CUDA-tensor weights: "
          f"launches={delta} max_abs_err={err}", flush=True)
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

def _writer(store, rows, weights, ids, spread, tenant="default",
            errors=None):
    """Start a thread that writes ``rows[i]`` as ``tenant``'s client
    ``ids[i]`` at ``weights[i]``, one every ``spread / len(ids)`` seconds
    — the fleet landing while a round is open. ``store`` is anything
    with ``store.write``'s signature (an ``HttpStoreClient`` too); with
    ``errors`` given, a failed write ends the thread and is appended
    there for the caller to check."""
    import threading

    def run():
        pause = spread / max(len(ids), 1)
        try:
            for cid, row, w in zip(ids, rows, weights):
                time.sleep(pause)
                store.write(cid, row, weight=float(w), tenant=tenant)
        except Exception as exc:
            if errors is None:
                raise
            errors.append((tenant, exc))

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def _open_round(svc, what, **kw):
    """One store round while a writer runs: (fused, report, launches,
    wall), with the wall, phases and overlap printed."""
    from repro_torch.launch.aggregate import _report_line

    before = _all_launches()
    t0 = time.perf_counter()
    fused, report = svc.aggregate(from_store=True, **kw)
    wall = time.perf_counter() - t0
    delta = {k: v for k, v in _launch_delta(before).items() if v}
    print(f"[phase6] {what}: wall={wall:.3f}s "
          f"overlap_seconds={report.overlap_seconds:.4f} "
          f"phase_seconds={report.phase_seconds} launches={delta}",
          flush=True)
    print(f"[phase6] {_report_line(report)}", flush=True)
    if report.empty:
        raise AssertionError(f"{what}: empty round {report}")
    return fused, report, delta, wall


def _folded(ids, store, before=()):
    """Indices of ``ids`` a consuming round folded: written, no longer in
    the store, and not folded by an earlier round."""
    left = set(store.client_ids())
    return [i for i, c in enumerate(ids) if c not in left and i not in before]


def phase_async_rounds(dev, U, W, Uc, Wc, cu_rows):
    """Async and adaptive rounds at Table-I widths through the entry
    points a user calls, with writer threads landing the clients while
    each round is open; every fused vector against float64 numpy."""
    import numpy as np

    from repro_torch.core.service import AggregationService
    from repro_torch.core.store import UpdateStore
    from repro_torch.launch import aggregate as cli

    out = {}
    n, P = U.shape
    ids = [f"client{i:05d}" for i in range(n)]
    gamma, spread = 0.5, 1.5

    # (a) Resnet50 x 48 fp32, gamma 0.5: round 1 closes on the static
    # gate at 24 of 48 while the writer is still landing rows 0-39; rows
    # 40-47 land after the stream closed and before the consume (written
    # from the store's arrival snapshot, which the round takes between
    # the two), so they are stragglers of age 1. Round 2 folds every row
    # round 1 left at gamma^age on top of round 1's carry times gamma
    store = UpdateStore()
    svc = AggregationService(store=store, staleness_discount=gamma,
                             threshold_frac=0.5, monitor_timeout=30.0)
    chunk = svc._chunk_rows(n, 4 * P)   # 1 row a block at Resnet50
    snapshot, tail = store.arrival_times, range(40, n)

    def land_stragglers(tenant=None):
        for i in tail:
            store.write(ids[i], U[i], weight=float(W[i]))
        store.arrival_times = snapshot
        return snapshot(tenant)

    store.arrival_times = land_stragglers
    th = _writer(store, U[:tail[0]], W, ids[:tail[0]], spread)
    fused1, rep1, d1, wall1 = _open_round(
        svc, "Resnet50 x 48 async round 1 (gamma 0.5)", expected_clients=n,
        async_round=True)
    th.join()
    f1 = _folded(ids, store)
    ages = dict(svc._stale_ages["default"])
    late = [i for i in range(n) if i not in f1]
    if not (rep1.async_round and rep1.overlap_seconds > 0 and late
            and rep1.n_clients == len(f1)
            and d1["weighted_sum"] >= -(-len(f1) // chunk)
            and all(ages.get(ids[i]) == 1 for i in tail)):
        raise AssertionError(f"async round 1: {rep1} {d1} ages={ages}")
    # float64 sums over round 1's rows and over the stragglers of each
    # age: round 1 is Eq. 1 over the first, round 2 Eq. 1 over gamma
    # times the first plus gamma^age times the rest, and the round over
    # all 48 (below) Eq. 1 over the plain total
    ws1, tot1 = _wsum_f64((U[i] for i in f1), W[f1])
    by_age = {}
    for i in late:
        by_age.setdefault(ages.get(ids[i], 0), []).append(i)
    sums = {a: _wsum_f64((U[i] for i in rows), W[rows])
            for a, rows in by_age.items()}
    err1 = _check_close(fused1.cpu().numpy(), ws1 / (tot1 + 1e-6), 2e-5,
                        1e-6, "async round 1 vs float64 Eq. 1")
    fused2, rep2, d2, wall2 = _open_round(
        svc, "Resnet50 x 48 async round 2 (the stragglers and the carry)",
        expected_clients=len(late), async_round=True)
    if rep2.n_clients != len(late) or store.count() \
            or d2["weighted_sum"] < -(-len(late) // chunk):
        raise AssertionError(f"async round 2: {rep2} {d2}")
    ws2 = gamma * ws1 + sum(gamma ** a * s[0] for a, s in sums.items())
    tot2 = gamma * tot1 + sum(gamma ** a * s[1] for a, s in sums.items())
    err2 = _check_close(fused2.cpu().numpy(), ws2 / (tot2 + 1e-6), 2e-5,
                        1e-6, "async round 2 vs float64 discounted carry")
    print(f"[phase6] gamma rounds: folded {len(f1)} + {len(late)}, ages "
          f"{sorted(ages.get(ids[i], 0) for i in late)}, max_abs_err "
          f"{err1} / {err2}", flush=True)
    out["gamma_rounds"] = {"folded": [len(f1), len(late)],
                           "walls": [wall1, wall2],
                           "overlap_seconds": rep1.overlap_seconds}
    del svc, store, fused1, fused2, ws2
    for s in sums.values():
        ws1 += s[0]
        tot1 += s[1]
    want = ws1 / (tot1 + 1e-6)
    del ws1, sums

    # the same writer schedule with a gate that waits for all 48: the
    # async round folds under the wait, the serialized one after it
    walls = {}
    for mode in (True, False):
        store = UpdateStore()
        svc = AggregationService(store=store, threshold_frac=1.0,
                                 monitor_timeout=30.0)
        th = _writer(store, U, W, ids, spread)
        fused, rep, delta, wall = _open_round(
            svc, f"Resnet50 x 48 {'async' if mode else 'serialized'} "
            "round, all 48", expected_clients=n, async_round=mode)
        th.join()
        if rep.n_clients != n or rep.async_round is not mode \
                or delta["weighted_sum"] < -(-n // chunk):
            raise AssertionError(f"{rep} {delta}")
        _check_close(fused.cpu().numpy(), want, 2e-5, 1e-6,
                     "all-48 round vs float64 Eq. 1")
        walls["async" if mode else "serialized"] = {
            "wall": wall, "overlap_seconds": rep.overlap_seconds,
            "phase_seconds": rep.phase_seconds}
        del svc, store, fused
    print(f"[phase6] Resnet50 x 48 over a {spread} s writer: async wall "
          f"{walls['async']['wall']:.3f}s, serialized wall "
          f"{walls['serialized']['wall']:.3f}s", flush=True)
    out["resnet50_walls"] = walls
    del want

    # (b) Resnet50 x 48 int8-compressed, one async round
    store = UpdateStore()
    svc = AggregationService(store=store, compress=True, threshold_frac=1.0,
                             monitor_timeout=30.0)
    th = _writer(store, cu_rows, W, ids, 0.5)
    fused, rep, delta, wall = _open_round(
        svc, "Resnet50 x 48 compressed async round", expected_clients=n,
        async_round=True)
    th.join()
    blocks = -(-n // svc._chunk_rows(n, svc._row_bytes(P, np.int8)))
    if rep.n_clients != n or not rep.async_round \
            or delta.get("weighted_sum_dequant", 0) < blocks:
        raise AssertionError(f"compressed async round: {rep} {delta}")
    err = _check_close(
        fused.cpu().numpy(),
        _eq1_f64((cu.dequantize() for cu in cu_rows), W), 2e-5, 1e-6,
        "compressed async round vs float64 dequantize-then-Eq. 1")
    print(f"[phase6] compressed async: max_abs_err={err}", flush=True)
    out["compressed_async"] = {"wall": wall, "launches": delta}
    del svc, store, fused

    # (c) CNN4.6 x 48 CoordMedian, one async round through the top-k
    # carve; the first row is in before the round opens, so the carve
    # can be sized and budgeted
    Uc48 = Uc[:n]
    (want_c,) = _order_stats_f64(Uc48, _median_f64)
    store = UpdateStore()
    store.write(ids[0], Uc48[0])
    svc = AggregationService(fusion="coordmedian", store=store,
                             threshold_frac=1.0, monitor_timeout=30.0,
                             robust_state_budget=256 << 20)
    th = _writer(store, Uc48[1:], np.ones(n - 1), ids[1:], 0.3)
    fused, rep, delta, wall = _open_round(
        svc, "CoordMedian CNN4.6 x 48 async round", expected_clients=n,
        async_round=True)
    th.join()
    blocks = -(-n // svc._chunk_rows(n, 4 * Uc.shape[1]))
    if rep.n_clients != n or not rep.async_round \
            or delta.get("topk_carve", 0) < blocks:
        raise AssertionError(f"async CoordMedian: {rep} {delta}")
    err = _check_close(fused.cpu().numpy(), want_c, 1e-5, 1e-5,
                       "async CoordMedian vs float64 median")
    print(f"[phase6] CoordMedian async: max_abs_err={err}", flush=True)
    out["coordmedian_async"] = {"wall": wall, "launches": delta}
    del svc, store, fused, want_c

    # (d) adaptive, CNN4.6 x 64 expected, 56 write a round and 8 never
    # do: the static first round waits out its timeout, the learned
    # gate closes at the 56th
    expected, writers, timeout, rounds = 64, 56, 4.0, 5
    store = UpdateStore()
    svc = AggregationService(store=store, adaptive=True, cost_bias=0.5,
                             threshold_frac=1.0, monitor_timeout=timeout)
    all_ids, done, closes = [], set(), []
    for r in range(rounds):
        # client k of the run writes row k of Uc (mod its 256 rows)
        rows = [k % Uc.shape[0] for k in range(r * writers, (r + 1) * writers)]
        all_ids += [f"r{r}-c{i:02d}" for i in range(writers)]
        th = _writer(store, Uc[rows], Wc[rows], all_ids[-writers:], 0.4)
        fused, rep, delta, wall = _open_round(
            svc, f"adaptive round {r}", expected_clients=expected,
            async_round=True)
        th.join()
        folded = _folded(all_ids, store, done)
        done.update(folded)
        src = [k % Uc.shape[0] for k in folded]
        err = _check_close(fused.cpu().numpy(), _eq1_f64(Uc[src], Wc[src]),
                           2e-5, 1e-6, f"adaptive round {r} vs float64 Eq. 1")
        pol = rep.close_policy
        closes.append({"source": pol.source, "waited": rep.monitor.waited,
                       "threshold": pol.threshold, "deadline": pol.deadline,
                       "folded": len(folded), "wall": wall})
        print(f"[phase6] adaptive round {r}: gate {pol.source} threshold "
              f"{pol.threshold} deadline {pol.deadline:.3f}s closed after "
              f"{rep.monitor.waited:.3f}s folded {len(folded)} "
              f"max_abs_err={err}", flush=True)
        if rep.n_clients != len(folded) or delta["weighted_sum"] < 1 \
                or (r > 0 and (pol.source != "learned"
                               or rep.monitor.waited >= timeout)):
            raise AssertionError(f"adaptive round {r}: {rep} {delta}")
    path = svc.save_controller(os.path.join(HERE, "build", "phase6",
                                            "adaptive"))
    fresh = AggregationService(adaptive=True, cost_bias=0.5,
                               threshold_frac=1.0, monitor_timeout=timeout)
    fresh.load_controller(path)
    resumed = fresh.controller.policy("default", expected)
    if resumed != svc.controller.policy("default", expected):
        raise AssertionError(f"resumed gate {resumed}")
    print(f"[phase6] controller saved to {os.path.relpath(path, HERE)} and "
          f"resumed: {resumed}", flush=True)
    out["adaptive"] = closes
    del svc, fresh, store, fused

    # (e) the CLI, as a user runs it
    before = _all_launches()
    t0 = time.perf_counter()
    cli.main(["--model", "CNN4.6", "--clients", "16", "--async-rounds",
              "--adaptive", "--rounds", "3", "--spread", "0.5", "--seed",
              str(SEED)])
    delta = _launch_delta(before)
    print(f"[phase6] CLI async adaptive CNN4.6 x 16: "
          f"wall={time.perf_counter() - t0:.3f}s launches={delta}",
          flush=True)
    if delta["weighted_sum"] < 1:
        raise AssertionError(f"async CLI launched no kernel: {delta}")
    return out



def _profile_streams(fn, tag="wsum"):
    """{stream id: [(start_us, end_us), ...]} of the device kernels whose
    name holds ``tag`` in one run of ``fn``, from ``torch.profiler``
    (host and device traced together, as ``_device_kernels`` does)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES // 10)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    streams = {}
    for e in prof.events():
        if tag in e.name and str(e.device_type).endswith("CUDA"):
            streams.setdefault(e.device_resource_id, []).append(
                (e.time_range.start, e.time_range.end))
    return streams


def _overlapped(streams) -> bool:
    """Whether two kernel intervals on different streams intersect."""
    spans = sorted((a, b, s) for s, ivs in streams.items() for a, b in ivs)
    return any(spans[j][0] < spans[i][1] and spans[j][2] != spans[i][2]
               for i in range(len(spans)) for j in range(i + 1, len(spans)))


def _wfq_order(counts, weights):
    """Admissions of ``counts`` rounds a tenant, all waiting and admitted
    one at a time, by the weighted-fair rule: the smallest (virtual
    time, name) goes next and its virtual time grows by 1 / weight."""
    vt, left, order = {}, dict(counts), []
    while any(left.values()):
        t = min((vt.get(t, 0.0), t) for t, c in left.items() if c)[1]
        vt[t] = vt.get(t, 0.0) + 1.0 / weights.get(t, 1.0)
        left[t] -= 1
        order.append(t)
    return order


def phase_concurrent(dev, U, W, cu_rows):
    """Phase 7: concurrent tenants on one service, the fair scheduler,
    secure aggregation and trace replay at Table-I widths through the
    entry points a user calls; every fused vector against float64
    numpy."""
    import contextlib
    import io
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from repro_torch.configs.cnn_suite import CNN_SUITE
    from repro_torch.core import (
        AggregationService,
        FairRoundScheduler,
        RoundScheduler,
        SecureMasking,
        UpdateStore,
    )
    from repro_torch.launch import aggregate as cli
    from repro_torch.launch.aggregate import _report_line
    from repro_torch.workload import (
        BurstyArrivals,
        FixedSize,
        Regime,
        RegimeSchedule,
        UniformArrivals,
        WorkloadSpec,
        start_writer,
        trace_payload,
    )

    out = {}
    n = 12   # rows a tenant writes a round in (a) and (b)
    P = U.shape[1]
    ids = [f"client{i:05d}" for i in range(n)]

    # (a) four tenants, one compress=True FedAvg service: appA-appC write
    # 12 fp32 Resnet50 rows each, appD 12 int8 rows, each over a 1.0 s
    # writer; four deployments of the same rounds, walls side by side
    tenants = ("appA", "appB", "appC", "appD")
    part = {t: slice(n * k, n * (k + 1)) for k, t in enumerate(tenants)}
    rows = {t: (cu_rows[part[t]] if t == "appD" else U[part[t]])
            for t in tenants}
    want = {t: (_eq1_f64((cu.dequantize() for cu in rows[t]), W[part[t]])
                if t == "appD" else _eq1_f64(rows[t], W[part[t]]))
            for t in tenants}
    kw = dict(from_store=True, expected_clients=n, async_round=True)

    def service(store, concurrency=1):
        return AggregationService(store=store, compress=True,
                                  threshold_frac=1.0, monitor_timeout=30.0,
                                  device_concurrency=concurrency)

    def writers(stores):
        return [_writer(stores[t], rows[t], W[part[t]], ids, 1.0, tenant=t)
                for t in tenants]

    def concurrent(concurrency):
        store = UpdateStore()
        svc = service(store, concurrency)
        ths = writers({t: store for t in tenants})
        with RoundScheduler(svc) as sched:
            res = sched.run_round(tenants, **kw)
        for th in ths:
            th.join()
        return res, [svc]

    def serialized():
        store = UpdateStore()
        svc = service(store)
        res = {}
        for t in tenants:   # each tenant's writer starts with its round
            th = _writer(store, rows[t], W[part[t]], ids, 1.0, tenant=t)
            res[t] = svc.aggregate(tenant=t, **kw)
            th.join()
        return res, [svc]

    def separate():
        stores = {t: UpdateStore() for t in tenants}
        svcs = {t: service(stores[t]) for t in tenants}
        ths = writers(stores)
        with ThreadPoolExecutor(len(tenants)) as pool:
            futs = {t: pool.submit(svcs[t].aggregate, tenant=t, **kw)
                    for t in tenants}
            res = {t: f.result() for t, f in futs.items()}
        for th in ths:
            th.join()
        return res, list(svcs.values())

    modes = {"concurrent": lambda: concurrent(1),
             "concurrent_dc2": lambda: concurrent(2),
             "serialized": serialized, "separate": separate}
    buckets = 2   # the fp32 fold step and the int8 fold step
    walls, shared = {}, {}
    for mode, run in modes.items():
        before = _all_launches()
        t0 = time.perf_counter()
        res, svcs = run()
        wall = time.perf_counter() - t0
        delta = {k: v for k, v in _launch_delta(before).items() if v}
        builds = sum(s.local.cache.misses for s in svcs)
        blocks = {t: -(-n // svcs[0]._chunk_rows(n, svcs[0]._row_bytes(
            P, np.int8 if t == "appD" else np.float32))) for t in tenants}
        errs = {}
        for t in tenants:
            fused, rep = res[t]
            print(f"[phase7] {mode}: {_report_line(rep)}", flush=True)
            if rep.empty or rep.n_clients != n:
                raise AssertionError(f"{mode} {t}: included "
                                     f"{rep.n_clients} of {n}: {rep}")
            errs[t] = _check_close(fused.cpu().numpy(), want[t], 2e-5, 1e-6,
                                   f"{mode} {t} vs float64 Eq. 1")
            if mode == "concurrent":
                shared[t] = fused.cpu().numpy()
            elif mode == "separate":
                _check_close(fused.cpu().numpy(), shared[t].astype(np.float64),
                             2e-5, 1e-6, f"{t}: shared vs isolated service")
        want_ws = sum(blocks[t] for t in tenants if t != "appD")
        if delta.get("weighted_sum", 0) != want_ws \
                or delta.get("weighted_sum_dequant", 0) != blocks["appD"] \
                or (mode != "separate" and builds > buckets):
            raise AssertionError(f"{mode}: launches {delta}, blocks {blocks}, "
                                 f"step builds {builds}")
        walls[mode] = {
            "wall": wall, "launches": delta, "step_builds": builds,
            "max_abs_err": errs,
            "phase_seconds": {t: res[t][1].phase_seconds for t in tenants}}
        print(f"[phase7] {mode}: wall={wall:.3f}s launches={delta} "
              f"step_builds={builds} max_abs_err={errs}", flush=True)
        del res, svcs
    print("[phase7] four tenants, writers over 1.0 s: "
          + ", ".join(f"{m} {w['wall']:.3f}s" for m, w in walls.items()),
          flush=True)
    out["four_tenants"] = walls

    # one more concurrent round at device_concurrency 2, profiled: the
    # streams the tenants' fold kernels ran on, and whether two of them
    # ran at once (a fact, not a check)
    streams = _profile_streams(lambda: concurrent(2))
    overlap = _overlapped(streams)
    print(f"[phase7] device_concurrency 2, profiled round: fold kernels by "
          f"stream id {{{', '.join(f'{s}: {len(v)}' for s, v in sorted(streams.items()))}}}, "
          f"kernel intervals overlapped: {overlap}", flush=True)
    if len(streams) != len(tenants):
        raise AssertionError(f"tenants' kernels on streams {sorted(streams)}")
    out["dc2_streams"] = {"kernels_by_stream": {str(s): len(v) for s, v in
                                                streams.items()},
                          "overlapped": overlap}
    del shared, want

    # (b) FairRoundScheduler: 3 rounds each of appA-appC (Resnet50 x 12)
    # under max_running 2, appA at weight 2 and a capacity of 1.5 x one
    # tenant's footprint. A round lands its tenant's next rows before it
    # ends, so a waiting round's footprint is always live
    fair = ("appA", "appB", "appC")
    rounds_b = 3
    store = UpdateStore()
    svc = AggregationService(store=store, threshold_frac=1.0,
                             monitor_timeout=30.0)
    footprint = 2 * svc._chunk_rows(n, 4 * P) * 4 * P
    capacity = int(1.5 * footprint)

    def rows_of(k, r):
        return [(n * k + 4 * r + i) % U.shape[0] for i in range(n)]

    def land(k, r):
        for cid, j in zip(ids, rows_of(k, r)):
            store.write(cid, U[j], weight=float(W[j]), tenant=fair[k])

    for k in range(len(fair)):
        land(k, 0)
    lock = threading.Lock()
    samples, done, fused_b = [], {t: 0 for t in fair}, {}
    inner = svc.aggregate
    sched = FairRoundScheduler(svc, max_running=2, weights={"appA": 2.0},
                               capacity_bytes=capacity)

    def sampled(tenant, **akw):
        samples.append(sched.running())
        fused, rep = inner(tenant=tenant, **akw)
        with lock:
            r = done[tenant]
            done[tenant] += 1
        fused_b[tenant, r] = (fused, rep)
        if r + 1 < rounds_b:
            land(fair.index(tenant), r + 1)
        samples.append(sched.running())
        return fused, rep

    svc.aggregate = sampled
    t0 = time.perf_counter()
    try:
        futs = [sched.submit(t, **kw) for _ in range(rounds_b) for t in fair]
        for f in futs:
            f.result()
    finally:
        sched.shutdown()
    wall_b = time.perf_counter() - t0
    order = sched.admission_order()
    wfq = _wfq_order({t: rounds_b for t in fair}, {"appA": 2.0})
    peak = max(len(s) for s in samples)
    if peak > 2 or any(len(s) > 1 and len(s) * footprint > capacity
                       for s in samples) or order != wfq:
        raise AssertionError(f"fair scheduler: running {samples}, admitted "
                             f"{order}, WFQ {wfq}")
    errs = []
    for (t, r), (fused, rep) in sorted(fused_b.items()):
        sl = rows_of(fair.index(t), r)
        if rep.n_clients != n:
            raise AssertionError(f"fair {t} round {r}: {rep}")
        errs.append(_check_close(fused.cpu().numpy(), _eq1_f64(U[sl], W[sl]),
                                 2e-5, 1e-6, f"fair {t} round {r}"))
    print(f"[phase7] fair scheduler: wall={wall_b:.3f}s admitted {order} "
          f"(WFQ replay {wfq}), running at most {peak}, footprint "
          f"{footprint} B, capacity {capacity} B, max_abs_err={max(errs)}",
          flush=True)
    out["fair"] = {"wall": wall_b, "admitted": order, "peak_running": peak,
                   "phase_seconds": {f"{t}/{r}": rep.phase_seconds for
                                     (t, r), (_, rep) in fused_b.items()}}
    del svc, store, fused_b, inner

    # (c) secure aggregation: 8 Resnet50 rows masked on the card, written,
    # fused by an IterAvg service; the masks cancel in the plain sum
    sm = SecureMasking(n_clients=8, seed=SEED)
    store = UpdateStore()
    svc = AggregationService(fusion="iteravg", store=store, secure=sm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masked = [sm.mask_update(i, U[i]) for i in range(8)]
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - t0
    for i, m in enumerate(masked):
        store.write(ids[i], m)
    del masked
    fused, rep, delta = _store_round(svc, 8, "secure IterAvg Resnet50 x 8",
                                     phase="phase7")
    ws, tot = _wsum_f64(U[:8], np.ones(8))
    err = _check_close(fused.cpu().numpy(), ws / tot, 1e-3, 1e-3,
                       "secure IterAvg vs float64 unmasked mean")
    print(f"[phase7] secure: mask 8 rows {mask_s:.3f}s on the card, "
          f"max_abs_err={err}", flush=True)
    out["secure"] = {"mask_seconds": mask_s, "max_abs_err": err,
                     "phase_seconds": rep.phase_seconds}
    del svc, store, fused, ws

    # (d) a trace of 3 tenants x 32 clients at CNN4.6's width over 8
    # rounds, uniform then bursty with 25% dropout from round 4, replayed
    # through a RoundScheduler with the static gate and the learned one
    spec = WorkloadSpec(
        tenants=fair, n_clients=32, rounds=8,
        regimes=RegimeSchedule([
            Regime("uniform", UniformArrivals(spread=0.5), 0),
            Regime("bursty", BurstyArrivals(spread=0.5, arrive_frac=0.75),
                   4)]),
        sizes=FixedSize(dim=CNN_SUITE["CNN4.6"].num_params))
    trace = spec.build(SEED)
    payload_bytes = 4 * spec.sizes.dim * spec.n_clients * len(fair)
    gates = {}
    for gate in ("static", "adaptive"):
        store = UpdateStore()
        svc = AggregationService(store=store, threshold_frac=1.0,
                                 monitor_timeout=2.0,
                                 adaptive=gate == "adaptive", cost_bias=0.5)
        per_round, walls_d = [], []
        with RoundScheduler(svc) as rsched:
            for rt in trace.rounds:
                t0 = time.perf_counter()
                ths = [start_writer(store, tr, SEED) for tr in rt.tenants]
                res = rsched.run_round(list(fair), from_store=True,
                                       expected_clients=spec.n_clients,
                                       async_round=True)
                walls_d.append(time.perf_counter() - t0)
                for th in ths:
                    th.join()
                for tr in rt.tenants:
                    fused, rep = res[tr.tenant]
                    left = set(store.client_ids(tr.tenant))
                    folded = [ev for ev in tr.events
                              if ev.client_id not in left]
                    src = rep.close_policy.source if rep.close_policy \
                        else "static"
                    if rep.n_clients != len(folded) or (
                            gate == "adaptive" and rt.index > 0
                            and src == "static"):
                        raise AssertionError(f"{gate} round {rt.index} "
                                             f"{tr.tenant}: {rep}")
                    _check_close(
                        fused.cpu().numpy(),
                        _eq1_f64((trace_payload(SEED, tr.tenant, ev.client_id,
                                                tr.dim) for ev in folded),
                                 [ev.weight for ev in folded]),
                        2e-5, 1e-6, f"{gate} round {rt.index} {tr.tenant}")
                    store.clear(tenant=tr.tenant)   # late rows: next trace
                    per_round.append({
                        "round": rt.index, "tenant": tr.tenant,
                        "regime": tr.regime, "gate": src,
                        "folded": len(folded), "expected": spec.n_clients,
                        "waited": rep.monitor.waited})
                print(f"[phase7] trace {gate} round {rt.index} "
                      f"({rt.tenants[0].regime}): wall={walls_d[-1]:.3f}s "
                      + ", ".join(f"{p['tenant']} {p['gate']} folded "
                                  f"{p['folded']} after {p['waited']:.3f}s"
                                  for p in per_round[-len(fair):]),
                      flush=True)
        gates[gate] = {"wall": sum(walls_d), "walls": walls_d,
                       "inclusion": sum(p["folded"] for p in per_round)
                       / sum(p["expected"] for p in per_round),
                       "rounds": per_round}
        del svc, store
    print(f"[phase7] trace_hash={trace.trace_hash()} payloads "
          f"{payload_bytes} B; static wall {gates['static']['wall']:.3f}s "
          f"inclusion {gates['static']['inclusion']:.4f}, adaptive wall "
          f"{gates['adaptive']['wall']:.3f}s inclusion "
          f"{gates['adaptive']['inclusion']:.4f}", flush=True)
    out["trace"] = {"trace_hash": trace.trace_hash(),
                    "payload_bytes": payload_bytes,
                    **{g: {k: v[k] for k in ("wall", "inclusion")}
                       for g, v in gates.items()}}

    # (e) the CLI, as a user runs it
    before = _all_launches()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rounds = cli.main(["--model", "CNN4.6", "--clients", "16",
                           "--async-rounds", "--concurrent-tenants", "3",
                           "--device-concurrency", "2", "--rounds", "2",
                           "--seed", str(SEED)])
    print(buf.getvalue(), end="", flush=True)
    delta = _launch_delta(before)
    labels = sorted(re.search(r"tenant=(\w+)", ln).group(1)
                    for ln in buf.getvalue().splitlines() if "engine=" in ln)
    paid = [rep.phase_seconds.get("compile", 0.0) for _, rep in rounds[0]]
    print(f"[phase7] CLI CNN4.6 x 16, 3 concurrent tenants: "
          f"wall={time.perf_counter() - t0:.3f}s launches={delta} "
          f"round-0 compile seconds {paid}", flush=True)
    if labels != sorted(f"app{i}" for i in range(3) for _ in range(2)) \
            or sum(c > 0 for c in paid) != 1 or delta["weighted_sum"] < 1:
        raise AssertionError(f"concurrent CLI: {labels} {paid} {delta}")
    return out


def _post_head(port, token, body_len):
    """Send an upload's request head declaring ``body_len`` body bytes and
    return the reply's status line, read before any body byte is sent."""
    import select
    import socket

    head = (f"POST /v1/upload HTTP/1.1\r\nHost: 127.0.0.1\r\n"
            f"Authorization: Bearer {token}\r\n"
            f"Content-Length: {body_len}\r\n\r\n").encode()
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(head)
        if not select.select([s], [], [], 10)[0]:
            raise AssertionError("no reply to the upload's head in 10 s")
        return s.recv(4096).split(b"\r\n", 1)[0].decode()


def _post_frame(port, token, frame):
    """One upload of ``frame``: (status, reply body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/upload", body=frame, headers={
            "Authorization": f"Bearer {token}",
            "Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def phase_edge_serving(dev, U, W, Uc):
    """Phase 8: the Edge serving path — HTTP uploads through
    ``EdgeAggregatorServer`` (``repro_torch.serving`` + the fair
    scheduler) into rounds on the card, and the serve CLI; every fused
    vector against float64 numpy."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.core import AggregationService, UpdateStore
    from repro_torch.core.fusion import get_fusion
    from repro_torch.fl import EdgeAggregatorServer
    from repro_torch.launch import serve
    from repro_torch.launch.aggregate import _report_line
    from repro_torch.serving import HttpStoreClient, encode_update
    from repro_torch.utils.dtypes import host_array
    from repro_torch.workload import trace_payload

    out = {}
    n = 12   # clients a tenant uploads in (a) and (b)
    P = U.shape[1]
    ids = [f"client{i:05d}" for i in range(n)]
    tenants = ("appA", "appB", "appC")
    tokens = {f"tok-{t}": t for t in tenants}
    part = {t: slice(n * k, n * (k + 1)) for k, t in enumerate(tenants)}
    rows_of = {t: range(n * k, n * (k + 1)) for k, t in enumerate(tenants)}
    cap = 128 << 20   # a Resnet50 fp32 frame is 91 MB, over the 64 MiB default

    def service(store, **kw):
        return AggregationService(store=store, threshold_frac=1.0,
                                  monitor_timeout=60.0, device=dev, **kw)

    # (a) three tenants over HTTP on one compress=True FedAvg service:
    # appA fp32 frames, appB bf16 frames, appC int8 frames
    store = UpdateStore()
    svc = service(store, compress=True)
    t0 = time.perf_counter()
    bf16 = [torch.from_numpy(U[j]).to(torch.bfloat16)
            for j in rows_of["appB"]]
    rows = {"appA": U[part["appA"]],
            "appB": [host_array(b) for b in bf16],
            "appC": [svc.compress_update(cid, U[j], tenant="appC")
                     for cid, j in zip(ids, rows_of["appC"])]}
    want = {"appA": _eq1_f64(rows["appA"], W[part["appA"]]),
            "appB": _eq1_f64((b.float().numpy() for b in bf16),
                             W[part["appB"]]),
            "appC": _eq1_f64((cu.dequantize() for cu in rows["appC"]),
                             W[part["appC"]])}
    tol = {"appA": (2e-5, 1e-6), "appB": (TOL["half"], 1e-6),
           "appC": (2e-5, 1e-6)}
    del bf16
    frame_bytes = {t: len(encode_update(ids[0], rows[t][0]))
                   for t in tenants}
    print(f"[phase8] frames and oracles seconds="
          f"{time.perf_counter() - t0:.3f}; frame bytes {frame_bytes}",
          flush=True)
    with EdgeAggregatorServer(svc, tokens, max_running=2,
                              max_body_bytes=cap) as edge:
        before = _all_launches()
        t0 = time.perf_counter()
        errors = []
        clients = [HttpStoreClient("127.0.0.1", edge.port,
                                   token=f"tok-{t}") for t in tenants]
        ths = [_writer(c, rows[t], W[part[t]], ids, 1.0, t, errors)
               for c, t in zip(clients, tenants)]
        res = edge.run_rounds(tenants, expected_clients=n)
        for th in ths:
            th.join()
        wall = time.perf_counter() - t0
        for c in clients:
            c.close()
        delta = {k: v for k, v in _launch_delta(before).items() if v}
        m = edge.metrics()
        errs = {}
        for t in tenants:
            fused, rep = res[t]
            print(f"[phase8] (a) {_report_line(rep)} "
                  f"phase_seconds={rep.phase_seconds}", flush=True)
            if rep.empty or rep.n_clients != n:
                raise AssertionError(f"(a) {t}: included {rep.n_clients} "
                                     f"of {n}: {rep}")
            errs[t] = _check_close(fused.cpu().numpy(), want[t], *tol[t],
                                   f"(a) {t} over HTTP vs float64 Eq. 1")
        blocks = {t: -(-n // svc._chunk_rows(n, svc._row_bytes(
            P, np.int8 if t == "appC" else rows[t][0].dtype)))
            for t in tenants}
        if errors or m.get("accepted") != 3 * n \
                or delta.get("weighted_sum", 0) \
                != blocks["appA"] + blocks["appB"] \
                or delta.get("weighted_sum_dequant", 0) != blocks["appC"]:
            raise AssertionError(f"(a): upload errors {errors}, metrics {m}, "
                                 f"launches {delta}, blocks {blocks}")
        print(f"[phase8] (a) three tenants over HTTP, writers over 1.0 s: "
              f"wall={wall:.3f}s accepted={m['accepted']} "
              f"batches={m['batches']} max_batch={m['max_batch']} "
              f"launches={delta} max_abs_err={errs}", flush=True)
        out["three_tenants"] = {
            "wall": wall, "launches": delta, "max_abs_err": errs,
            "metrics": {k: m[k] for k in ("accepted", "batches",
                                          "max_batch")},
            "phase_seconds": {t: res[t][1].phase_seconds for t in tenants}}
        store.clear()   # synchronous rounds don't consume
        del res

        # (b) the socket round against the in-process round, bitwise:
        # appA's fp32 rows, then appC's int8 rows, one after another over
        # one client, and the same rows written in-process to a second
        # store under a service with the same settings
        ref_store = UpdateStore()
        ref = service(ref_store, compress=True)
        cli = HttpStoreClient("127.0.0.1", edge.port, token="tok-appA")
        out["bitwise"] = {}
        for kind, src in (("fp32", rows["appA"]), ("int8", rows["appC"])):
            t0 = time.perf_counter()
            for cid, row, w in zip(ids, src, W[:n]):
                cli.write(cid, row, weight=float(w), tenant="appA")
            up = time.perf_counter() - t0
            for cid, row, w in zip(ids, src, W[:n]):
                ref_store.write(cid, row, weight=float(w), tenant="appA")
            sock, srep = edge.run_round("appA", expected_clients=n)
            inproc, irep = ref.aggregate(from_store=True, expected_clients=n,
                                         tenant="appA")
            same = torch.equal(sock, inproc)
            print(f"[phase8] (b) {kind}: {n} uploads over one client "
                  f"{up:.3f}s; socket round {srep.fuse_seconds:.3f}s, "
                  f"in-process {irep.fuse_seconds:.3f}s; bitwise equal: "
                  f"{same}", flush=True)
            if not same or srep.n_clients != n or irep.n_clients != n:
                raise AssertionError(f"(b) {kind}: socket {srep} vs "
                                     f"in-process {irep}")
            out["bitwise"][kind] = {"upload_seconds": up, "equal": same}
            store.clear()
            ref_store.clear()
            del sock, inproc
        cli.close()
        del ref, ref_store

        # (c) fail closed on the card's service: a truncated frame at the
        # 128 MiB cap gets 400, and a Resnet50 fp32 frame at the default
        # 64 MiB cap gets 413 on its head, before a body byte is read
        frame = encode_update(ids[0], rows["appA"][0], weight=1.0)
        count = store.count()
        status, body = _post_frame(edge.port, "tok-appA", frame[:-7])
        with EdgeAggregatorServer(svc, tokens) as strict:
            line = _post_head(strict.port, "tok-appA", len(frame))
            shed = strict.metrics().get("shed_413", 0)
        if status != 400 or " 413 " not in line or shed != 1 \
                or store.count() != count \
                or edge.metrics().get("malformed") != 1:
            raise AssertionError(f"(c): truncated frame {status} {body!r}, "
                                 f"{len(frame)} B at the default cap "
                                 f"{line!r} (shed_413 {shed}), store "
                                 f"count {count} -> {store.count()}")
        print(f"[phase8] (c) truncated frame: {status}; {len(frame)} B "
              f"frame at the 64 MiB default: {line!r}; store count "
              f"{store.count()} before and after", flush=True)
        del frame
    del rows, want, svc, store

    # (d) robust fusion over HTTP: a streamed TrimmedMean(0.1) service
    # behind its own server, 48 CNN4.6 clients over 4 writers
    nr = 48
    rows_d = Uc[:nr]
    trim = get_fusion("trimmedmean", beta=0.1).trim_count(nr)
    (want_d,) = _order_stats_f64(rows_d, _trimmed_f64(trim))
    store = UpdateStore()
    svc = AggregationService(fusion=get_fusion("trimmedmean", beta=0.1),
                             store=store, threshold_frac=1.0,
                             monitor_timeout=60.0, device=dev)
    ids_d = [f"client{i:05d}" for i in range(nr)]
    with EdgeAggregatorServer(svc, {"tok-robust": "robust"}) as edge:
        before = _all_launches()
        t0 = time.perf_counter()
        errors = []
        clients = [HttpStoreClient("127.0.0.1", edge.port,
                                   token="tok-robust") for _ in range(4)]
        ths = [_writer(c, rows_d[k::4], np.ones(nr)[k::4], ids_d[k::4],
                       0.5, "robust", errors)
               for k, c in enumerate(clients)]
        fused, rep = edge.run_round("robust", expected_clients=nr)
        for th in ths:
            th.join()
        wall = time.perf_counter() - t0
        for c in clients:
            c.close()
        delta = {k: v for k, v in _launch_delta(before).items() if v}
        print(f"[phase8] (d) {_report_line(rep)} "
              f"phase_seconds={rep.phase_seconds}", flush=True)
        if errors or rep.n_clients != nr or not rep.streamed \
                or delta.get("topk_carve", 0) == 0:
            raise AssertionError(f"(d): upload errors {errors}, {rep}, "
                                 f"launches {delta}")
        err = _check_close(fused.cpu().numpy(), want_d, 1e-5, 1e-5,
                           "(d) TrimmedMean CNN4.6 x 48 over HTTP vs float64")
        print(f"[phase8] (d) TrimmedMean(0.1) CNN4.6 x 48 over HTTP: "
              f"wall={wall:.3f}s launches={delta} max_abs_err={err}",
              flush=True)
        out["robust"] = {"wall": wall, "launches": delta, "max_abs_err": err,
                         "phase_seconds": rep.phase_seconds}
    del svc, store, want_d

    # (e) the serve CLI, as a user runs it: fp32, then int8 frames under
    # a token bucket of 20 uploads/s that sheds and retries
    out["cli"] = {}
    base = ["--tenants", "2", "--clients", "12", "--dim", "1150000",
            "--rounds", "2", "--seed", str(SEED), "--device", str(dev)]
    for name, argv in (("fp32", base),
                       ("int8", base + ["--compress", "--rate", "20",
                                        "--burst", "4"])):
        before = _all_launches()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rounds, m = serve.main(argv)
        wall = time.perf_counter() - t0
        print(buf.getvalue(), end="", flush=True)
        delta = {k: v for k, v in _launch_delta(before).items() if v}
        included = [rep.n_clients for r in rounds for _, rep in r.values()]
        kernel = "weighted_sum_dequant" if name == "int8" else "weighted_sum"
        if m.get("accepted") != 2 * 12 * 2 or included != [12] * 4 \
                or delta.get(kernel, 0) == 0 \
                or (name == "int8" and m.get("shed_429", 0) == 0):
            raise AssertionError(f"(e) CLI {name}: metrics {m}, included "
                                 f"{included}, launches {delta}")
        if name == "fp32":   # every round against the trace's payloads
            args = serve.parse_args(argv)
            trace = serve.build_spec(args).build(args.seed)
            for rt, results in zip(trace.rounds, rounds):
                for tr in rt.tenants:
                    _check_close(
                        results[tr.tenant][0].cpu().numpy(),
                        _eq1_f64((trace_payload(args.seed, tr.tenant,
                                                ev.client_id, args.dim)
                                  for ev in tr.events),
                                 [ev.weight for ev in tr.events]),
                        2e-5, 1e-6, f"(e) CLI round {rt.index} {tr.tenant}")
        print(f"[phase8] (e) CLI {name}: wall={wall:.3f}s "
              f"accepted={m['accepted']} shed_429={m.get('shed_429', 0)} "
              f"batches={m['batches']} launches={delta}", flush=True)
        out["cli"][name] = {"wall": wall, "launches": delta,
                            "shed_429": m.get("shed_429", 0)}
    return out

# -- phase 10: the distributed engine ------------------------------------------
def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _runs(fn, dev, reps: int = 5):
    """(the first run's result, the launches it made, the median host wall
    seconds of ``reps`` runs, each synced before and after)."""
    walls, first, delta = [], None, None
    for i in range(reps):
        before = _all_launches()
        _sync(dev)
        t0 = time.perf_counter()
        result = fn()
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        if i == 0:
            first = result
            delta = {k: v for k, v in _launch_delta(before).items() if v}
    return first, delta, statistics.median(walls)


def _comm_share(fn, dev, tries: int = 5):
    """(NCCL's device ms, device busy ms, fusion kernels recorded) in one
    profiled run of ``fn``: the device events whose name holds "nccl"
    against all of them. As in ``_device_kernels``, the session opens
    with a spin kernel and a synchronize, and is taken again, up to
    ``tries`` times, while it records no device time: on the H100 the
    first session of a short run has come back empty, and long sessions
    lose a few of their first kernels, so the fusion kernels it
    did record are returned to be printed beside the launches. The spin
    kernel is left out of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        fn()
        return 0.0, 0.0, 0
    ours = ("wsum_kernel", "wsum_dequant_kernel", "carve_", "stat_")
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES // 10)
            _sync(dev)
            fn()
            _sync(dev)
        dev_events = [e for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")
                      and "spin" not in e.key]
        busy = sum(e.self_device_time_total for e in dev_events) / 1e3
        if busy > 0:
            break
        print(f"[profile] no device time recorded; profile {attempt + 1} "
              f"of {tries}", flush=True)
    nccl = sum(e.self_device_time_total for e in dev_events
               if "nccl" in e.key.lower()) / 1e3
    fused = sum(e.count for e in dev_events if any(k in e.key for k in ours))
    return nccl, busy, fused


def _f64_wsum(rows, w):
    """(sum_i w_i u_i, sum_i w_i) in float64 on the rows' device, a row
    at a time."""
    import torch

    acc = torch.zeros(rows.shape[1], dtype=torch.float64, device=rows.device)
    for i in range(rows.shape[0]):
        acc.add_(rows[i].double(), alpha=float(w[i]))
    return acc, float(sum(float(x) for x in w))


def _f64_order_stats(rows, trim):
    """(trimmed mean, median) per column in float64 on the rows' device,
    a column slice at a time."""
    import torch

    n, P = rows.shape
    tm = torch.empty(P, dtype=torch.float64, device=rows.device)
    med = torch.empty_like(tm)
    for lo in range(0, P, ORACLE_COLS * 4):
        s = torch.sort(rows[:, lo:lo + ORACLE_COLS * 4].double(), dim=0)[0]
        tm[lo:lo + s.shape[1]] = s[trim:n - trim].mean(dim=0)
        med[lo:lo + s.shape[1]] = 0.5 * (s[(n - 1) // 2] + s[n // 2])
    return tm, med


def phase_distributed(dev, U, W, Uc, Wc, cu_rows):
    """Phase 10: ``DistributedEngine`` and ``AggregationService(mesh=)``
    over NCCL at world size 1, on (1, 1) ("data", "model") and (1, 1, 1)
    ("pod", "data", "model") meshes: every collective runs through NCCL
    on the card; each case beside ``LocalEngine`` on the same inputs."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.core.fusion import get_fusion
    from repro_torch.core.local import LocalEngine
    from repro_torch.core.service import AggregationService
    from repro_torch.core.store import UpdateStore
    from repro_torch.launch.aggregate import _report_line
    from repro_torch.launch.mesh import make_local_mesh

    cuda = dev.type == "cuda"
    # NCCL's bootstrap on a machine whose only interface is loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    rdv = os.path.join(HERE, "build", "phase10", "rendezvous")
    os.makedirs(os.path.dirname(rdv), exist_ok=True)
    if os.path.exists(rdv):
        os.remove(rdv)
    if cuda:   # the rank's card, before NCCL binds to one
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl" if cuda else "gloo", store=dist.FileStore(rdv, 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        mesh = make_local_mesh(1, 1, device_type=dev.type)
        pod = make_local_mesh(1, 1, pod=1, device_type=dev.type)
        flat = DistributedEngine(mesh=mesh)
        hier = DistributedEngine(mesh=pod, hierarchical=True)
        local = LocalEngine(device=dev)
        # the first collective builds NCCL's communicator: out of the walls
        flat.broadcast(None)
        print(f"[phase10] {dist.get_backend()} world 1, meshes "
              f"{tuple(mesh.mesh.shape)} / {tuple(pod.mesh.shape)} on "
              f"{flat.device}: setup {time.perf_counter() - t0:.3f}s",
              flush=True)
        n, P = U.shape
        U_dev = torch.from_numpy(U).to(dev)
        Wt = torch.from_numpy(np.ascontiguousarray(W))

        lib = {"weighted_sum": "fused_fusion", "weighted_sum_dequant":
               "fused_fusion", "topk_carve": "robust_fusion",
               "trimmed_mean": "robust_fusion",
               "coord_median": "robust_fusion"}

        def case(what, dist_fn, local_fn, expect, local=None):
            """Both sides five times, synced (the first run's launches
            must be ``expect``; median walls), then one profiled run of
            the distributed side. ``local``: the (result, wall) of an
            identical local run already timed."""
            want = {k: v for k, v in expect.items() if v}
            got, delta, d_wall = _runs(dist_fn, dev)
            if delta != want:
                raise AssertionError(f"{what}: launches {delta}, want {want}")
            if local is None:
                ref, local_delta, l_wall = _runs(local_fn, dev)
                if local_delta != want:
                    raise AssertionError(f"{what}: local launches "
                                         f"{local_delta}")
            else:
                ref, l_wall = local
            nccl_ms, busy_ms, seen = _comm_share(dist_fn, dev)
            libs = {k: f"{lib[k]}:{v}" for k, v in delta.items()}
            print(f"[phase10] {what}: distributed {d_wall:.4f}s local "
                  f"{l_wall:.4f}s (median of 5) launches={libs} nccl "
                  f"{nccl_ms:.3f} of {busy_ms:.3f} device ms "
                  f"({nccl_ms / max(busy_ms, 1e-9):.1%}; the profile "
                  f"recorded {seen} fusion kernels)", flush=True)
            out[what] = {"dist_s": round(d_wall, 4),
                         "local_s": round(l_wall, 4)}
            return got, ref, l_wall

        def k(name, count):
            return {name: count if cuda else 0}

        # -- dense rounds, Resnet50 x 48 on the card -----------------------
        ws, tot = _f64_wsum(U_dev, W)
        for name, kw in (("fedavg", {}), ("iteravg", {}),
                         ("clippedavg", {"clip_norm": 10.0})):
            f = get_fusion(name, **kw)
            got, ref, _ = case(
                f"{name} Resnet50 x {n} dense",
                lambda f=f: flat.fuse(f, U_dev, Wt),
                lambda f=f: local.fuse(f, U_dev, Wt),
                k("weighted_sum", 0 if name == "clippedavg" else 1))
            if name == "fedavg":
                want = ws / (tot + 1e-6)
            elif name == "iteravg":
                want = _f64_wsum(U_dev, [1.0] * n)[0] / (n + 1e-6)
            else:
                norms = torch.linalg.vector_norm(U_dev.double(), dim=1)
                scale = torch.clamp(10.0 / (norms + 1e-6), max=1.0)
                want = _f64_wsum(U_dev, (scale.cpu() * Wt.double()).tolist()
                                 )[0] / (tot + 1e-6)
            err = _check_close(got.cpu().numpy(), want.cpu().numpy(), 2e-5,
                               1e-6, f"{name} distributed vs float64")
            # the same kernel on the same rows: bit for bit the local
            # engine's, but ClippedAvg, whose row norms sum in another order
            same = torch.equal(got, ref)
            if not same and name != "clippedavg":
                raise AssertionError(f"{name}: distributed != local")
            print(f"[phase10] {name}: max_abs_err={err} bitwise_local={same}",
                  flush=True)
        trim = get_fusion("trimmedmean", beta=0.1).trim_count(n)
        want_tm, want_med = _f64_order_stats(U_dev, trim)
        for name, want in (("trimmedmean", want_tm),
                           ("coordmedian", want_med)):
            f = get_fusion(name, **({"beta": 0.1} if name == "trimmedmean"
                                    else {}))
            kname = "trimmed_mean" if name == "trimmedmean" \
                else "coord_median"
            got, ref, _ = case(f"{name} Resnet50 x {n} dense (all-to-all)",
                            lambda f=f: flat.fuse(f, U_dev, None),
                            lambda f=f: local.fuse(f, U_dev, None),
                            k(kname, 1))
            err = _check_close(got.cpu().numpy(), want.cpu().numpy(), 1e-5,
                               1e-6, f"{name} distributed vs float64")
            if not torch.equal(got, ref):
                raise AssertionError(f"{name}: distributed != local")
            print(f"[phase10] {name}: max_abs_err={err} (== local)",
                  flush=True)
        del want_med
        rows = torch.from_numpy(np.ascontiguousarray(Uc[:64])).to(dev)
        wc = torch.from_numpy(np.ascontiguousarray(Wc[:64]))
        for name in ("krum", "zeno", "geomedian"):
            f = get_fusion(name)
            got, ref, _ = case(f"{name} CNN4.6 x 64 dense (all-reduced)",
                            lambda f=f: flat.fuse(f, rows, wc),
                            lambda f=f: local.fuse(f, rows, wc), {})
            err = _check_close(got.cpu().numpy(),
                               ref.double().cpu().numpy(), 1e-4, 1e-5,
                               f"{name} distributed vs local")
            print(f"[phase10] {name}: max_abs_err vs local={err}", flush=True)
        del rows

        # -- streamed rounds off UpdateStore.iter_chunks, Resnet50 x 48 -----
        store = UpdateStore()
        for i in range(n):
            store.write(f"client{i:05d}", U[i], weight=float(W[i]))
        chunk = max(1, (64 << 20) // (4 * P))      # 1 row a block
        blocks = list(store.iter_chunks(chunk))
        qstore = UpdateStore()
        for i, cu in enumerate(cu_rows):
            qstore.write(f"client{i:05d}", cu, weight=float(W[i]))
        qrow = cu_rows[0].codes.nbytes + cu_rows[0].scales.nbytes
        qchunk = max(1, (64 << 20) // qrow)       # 2 rows a block
        qblocks = list(qstore.iter_chunks(qchunk))
        del store, qstore
        want = ws / (tot + 1e-6)
        fedavg = get_fusion("fedavg")
        local_run = None   # the local side of both is the same stream
        for what, eng in (("FedAvg fp32", flat), ("FedAvg fp32 hierarchical",
                                                  hier)):
            got, ref, l_wall = case(
                f"{what} Resnet50 x {n} streamed, {len(blocks)} blocks",
                lambda eng=eng: eng.fuse_stream(fedavg, iter(blocks),
                                                chunk_rows=chunk)[0],
                lambda: local.fuse_stream(fedavg, iter(blocks),
                                          chunk_rows=chunk)[0],
                k("weighted_sum", len(blocks)), local=local_run)
            local_run = (ref, l_wall)
            err = _check_close(got.cpu().numpy(), want.cpu().numpy(), 2e-5,
                               1e-6, f"{what} streamed vs float64")
            print(f"[phase10] {what} streamed: max_abs_err={err}", flush=True)
        # dequantize-then-Eq. 1 in float64, a row at a time on the card
        qwant = torch.zeros(P, dtype=torch.float64, device=dev)
        for cu, wi in zip(cu_rows, W):
            q = torch.from_numpy(cu.codes).to(dev).double()
            sc = torch.from_numpy(cu.scales).to(dev).double()
            qwant += float(wi) * (q.reshape(sc.shape[0], -1)
                                  * sc[:, None]).reshape(-1)[:P]
        qwant = qwant / (float(W.sum(dtype=np.float64)) + 1e-6)
        got, ref, _ = case(
            f"FedAvg int8 Resnet50 x {n} streamed, {len(qblocks)} blocks",
            lambda: flat.fuse_stream(fedavg, iter(qblocks),
                                     chunk_rows=qchunk)[0],
            lambda: local.fuse_stream(fedavg, iter(qblocks),
                                      chunk_rows=qchunk)[0],
            k("weighted_sum_dequant", len(qblocks)))
        err = _check_close(got.cpu().numpy(), qwant.cpu().numpy(), 2e-5,
                           1e-6, "int8 streamed vs float64")
        print(f"[phase10] FedAvg int8 streamed: max_abs_err={err}", flush=True)
        tmf = get_fusion("trimmedmean", beta=0.1)
        got, ref, _ = case(
            f"TrimmedMean Resnet50 x {n} streamed (carve), {len(blocks)} "
            "blocks",
            lambda: flat.fuse_stream(tmf, iter(blocks), chunk_rows=chunk,
                                     n_hint=n)[0],
            lambda: local.fuse_stream(tmf, iter(blocks), chunk_rows=chunk,
                                      n_hint=n)[0],
            k("topk_carve", len(blocks)))
        err = _check_close(got.cpu().numpy(), want_tm.cpu().numpy(), 1e-5,
                           1e-6, "TrimmedMean streamed vs float64")
        if not torch.equal(got, ref):
            raise AssertionError("TrimmedMean streamed: distributed != local")
        print(f"[phase10] TrimmedMean streamed: max_abs_err={err} (== local)",
              flush=True)
        del blocks, qblocks, U_dev, want_tm, ws, want

        # -- service rounds, CNN4.6 ------------------------------------------
        m = Uc.shape[0]
        ids = [f"client{i:05d}" for i in range(m)]
        store = UpdateStore()
        for i in range(m):
            store.write(ids[i], Uc[i], weight=float(Wc[i]))
        svc = AggregationService(store=store, mesh=mesh)
        plain = AggregationService(store=store, device=dev)
        (fused, report), delta, d_wall = _runs(lambda: svc.aggregate(
            from_store=True, expected_clients=m), dev)
        delta = {"weighted_sum": 0, **delta}
        print(f"[phase10] {_report_line(report)}", flush=True)
        cw = _eq1_f64(Uc, Wc)
        err = _check_close(fused.cpu().numpy(), cw, 2e-5, 1e-6,
                           "mesh service store round vs float64 Eq. 1")
        sblocks = -(-m // svc._chunk_rows(m, 4 * Uc.shape[1]))
        if report.client_ids != tuple(ids) or not report.streamed \
                or report.plan.n_devices != 1 \
                or delta["weighted_sum"] != (sblocks if cuda else 0):
            raise AssertionError(f"mesh service round: {report} {delta}")
        _, _, l_wall = _runs(lambda: plain.aggregate(
            from_store=True, expected_clients=m), dev)
        nccl_ms, busy_ms, _ = _comm_share(lambda: svc.aggregate(
            from_store=True, expected_clients=m), dev)
        print(f"[phase10] store round CNN4.6 x {m} through "
              f"AggregationService(mesh=): engine={report.plan.engine} (one "
              f"device: no mesh plan) mesh service {d_wall:.4f}s plain "
              f"service {l_wall:.4f}s (median of 5) launches=fused_fusion:"
              f"weighted_sum:{delta['weighted_sum']} max_abs_err={err} nccl "
              f"{nccl_ms:.3f} of {busy_ms:.3f} device ms (the membership "
              "broadcasts)", flush=True)
        out["service store round"] = {"dist_s": round(d_wall, 4),
                                      "local_s": round(l_wall, 4)}

        # a gamma 0.5 carry from a LocalEngine stream into the mesh engine
        half, g = m // 2, 0.5
        cblocks = [(Uc[i:i + 16], Wc[i:i + 16]) for i in range(0, m, 16)]
        _, rep1 = local.fuse_stream(fedavg, iter(cblocks[:half // 16]),
                                    chunk_rows=16)
        init = fedavg.discount_state(rep1.acc_state, g)
        got, ref, _ = case(
            f"gamma {g} carry LocalEngine -> DistributedEngine, CNN4.6 x "
            f"{half} + {m - half}",
            lambda: flat.fuse_stream(fedavg, iter(cblocks[half // 16:]),
                                     init=init, chunk_rows=16)[0],
            lambda: local.fuse_stream(fedavg, iter(cblocks[half // 16:]),
                                      init=init, chunk_rows=16)[0],
            k("weighted_sum", len(cblocks) - half // 16))
        a, ta = _wsum_f64(Uc[:half], Wc[:half])
        b, tb = _wsum_f64(Uc[half:], Wc[half:])
        err = _check_close(got.cpu().numpy(), (g * a + b) / (g * ta + tb
                                                             + 1e-6),
                           2e-5, 1e-6, "carried stream vs float64")
        print(f"[phase10] carry handed over: max_abs_err={err}", flush=True)

        # two async rounds through the mesh service with gamma 0.5: the
        # second folds its rows on the first's discounted carry
        store = UpdateStore()
        svc = AggregationService(store=store, mesh=mesh,
                                 staleness_discount=g, threshold_frac=1.0)
        walls = []
        for r, part in enumerate((slice(0, half), slice(half, m))):
            for i in range(part.start, part.stop):
                store.write(ids[i], Uc[i], weight=float(Wc[i]))
            t0 = time.perf_counter()
            fused, report = svc.aggregate(from_store=True, async_round=True,
                                          expected_clients=half)
            _sync(dev)
            walls.append(time.perf_counter() - t0)
            if report.client_ids != tuple(ids[part]) \
                    or not report.async_round:
                raise AssertionError(f"async round {r}: {report}")
        err = _check_close(fused.cpu().numpy(),
                           (g * a + b) / (g * ta + tb + 1e-6), 2e-5, 1e-6,
                           "mesh service async carry vs float64")
        print(f"[phase10] async rounds through AggregationService(mesh=), "
              f"gamma {g}: walls {walls[0]:.4f}s / {walls[1]:.4f}s (one "
              f"round each) engine={report.plan.engine} max_abs_err={err}",
              flush=True)
    finally:
        dist.destroy_process_group()
    return out


# rtol, atol. Kernel 6 and its plain version both compute in fp32 and
# round the output once, so at bf16 / fp16 they differ by about one ulp
# of the output (2**-8 relative at bf16): rtol 1e-2 holds that, atol 2e-3
# the values near zero. Kernel 7's plain version, the model's
# decode_attention, rounds the probabilities to the cache dtype before
# PV, which moves an output by up to 2**-9 * sum(p * |v|) (2.3e-3 seen
# near zero at pos 5): atol 1e-2 there. So kernel 7 at half precision is
# also held, at the tight limits, against the plain version run in fp32
# on the same (upcast) inputs, where only the output's rounding differs.
ATTN_TOL = {"fp32": (2e-4, 3e-5), "half": (1e-2, 2e-3)}
DECODE_TOL = {"fp32": (2e-4, 2e-5), "half": (1e-2, 1e-2)}
HALF_OUT_TOL = (1e-2, 2e-3)


def _live_scores(T: int, S: int, window: int) -> int:
    """(query, key) pairs a causal, optionally windowed, attention keeps:
    query t sees keys max(0, t - window + 1) .. min(t, S - 1)."""
    import numpy as np

    t = np.arange(T, dtype=np.int64)
    hi = np.minimum(t, S - 1)
    lo = np.maximum(0, t - window + 1) if window > 0 else np.zeros_like(t)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _sdpa(q, k, v, mask=None, causal=False):
    """``scaled_dot_product_attention`` on the same inputs, in its
    (B, heads, T, hd) layout with GQA, as one call (the yardstick)."""
    from torch.nn import functional as F

    gqa = q.shape[2] != k.shape[2]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal, enable_gqa=gqa)


def _sass(name: str) -> str:
    """The SASS of the built library ``lib<name>.so``."""
    from repro_torch.kernels import _build

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run(
        [cuobjdump, "-sass", str(_build.library_path(name))],
        check=True, capture_output=True, text=True, timeout=300).stdout


def _attention_sass():
    """The built attention library's tensor-core products (HMMA),
    asynchronous copies (LDGSTS) and shared-memory matrix loads (LDSM),
    counted in its SASS: the bf16 / fp16 route must have all three."""
    sass = _sass("flash_attention")
    counts = {op: sass.count(op) for op in ("HMMA", "LDGSTS", "LDSM")}
    print(f"[phase0] flash_attention SASS {counts}", flush=True)
    if not all(counts.values()):
        raise AssertionError(f"flash_attention SASS lacks {counts}")


_PTX_TYPES = {"f": "fp32", "13__nv_bfloat16": "bf16", "6__half": "fp16"}


def _ptxas_entries(name: str):
    """{mangled kernel name: [registers, spill store bytes, spill load
    bytes]} from the ``ptxas -v`` report of the build of ``lib<name>.so``."""
    from repro_torch.kernels import _build

    report, cur = {}, None
    for line in _build.build_log(name).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = report.setdefault(m.group(1), [0, 0, 0])
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur[0] = int(m.group(1))
    return report


def _ptxas_report(name: str, entry: str):
    """{(dtype, *int template arguments): (registers, spill store bytes,
    spill load bytes)} of the kernels named ``entry`` in the ``ptxas -v``
    report of the build of ``lib<name>.so`` (for the decode kernel the
    arguments are hd and the head tile)."""
    report = {}
    for fn, v in _ptxas_entries(name).items():
        m = re.search(entry + r"I(\w+?)((?:Li\d+E)+)E", fn)
        if m:
            report[(_PTX_TYPES.get(m.group(1), m.group(1)),
                    *(int(a) for a in re.findall(r"Li(\d+)E", m.group(2))))
                   ] = tuple(v)
    return report


def _template_label(fn: str, entry: str) -> str:
    """``carve_reg_kernel<float, 24>`` as "fp32 24", from its mangled
    name."""
    args = re.search(entry + r"I(.*?)EEv", fn).group(1)
    for mangled, short in _PTX_TYPES.items():
        args = re.sub(rf"^{mangled}(?=L|$)", short + " ", args)
    return re.sub(r"Li(\d+)E", r"\1 ", args).strip()


def _sass_sections(sass: str):
    """{mangled kernel name: its SASS text}."""
    parts = re.split(r"\s+Function : (\S+)", sass)
    return dict(zip(parts[1::2], parts[2::2]))


def _fusion_build():
    """What the builds of the carve and the dequant show: each instance's
    registers and spills from ``ptxas -v`` (no spill allowed), the
    stores of each dequant instance (the vector routes' only 16-byte
    STG.E.128), and the integer min / max (IMNMX, VIMNMX) of the fp32
    carve with a 24-slot window, in their SASS."""
    regs, spills = {}, {}
    for lib, entry, count in (("robust_fusion", "carve_reg_kernel", 21),
                              ("robust_fusion", "carve_mem_kernel", 3),
                              ("fused_fusion", "wsum_dequant_kernel", 3)):
        found = {f"{entry} {_template_label(fn, entry)}": v
                 for fn, v in _ptxas_entries(lib).items() if entry in fn}
        if len(found) != count:
            raise AssertionError(f"{lib}: {len(found)} {entry} instances, "
                                 f"expected {count}")
        for label, (r, st, ld) in sorted(found.items()):
            regs[label] = r
            if st or ld:
                spills[label] = [st, ld]
    stores = {}
    for fn, text in _sass_sections(_sass("fused_fusion")).items():
        if "wsum_dequant_kernel" in fn:
            ops = re.findall(r"\b(STG\.[\w.]+)", text)
            stores[f"scale {_template_label(fn, 'wsum_dequant_kernel')}"] = {
                op: ops.count(op) for op in sorted(set(ops))}
    carve = next(text for fn, text in
                 _sass_sections(_sass("robust_fusion")).items()
                 if "carve_reg_kernelIfLi24E" in fn)
    minmax = {"VIMNMX": carve.count("VIMNMX"),
              "IMNMX": carve.count("IMNMX") - carve.count("VIMNMX")}
    print(f"[phase0] carve / dequant ptxas registers {regs}; spills (store, "
          f"load bytes) {spills or 'none'}; dequant stores {stores} "
          f"(scale 0 a thread, 1 a vector, 2 an element); fp32 KM 24 carve "
          f"integer min / max {minmax}", flush=True)
    # the vector routes store only whole float4s: 512 bytes a warp store
    partial = {k: v for k, v in stores.items()
               if k != "scale 2" and any(".128" not in op for op in v)}
    if spills or partial or len(stores) != 3 or not sum(minmax.values()):
        raise AssertionError(f"carve / dequant build: spills {spills}, "
                             f"stores {stores}, min / max {minmax}")


_BWD_ENTRY = re.compile(r"(bwd_[a-z_]+_kernel)I(f|13__nv_bfloat16|6__half)"
                        r"(?:Li(\d+)E)?E")


def _attention_bwd_build():
    """Each instance of the attention backward's kernels in the ``ptxas
    -v`` report of the attention library: registers and spills (none
    allowed), the set of instances exactly what ``kernel.bwd_instances``
    says ``flash_attn_bwd`` dispatches; and in the SASS, the tensor-core
    products (HMMA) of every dK / dV and dQ instance (none may lack
    them), the fp32 ones TF32 products (HMMA.1688.F32.TF32)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa

    names = {torch.float32: "fp32", torch.bfloat16: "bf16",
             torch.float16: "fp16"}
    want = {" ".join(x for x in (name, names[dt], hd and f"hd {hd}") if x)
            for name, dt, hd in fa.bwd_instances()}
    regs, spills, mangled = {}, {}, {}
    for fn, (r, st, ld) in _ptxas_entries("flash_attention").items():
        m = _BWD_ENTRY.search(fn)
        if not m:
            continue
        label = " ".join(x for x in (m.group(1), _PTX_TYPES[m.group(2)],
                                     m.group(3) and f"hd {m.group(3)}") if x)
        regs[label], mangled[fn] = r, label
        if st or ld:
            spills[label] = [st, ld]
    tile = {name for names in fa.BWD_TILE_KERNELS.values() for name in names}
    hmma, tf32 = {}, {}
    for fn, text in _sass_sections(_sass("flash_attention")).items():
        label = mangled.get(fn)
        if label and label.split()[0] in tile:
            hmma[label] = text.count("HMMA")
            if label.split()[1] == "fp32":
                tf32[label] = text.count("HMMA.1688.F32.TF32")
    want_hmma = {label for label in want if label.split()[0] in tile}
    want_tf32 = {label for label in want_hmma if label.split()[1] == "fp32"}
    print(f"[phase0] flash_attention_bwd ptxas: {len(regs)} kernels "
          f"({len(want)} dispatched), registers {regs}; spills "
          f"(store, load bytes) {spills or 'none'}; HMMA a tile-kernel "
          f"instance {hmma}; of them HMMA.1688.F32.TF32 in fp32 {tf32}",
          flush=True)
    if spills or set(regs) != want or set(hmma) != want_hmma \
            or not all(hmma.values()) or set(tf32) != want_tf32 \
            or not all(tf32.values()):
        raise AssertionError(
            f"flash_attention_bwd build: instances {sorted(regs)} against "
            f"{sorted(want)}, spills {spills}, HMMA {hmma}, TF32 {tf32}")


def _decode_build():
    """What the build of the decode kernel shows: 16-byte global loads of
    q (LDG.E.128) and 16-byte asynchronous copies of k / v
    (LDGSTS.E.BYPASS.128) and the cluster barrier (UCGABAR) in its SASS,
    each instance's registers and spills from ``ptxas -v``, and how many
    8-CTA clusters fit on the card at once."""
    import torch

    from repro_torch.kernels.flash_decode import kernel as fd

    sass = _sass("flash_decode")
    counts = {op: sass.count(op) for op in ("LDG.E.128", "LDGSTS.E.BYPASS.128",
                                            "UCGABAR")}
    ptxas = _ptxas_report("flash_decode", "decode_kernel")
    spills = {f"{t} hd {hd} x{gt}": [st, ld]
              for (t, hd, gt), (_, st, ld) in sorted(ptxas.items())
              if st or ld}
    regs = {f"{t} hd {hd} x{gt}": r
            for (t, hd, gt), (r, _, _) in sorted(ptxas.items())}
    clusters = {f"{name} x{tile}": fd.max_active_clusters(hd, dt, tile, 8)
                for name, hd, dt, tile in (
                    ("bf16 hd 64", 64, torch.bfloat16, 4),
                    ("bf16 hd 256", 256, torch.bfloat16, 8),
                    ("fp32 hd 256", 256, torch.float32, 8))}
    print(f"[phase0] flash_decode SASS {counts}; ptxas: {len(ptxas)} "
          f"kernels, registers {regs}; spills (store, load bytes) "
          f"{spills or 'none'}; max active 8-CTA clusters {clusters}",
          flush=True)
    if not all(counts.values()) or len(ptxas) != 48 \
            or min(clusters.values()) < 1:
        raise AssertionError(f"flash_decode build: SASS {counts}, "
                             f"{len(ptxas)} kernels, clusters {clusters}")


def _sass_functions(sass: str):
    """{mangled kernel name: [opcode of each instruction]} of a SASS
    listing (NOPs left out, predicates and modifiers dropped)."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if m and cur is not None and m.group(1) != "NOP":
            cur.append(m.group(1))
    return funcs


def _ssd_build():
    """What the build of the SSD scan shows: tensor-core TF32 products
    (HMMA.1688.F32.TF32) and asynchronous copies (LDGSTS) in its SASS,
    each instance's registers and spills from ``ptxas -v``, which must be
    none, and the instruction mix of the Zamba2 layer's two kernels (fp32,
    N_pad 64, head tile 2): how many instructions each tensor-core
    product takes with it."""
    from collections import Counter

    from repro_torch.kernels import _build

    sass = _sass("ssd_chunk")
    counts = {op: sass.count(op) for op in ("HMMA.1688.F32.TF32", "LDGSTS")}
    regs = {}
    for entry, short in (("ssd_state_kernel", "state"), ("ssd_out_kernel", "out")):
        for (t, n_pad, heads), (r, st, ld) in sorted(
                _ptxas_report("ssd_chunk", entry).items()):
            regs[f"{short} {t} N{n_pad} x{heads}"] = r
    spills = [line.strip() for line in
              _build.build_log("ssd_chunk").read_text().splitlines()
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]
    mix = {}
    for name, ops in _sass_functions(sass).items():
        for entry in ("ssd_state_kernel", "ssd_out_kernel"):
            if f"{entry}IfLi64ELi2E" in name:
                top = Counter(ops).most_common(8)
                mix[entry] = {"instructions": len(ops),
                              "HMMA": ops.count("HMMA"),
                              "per_HMMA": len(ops) / max(ops.count("HMMA"), 1),
                              "top": dict(top)}
    print(f"[phase0] ssd_chunk SASS {counts}; ptxas: {len(regs)} templated "
          f"kernels, registers {regs}; spills {spills or 'none'}", flush=True)
    print(f"[phase0] ssd_chunk static instruction mix, fp32 N_pad 64 head "
          f"tile 2: {json.dumps(mix)}", flush=True)
    if not all(counts.values()) or spills or len(regs) != 48 or len(mix) != 2:
        raise AssertionError(f"ssd_chunk build: SASS {counts}, {len(regs)} "
                             f"kernels, spills {spills}, mix of {list(mix)}")


# mma.sync m16n8k8 TF32 alone: every warp keeps MMA_ACC independent
# products in flight on operands held in registers, so the time is the
# tensor cores' issue rate for the instruction the SSD kernels use.
MMA_ACC = 16
MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mma_peak_kernel(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  float d[ACC][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < ACC; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[0] ^ it), "r"(a[1]));
  }
  float s = 0.f;
  for (int k = 0; k < ACC; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_peak(float* out, int blocks, int threads, int iters, void* stream) {
  mma_peak_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def _mma_peak_build():
    """Compile the mma.sync probe into the build directory; its path."""
    import hashlib

    from repro_torch.kernels import _build

    out = (_build.BUILD_ROOT / "probe"
           / hashlib.sha256(MMA_PEAK_CU.encode()).hexdigest()[:16]
           / "libmma_peak.so")
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        src = out.with_name("mma_peak.cu")
        src.write_text(MMA_PEAK_CU)
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, f"-DACC={MMA_ACC}",
                        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                        "-o", str(out), str(src)],
                       check=True, capture_output=True, text=True, timeout=600)
    return out


def _mma_peak(dev, sms: int) -> float:
    """The best rate of mma.sync m16n8k8 TF32 over 4, 8 and 16 warps a
    block, two blocks an SM, in FLOP/s (2 * 16 * 8 * 8 a product)."""
    import ctypes

    import torch

    lib = ctypes.CDLL(str(_mma_peak_build()))
    lib.mma_peak.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.mma_peak.restype = ctypes.c_int
    out = torch.empty(2 * sms * 16 * 32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    iters, rates = 4096, {}
    for warps in (4, 8, 16):
        def run(n):
            if lib.mma_peak(out.data_ptr(), 2 * sms, warps * 32, n, stream):
                raise RuntimeError("mma_peak launch failed")
        run(16)
        ms = _ms_median(lambda: run(iters), reps=5, warmup=1)
        rates[warps] = 2 * sms * warps * iters * MMA_ACC * 2048 / (ms * 1e-3)
    print(f"[phase0] mma.sync m16n8k8 TF32 alone, TFLOP/s by warps a block "
          f"(2 blocks an SM): "
          + ", ".join(f"{w}: {r / 1e12:.1f}" for w, r in rates.items()),
          flush=True)
    return max(rates.values())


def phase_attention_kernels(dev, hbm_bw):
    """The flash-attention kernel against its plain version at the
    serving path's shapes and at edge shapes; times kernel, plain
    version and SDPA."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref as faref

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    names = {torch.float32: "fp32", torch.bfloat16: "bf16",
             torch.float16: "fp16"}
    bf16, fp32, fp16 = torch.bfloat16, torch.float32, torch.float16
    cases = {"flash_attention": []}
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, T, nq, nkv, hd, win, dt, label in [
        (4, 1024, 14, 2, 64, 0, bf16, "Qwen2-0.5B prefill layer"),
        (4, 1024, 14, 2, 64, 0, fp32, "Qwen2-0.5B prefill layer"),
        (1, 1280, 4, 1, 256, 1024, fp32, "Gemma3-1B local layer (MQA)"),
        (1, 1280, 4, 1, 256, 1024, bf16, "Gemma3-1B local layer (MQA)"),
        (1, 1280, 4, 1, 256, 0, fp32, "Gemma3-1B global layer (MQA)"),
        (2, 1000, 14, 2, 64, 0, fp32, "ragged T = 1000"),
        (2, 512, 8, 8, 128, 200, bf16, "MHA, hd 128, window 200"),
        (2, 512, 8, 1, 64, 0, fp32, "MQA"),
        (2, 777, 14, 2, 64, 300, fp16, "fp16, ragged, window 300"),
        (2, 100, 4, 2, 32, 0, fp32, "hd 32 (smoke configs)"),
        (4, 1024, 32, 32, 64, 2048, bf16,
         "Zamba2-1.2B shared block (MHA, window 2048)"),
        (2, 512, 32, 32, 64, 2048, fp32,
         "Zamba2-1.2B shared block (MHA, window 2048)"),
    ]:
        q = torch.randn((B, T, nq, hd), generator=g, device=dev).to(dt)
        k = torch.randn((B, T, nkv, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B, T, nkv, hd), generator=g, device=dev).to(dt)
        got = fa.flash_attention(q, k, v, window=win)
        want = faref.attention_ref(q, k, v, window=win)
        torch.cuda.synchronize()
        key = "fp32" if dt == fp32 else "half"
        rtol, atol = ATTN_TOL[key]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        err = (got.float() - want.float()).abs().max().item()
        del got, want
        live = _live_scores(T, T, win)
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        bound_ms, bound_by = _bound(nbytes, 4.0 * B * nq * hd * live, hbm_bw,
                                    FP32_FLOPS if dt == fp32 else HALF_FLOPS)
        mask = None
        if win:
            mask = faref.attention_mask(T, T, win, device=dev)
        library = _sdpa(q, k, v, mask=mask, causal=not win)
        cases["flash_attention"].append({
            "shape": [B, T, nq, nkv, hd], "window": win,
            "dtype": names[dt], "what": label,
            "route": (f"cuda cores, {fa.fp32_query_tile(B, T, nq, sm_count)}"
                      "-row query tiles" if dt == fp32 else
                      "tensor cores (mma.sync), 64-row query tiles"),
            "max_abs_err": err, "rtol": rtol, "atol": atol,
            "live_scores": live,
            "ms": _ms_median(lambda: fa.flash_attention(q, k, v, window=win)),
            "plain_ms": _ms_median(
                lambda: faref.attention_ref(q, k, v, window=win), reps=5),
            "library_ms": _ms_median(library),
            "library": "scaled_dot_product_attention(enable_gqa)",
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        print(f"[phase1] flash_attention "
              f"{json.dumps(cases['flash_attention'][-1])}", flush=True)
        del q, k, v, library, mask
    torch.cuda.empty_cache()
    return cases


# rtol, atol of the attention backward, per route. fp32 against
# attention_bwd_ref on the same inputs: the same arithmetic summed in
# another order, gradients of up to ~10 summed over up to 1280 terms.
# bf16 / fp16 against the plain backward run in fp32 on the upcast
# inputs: the kernel rounds p and dS to the input dtype before the
# products they feed (as the reference's VJP does) and each gradient
# once at the end, the fp32 run rounds neither. Each case is held twice:
# with the kernel's own out and lse (the backward alone), and with the
# plain forward's (attention_lse_ref, fp32 on upcast inputs for half),
# so a wrong lse store cannot cancel out. "limit_share" is the largest
# |got - want| / (atol + rtol |want|) of a case. The card's largest
# shares of these limits over dq, dk, dv and both forwards (H100): half
# 0.666 at the Qwen2 training layer, 0.820 at the prefill shape (dv: up
# to 7 x 1024 terms of rounded p), 0.408 Gemma3 local, 0.473 Zamba2
# block, 0.328 T = 17, 0.039 window 1 (fp16), the same with the half
# route on the CUDA cores or the tensor cores (the worst are dv's, set by
# the rounding of p both share); fp32 at most 0.067 on the CUDA cores,
# 0.243 (Gemma3 local, dv) in three TF32 passes. The inputs come
# from the seed and the kernel is deterministic, so a run reads the
# same shares; the 1.2x or more that is left is for a changed
# kernel's other summation order, and a share above 1 fails the phase.
BWD_TOL = {"fp32": (1e-4, 1e-4), "half": (1e-2, 2e-2)}
# The largest shares of the backward's first design (CUDA cores in every
# dtype) at the half shapes below, printed beside each case's own.
BWD_FIRST_DESIGN_SHARE = {("Qwen2-0.5B training layer", "bf16"): 0.666,
                  ("Qwen2-0.5B prefill shape", "bf16"): 0.820,
                  ("Gemma3-1B local layer (MQA)", "bf16"): 0.408,
                  ("Zamba2-1.2B shared block (MHA, window 2048)", "bf16"):
                  0.473}
# The forward's out and lse when the lse is stored, against
# attention_lse_ref: fp32 on the same inputs; half in fp32 on upcast
# inputs, where out differs by the rounding of p before PV and of out
# itself (the serving limits, HALF_OUT_TOL) and lse only by the order
# of the fp32 sums of identical products. The card read at most 0.346
# of the out limits and 0.061 of the lse limits at the shapes below.
LSE_TOL = {"fp32": {"out": ATTN_TOL["fp32"], "lse": (1e-5, 1e-5)},
           "half": {"out": HALF_OUT_TOL, "lse": (1e-5, 1e-5)}}


def _limit_share(got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|) in fp32: at most 1 where
    ``torch.testing.assert_close`` passes; NaN where either is NaN."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def _sdpa_bwd(q, k, v, dout, mask=None, causal=False):
    """The backward alone of one ``scaled_dot_product_attention`` call
    (GQA) on the same inputs, after one forward (the yardstick)."""
    import torch
    from torch.nn import functional as F

    gqa = q.shape[2] != k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                       is_causal=causal, enable_gqa=gqa)
    go = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(o, (qt, kt, vt), go,
                                       retain_graph=True)


def _kernel_label(name: str) -> str:
    """``bwd_dq_mma_kernel<__nv_bfloat16, 64>`` out of a profiler key that
    also holds the namespace and the argument list."""
    m = re.search(r"\w+<[^>]*>", name)
    return m.group(0) if m else name


def phase_attention_bwd(dev, hbm_bw, mma_peak):
    """The attention backward kernel against its plain version at the
    training path's shapes and at edge shapes (every fp32 instance, hd
    32 to 256, launches): two calls bitwise equal; kernel, plain version
    and SDPA's backward timed. The fp32 cases also give the least time
    at ``mma_peak``, the rate of mma.sync TF32 that phase 0 measured,
    taken three times (the route's three passes), beside the CUDA
    cores' FMA bound."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref as faref

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    names = {torch.float32: "fp32", torch.bfloat16: "bf16",
             torch.float16: "fp16"}
    bf16, fp32, fp16 = torch.bfloat16, torch.float32, torch.float16
    cases = {"flash_attention_bwd": []}
    for B, T, nq, nkv, hd, win, dt, label in [
        (4, 512, 14, 2, 64, 0, bf16, "Qwen2-0.5B training layer"),
        (4, 512, 14, 2, 64, 0, fp32, "Qwen2-0.5B training layer"),
        (4, 1024, 14, 2, 64, 0, bf16, "Qwen2-0.5B prefill shape"),
        (1, 1280, 4, 1, 256, 1024, fp32, "Gemma3-1B local layer (MQA)"),
        (1, 1280, 4, 1, 256, 1024, bf16, "Gemma3-1B local layer (MQA)"),
        (4, 1024, 32, 32, 64, 2048, bf16,
         "Zamba2-1.2B shared block (MHA, window 2048)"),
        (2, 1, 14, 2, 64, 0, fp32, "T = 1"),
        (2, 17, 4, 2, 32, 0, bf16, "T = 17, hd 32"),
        (2, 300, 8, 2, 128, 1, fp16, "window 1, hd 128, fp16"),
        (1, 77, 6, 3, 64, 1, fp32, "window 1"),
        (2, 64, 4, 1, 32, 0, fp32, "train CLI reduced shape, hd 32"),
        (2, 300, 8, 2, 128, 1, fp32, "window 1, hd 128"),
    ]:
        q, dout = (torch.randn((B, T, nq, hd), generator=g, device=dev).to(dt)
                   for _ in range(2))
        k, v = (torch.randn((B, T, nkv, hd), generator=g, device=dev).to(dt)
                for _ in range(2))
        key = "fp32" if dt == fp32 else "half"
        # fp32 inputs as they are, half ones upcast: the plain versions
        qr, kr, vr, dr = ((q, k, v, dout) if dt == fp32 else
                          (x.float() for x in (q, k, v, dout)))
        out, lse = fa.flash_attention(q, k, v, window=win, return_lse=True)
        out_p, lse_p = faref.attention_lse_ref(qr, kr, vr, window=win)
        shares = {}
        for name, a, b in (("out", out, out_p), ("lse", lse, lse_p)):
            shares[name] = _limit_share(a, b, *LSE_TOL[key][name])
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, window=win)
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout, window=win)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {label}: two calls "
                                 "differ")
        rtol, atol = BWD_TOL[key]
        err, err_p = 0.0, 0.0
        for chain, (o, l) in (("", (out, lse)), ("plain ", (out_p, lse_p))):
            want = faref.attention_bwd_ref(qr, kr, vr, o.to(qr.dtype), l, dr,
                                           window=win)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                shares[chain + name] = _limit_share(a, b, rtol, atol)
                e = (a.float() - b.float()).abs().max().item()
                if chain:
                    err_p = max(err_p, e)
                else:
                    err = max(err, e)
            del want
        bad = {n: x for n, x in shares.items() if not x <= 1.0}
        if bad:
            raise AssertionError(
                f"flash_attention_bwd {label} {names[dt]}: limit shares "
                f"{bad} above 1 (out / lse: LSE_TOL; dq, dk, dv against the "
                f"kernel's and the plain forward's out and lse: BWD_TOL)")
        del got, again, out_p, lse_p, qr, kr, vr, dr
        live = _live_scores(T, T, win)
        nbytes = (4 * (q.numel() + k.numel()) * q.element_size()
                  + 4 * lse.numel())
        flops = 10.0 * B * nq * hd * live
        bound_ms, bound_by = _bound(nbytes, flops, hbm_bw,
                                    FP32_FLOPS if dt == fp32 else HALF_FLOPS)
        mask = faref.attention_mask(T, T, win, device=dev) if win else None
        library = _sdpa_bwd(q, k, v, dout, mask=mask, causal=not win)
        cases["flash_attention_bwd"].append({
            "shape": [B, T, nq, nkv, hd], "window": win,
            "dtype": names[dt], "what": label,
            "route": (f"{fa.bwd_route(dt)}, 4 kernels (delta, dK/dV, dQ, "
                      "group sum)"),
            "max_abs_err": err, "max_abs_err_plain_forward": err_p,
            "rtol": rtol, "atol": atol,
            "limit_share": {n: float(f"{x:.3g}") for n, x in shares.items()},
            "worst_limit_share": float(f"{max(shares.values()):.3g}"),
            "first_design_worst_limit_share": BWD_FIRST_DESIGN_SHARE.get((label, names[dt])),
            "against": ("attention_bwd_ref, same inputs" if dt == fp32 else
                        "attention_bwd_ref in fp32 on upcast inputs"),
            "bitwise_repeat": True, "live_scores": live,
            "ms": _ms_median(lambda: fa.flash_attention_bwd(
                q, k, v, out, lse, dout, window=win)),
            "plain_ms": _ms_median(lambda: faref.attention_bwd_ref(
                q, k, v, out, lse, dout, window=win), reps=5),
            "library_ms": _ms_median(library),
            "library": "scaled_dot_product_attention(enable_gqa) backward",
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        if dt == fp32:   # the same work at a third of mma.sync TF32's rate
            cases["flash_attention_bwd"][-1]["bound_tf32x3_ms"], \
                cases["flash_attention_bwd"][-1]["bound_tf32x3_by"] = _bound(
                    nbytes, flops, hbm_bw, mma_peak / 3)
        if T >= 512:   # the device kernels of one call, and their times
            cases["flash_attention_bwd"][-1]["device_kernels"] = {
                _kernel_label(name):
                [n, float(f"{ms:.4f}")] for name, (n, ms) in _device_kernels(
                    lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                                   window=win),
                    3 + (nq != nkv), tag="bwd_").items()}
        print(f"[phase1] flash_attention_bwd "
              f"{json.dumps(cases['flash_attention_bwd'][-1])}", flush=True)
        del q, k, v, out, lse, dout, library, mask
    torch.cuda.empty_cache()
    return cases


HOST_REPS = 100   # enqueues timed on the host clock


def _host_us(fn, reps: int = HOST_REPS) -> float:
    """Median host time of one call of ``fn`` in microseconds: the
    wrapper's checks and launch, the card left to run behind."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def phase_decode_kernel(dev, hbm_bw):
    """The flash-decode kernel against its plain version at the serving
    path's shapes and at edge shapes (one live slot, the fewest CTAs
    with the most registers, hd 32); each case prints the split plan,
    checks that two calls agree bit for bit and times kernel (device
    and host), plain version and SDPA."""
    import torch

    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode import ref as fdref

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    names = {torch.float32: "fp32", torch.bfloat16: "bf16",
             torch.float16: "fp16"}
    bf16, fp32, fp16 = torch.bfloat16, torch.float32, torch.float16
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = {"flash_decode": []}
    for B, S, nq, nkv, hd, pos, dt, label in [
        (4, 2048, 14, 2, 64, 1500, bf16, "Qwen2-0.5B decode step"),
        (4, 2048, 14, 2, 64, 5, bf16, "Qwen2-0.5B decode step, pos 5"),
        (4, 2048, 14, 2, 64, 80, bf16, "Qwen2-0.5B decode step, pos 80"),
        (4, 2048, 14, 2, 64, 0, bf16,
         "Qwen2-0.5B decode step, pos 0 (one live slot)"),
        (4, 2048, 14, 2, 64, 5000, bf16, "Qwen2-0.5B, ring wrapped"),
        (4, 2048, 14, 2, 64, 1500, fp32, "Qwen2-0.5B decode step"),
        (1, 1024, 4, 1, 256, 1279, fp32, "Gemma3-1B local ring, wrapped"),
        (1, 1024, 4, 1, 256, 1279, bf16, "Gemma3-1B local ring, wrapped"),
        (1, 2048, 8, 1, 256, 1500, bf16, "B 1, MQA group 8, hd 256"),
        (2, 600, 8, 2, 128, 599, fp32, "ragged S = 600, full"),
        (2, 600, 8, 2, 128, 300, fp32, "ragged S = 600, half live"),
        (2, 300, 4, 4, 64, 150, fp16, "MHA fp16"),
        (2, 300, 4, 2, 32, 200, fp32, "hd 32 (smoke configs)"),
        (4, 2048, 32, 32, 64, 80, bf16,
         "Zamba2-1.2B shared block step, pos 80"),
    ]:
        q = torch.randn((B, 1, nq, hd), generator=g, device=dev).to(dt)
        kc = torch.randn((B, S, nkv, hd), generator=g, device=dev).to(dt)
        vc = torch.randn((B, S, nkv, hd), generator=g, device=dev).to(dt)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        splits = fd.split_plan(S, B * nkv, sm_count)
        got = fd.flash_decode(q, kc, vc, p)
        again = fd.flash_decode(q, kc, vc, p)
        want = fdref.flash_decode_ref(q, kc, vc, p)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"flash_decode {label}: two calls differ")
        key = "fp32" if dt == fp32 else "half"
        rtol, atol = DECODE_TOL[key]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        err = (got.float() - want.float()).abs().max().item()
        err32 = err
        if dt != fp32:
            want = fdref.flash_decode_ref(q.float(), kc.float(), vc.float(),
                                          p)
            torch.testing.assert_close(got.float(), want,
                                       rtol=HALF_OUT_TOL[0],
                                       atol=HALF_OUT_TOL[1])
            err32 = (got.float() - want).abs().max().item()
        del got, again, want
        live = S if pos >= S else pos + 1
        nbytes = (2 * q.numel() + 2 * B * live * nkv * hd) * q.element_size()
        bound_ms, bound_by = _bound(nbytes, 4.0 * B * nq * hd * live, hbm_bw,
                                    FP32_FLOPS if dt == fp32 else HALF_FLOPS)
        mask = fdref.ring_live(S, p)[None, None, None, :]
        library = _sdpa(q, kc, vc, mask=mask)
        cases["flash_decode"].append({
            "shape": [B, S, nq, nkv, hd], "pos": pos, "dtype": names[dt],
            "what": label, "splits": splits,
            "head_tile": fd.head_tile(nq // nkv, splits * B * nkv, sm_count),
            "max_abs_err": err, "rtol": rtol, "atol": atol,
            "max_abs_err_vs_fp32_plain": err32, "live_slots": live,
            "ms": _ms_median(lambda: fd.flash_decode(q, kc, vc, p)),
            "host_us": _host_us(lambda: fd.flash_decode(q, kc, vc, p)),
            "plain_ms": _ms_median(
                lambda: fdref.flash_decode_ref(q, kc, vc, p)),
            "library_ms": _ms_median(library),
            "library": "scaled_dot_product_attention(enable_gqa)",
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        print(f"[phase1] flash_decode {json.dumps(cases['flash_decode'][-1])}",
              flush=True)
        del q, kc, vc, library, mask
    torch.cuda.empty_cache()
    return cases


# rtol = atol of the reference's SSD tests (tests/test_kernels_extra.py:
# 47-48 for fp32 inputs, :76 for bf16 inputs)
SSD_TOL = {"fp32": 1e-4, "half": 5e-2}
# fp32-accurate products on the tensor cores take three TF32 passes
# (H100 SXM TF32 dense, data sheet): the least time of the SSD scan's
# fp32 work, beside FP32_FLOPS, the CUDA cores' FMA rate
TF32X3_FLOPS = 495e12 / 3


def _ssd_work(B, T, H, N, P, L, elem):
    """(bytes, FLOPs) of one SSD scan, the least work: lam read in fp32,
    B, C and x in their dtype, y written in fp32; C B^T once per (batch,
    chunk), since B and C are shared by the heads (L(L+1)/2 * 2N), and
    per lane and chunk W x (L(L+1)/2 * 2P) and C h, B^T x (2LNP each)."""
    nbytes = 4 * B * T * H + 2 * B * T * N * elem + B * T * H * P * elem \
        + 4 * B * T * H * P
    nc = T // L
    flops = B * nc * (L * (L + 1) / 2 * 2 * N) \
        + B * H * nc * (L * (L + 1) / 2 * 2 * P + 4.0 * L * N * P)
    return nbytes, flops


def _device_kernels(fn, expect, tag="ssd_", tries=5):
    """{name: (launches, device ms)} of the device kernels whose name holds
    ``tag`` in one call of ``fn``, from torch.profiler tracing host and
    device together, as ``_profile`` does (tracing the device alone has
    returned sessions short of its records on the H100). The session
    opens with a spin kernel and a synchronize before the call, since
    sessions have also lost the first kernels launched in them. A
    profile whose count is not ``expect`` is taken again, up to ``tries``
    times, and said so; the caller checks the count it gets, so a call
    that runs other kernels than planned still fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES // 10)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        found = {e.key: (e.count, e.self_device_time_total / 1e3)
                 for e in prof.key_averages()
                 if tag in e.key and str(e.device_type).endswith("CUDA")}
        if sum(n for n, _ in found.values()) == expect:
            break
        print(f"[profile] {tag} kernels recorded {found}, expected {expect}; "
              f"profile {attempt + 1} of {tries}", flush=True)
    return found


def phase_ssd_kernel(dev, hbm_bw, mma_peak):
    """The SSD chunked-scan kernel against its plain version at the
    Zamba2-1.2B layer's shape and at edge shapes; each case checks that
    two calls agree bit for bit and gives the device kernels a call runs
    and each one's device time; times kernel and plain version (no
    single PyTorch call computes the scan), and the Zamba2 layer also at
    a head tile of 1, the alternative to the wrapper's choice of 2. The
    fp32 cases also give the least time at ``mma_peak``, the rate of
    mma.sync TF32 that phase 0 measured, taken three times."""
    from unittest import mock

    import torch

    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.kernels.ssd_chunk import ref as sref
    from repro_torch.utils.device import sm_count

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    fp32, bf16, fp16 = torch.float32, torch.bfloat16, torch.float16
    names = {fp32: "fp32", bf16: "bf16", fp16: "fp16"}
    cases = {"ssd_chunk": []}
    for B, T, H, N, P, chunk, dt, lam_kind, label in [
        (4, 1024, 64, 64, 64, 256, fp32, "rand", "Zamba2-1.2B layer"),
        (2, 600, 64, 64, 64, 256, fp32, "rand", "ragged T = 600: L = T"),
        (4, 64, 64, 64, 64, 256, fp32, "rand", "T = 64 < chunk"),
        (1, 4096, 1, 64, 64, 256, fp32, "rand", "B = H = 1: 16 chunks"),
        (4, 1024, 64, 64, 64, 256, bf16, "rand", "Zamba2-1.2B layer, bf16"),
        (2, 512, 32, 16, 16, 16, fp32, "rand", "smoke widths N = P = 16"),
        (2, 512, 8, 64, 64, 256, fp32, "-50", "lam <= -50: decays underflow"),
        (2, 512, 8, 64, 64, 256, fp32, "0",
         "lam = 0: no decay (B, C, x scaled by 1/4)"),
        (2, 512, 8, 128, 64, 256, fp32, "rand", "N = 128"),
        (2, 512, 8, 64, 32, 256, fp32, "rand", "P = 32 (padded to 64)"),
        (1, 300, 3, 10, 7, 256, fp32, "rand",
         "odd N, P, H: 4-byte copies, odd-P stores, head tile 1"),
        (2, 512, 4, 64, 64, 256, fp16, "rand", "fp16"),
        (1, 300, 3, 10, 7, 256, bf16, "rand",
         "odd N, P, H, bf16: rows padded to 16 bytes"),
    ]:
        lam = -torch.randn((B, T, H), generator=g, device=dev).abs() * 0.1
        scale = 1.0
        if lam_kind == "-50":
            lam = lam * 10.0 - 50.0
        elif lam_kind == "0":
            lam.zero_()
            scale = 0.25
        Bm = (torch.randn((B, T, N), generator=g, device=dev) * scale).to(dt)
        Cm = (torch.randn((B, T, N), generator=g, device=dev) * scale).to(dt)
        xdt = (torch.randn((B, T, H, P), generator=g, device=dev)
               * scale).to(dt)

        def call():
            return sk.ssd_chunk(lam, Bm, Cm, xdt, chunk=chunk)

        got, again = call(), call()
        want = sref.ssd_scan_ref(lam, Bm, Cm, xdt, chunk=chunk)
        torch.cuda.synchronize()
        tol = SSD_TOL["fp32" if dt == fp32 else "half"]
        if tuple(got.shape) != (B, T, H, P) or not torch.isfinite(got).all():
            raise AssertionError(f"ssd_chunk {label}: shape "
                                 f"{tuple(got.shape)} or non-finite output")
        if not torch.equal(got, again):
            raise AssertionError(f"ssd_chunk {label}: two calls differ")
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        err = (got - want).abs().max().item()
        L = sref.chunk_len(T, chunk)
        tile = sk.head_tile(B, T // L, -(-L // sk.ROW_TILE), H, sm_count(dev))
        extra = {}
        if label == "Zamba2-1.2B layer":
            with mock.patch.object(sk, "head_tile", lambda *_: 1):
                one = call()
                torch.testing.assert_close(one, want, rtol=tol, atol=tol)
                extra["ms_head_tile_1"] = _ms_median(call)
            del one
        del got, again, want
        planned = sk.device_kernels(T, chunk)
        kernels = _device_kernels(call, planned)
        n_kernels = sum(n for n, _ in kernels.values())
        if n_kernels != planned:
            raise AssertionError(f"ssd_chunk {label}: device kernels a call "
                                 f"{kernels}, planned {planned}")
        nbytes, flops = _ssd_work(B, T, H, N, P, L, Bm.element_size())
        bound_ms, bound_by = _bound(nbytes, flops, hbm_bw,
                                    TF32X3_FLOPS if dt == fp32 else HALF_FLOPS)
        ms = _ms_median(call)
        cases["ssd_chunk"].append({
            "shape": [B, T, H, N, P], "L": L, "chunks": T // L,
            "dtype": names[dt], "what": label, "head_tile": tile,
            "device_kernels": n_kernels,
            "kernel_ms": {re.search(r"ssd_\w+", k).group(0): t
                          for k, (_, t) in kernels.items()},
            "max_abs_err": err, "rtol": tol, "atol": tol, "flops": flops,
            "ms": ms, **extra,
            "plain_ms": _ms_median(
                lambda: sref.ssd_scan_ref(lam, Bm, Cm, xdt, chunk=chunk),
                reps=5),
            "library_ms": None,
            "library": "none: no single PyTorch call computes the scan",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_rate": ("TF32 x3, 165 TFLOP/s" if dt == fp32
                           else "bf16, 989 TFLOP/s"),
            "bound_fma_ms": (flops / FP32_FLOPS * 1e3 if dt == fp32
                             else None),
            "bound_mma_sync_ms": (3 * flops / mma_peak * 1e3 if dt == fp32
                                  else None),
            "tf32x3_tflops": (3 * flops / ms * 1e-9 if dt == fp32 else None),
        })
        print(f"[phase1] ssd_chunk {json.dumps(cases['ssd_chunk'][-1])}",
              flush=True)
        del lam, Bm, Cm, xdt
    torch.cuda.empty_cache()
    return cases


def _profile(fn, what, top=6, phase="phase4"):
    """Device busy time and the kernels and host ops that take the most
    time in one run of ``fn``, under ``torch.profiler`` (CPU + CUDA).
    Returns (wall ms under the profiler, device busy ms, {kernel name:
    (calls, device ms)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_device = sorted(kernels, key=lambda e: -e.self_device_time_total)
    by_host = sorted((e for e in events if e not in kernels),
                     key=lambda e: -e.self_cpu_time_total)
    print(f"[{phase}] profile {what}: wall {wall_ms:.3f} ms under the "
          f"profiler, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.1%}); top kernels (ms, calls): "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} "
                      f"x{e.count}" for e in by_device[:top])
          + "; top host ops (self ms, calls): "
          + "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.3f} "
                      f"x{e.count}" for e in by_host[:top]), flush=True)
    return wall_ms, busy_ms, {e.key: (e.count, e.self_device_time_total / 1e3)
                              for e in kernels}


def _decode_profile(kernels, busy_ms, steps, per_step, what, phase):
    """flash_decode in a profiled run of ``steps`` decode steps: exactly
    one device kernel per call (``per_step`` calls a step), and its
    device time per step and share of the device busy time."""
    calls = [v for key, v in kernels.items() if "decode_kernel" in key]
    n = sum(c for c, _ in calls)
    ms = sum(m for _, m in calls)
    if n != steps * per_step:
        raise AssertionError(f"{what}: {n} flash_decode device kernels in "
                             f"{steps} steps, expected {steps * per_step}")
    out = {"device_busy_ms_per_step": busy_ms / steps,
           "flash_decode_ms_per_step": ms / steps,
           "flash_decode_busy_share": ms / busy_ms}
    print(f"[{phase}] {what}: {n} flash_decode kernels ({per_step} a step), "
          f"device busy {out['device_busy_ms_per_step']:.4f} ms a step, "
          f"flash_decode {out['flash_decode_ms_per_step']:.4f} ms a step "
          f"({out['flash_decode_busy_share']:.1%} of busy)", flush=True)
    return out


def _per_call(cfg):
    """Kernel launches of one prefill and of one decode step of a model
    of ``cfg``: the dense decoder runs flash_attention / flash_decode
    once per layer; the hybrid runs ssd_chunk once per Mamba2 layer in
    prefill (never in a decode step) and flash_attention / flash_decode
    once per call point of the shared block."""
    from repro_torch.models.zamba import call_points

    if cfg.ssm is not None:
        shared = sum(after for _, _, after in call_points(cfg))
        return ({"ssd_chunk": cfg.n_layers, "flash_attention": shared},
                {"flash_decode": shared})
    return {"flash_attention": cfg.n_layers}, {"flash_decode": cfg.n_layers}


PREFILL_REPS = 10   # timed prefills after the first


def _time_prefill(model, prompt):
    """(logits, first call's wall, median wall, median enqueue) over
    PREFILL_REPS calls after the first, in ms: the wall runs from the call
    to ``synchronize``, the enqueue to the call's return. Where the two
    meet, the host's launches and not the device set the prefill's pace."""
    import torch

    walls, enqueues = [], []
    for _ in range(PREFILL_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = model.prefill({"tokens": prompt})
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        enqueues.append((t1 - t0) * 1e3)
    return (last, walls[0], statistics.median(walls[1:]),
            statistics.median(enqueues[1:]))


def _serving_launches(delta, what, cfg, prefills, steps, fusions=0):
    """The serving run launched exactly the kernels ``prefills`` prefills
    and ``steps`` decode steps of a ``cfg`` model take, and one
    weighted-sum launch per fusion."""
    per_prefill, per_step = _per_call(cfg)
    want = {k: per_prefill.get(k, 0) * prefills + per_step.get(k, 0) * steps
            for k in ("ssd_chunk", "flash_attention", "flash_decode")}
    want["weighted_sum"] = fusions
    got = {k: delta.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {delta}, want {want}")


def _prefill_vs_decode(model, tokens, what, rtol, atol, phase="phase4"):
    """Prefill's last-position logits (flash-attention kernel, and the
    SSD-scan kernel in a hybrid) against the same tokens teacher-forced
    through ``decode_step`` (flash-decode kernel) and against prefill
    through the plain versions."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_chunk.ref import ssd_scan_ref
    from repro_torch.launch.generate import generate

    B, T = tokens.shape
    before = _all_launches()
    t0 = time.perf_counter()
    pre = model.prefill({"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, logits = generate(model, tokens, 1, cache_len=T, return_logits=True)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    delta = _launch_delta(before)
    plain_kw = {"attention": attention_ref}
    if model.config.ssm is not None:
        plain_kw["ssd"] = ssd_scan_ref
    plain = model.prefill({"tokens": tokens}, **plain_kw)
    tf = logits[:, 0]
    err_tf = _check_close(tf.cpu().numpy(), pre.double().cpu().numpy(),
                          rtol, atol, f"{what}: teacher-forced vs prefill")
    err_plain = _check_close(plain.cpu().numpy(), pre.double().cpu().numpy(),
                             rtol, atol, f"{what}: plain vs kernel prefill")
    print(f"[{phase}] {what}: prefill {B}x{T} {prefill_s * 1e3:.3f} ms, "
          f"{T} teacher-forced steps {decode_s:.3f} s; max_abs_err "
          f"teacher-forced={err_tf} plain={err_plain} (rtol={rtol}, "
          f"atol={atol}) launches={delta}", flush=True)
    _serving_launches(delta, what, model.config, 1, T)
    return delta


def _fused_vs_eq1(fused, clients, weights, template, what, phase):
    """The fused flat vector against float64 Eq. 1, one parameter's
    slice at a time (so the card never holds a float64 copy of the
    whole model)."""
    import numpy as np

    denom = float(np.sum(weights.astype(np.float64))) + 1e-6
    offset, bad, max_err = 0, 0, 0.0
    for name, p in template.items():
        n = p.numel()
        want = None
        for c, w in zip(clients, weights):
            term = c[name].double().reshape(-1) * float(w)
            want = term if want is None else want.add_(term)
        want /= denom
        got = fused[offset:offset + n].double()
        offset += n
        err = (got - want).abs()
        bad += int((err > 1e-6 + 2e-5 * want.abs()).sum().item())
        max_err = max(max_err, err.max().item())
        if not got.isfinite().all():
            raise AssertionError(f"{what}: non-finite fused values in {name}")
    if offset != fused.numel() or bad:
        raise AssertionError(f"{what} vs float64 Eq. 1: {bad} values outside "
                             f"rtol 2e-5, max_abs_err {max_err}")
    print(f"[{phase}] {what}: max_abs_err={max_err} (float64 Eq. 1, "
          "rtol 2e-5, a parameter at a time)", flush=True)
    return max_err


def phase_serving(dev, attn_cases):
    """The serving path through ``build_model`` and ``launch.generate``:
    FedAvg-fused Qwen2-0.5B served by prefill and cached decoding at full
    width, then fp32 prefill-vs-decode checks of Qwen2-0.5B and of
    Gemma3-1B cut to 6 layers."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import generate as gen
    from repro_torch.models import build_model

    rng = np.random.default_rng(SEED)
    out = {}

    # (a) Qwen2-0.5B bf16, 24 layers: fuse 4 clients, prefill 4 x 1024,
    # decode 32 tokens after a 64-token prompt with a 2048-slot cache
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    clients = gen.perturbed_clients(model, 4, seed=SEED + 1)
    weights = rng.integers(1, 100, size=4).astype(np.float32)
    torch.cuda.synchronize()
    print(f"[phase4] qwen2-0.5b bf16: {cfg.num_params()} params, 4 clients "
          f"made in {time.perf_counter() - t0:.3f} s", flush=True)
    before = _all_launches()
    t0 = time.perf_counter()
    fused, report = gen.fuse_clients(model, clients, weights)
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    print(f"[phase4] qwen2-0.5b bf16 FedAvg of 4 clients: wall={fuse_s:.3f}s "
          f"fuse={report.fuse_seconds:.3f}s phases={report.phase_seconds}",
          flush=True)
    _fused_vs_eq1(fused, clients, weights, model.state_dict(),
                  "qwen2-0.5b bf16 FedAvg of 4 clients", "phase4")
    del clients, fused
    torch.cuda.empty_cache()

    prompt = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           size=(4, 1024))).to(dev)
    last, first_ms, prefill_ms, enqueue_ms = _time_prefill(model, prompt)
    if tuple(last.shape) != (4, cfg.vocab) or not torch.isfinite(last).all():
        raise AssertionError(f"qwen2 prefill logits {tuple(last.shape)}")
    fa_ms = attn_cases["flash_attention"][0]["ms"]     # this layer, bf16
    out["qwen2_prefill_ms"] = prefill_ms
    out["qwen2_prefill_enqueue_ms"] = enqueue_ms
    out["qwen2_prefill_kernel_share"] = cfg.n_layers * fa_ms / prefill_ms
    print(f"[phase4] qwen2-0.5b bf16 prefill 4x1024: {prefill_ms:.3f} ms "
          f"(median of {PREFILL_REPS}; host enqueue {enqueue_ms:.3f} ms; "
          f"first call {first_ms:.3f} ms); flash_attention "
          f"{cfg.n_layers} x {fa_ms:.4f} ms = "
          f"{out['qwen2_prefill_kernel_share']:.1%}", flush=True)

    _, out["qwen2_prefill_device_busy_ms"], _ = _profile(
        lambda: model.prefill({"tokens": prompt}), "qwen2 bf16 prefill 4x1024")
    prompt = prompt[:, :64].contiguous()
    n_new = 32
    gen.generate(model, prompt, 2, cache_len=2048)    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens, logits = gen.generate(model, prompt, n_new, cache_len=2048,
                                  return_logits=True)
    torch.cuda.synchronize()
    steps = prompt.shape[1] + n_new - 1
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    if tuple(tokens.shape) != (4, 64 + n_new) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"qwen2 generate {tuple(tokens.shape)}")
    wall, busy, kernels = _profile(
        lambda: gen.generate(model, prompt[:, :4], 4, cache_len=2048),
        "qwen2 bf16 decode, 7 steps")
    out["qwen2_decode_device_busy_share"] = busy / wall
    for name, val in _decode_profile(kernels, busy, 7, cfg.n_layers,
                                     "qwen2 bf16 decode", "phase4").items():
        out[f"qwen2_decode_{name}"] = val
    delta = _launch_delta(before)
    print(f"[phase4] qwen2-0.5b bf16 launches={delta}", flush=True)
    # PREFILL_REPS + 2 prefills; 65 warm-up, 95 timed and 7 profiled
    # decode steps
    _serving_launches(delta, "qwen2-0.5b bf16 serving", cfg, PREFILL_REPS + 2,
                      65 + steps + 7, fusions=1)
    # the kernel at this step's shape mid-run (pos 80 of 2048), as
    # phase 1 timed it
    fd_ms = next(c["ms"] for c in attn_cases["flash_decode"]
                 if c["dtype"] == "bf16" and c["pos"] == 80)
    out["qwen2_decode_ms_per_step"] = step_ms
    out["qwen2_decode_kernel_share"] = cfg.n_layers * fd_ms / step_ms
    print(f"[phase4] qwen2-0.5b bf16 generate: {steps} steps (64 "
          f"teacher-forced + {n_new - 1} greedy, B=4, 2048-slot cache): "
          f"{step_ms:.3f} ms/step; flash_decode {cfg.n_layers} x "
          f"{fd_ms:.4f} ms (pos 80) = {out['qwen2_decode_kernel_share']:.1%}",
          flush=True)
    del model, prompt, tokens, logits
    torch.cuda.empty_cache()

    # (b) Qwen2-0.5B fp32, B = 2, a 512-token prompt
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg32, device=dev, seed=SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           size=(2, 512))).to(dev)
    _prefill_vs_decode(model, tokens, "qwen2-0.5b fp32", 2e-3, 2e-3)
    del model
    torch.cuda.empty_cache()

    # (c) Gemma3-1B fp32 at full width, 6 layers (5 local + 1 global),
    # B = 1, T = 1280: window tiles skipped, the 1024 ring wrapped
    gcfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=6,
                               dtype="float32")
    model = build_model(gcfg, device=dev, seed=SEED)
    tokens = torch.from_numpy(rng.integers(0, gcfg.vocab,
                                           size=(1, 1280))).to(dev)
    _prefill_vs_decode(model, tokens, "gemma3-1b fp32, 6 layers", 2e-3, 2e-3)
    del model
    torch.cuda.empty_cache()

    # the CLI, as a user runs it
    before = _all_launches()
    t0 = time.perf_counter()
    gen.main(["--arch", "qwen2-0.5b", "--clients", "2", "--batch", "2",
              "--prompt-len", "16", "--new-tokens", "8",
              "--seed", str(SEED)])
    delta = _launch_delta(before)
    print(f"[phase4] CLI generate qwen2-0.5b: "
          f"wall={time.perf_counter() - t0:.3f}s launches={delta}",
          flush=True)
    _serving_launches(delta, "CLI generate", cfg, 1, 16 + 8 - 1,
                      fusions=1)
    return out


def phase_hybrid_serving(dev, cases):
    """The hybrid's serving path through ``build_model`` and
    ``launch.generate``: a FedAvg-fused Zamba2-1.2B at full width and
    depth served by prefill (the SSD-scan kernel in every Mamba2 layer,
    flash attention in the shared block) and cached decoding, then fp32
    prefill-vs-decode checks at full width and 12 layers, then the CLI."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import generate as gen
    from repro_torch.models import build_model

    rng = np.random.default_rng(SEED + 5)
    out = {}
    cfg = get_config("zamba2-1.2b")
    per_prefill, per_step = _per_call(cfg)

    # (a) Zamba2-1.2B bf16, 38 layers: fuse 2 clients, prefill 4 x 1024,
    # decode 32 tokens after a 64-token prompt with a 2048-slot cache
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    clients = gen.perturbed_clients(model, 2, seed=SEED + 1)
    weights = rng.integers(1, 100, size=2).astype(np.float32)
    torch.cuda.synchronize()
    print(f"[phase5] zamba2-1.2b bf16: {cfg.num_params()} params, 2 clients "
          f"made in {time.perf_counter() - t0:.3f} s", flush=True)
    before = _all_launches()
    t0 = time.perf_counter()
    fused, report = gen.fuse_clients(model, clients, weights)
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    delta = _launch_delta(before)
    _serving_launches(delta, "zamba2 fusion", cfg, 0, 0, fusions=1)
    print(f"[phase5] zamba2-1.2b bf16 FedAvg of 2 clients: wall={fuse_s:.3f}s "
          f"fuse={report.fuse_seconds:.3f}s phases={report.phase_seconds} "
          f"launches={delta}", flush=True)
    _fused_vs_eq1(fused, clients, weights, model.state_dict(),
                  "zamba2-1.2b bf16 FedAvg of 2 clients", "phase5")
    del clients, fused
    torch.cuda.empty_cache()

    prompt = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           size=(4, 1024))).to(dev)
    before = _all_launches()
    last, first_ms, prefill_ms, enqueue_ms = _time_prefill(model, prompt)
    _serving_launches(_launch_delta(before), "zamba2 prefills", cfg,
                      PREFILL_REPS + 1, 0)
    if tuple(last.shape) != (4, cfg.vocab) or not torch.isfinite(last).all():
        raise AssertionError(f"zamba2 prefill logits {tuple(last.shape)}")
    ssd_ms = cases["ssd_chunk"][0]["ms"]     # this layer's scan, fp32
    fa_ms = next(c["ms"] for c in cases["flash_attention"]
                 if c["shape"] == [4, 1024, 32, 32, 64])
    kernel_ms = cfg.n_layers * ssd_ms + per_prefill["flash_attention"] * fa_ms
    out["zamba2_prefill_ms"] = prefill_ms
    out["zamba2_prefill_enqueue_ms"] = enqueue_ms
    out["zamba2_prefill_kernel_share"] = kernel_ms / prefill_ms
    out["zamba2_prefill_ssd_share"] = cfg.n_layers * ssd_ms / prefill_ms
    print(f"[phase5] zamba2-1.2b bf16 prefill 4x1024: {prefill_ms:.3f} ms "
          f"(median of {PREFILL_REPS}; host enqueue {enqueue_ms:.3f} ms; "
          f"first call {first_ms:.3f} ms); ssd_chunk {cfg.n_layers} x "
          f"{ssd_ms:.4f} ms + flash_attention "
          f"{per_prefill['flash_attention']} x {fa_ms:.4f} ms = "
          f"{out['zamba2_prefill_kernel_share']:.1%} (ssd_chunk "
          f"{out['zamba2_prefill_ssd_share']:.1%})", flush=True)
    before = _all_launches()
    wall, busy, _ = _profile(lambda: model.prefill({"tokens": prompt}),
                             "zamba2 bf16 prefill 4x1024", phase="phase5")
    _serving_launches(_launch_delta(before), "zamba2 profiled prefill", cfg,
                      1, 0)
    out["zamba2_prefill_device_busy_ms"] = busy
    out["zamba2_prefill_device_busy_share"] = busy / wall

    prompt = prompt[:, :64].contiguous()
    n_new = 32
    before = _all_launches()
    gen.generate(model, prompt, 2, cache_len=2048)    # warm-up
    torch.cuda.synchronize()
    _serving_launches(_launch_delta(before), "zamba2 warm-up decode", cfg,
                      0, 65)
    before = _all_launches()
    t0 = time.perf_counter()
    tokens, logits = gen.generate(model, prompt, n_new, cache_len=2048,
                                  return_logits=True)
    torch.cuda.synchronize()
    steps = prompt.shape[1] + n_new - 1
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    _serving_launches(_launch_delta(before), "zamba2 generate", cfg, 0, steps)
    if tuple(tokens.shape) != (4, 64 + n_new) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"zamba2 generate {tuple(tokens.shape)}")
    before = _all_launches()
    wall, busy, kernels = _profile(
        lambda: gen.generate(model, prompt[:, :4], 4, cache_len=2048),
        "zamba2 bf16 decode, 7 steps", phase="phase5")
    _serving_launches(_launch_delta(before), "zamba2 profiled decode", cfg,
                      0, 7)
    out["zamba2_decode_device_busy_share"] = busy / wall
    for name, val in _decode_profile(kernels, busy, 7,
                                     per_step["flash_decode"],
                                     "zamba2 bf16 decode", "phase5").items():
        out[f"zamba2_decode_{name}"] = val
    fd_ms = next(c["ms"] for c in cases["flash_decode"]
                 if c["shape"] == [4, 2048, 32, 32, 64])
    out["zamba2_decode_ms_per_step"] = step_ms
    out["zamba2_decode_kernel_share"] = \
        per_step["flash_decode"] * fd_ms / step_ms
    print(f"[phase5] zamba2-1.2b bf16 generate: {steps} steps (64 "
          f"teacher-forced + {n_new - 1} greedy, B=4, 2048-slot cache): "
          f"{step_ms:.3f} ms/step; flash_decode {per_step['flash_decode']} x "
          f"{fd_ms:.4f} ms (pos 80) = {out['zamba2_decode_kernel_share']:.1%}",
          flush=True)
    del model, prompt, tokens, logits, last
    torch.cuda.empty_cache()

    # (b) fp32 at full width, 12 layers (segments [6, 6]: two call points
    # of the shared block, each with its own ring): 2 chunks of 256, and
    # the L = T fallback at T = 300
    cfg32 = dataclasses.replace(cfg, n_layers=12, dtype="float32")
    model = build_model(cfg32, device=dev, seed=SEED)
    for B, T in [(2, 512), (1, 300)]:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                               size=(B, T))).to(dev)
        _prefill_vs_decode(model, tokens, f"zamba2-1.2b fp32, 12 layers, "
                           f"{B}x{T}", 2e-3, 2e-3, phase="phase5")
    del model
    torch.cuda.empty_cache()

    # (c) the CLI, as a user runs it
    before = _all_launches()
    t0 = time.perf_counter()
    gen.main(["--arch", "zamba2-1.2b", "--clients", "2", "--batch", "2",
              "--prompt-len", "16", "--new-tokens", "8",
              "--seed", str(SEED)])
    delta = _launch_delta(before)
    print(f"[phase5] CLI generate zamba2-1.2b: "
          f"wall={time.perf_counter() - t0:.3f}s launches={delta}",
          flush=True)
    _serving_launches(delta, "CLI generate zamba2", cfg, 1, 16 + 8 - 1,
                      fusions=1)
    return out


TRAIN_STEP_REPS = 5


def _leaf_cosines(got, want):
    """{leaf: cosine} of two gradient trees, in fp64, and the relative
    difference of their global norms."""
    import torch

    cos, na, nb = {}, 0.0, 0.0
    for name, a in got.items():
        a, b = a.double().reshape(-1), want[name].double().reshape(-1)
        den = (a.norm() * b.norm()).item()
        cos[name] = 1.0 if den == 0.0 else (a @ b).item() / den
        na += a.square().sum().item()
        nb += b.square().sum().item()
    return cos, abs(math.sqrt(na) - math.sqrt(nb)) / max(math.sqrt(nb),
                                                         1e-30)


def _train_step(model, params, batch, cfg, what, case, key, *, loss_rel,
                cos_min, norm_rel):
    """One local SGD step of ``model`` (a ``Client`` with ``sgd(0.25)``) on
    ``batch``: its loss and gradients through the attention kernels
    (exactly 2 forward launches a layer, remat, and 1 backward) against
    the same through ``attention_train_ref``, within ``loss_rel`` (the
    loss), ``cos_min`` (every gradient leaf's cosine) and ``norm_rel``
    (the global norm); then the step timed (synced, median of
    ``TRAIN_STEP_REPS`` after one) and profiled. {key_*: number}."""
    import collections

    import torch
    from torch.func import functional_call

    from repro_torch.fl import Client
    from repro_torch.models.layers.attention import attention_train_ref
    from repro_torch.optim import sgd

    out = {}
    dev = next(iter(params.values())).device

    def grads(**kw):   # the model's default attention: the kernels
        leaves = collections.OrderedDict(
            (k, v.detach().requires_grad_(True)) for k, v in params.items())
        loss, _ = functional_call(model, leaves, (batch,), kw)
        g = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), collections.OrderedDict(zip(leaves, g))

    before = _all_launches()
    loss_k, g_k = grads()
    torch.cuda.synchronize()
    delta = _launch_delta(before)
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}
    if any(delta[k] != n for k, n in want.items()) or any(
            v for k, v in delta.items() if k not in want):
        raise AssertionError(f"{case} a training step launched {delta}, "
                             f"expected {want}")
    loss_p, g_p = grads(attention=attention_train_ref)
    rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    cos, nrel = _leaf_cosines(g_k, g_p)
    worst = min(cos, key=cos.get)
    print(f"[phase9] {case} {what}: loss kernels {loss_k.item():.6f} plain "
          f"{loss_p.item():.6f} (rel {rel:.2e}, limit {loss_rel:g}); "
          f"gradient cosine min {cos[worst]:.6f} ({worst}; limit "
          f"{cos_min:g}), global-norm rel diff {nrel:.2e} (limit "
          f"{norm_rel:g}); launches {delta}", flush=True)
    if not (rel <= loss_rel and cos[worst] >= cos_min and nrel <= norm_rel
            and math.isfinite(loss_k.item())):
        raise AssertionError(f"{case} kernels vs plain step: loss rel {rel}, "
                             f"cosine {cos[worst]} at {worst}, norm rel "
                             f"{nrel}")
    out[f"{key}_loss_rel"], out[f"{key}_cos_min"] = rel, cos[worst]
    out[f"{key}_norm_rel"] = nrel
    del g_k, g_p

    client = Client(client_id=0, model=model, optimizer=sgd(0.25))
    opt_state = client.optimizer.init(params)

    def step():
        return client._step(params, opt_state, batch, 0)

    step()   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(TRAIN_STEP_REPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out[f"{key}_ms"] = statistics.median(times)
    out[f"{key}_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    wall, busy, kernels = _profile(step, what, phase="phase9")
    out[f"{key}_device_busy_share"] = busy / wall
    bwd_ms = sum(ms for name, (_, ms) in kernels.items()
                 if "bwd_" in name)
    out[f"{key}_attention_bwd_device_ms"] = bwd_ms
    print(f"[phase9] {case} {what}: {out[f'{key}_ms']:.3f} ms (median of "
          f"{TRAIN_STEP_REPS}: {[round(t, 3) for t in times]}); device busy "
          f"{busy:.3f} of {wall:.3f} ms profiled ({busy / wall:.1%}), "
          f"attention backward kernels {bwd_ms:.3f} ms; peak memory "
          f"{out[f'{key}_peak_gb']:.2f} GB", flush=True)
    return out


def phase_training(dev, attn_cases):
    """Federated training of full-width Qwen2-0.5B bf16 on the card: (a)
    one local step through the attention kernels against the same step
    with the plain forward and backward, timed and profiled; (b) two
    FedAvg rounds of 4 clients through ``FederatedServer`` with each
    round's fused params held against float64 Eq. 1, then a gradavg
    round; (c) ``save_pytree`` / ``load_pytree`` of the trained params;
    (d) the train CLI; then (e) (a)'s step for full-width Gemma3-1B in
    fp32, 1 x 1280 tokens, through the fp32 attention backward."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.configs import get_config
    from repro_torch.core.service import AggregationService
    from repro_torch.data import FederatedLoader, SyntheticLM
    from repro_torch.fl import Client, FederatedServer
    from repro_torch.fl.client import batch_to_device
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.utils.pytree import flat_vector_to_tree, tree_leaves

    out = {}
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    params = model.state_dict()
    gen = SyntheticLM(vocab=cfg.vocab, seed=SEED)
    batch = batch_to_device(
        {"tokens": gen.sample(4, 512, rng_seed=SEED)}, dev)
    batch["labels"] = batch["tokens"]
    torch.cuda.synchronize()
    print(f"[phase9] qwen2-0.5b bf16 {cfg.num_params()} params, a 4 x 512 "
          f"batch, made in {time.perf_counter() - t0:.3f} s", flush=True)

    # (a) one step's loss and gradients: kernels against plain versions,
    # then the step timed and profiled
    out.update(_train_step(model, params, batch, cfg,
                           "qwen2 bf16 local step 4x512", "(a)", "step",
                           loss_rel=1e-2, cos_min=0.99, norm_rel=5e-2))
    del batch
    torch.cuda.empty_cache()

    # (b) FederatedServer: 4 clients x 2 local SGD steps x 2 rounds, then
    # a gradavg round; each round's fp32 fused vector against float64
    # Eq. 1 of the clients' updates before the cast to the params' dtype
    def server_for(fusion, send_delta, start):
        svc = AggregationService(fusion=fusion, device=dev)
        loader = FederatedLoader(gen=gen, n_clients=4, batch=4, seq_len=128)
        clients = [Client(client_id=i, model=model, optimizer=sgd(0.25),
                          local_steps=2, send_delta=send_delta)
                   for i in range(4)]
        server = FederatedServer(model=model, clients=clients, loader=loader,
                                 service=svc, rng_seed=SEED, params=start)
        # the server's own call, template branch included, runs as it is;
        # the spies only record its inputs and the fp32 vector that the
        # round epilogue casts into the template's leaves
        seen = {}
        aggregate, finish = svc.aggregate, svc._finish

        def aggregate_spy(updates=None, weights=None, **kw):
            seen.update(updates=updates, weights=weights)
            tree, report = aggregate(updates=updates, weights=weights, **kw)
            seen.update(tree=tree, template=kw.get("template"))
            return tree, report

        def finish_spy(fused, *a, **kw):
            seen["flat"] = fused
            return finish(fused, *a, **kw)

        svc.aggregate, svc._finish = aggregate_spy, finish_spy
        return server, seen

    rounds = []
    for fusion, send_delta, n_rounds in (("fedavg", False, 2),
                                         ("gradavg", True, 1)):
        server, seen = server_for(fusion, send_delta,
                                  params if not rounds else trained)
        for r in range(n_rounds):
            before = _all_launches()
            t0 = time.perf_counter()
            res = server.run_round(r)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            delta = {k: v for k, v in _launch_delta(before).items() if v}
            if not math.isfinite(res.mean_client_loss) or \
                    delta.get("weighted_sum") != 1:
                raise AssertionError(f"(b) {fusion} round {r}: loss "
                                     f"{res.mean_client_loss}, {delta}")
            err = _fused_vs_eq1(
                seen["flat"], seen["updates"],
                np.asarray(seen["weights"], np.float32), seen["template"],
                f"(b) {fusion} round {r} fused params", "phase9")
            # the tree the server applied is that vector cast leaf by leaf
            want = flat_vector_to_tree(seen["flat"], seen["template"])
            got_leaves, want_leaves = (tree_leaves(seen["tree"]),
                                       tree_leaves(want))
            if len(got_leaves) != len(want_leaves) or not all(
                    a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(got_leaves, want_leaves)):
                raise AssertionError(f"(b) {fusion} round {r}: the returned "
                                     "tree is not the fused vector cast")
            rounds.append({"fusion": fusion, "round": r, "wall_s": wall,
                           "loss": res.mean_client_loss,
                           "fuse_s": res.report.fuse_seconds,
                           "phase_seconds": res.report.phase_seconds,
                           "launches": delta, "max_abs_err": err})
            print(f"[phase9] (b) {fusion} round {r}: wall={wall:.3f}s "
                  f"loss={res.mean_client_loss:.4f} "
                  f"fuse={res.report.fuse_seconds:.4f}s "
                  f"phases={res.report.phase_seconds} launches={delta}",
                  flush=True)
            seen.clear()
        trained = server.params
        del server
        torch.cuda.empty_cache()
    out["rounds"] = rounds

    # (c) the trained params through save_pytree / load_pytree, bitwise
    ckpt = os.path.join(HERE, "build", "phase9", "trained")
    t0 = time.perf_counter()
    save_pytree(ckpt, trained)
    back = load_pytree(ckpt, trained)
    same = all(torch.equal(back[k], v) and back[k].dtype == v.dtype
               for k, v in trained.items())
    shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    print(f"[phase9] (c) save_pytree / load_pytree of {len(trained)} leaves: "
          f"{time.perf_counter() - t0:.3f} s, bitwise equal {same}",
          flush=True)
    if not same:
        raise AssertionError("(c) loaded params differ from the saved ones")
    del trained, back, params, model
    torch.cuda.empty_cache()

    # (d) the train CLI, as a user runs it
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-0.5b", "--full-config", "--rounds", "2", "--clients", "4",
         "--local-steps", "1", "--seq-len", "128"],
        capture_output=True, text=True, timeout=600, cwd=HERE,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    print(res.stdout.strip(), flush=True)
    if res.returncode != 0 or "[round   1]" not in res.stdout:
        raise AssertionError(f"(d) train CLI: {res.stderr[-3000:]}")
    out["cli_s"] = time.perf_counter() - t0
    print(f"[phase9] (d) train CLI: {out['cli_s']:.3f} s", flush=True)

    # (e) full-width Gemma3-1B fp32 (26 layers, hd 256, MQA, a window of
    # 1024 on 5 of 6 layers): one 1 x 1280 local step, so that the local
    # layers cross their window at phase 1's Gemma3 shape, through the
    # fp32 attention backward (three TF32 passes); fp32 sums in other
    # orders than the plain attention's, and nothing rounded to a half
    # type, hence limits 100x tighter than (a)'s
    gcfg = dataclasses.replace(get_config("gemma3-1b"), dtype="float32")
    t0 = time.perf_counter()
    model = build_model(gcfg, device=dev, seed=SEED)
    params = model.state_dict()
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, gcfg.vocab, size=(1, 1280))
    batch = batch_to_device({"tokens": tokens, "labels": tokens}, dev)
    torch.cuda.synchronize()
    print(f"[phase9] (e) gemma3-1b fp32 {gcfg.num_params()} params, a 1 x "
          f"1280 batch, made in {time.perf_counter() - t0:.3f} s", flush=True)
    out.update(_train_step(model, params, batch, gcfg,
                           "gemma3-1b fp32 local step 1x1280", "(e)",
                           "gemma3_fp32_step", loss_rel=1e-4, cos_min=0.9999,
                           norm_rel=1e-3))
    del model, params, batch
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.cnn_suite import CNN_SUITE
    from repro_torch.core.compress import CompressedUpdate, quantize
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.utils.mem import hardware_spec

    kernel, rk, fa, fd, sk = _kernel_modules()

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
    with ThreadPoolExecutor(6) as pool:   # one nvcc per source, together
        for done in [pool.submit(m.build) for m in (kernel, rk, fa, fd, sk)] \
                + [pool.submit(_mma_peak_build)]:
            done.result()
    print(f"[phase0] kernel build seconds={time.perf_counter() - t0:.3f}",
          flush=True)
    _attention_sass()
    _attention_bwd_build()
    _decode_build()
    _ssd_build()
    _fusion_build()
    mma_peak = _mma_peak(dev, hw.sm_count)

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
    cases.update(phase_carve_kernel(dev, hw.hbm_bw, resnet_p, cnn_p))
    cases.update(phase_robust_kernels(dev, hw.hbm_bw, resnet_p, cnn_p))
    cases.update(phase_attention_kernels(dev, hw.hbm_bw))
    cases.update(phase_attention_bwd(dev, hw.hbm_bw, mma_peak))
    cases.update(phase_decode_kernel(dev, hw.hbm_bw))
    cases.update(phase_ssd_kernel(dev, hw.hbm_bw, mma_peak))
    print(f"[phase1] seconds={time.perf_counter() - t0:.3f}", flush=True)

    # -- phases 2-8: each path with the counts set to 0 just before it --
    by_phase = {}

    def run_phase(name, fn, *args):
        _reset_launches()
        t0 = time.perf_counter()
        result = fn(*args)
        by_phase[name] = {k: v for k, v in _all_launches().items() if v}
        print(f"[{name}] seconds={time.perf_counter() - t0:.3f} "
              f"launches={by_phase[name]}"
              + (f" {json.dumps(result)}" if result else ""), flush=True)

    run_phase("phase2", phase_main_path, dev, U, W, Uc, Wc, cu_rows)  # FedAvg
    run_phase("phase3", phase_robust_path, dev, U, Uc, cu_rows)     # robust
    # async and adaptive rounds, while the round data is still held
    run_phase("phase6", phase_async_rounds, dev, U, W, Uc, Wc, cu_rows)
    # concurrent tenants, fair admission, secure rounds, trace replay
    run_phase("phase7", phase_concurrent, dev, U, W, cu_rows)
    # the Edge serving path: HTTP uploads into rounds on the card
    run_phase("phase8", phase_edge_serving, dev, U, W, Uc)
    # the distributed engine and the mesh service over NCCL
    run_phase("phase10", phase_distributed, dev, U, W, Uc, Wc, cu_rows)
    del U, Uc, cu_rows
    run_phase("phase4", phase_serving, dev, cases)      # a fused decoder
    run_phase("phase5", phase_hybrid_serving, dev, cases)   # fused Zamba2
    run_phase("phase9", phase_training, dev, cases)     # federated training
    launches = {k: sum(p.get(k, 0) for p in by_phase.values())
                for k in _all_launches()}
    missing = [k for k, v in launches.items() if v == 0]
    if missing or by_phase["phase3"].get("topk_carve", 0) < 48 \
            or by_phase["phase5"].get("ssd_chunk", 0) == 0 \
            or any(by_phase["phase6"].get(k, 0) == 0 for k in (
                "weighted_sum", "weighted_sum_dequant", "topk_carve")) \
            or any(by_phase["phase7"].get(k, 0) == 0 for k in (
                "weighted_sum", "weighted_sum_dequant")) \
            or any(by_phase["phase8"].get(k, 0) == 0 for k in (
                "weighted_sum", "weighted_sum_dequant", "topk_carve")) \
            or any(by_phase["phase9"].get(k, 0) == 0 for k in (
                "weighted_sum", "flash_attention", "flash_attention_bwd")) \
            or any(by_phase["phase10"].get(k, 0) == 0 for k in (
                "weighted_sum", "weighted_sum_dequant", "topk_carve",
                "trimmed_mean", "coord_median")):
        raise AssertionError(f"main path never launched {missing}: "
                             f"{by_phase}")

    replaces = {
        "weighted_sum": "src/repro/kernels/fused_fusion/kernel.py:61",
        "weighted_sum_dequant": "src/repro/kernels/fused_fusion/kernel.py:128",
        "topk_carve": "src/repro/kernels/robust_fusion/kernel.py:84",
        "trimmed_mean": "src/repro/kernels/robust_fusion/kernel.py:132",
        "coord_median": "src/repro/kernels/robust_fusion/kernel.py:43",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:83",
        # no pallas_call: the custom VJP of the model's blockwise_attention
        "flash_attention_bwd": "src/repro/models/layers/attention.py:217",
        "flash_decode": "src/repro/kernels/flash_decode/kernel.py:65",
        "ssd_chunk": "src/repro/kernels/ssd_chunk/kernel.py:59",
    }
    sources = {name: src for mod, src in (
        (kernel, "fused_fusion"), (rk, "robust_fusion"),
        (fa, "flash_attention"), (fd, "flash_decode"), (sk, "ssd_chunk"))
        for name in mod.LAUNCHES}
    kernels = []
    for name, runs in cases.items():
        main_case = runs[0]   # the main path's shape
        source = sources[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "launches_by_phase": {ph: n[name] for ph, n in by_phase.items()
                                  if name in n},
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
