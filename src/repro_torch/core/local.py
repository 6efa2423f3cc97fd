"""Single-card aggregation engine (paper §III-D1).

``kernel`` strategy — the default: the hand-written CUDA kernels (the
                      weighted sums, the top-k carve, the dense trimmed
                      mean and median), the twin of ``repro``'s
                      ``pallas`` strategy.
``torch`` strategy  — the paper's baseline engine: plain dense PyTorch
                      ops on one device, the twin of ``jnp``; taken only
                      when asked for.

Both fold streamable fusions from (chunk, P) blocks into the fusion's
carry — a (P,) fp32 weighted sum, or the O(K*P) top-k carve of
TrimmedMean / CoordMedian — so a memory-capped node can aggregate more
clients than fit at once, and ``fuse_stream`` consumes blocks straight
off ``UpdateStore.iter_chunks``: the dense (n, P) matrix never exists on
the host. Each block is copied to the device once, before its fold.

Fold steps are built once per shape key (``utils.jitcache``) and reused
across rounds; the keys are those of ``repro.core.local`` so the
planner's reuse term and ``is_warm``/``is_warm_stream`` keep working.
Where the JAX engine scans a compiled executable, this one loops in
Python over kernel launches.

``combine`` runs outside the steps because FedAvgM / FedAdam carry
server state that must advance every round.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compress import BLOCK, CompressedBlock
from repro_torch.core.fusion.base import FusionAlgorithm
from repro_torch.kernels.fused_fusion import kernel
from repro_torch.kernels.robust_fusion import kernel as robust_kernel
from repro_torch.utils.device import DeviceLike, resolve_device, synchronize
from repro_torch.utils.dtypes import (
    fold_dtype,
    host_array,
    host_dtype,
    to_device,
    updates_to_device,
)
from repro_torch.utils.jitcache import CompiledCache, bucket_rows, fusion_cache_key

# fusions whose weighted-sum partial routes through the CUDA kernels
_KERNEL_WSUM = ("fedavg", "gradavg", "iteravg", "fedavgm", "fedadam")
STRATEGIES = ("kernel", "torch")


def _check_scale(scale) -> np.ndarray:
    """A block's optional third element must be a NUMERIC per-row scale
    (``UpdateStore.iter_arrivals`` yields client ids there instead)."""
    arr = host_array(scale)
    if arr.dtype.kind not in "fiu":
        raise TypeError(
            "fuse_stream: blocks must be (updates, weights[, scale]) with "
            f"a numeric per-row scale, got dtype {arr.dtype}; note "
            "UpdateStore.iter_arrivals yields (block, weights, client_ids)"
        )
    return arr


def _nbytes(block) -> int:
    if isinstance(block, torch.Tensor):
        return block.numel() * block.element_size()
    return int(block.nbytes)


def _host_weights(w) -> torch.Tensor:
    """Per-row weights as a fresh fp32 CPU tensor (small; the weight
    arithmetic runs on the host, then one copy goes to the device)."""
    return torch.tensor(np.asarray(host_array(w), np.float32))


def _block_weights(fusion, w, scale, rows: int, width: int) -> torch.Tensor:
    """The block's (width,) fp32 fold weights on the host: effective
    weights, times the per-row scale, and zero on padded rows; for an
    order-statistic fold, 1 on each real row (validity only)."""
    wt = torch.zeros((width,), dtype=torch.float32)
    if not fusion.weighted:
        wt[:rows] = 1.0
        return wt
    wt[:rows] = _host_weights(w)[:rows]
    wt = fusion.effective_weights(wt).clone()
    if scale is not None:
        wt[:rows] *= torch.tensor(np.asarray(scale, np.float32)[:rows])
    wt[rows:] = 0.0   # effective_weights may remap pads
    return wt


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    out = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[: x.shape[0]] = x
    return out


@dataclasses.dataclass
class StreamReport:
    """Phase accounting for one streamed aggregation."""

    ingest_seconds: float = 0.0    # stalls waiting on store blocks
    compile_seconds: float = 0.0   # step build (0.0 on warm rounds)
    compute_seconds: float = 0.0   # host-to-device copy + fold, synced
    n_rows: int = 0
    n_blocks: int = 0
    chunk_rows: int = 0
    # payload bytes ingested (pre-padding; codes + scales for compressed
    # blocks) — what RoundReport.bytes_ingested reports
    ingest_bytes: int = 0
    # pre-finalize carry (tuple of device tensors, the fusion's reducer
    # state) so a later round can continue it; acc_wsum / acc_tot are
    # its sum-family view, set for reducible fusions only
    acc_state: Optional[tuple] = None
    acc_wsum: Optional[torch.Tensor] = None
    acc_tot: float = 0.0


@dataclasses.dataclass
class LocalEngine:
    """Fuses on one device: the card unless ``device="cpu"``."""

    strategy: str = "kernel"      # "kernel" | "torch"
    memory_cap_bytes: Optional[int] = None  # simulate a memory-limited node
    device: DeviceLike = None

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}, "
                             f"got {self.strategy!r}")
        self.device = resolve_device(self.device)
        self.cache = CompiledCache(name=f"local:{self.strategy}")
        # per-THREAD compile accounting: concurrent rounds share the
        # engine, and one round must not read another's build time
        self._tls = threading.local()

    @property
    def last_compile_seconds(self) -> float:
        """Build seconds paid by the CURRENT thread's last fuse call."""
        return getattr(self._tls, "compile_seconds", 0.0)

    @last_compile_seconds.setter
    def last_compile_seconds(self, value: float) -> None:
        self._tls.compile_seconds = value

    # -- public --------------------------------------------------------------
    def fuse(self, fusion: FusionAlgorithm, updates, weights,
             device_sem=None) -> torch.Tensor:
        """Dense fuse of a (n, P) array or tensor. ``device_sem``
        (optional semaphore) is held around device execution only, and
        the fold is waited for under it. Over ``memory_cap_bytes`` a
        streamable fusion folds capped chunks one at a time (the carve
        through ``fuse_stream``)."""
        n, P = updates.shape
        dev = self.device
        w = torch.ones((n,), dtype=torch.float32) if weights is None \
            else _host_weights(weights)
        w = fusion.effective_weights(w).to(dev)
        dtype = fold_dtype(updates)
        self.last_compile_seconds = 0.0
        sem = device_sem if device_sem is not None \
            else contextlib.nullcontext()

        if self.memory_cap_bytes is not None:
            max_rows = max(
                int(self.memory_cap_bytes // max(dtype.itemsize * P, 1)), 1)
            if max_rows < n:
                if not fusion.streamable:
                    raise MemoryError(
                        f"{fusion.name}: {n} updates x {dtype.itemsize * P} B "
                        f"exceed the {self.memory_cap_bytes} B cap and the "
                        "fusion is not streamable — classify as DISTRIBUTED"
                    )
                if not fusion.reducible:
                    # order-statistic reducer: chunk the dense input
                    # through the streamed carve fold (bounded carry)
                    chunks = ((updates[i: i + max_rows], w[i: i + max_rows])
                              for i in range(0, n, max_rows))
                    fused, _ = self.fuse_stream(
                        fusion, chunks, chunk_rows=max_rows,
                        device_sem=device_sem, n_hint=n,
                    )
                    return fused
                return self._streamed(fusion, updates, w, max_rows, dtype,
                                      device_sem)

        u = updates_to_device(updates, dev)
        if fusion.reducible:
            return self._fuse_reducible_dense(fusion, u, w, dtype, device_sem)
        with sem:
            if self.strategy == "kernel" and fusion.name == "coordmedian":
                out = robust_kernel.coord_median(u)
            elif self.strategy == "kernel" and fusion.name == "trimmedmean":
                out = robust_kernel.trimmed_mean(u, fusion.trim_count(n))
            else:
                out = fusion.fuse(u, w)
            return self._bounded(out, device_sem)

    def _bounded(self, out, device_sem):
        """Wait for ``out`` while a device semaphore is installed —
        launches return at once and would otherwise escape the bound."""
        if device_sem is not None:
            synchronize(self.device)
        return out

    def fuse_stream(
        self,
        fusion: FusionAlgorithm,
        blocks: Iterable[Tuple[np.ndarray, ...]],
        init: Optional[tuple] = None,
        chunk_rows: Optional[int] = None,
        device_sem=None,
        n_hint: Optional[int] = None,
    ) -> Tuple[torch.Tensor, StreamReport]:
        """Fuse a streamable fusion from an iterator of (chunk, P) blocks
        (e.g. ``UpdateStore.iter_chunks``) without ever holding the dense
        matrix: each block is copied to the device and folded into the
        fusion's carry by one cached step — the (P,) fp32 weighted-sum
        pair for the reducible family, the (sum, count, topk, botk) top-k
        carve for order-statistic fusions, whose K is sized from
        ``n_hint`` (the expected client count; required for them).

        Blocks are ``(updates, weights)`` or ``(updates, weights,
        scale)``; the optional numeric (c,) ``scale`` multiplies the
        EFFECTIVE weights. Order-statistic (``fusion.weighted == False``)
        streams ignore client weights — the engine passes a 0/1 validity
        row — and refuse per-row scales with a ValueError. ``updates``
        is a dense (c, P) array or tensor, or a
        :class:`~repro_torch.core.compress.CompressedBlock` (int8 codes +
        fp32 per-block scales) folded without dequantizing on the host; a
        round may mix both, each payload kind with its own step, all into
        one carry. ``chunk_rows`` pins the step key (the first block's
        size if unset); only the final block may be smaller. The kernel
        strategy folds a ragged block as it is, the torch strategy pads
        it to ``chunk_rows`` zero-weight (invalid) rows. ``init`` seeds
        the carry with an earlier ``acc_state`` (tensors or ndarrays),
        which is copied first: the carve kernel updates the carry in
        place and never writes into the caller's tensors. ``device_sem``
        is held around each block's copy and fold and the final combine,
        and each is waited for under it, so it bounds device execution
        while ingest stalls stay outside. Returns (fused, StreamReport).
        """
        if not fusion.streamable:
            raise ValueError(
                f"{fusion.name} is not streamable — streamed aggregation "
                "needs a reducer decomposition (weighted sum or "
                "order-statistic carve)"
            )
        dev = self.device
        rep = StreamReport()
        sem = device_sem if device_sem is not None \
            else contextlib.nullcontext()
        it = iter(blocks)
        steps: dict = {}   # payload kind -> cached step
        state = sig = None
        chunk = dim = None
        compile_total = 0.0
        self.last_compile_seconds = 0.0
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                break
            rep.ingest_seconds += time.perf_counter() - t0
            block, w = item[0], item[1]
            scale = _check_scale(item[2]) if len(item) > 2 else None
            if scale is not None and not fusion.weighted:
                raise ValueError(
                    f"{fusion.name}: per-row staleness scales are "
                    "unsupported — order statistics cannot discount rows"
                )
            compressed = isinstance(block, CompressedBlock)
            rows = block.rows if compressed else block.shape[0]
            bdim = block.dim if compressed else block.shape[1]
            if chunk is None:
                dim = bdim
                chunk = int(chunk_rows) if chunk_rows else rows
                rep.chunk_rows = chunk
                state = self._stream_state(fusion, dim, n_hint, init)
                sig = fusion.state_signature(dim, n_hint)
            elif bdim != dim:
                raise ValueError(
                    f"fuse_stream: block dim {bdim} != stream dim {dim}"
                )
            if rows > chunk:
                raise ValueError(
                    f"fuse_stream: block of {rows} rows exceeds "
                    f"chunk_rows={chunk}"
                )
            rep.ingest_bytes += _nbytes(block)   # pre-padding payload
            dtype = None if compressed else host_dtype(block)
            kind = ("q", block.codes.shape[1], block.block) if compressed \
                else ("d", dtype.str)
            step = steps.get(kind)
            if step is None:
                if compressed:
                    step, compile_s = self._stream_step_q(
                        fusion, chunk, dim, block.codes.shape[1],
                        block.block, sig,
                    )
                else:
                    step, compile_s = self._stream_step(
                        fusion, chunk, dim, dtype, sig,
                    )
                steps[kind] = step
                compile_total += compile_s
                rep.compile_seconds = compile_total
                self.last_compile_seconds = compile_total
            pad = self.strategy == "torch" and rows < chunk
            wt = _block_weights(fusion, w, scale, rows,
                                     chunk if pad else rows)
            t0 = time.perf_counter()
            with sem:
                if compressed:
                    q = to_device(block.codes, dev)
                    s = to_device(block.scales, dev)
                    if pad:
                        q, s = _pad_rows(q, chunk), _pad_rows(s, chunk)
                    state = step(q, s, wt.to(dev), *state)
                else:
                    u = updates_to_device(block, dev)
                    if pad:
                        u = _pad_rows(u, chunk)
                    state = step(u, wt.to(dev), *state)
                if device_sem is not None:
                    synchronize(dev)
            rep.compute_seconds += time.perf_counter() - t0
            rep.n_rows += rows
            rep.n_blocks += 1
        if rep.n_blocks == 0:
            if init is None:
                raise ValueError("fuse_stream: empty block iterator")
            # carry-only round: nothing arrived, finalize the carried state
            state = tuple(self._carried(x, torch.float32) for x in init)
        t0 = time.perf_counter()
        rep.acc_state = tuple(state)
        if fusion.reducible:
            rep.acc_wsum = state[0]
            rep.acc_tot = float(state[1])
        with sem:
            fused = fusion.finalize(state)
            synchronize(dev)
        rep.compute_seconds += time.perf_counter() - t0
        return fused, rep

    def _stream_state(self, fusion, dim, n_hint, init):
        """Fresh (or carried) reducer state as a tuple of device tensors.
        Carried leaves must match the fresh state's shapes."""
        proto = tuple(fusion.init_state(dim, n_hint, device=self.device))
        if init is None:
            return proto
        if len(init) != len(proto):
            raise ValueError(
                f"fuse_stream: carried state has {len(init)} leaves, "
                f"{fusion.name} expects {len(proto)}"
            )
        state = tuple(self._carried(x, p.dtype) for x, p in zip(init, proto))
        for got, want in zip(state, proto):
            if got.shape != want.shape:
                raise ValueError(
                    f"fuse_stream: carried accumulator has dim "
                    f"{tuple(got.shape)}, stream blocks have dim {dim}"
                )
        return state

    def _carried(self, x, dtype) -> torch.Tensor:
        """A carried leaf as a fresh contiguous device tensor: a copy, so
        an in-place fold never writes into the caller's ``init``."""
        x = x if isinstance(x, torch.Tensor) else np.asarray(x)
        return to_device(x, self.device).to(dtype).clone()

    # -- cache introspection (planner reuse term) -----------------------------
    def is_warm(self, fusion, n: int, P: int, dtype) -> bool:
        if not fusion.reducible:
            return False
        row_bytes = np.dtype(dtype).itemsize * P
        if self.memory_cap_bytes is not None:
            max_rows = max(int(self.memory_cap_bytes // max(row_bytes, 1)), 1)
            if max_rows < n:
                return self._scan_key(fusion, n, max_rows, P, dtype) \
                    in self.cache
        return self._dense_key(fusion, n, P, dtype) in self.cache

    def is_warm_stream(self, fusion, chunk: int, P: int, dtype,
                       block: Optional[int] = None,
                       n_hint: Optional[int] = None) -> bool:
        """Warm-path probe for the streamed step. ``dtype`` int8 probes
        the COMPRESSED step at quantization block ``block`` (default
        ``compress.BLOCK``). ``n_hint`` sizes an order-statistic carve's
        state (and so its step key); without it such a fusion cannot
        stream and is never warm."""
        if not fusion.streamable:
            return False
        try:
            sig = fusion.state_signature(P, n_hint)
        except ValueError:   # carve fusion with no n_hint: can't stream
            return False
        if np.dtype(dtype) == np.int8:
            blk = int(block) if block else BLOCK
            Pq = -(-P // blk) * blk
            return self._step_key_q(fusion, chunk, P, Pq, blk, sig) \
                in self.cache
        return self._step_key(fusion, chunk, P, dtype, sig) in self.cache

    # -- internals ------------------------------------------------------------
    def _dense_key(self, fusion, n, P, dtype):
        return ("dense", fusion_cache_key(fusion), self.strategy,
                bucket_rows(n), P, np.dtype(dtype).str)

    def _step_key(self, fusion, chunk, P, dtype, sig):
        return ("stream", fusion_cache_key(fusion), self.strategy,
                chunk, P, np.dtype(dtype).str, sig)

    def _step_key_q(self, fusion, chunk, P, Pq, blk, sig):
        return ("streamq", fusion_cache_key(fusion), self.strategy,
                chunk, P, Pq, blk, sig)

    def _scan_key(self, fusion, n, max_rows, P, dtype):
        # keyed by chunk COUNT, not n: rounds sharing ceil(n/chunk) reuse
        k = -(-n // max_rows)
        return ("streamscan", fusion_cache_key(fusion), self.strategy,
                k, max_rows, P, np.dtype(dtype).str)

    def _make_build(self, step, lib=kernel):
        """The build function of a cached step: the first kernel step of a
        process on the card also builds and loads the CUDA library
        ``lib`` (a kernel module) that the step launches."""
        def build():
            if self.strategy == "kernel" and self.device.type == "cuda":
                lib.build()
            return step

        return build

    def _partial_fn(self, fusion):
        """The stateless 'map' stage: (u, w) -> (wsum (P,), tot)."""
        use_kernel = self.strategy == "kernel" \
            and fusion.name in _KERNEL_WSUM

        def partial(u, w):
            if use_kernel:
                return kernel.weighted_sum(u, w), w.sum()
            return fusion.partial(u, w)

        return partial

    def _fuse_reducible_dense(self, fusion, u, w, dtype, device_sem=None):
        n, P = u.shape
        key = self._dense_key(fusion, n, P, dtype)
        partial = self._partial_fn(fusion)
        # built OUTSIDE the device semaphore (single-flight per key)
        fn, compile_s = self.cache.get(key, self._make_build(partial))
        self.last_compile_seconds = compile_s
        sem = device_sem if device_sem is not None \
            else contextlib.nullcontext()
        with sem:
            wsum, tot = fn(u, w)
            return self._bounded(fusion.combine(wsum, tot), device_sem)

    def _carve_fn(self):
        """The carve injected into an order-statistic fold: the CUDA
        kernel under the kernel strategy (on a CPU tensor its plain
        version), None (the fusion's plain merge) under torch."""
        if self.strategy != "kernel":
            return None

        def carve(u, valid, ssum, topk, botk):
            # a dequantized compressed block is a column slice
            return robust_kernel.topk_carve(u.contiguous(), valid, ssum,
                                            topk, botk)

        return carve

    def _fold_fn(self, fusion, partial):
        """The per-block fold: fusion-owned semantics with this engine's
        kernels injected, and the library the fold launches."""
        if fusion.reducible:
            return (lambda st, payload, w: tuple(
                fusion.fold_block(st, payload, w, partial=partial))), kernel
        carve = self._carve_fn()
        return (lambda st, payload, w: tuple(
            fusion.fold_block(st, payload, w, carve=carve))), robust_kernel

    def _stream_step(self, fusion, chunk, P, dtype, sig):
        """One fold step: (block, w, *state) -> updated state
        (reducible: (wsum, tot); carve: (sum, count, topk, botk))."""
        key = self._step_key(fusion, chunk, P, dtype, sig)
        fold, lib = self._fold_fn(fusion, self._partial_fn(fusion))

        def step(u, w, *state):
            return fold(tuple(state), u, w)

        return self.cache.get(key, self._make_build(step, lib))

    def _partial_q_fn(self, fusion, dim, blk):
        """The 'map' stage for COMPRESSED blocks: (codes (c, Pq) int8,
        scales (c, Pq//blk) fp32, w (c,)) -> (partial wsum (dim,), tot).
        The kernel strategy folds the scales into the weighted sum, so
        the fp32 update matrix never exists; the torch strategy folds
        them into one block-batched contraction for the plain weighted
        sums and dequantizes for the others (ClippedAvg needs row norms).
        """
        use_kernel = self.strategy == "kernel" \
            and fusion.name in _KERNEL_WSUM
        plain_wsum = fusion.name in _KERNEL_WSUM

        def partial_q(q, s, w):
            if use_kernel:
                ws = kernel.weighted_sum_dequant(q, s, w, block=blk)
                return ws[:dim], w.sum()
            c, Pq = q.shape
            B = Pq // blk
            if plain_wsum:
                ws = torch.einsum(
                    "bn,bnk->bk",
                    (w[:, None] * s).T,
                    q.reshape(c, B, blk).transpose(0, 1).float(),
                ).reshape(-1)[:dim]
                return ws, w.sum()
            u = (q.float().reshape(c, B, blk)
                 * s[:, :, None]).reshape(c, Pq)[:, :dim]
            return fusion.partial(u, w)

        return partial_q

    def _stream_step_q(self, fusion, chunk, P, Pq, blk, sig):
        """The compressed twin of ``_stream_step``: (codes, scales, w,
        *state) -> the same carry as the dense step, which is what lets
        mixed dense/compressed rounds share one accumulator. A carve fold
        dequantizes the block on the device first (``dequant_payload``,
        bit-identical to the host dequant), then runs the carve."""
        key = self._step_key_q(fusion, chunk, P, Pq, blk, sig)
        partial_q = self._partial_q_fn(fusion, P, blk)

        def partial(payload, w):
            return partial_q(payload[0], payload[1], w)

        fold, lib = self._fold_fn(fusion, partial)

        def step(q, s, w, *state):
            return fold(tuple(state), (q, s), w)

        return self.cache.get(key, self._make_build(step, lib))

    def _streamed(self, fusion, updates, w, max_rows, dtype,
                  device_sem=None) -> torch.Tensor:
        """Memory-capped dense input: fold fixed (max_rows, P) client
        chunks one at a time — each chunk is copied to the device only
        when its turn comes, so the device holds one chunk at a time."""
        n, P = updates.shape
        key = self._scan_key(fusion, n, max_rows, P, dtype)
        partial = self._partial_fn(fusion)
        dev = self.device

        def scanned(chunks):
            wsum = torch.zeros((P,), dtype=torch.float32, device=dev)
            tot = torch.zeros((), dtype=torch.float32, device=dev)
            for u, wc in chunks:
                ws, t = partial(u, wc)
                wsum += ws
                tot += t
            return wsum, tot

        fn, compile_s = self.cache.get(key, self._make_build(scanned))
        self.last_compile_seconds = compile_s
        chunks = (
            (updates_to_device(updates[i: i + max_rows], dev),
             w[i: i + max_rows])
            for i in range(0, n, max_rows)
        )
        sem = device_sem if device_sem is not None \
            else contextlib.nullcontext()
        with sem:
            wsum, tot = fn(chunks)
            return self._bounded(fusion.combine(wsum, tot), device_sem)
