"""AggregationService — the paper's Algorithm 1 on one GPU: aggregation
rounds in memory or gated on the UpdateStore, synchronous, async or
adaptive.

Round flow (as ``repro.core.service``):
  1. S = w_s * n  -> classify + plan (the planner's roofline model plus a
     reuse term: an engine holding a built step for this round's shape
     is costed below a cold one).
  2. in-memory rounds: updates arrived with the call (IBMFL-style RPC)
     and fuse densely on the card.
  3. store rounds: ``Monitor.wait`` gates on the tenant's partition
     (threshold or timeout), then a streamable fusion STREAMS (chunk, P)
     blocks off the store through one cached fold step — the dense
     (n, P) matrix never exists on the host; each block crosses to the
     card once. An order-statistic fusion streams through the top-k
     carve while its O(K*P) carry fits ``robust_state_budget``, and
     reads dense otherwise, with a ``RoundReport.notes`` entry.
  4. The fused flat vector (fp32, on the service's device) is unflattened
     into the model pytree when a template is given.

ASYNC ROUNDS (``aggregate(from_store=True, async_round=True)``), as in
``repro.core.service``: instead of idling in ``Monitor.wait()`` and only
then ingesting, the round feeds ``UpdateStore.iter_arrivals`` into the
engine's ``fuse_stream`` — blocks are copied to the card and folded WHILE
stragglers are still writing, and the gate decides when the in-flight
stream closes. Folded updates are consumed from the store (queue
semantics, version-checked); stragglers that miss the close land in the
next round. With ``staleness_discount=γ`` the (P,) fp32 carry stays on
the card between rounds, one a tenant: round r starts from γ × round
r−1's sums, and a straggler ``a`` rounds late folds at weight γ^a (the
scales ride in the kernel's block weights). Without it each async round
is independent and equal to the synchronous streamed round.
``async_round="auto"`` lets the planner's overlap model choose.

ADAPTIVE ROUNDS (``AggregationService(adaptive=True, cost_bias=b)``): the
static threshold/timeout gate is replaced per round by the
``repro_torch.core.adaptive`` controller's learned policy for the tenant,
fed by the store's write timestamps at each close. ``save_controller`` /
``load_controller`` persist it as the reference's ``.controller.json``.

Rounds for different tenants may run concurrently on one service; rounds
for the SAME tenant serialize on a per-tenant lock, and device execution
is bounded by the ``device_concurrency`` semaphore, which the engine
holds around each block's copy and fold and waits for under it.

Not yet ported (each raises ``NotImplementedError`` naming its ROADMAP
item): the distributed engines over a mesh and secure aggregation.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import (
    load_controller_state,
    save_controller_state,
)
from repro_torch.core.adaptive import AdaptiveController, ClosePolicy
from repro_torch.core.compress import (
    BLOCK,
    CompressedUpdate,
    ErrorFeedbackCompressor,
    compressed_bytes,
)
from repro_torch.core.fusion import FusionAlgorithm, get_fusion
from repro_torch.core.local import LocalEngine
from repro_torch.core.monitor import Monitor, MonitorResult
from repro_torch.core.planner import Plan, Planner
from repro_torch.core.store import DEFAULT_TENANT, StoreStats, UpdateStore
from repro_torch.core.workload import Workload, WorkloadClass, classify
from repro_torch.utils.device import DeviceLike, resolve_device, synchronize
from repro_torch.utils.dtypes import host_array, host_dtype, updates_to_device
from repro_torch.utils.mem import HardwareSpec, hardware_spec
from repro_torch.utils.pytree import flat_vector_to_tree, tree_to_flat_vector

PyTree = Any


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to repro_torch (ROADMAP, modules to "
        f"port, item {item})"
    )


# Monitor threshold sentinel: no client count can close the gate — the
# round is gated by the timeout alone (async rounds with no expected
# client count).
_TIMEOUT_GATED = 1 << 62


@dataclasses.dataclass
class RoundReport:
    plan: Plan
    n_clients: int
    update_bytes: int
    # wall time of the fusion computation; on async rounds this spans the
    # whole overlapped window (fusing AND waiting ran concurrently)
    fuse_seconds: float
    monitor: Optional[MonitorResult] = None
    route_next_to_store: bool = False
    streamed: bool = False       # True: chunked store pipeline (no dense n,P)
    # ingest (store -> host blocks) / compile (step build; 0.0 on warm
    # rounds) / compute (copy + fold on the device, synced)
    phase_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # seconds of the monitor window during which fusion work proceeded
    # concurrently with the straggler wait (0.0 on serialized rounds)
    overlap_seconds: float = 0.0
    async_round: bool = False    # arrival-driven overlapped round
    empty: bool = False          # monitor timed out with nothing to fuse
    tenant: str = DEFAULT_TENANT
    # the gate that closed this round — source == "learned" once the
    # adaptive controller has enough arrival history for the tenant
    close_policy: Optional[ClosePolicy] = None
    store_stats: Optional[StoreStats] = None
    # payload bytes the fusion ingested (pre-padding): int8 codes + fp32
    # scales on compressed rounds, the dense matrix bytes otherwise
    bytes_ingested: int = 0
    notes: Tuple[str, ...] = ()


class AggregationService:
    """Aggregation rounds on one GPU (or the CPU on request)."""

    def __init__(
        self,
        fusion: FusionAlgorithm | str = "fedavg",
        mesh=None,
        hw: Optional[HardwareSpec] = None,
        local_strategy: str = "kernel",
        store: Optional[UpdateStore] = None,
        threshold_frac: float = 0.8,
        monitor_timeout: float = 30.0,
        memory_cap_bytes: Optional[int] = None,
        stream_chunk_bytes: int = 64 << 20,
        staleness_discount: Optional[float] = None,
        adaptive: bool = False,
        cost_bias: float = 0.5,
        compress: bool | int = False,
        device_concurrency: int = 1,
        secure=None,
        robust_state_budget: int = 64 << 20,
        clock=time.monotonic,
        sleep=time.sleep,
        poll_interval: float = 0.01,
        device: DeviceLike = None,
    ):
        """Configure the service. Arguments as in
        ``repro.core.service.AggregationService``, except:

          local_strategy: ``"kernel"`` (the CUDA kernels, default) or
            ``"torch"`` (the plain PyTorch baseline).
          hw: the planner's hardware spec; by default the H100 data sheet
            with name, memory and SM count read from the card.
          device: where rounds run — the card by default (raises without
            one); ``"cpu"`` only when asked for.
          robust_state_budget: byte cap on an order-statistic fusion's
            streamed carry (the O(K*P) top-k carve buffers); rounds over
            it read dense, with a ``RoundReport.notes`` entry.
          staleness_discount: γ in (0, 1] carries each tenant's
            accumulator between async rounds scaled by γ, and discounts a
            straggler folding ``a`` rounds late to γ^a of its weight;
            needs a weighted fusion.
          adaptive / cost_bias: learn per-tenant arrival curves and close
            rounds on the controller's policy (``self.controller``);
            ``cost_bias`` 0 optimizes round wall-clock, 1 inclusion.
          mesh / secure: not yet ported; each raises
            ``NotImplementedError``.
        """
        if mesh is not None:
            raise _not_ported("the distributed engine over a mesh", "8")
        if secure is not None:
            raise _not_ported("secure aggregation", "5")
        if staleness_discount is not None and not 0 < staleness_discount <= 1:
            raise ValueError("staleness_discount must be in (0, 1] or None")
        self.staleness_discount = staleness_discount
        self.device = resolve_device(device)
        self.fusion = (
            get_fusion(fusion) if isinstance(fusion, str) else fusion
        )
        self.hw = hw if hw is not None else hardware_spec(self.device)
        self.store = store or UpdateStore()
        self.threshold_frac = threshold_frac
        self.monitor_timeout = monitor_timeout
        self.stream_chunk_bytes = stream_chunk_bytes
        self.memory_cap_bytes = memory_cap_bytes
        self.clock = clock
        self.sleep = sleep
        self.poll_interval = poll_interval
        if device_concurrency < 1:
            raise ValueError("device_concurrency must be >= 1")
        self.device_sem = threading.BoundedSemaphore(device_concurrency)
        self._state_lock = threading.Lock()
        self._tenant_locks: Dict[str, threading.Lock] = {}  # guarded-by: _state_lock
        # per-tenant round continuity: tenant -> (wsum, tot) carry on the
        # service's device, tenant -> {straggler id -> rounds late}, and
        # tenant -> last monitor wait (async_round="auto"'s projection)
        self._carry: Dict[str, tuple] = {}  # guarded-by: _state_lock
        self._stale_ages: Dict[str, Dict[str, int]] = {}  # guarded-by: _state_lock
        self._last_wait: Dict[str, float] = {}  # guarded-by: _state_lock
        self.local = LocalEngine(
            strategy=local_strategy, memory_cap_bytes=memory_cap_bytes,
            device=self.device,
        )
        self.planner = Planner(hw=self.hw)
        if not 0 <= cost_bias <= 1:
            raise ValueError("cost_bias must be in [0, 1]")
        self.cost_bias = cost_bias
        if compress is True:
            self.compress_block: Optional[int] = BLOCK
        elif compress:
            if int(compress) < 1:
                raise ValueError("compress block size must be >= 1")
            self.compress_block = int(compress)
        else:
            self.compress_block = None
        self._compressors: Dict[str, ErrorFeedbackCompressor] = {}  # guarded-by: _state_lock
        if self.compress_block is not None and not self.fusion.streamable:
            raise ValueError(
                "compress=True requires a streamable fusion (the dequant "
                f"fold runs inside the streamed step); {self.fusion.name} "
                "is not streamable"
            )
        if staleness_discount is not None and not self.fusion.weighted:
            raise ValueError(
                "staleness_discount requires a weighted fusion; "
                f"{self.fusion.name} folds order statistics that cannot "
                "be discounted"
            )
        if int(robust_state_budget) < 1:
            raise ValueError("robust_state_budget must be >= 1 byte")
        self.robust_state_budget = int(robust_state_budget)
        self.controller: Optional[AdaptiveController] = (
            AdaptiveController(
                cost_bias=cost_bias,
                threshold_frac=threshold_frac,
                timeout=monitor_timeout,
                planner=self.planner,
            ) if adaptive else None
        )
        self.history: List[RoundReport] = []  # guarded-by: _state_lock

    # -- quantized transport --------------------------------------------------
    def compress_update(
        self, client_id: str, update, tenant: str = DEFAULT_TENANT,
    ) -> CompressedUpdate:
        """Quantize one client update for spooling: int8 codes + fp32
        per-block scales, with per-tenant error feedback. Pass the result
        to ``store.write``; requires ``compress=...``."""
        if self.compress_block is None:
            raise ValueError(
                "compress_update needs a compressing service "
                "(AggregationService(compress=True) or =block_size)"
            )
        if getattr(update, "ndim", None) != 1:
            update = tree_to_flat_vector(update)
        with self._state_lock:
            comp = self._compressors.get(tenant)
            if comp is None:
                comp = self._compressors[tenant] = ErrorFeedbackCompressor(
                    block=self.compress_block
                )
        return comp.compress_update(client_id, update)

    # -- streaming knobs ------------------------------------------------------
    def _row_bytes(self, p: int, dtype) -> int:
        """Per-client payload bytes in the store: padded codes + fp32
        scales for int8 quantized updates, dense bytes otherwise."""
        if np.dtype(dtype) == np.int8:
            return compressed_bytes(p, self.compress_block or BLOCK)
        return p * np.dtype(dtype).itemsize

    def _chunk_rows(self, n: int, row_bytes: int) -> int:
        """Rows per streamed block: half the memory cap (two blocks are
        resident under double buffering), else the chunk-size default."""
        budget = (
            self.memory_cap_bytes // 2
            if self.memory_cap_bytes is not None
            else self.stream_chunk_bytes
        )
        return max(1, min(n, int(budget // max(row_bytes, 1))))

    def _stream_mode(
        self, fusion: FusionAlgorithm, p: int, n_hint: int,
    ) -> Tuple[bool, Optional[str]]:
        """Can this round stream, and if not, why not (operator note).
        Reducible fusions always stream (O(P) sum carry). Order-statistic
        fusions stream through the top-k carve iff their projected carry
        — O(K*P) bytes, K from ``n_hint`` — fits ``robust_state_budget``;
        over-budget rounds read dense with a note instead of raising."""
        if not fusion.streamable:
            return False, None
        if fusion.reducible:
            return True, None
        need = fusion.state_nbytes(p, max(int(n_hint), 1))
        if need > self.robust_state_budget:
            return False, (
                f"robust stream fallback: {fusion.name} carve state needs "
                f"{need / (1 << 20):.1f} MiB for n={int(n_hint)}, P={p} "
                f"(budget {self.robust_state_budget / (1 << 20):.1f} MiB) "
                "— routed to the dense path"
            )
        return True, None

    def _warm_engines(self, n: int, p: int, dtype, chunk_rows=None,
                      fusion: Optional[FusionAlgorithm] = None,
                      n_hint: Optional[int] = None):
        """Engines holding a built step for this round's shape — dense
        keys, or (with ``chunk_rows``) the streamed step keys."""
        fusion = fusion if fusion is not None else self.fusion
        if chunk_rows is not None:
            warm = self.local.is_warm_stream(
                fusion, chunk_rows, p, dtype,
                block=self.compress_block or BLOCK, n_hint=n_hint)
        else:
            warm = self.local.is_warm(fusion, n, p, dtype)
        return {"local"} if warm else set()

    def _round_lock(self, tenant: str) -> threading.Lock:
        """The tenant's round-serialization lock (created on first use)."""
        with self._state_lock:
            lock = self._tenant_locks.get(tenant)
            if lock is None:
                lock = self._tenant_locks[tenant] = threading.Lock()
            return lock

    # -- Algorithm 1 ----------------------------------------------------------
    def aggregate(
        self,
        updates: Optional[Sequence[PyTree]] = None,
        weights: Optional[Sequence[float]] = None,
        template: Optional[PyTree] = None,
        expected_clients: Optional[int] = None,
        from_store: bool = False,
        async_round: bool | str = False,
        tenant: str = DEFAULT_TENANT,
        val_grad=None,
    ) -> Tuple[PyTree, RoundReport]:
        """One aggregation round; returns ``(fused, RoundReport)`` with
        ``fused`` an fp32 tensor on the service's device (or the
        ``template`` pytree built from it).

        ``updates`` (+ optional ``weights``): an in-memory round over
        flat vectors or pytrees (tensors or ndarrays). ``from_store``:
        clients wrote to ``tenant``'s store partition; the monitor gates
        on ``expected_clients`` (else the current count). An empty round
        (timeout, nothing landed) returns ``(None, report)`` with
        ``report.empty`` set. ``val_grad`` binds a per-round validation
        gradient (tensor or ndarray) for fusions that score against one
        (Zeno): the round runs on a per-call clone, so concurrent tenants
        never race one fusion's state.

        ``async_round`` (store rounds, streamable fusions) folds arrivals
        while stragglers write: ``True`` forces it, ``"auto"`` defers to
        the planner's overlap model, ``False`` serializes. With
        ``adaptive=True`` on the service the gate is the controller's
        learned policy for ``tenant`` (``report.close_policy``)."""
        with self._round_lock(tenant):
            return self._aggregate_impl(
                updates, weights, template, expected_clients, from_store,
                async_round, tenant, val_grad,
            )

    def _aggregate_impl(
        self,
        updates: Optional[Sequence[PyTree]],
        weights: Optional[Sequence[float]],
        template: Optional[PyTree],
        expected_clients: Optional[int],
        from_store: bool,
        async_round: bool | str,
        tenant: str,
        val_grad=None,
    ) -> Tuple[PyTree, RoundReport]:
        """``aggregate`` body; caller holds the tenant's round lock."""
        fusion = self.fusion
        if val_grad is not None:
            if not hasattr(fusion, "with_val_grad"):
                raise ValueError(
                    f"{fusion.name} does not score against a validation "
                    "gradient — val_grad only applies to Zeno-style "
                    "fusions"
                )
            fusion = fusion.with_val_grad(val_grad)
        dev = self.device
        monitor_result = None
        phase: Dict[str, float] = {}
        notes: Tuple[str, ...] = ()
        policy = arrivals = t_round_store = None
        expected = expected_clients

        if from_store:
            expected = expected_clients or self.store.count(tenant)
            use_async = self._resolve_async(
                async_round, expected, tenant, fusion=fusion,
            )
            threshold = max(int(expected * self.threshold_frac), 1)
            timeout = self.monitor_timeout
            if self.controller is not None and expected > 0:
                # the adaptive gate: the tenant's learned threshold and
                # deadline (static until its arrival curve has history)
                policy = self.controller.policy(tenant, expected)
                threshold, timeout = policy.threshold, policy.deadline
            if use_async and expected == 0:
                # async rounds start before any arrival; with no expected
                # count a threshold of 1 would close on the first client,
                # so the timeout alone gates (monitor.ready stays False)
                threshold = _TIMEOUT_GATED
                policy = None
            monitor = Monitor(
                self.store,
                threshold=threshold,
                timeout=timeout,
                poll_interval=self.poll_interval,
                clock=self.clock, sleep=self.sleep,
                policy=policy,
                tenant=tenant,
            )
            t_round = self.clock()
            # arrival offsets are taken on the STORE's clock (the
            # timestamps' timebase), which may differ from the service's
            # under injected test clocks
            t_round_store = self.store.clock()
            if use_async:
                return self._aggregate_async(
                    monitor, expected, template, tenant, t_round, policy,
                    t_round_store, fusion=fusion,
                )
            monitor_result = monitor.wait()
            # arrival snapshot at close — the controller's training
            # signal; later stragglers belong to the next round's curve
            arrivals = self.store.arrival_times(tenant)
            if self.store.count(tenant) == 0:
                return self._empty_round(monitor_result, tenant=tenant,
                                         expected=expected)
            n, p, dtype = self.store.meta(tenant)
            row_bytes = self._row_bytes(p, dtype)
            chunk_rows = self._chunk_rows(n, row_bytes)
            load = Workload(
                update_bytes=row_bytes, n_clients=n,
                dtype_bytes=dtype.itemsize, params=p,
            )
            n_hint = max(n, expected or 0, 1)
            can_stream, stream_note = self._stream_mode(fusion, p, n_hint)
            notes = (stream_note,) if stream_note else ()
            plan = self.planner.plan(
                load, fusion,
                warm_engines=self._warm_engines(
                    n, p, dtype,
                    chunk_rows=chunk_rows if can_stream else None,
                    fusion=fusion,
                    n_hint=n_hint if can_stream else None,
                ),
            )
            if can_stream:
                t0 = time.perf_counter()
                fused, srep = self.local.fuse_stream(
                    fusion,
                    self.store.iter_chunks(chunk_rows, tenant=tenant),
                    chunk_rows=chunk_rows,
                    device_sem=self.device_sem,
                    n_hint=n_hint,
                )
                dt = time.perf_counter() - t0
                phase = {
                    "ingest": srep.ingest_seconds,
                    "compile": srep.compile_seconds,
                    "compute": srep.compute_seconds,
                }
                return self._finish(
                    fused, template, plan, n, load, dt, monitor_result,
                    expected_clients, True, phase, tenant=tenant,
                    policy=policy, t_round=t_round_store, expected=expected,
                    arrivals=arrivals, ingest_bytes=srep.ingest_bytes,
                    fusion=fusion, notes=notes,
                )
            t0 = time.perf_counter()
            raw, w = self.store.read_stacked(tenant)
        else:
            if updates is None or len(updates) == 0:
                raise ValueError("an in-memory round needs updates")
            t0 = time.perf_counter()
            flat = [
                u if getattr(u, "ndim", None) == 1
                else tree_to_flat_vector(u)
                for u in updates
            ]
            if all(isinstance(f, torch.Tensor) for f in flat):
                raw = torch.stack([f.to(flat[0].device) for f in flat])
            else:
                raw = np.stack([host_array(f) for f in flat])
            w = (
                np.asarray(host_array(weights), np.float32)
                if weights is not None
                else np.ones((len(flat),), np.float32)
            )
        # ingest ends with the rows staged on the host; their copy to
        # the device is timed in compute, as the reference times it
        phase["ingest"] = time.perf_counter() - t0

        # dense path (in-memory round, or a store round that can't
        # stream): one plan against the materialized matrix
        n, p = raw.shape
        raw_dtype = host_dtype(raw)
        load = Workload(update_bytes=p * raw_dtype.itemsize, n_clients=n,
                        dtype_bytes=raw_dtype.itemsize)
        plan = self.planner.plan(
            load, fusion,
            warm_engines=self._warm_engines(n, p, raw_dtype, fusion=fusion),
        )
        t0 = time.perf_counter()
        stacked = updates_to_device(raw, dev)   # one copy to the device
        # the engine holds the semaphore around execution only, so a cold
        # build (outside it, single-flight) never stalls other folds
        fused = self.local.fuse(fusion, stacked, w,
                                device_sem=self.device_sem)
        phase["compile"] = self.local.last_compile_seconds
        synchronize(dev)
        dt = time.perf_counter() - t0
        phase["compute"] = dt - phase["compile"]
        return self._finish(
            fused, template, plan, n, load, dt, monitor_result,
            expected_clients, False, phase, tenant=tenant,
            policy=policy, t_round=t_round_store, expected=expected,
            arrivals=arrivals, ingest_bytes=n * p * raw_dtype.itemsize,
            fusion=fusion, notes=notes,
        )

    # -- async (monitor-overlapped) rounds ------------------------------------
    def _resolve_async(
        self, async_round: bool | str, expected: int,
        tenant: str = DEFAULT_TENANT,
        fusion: Optional[FusionAlgorithm] = None,
    ) -> bool:
        """Decide whether this store round overlaps fusion with the wait.
        Only streamable fusions fold arrivals incrementally; "auto" asks
        the planner whether the expected monitor wait (the tenant's last
        observed wait, else the timeout) dominates the drain residue."""
        fusion = fusion if fusion is not None else self.fusion
        if not async_round or not fusion.streamable:
            return False
        if not fusion.reducible:
            # order-statistic streams size and budget the carve state up
            # front: no known P yet, or over the budget -> the round runs
            # synchronously (dense fallback with a note)
            try:
                _n_now, p, _dtype = self.store.meta(tenant)
            except LookupError:
                return False
            ok, _note = self._stream_mode(fusion, p, max(expected, 1))
            if not ok:
                return False
        if async_round != "auto":
            return True
        with self._state_lock:
            last_wait = self._last_wait.get(tenant)
        expected_wait = (
            last_wait if last_wait is not None else self.monitor_timeout
        )
        try:
            n, p, dtype = self.store.meta(tenant)
        except LookupError:
            # nothing has arrived yet: the wait is all there is, so
            # overlapping it is free
            return True
        n_proj = max(expected, n, 1)
        row_bytes = self._row_bytes(p, dtype)
        load = Workload(
            update_bytes=row_bytes, n_clients=n_proj,
            dtype_bytes=dtype.itemsize, params=p,
        )
        # cost against the warmth the round itself will plan with
        warm = self._warm_engines(
            n_proj, p, dtype,
            chunk_rows=self._chunk_rows(n_proj, row_bytes),
            fusion=fusion, n_hint=n_proj,
        )
        return self.planner.prefer_async(
            load, fusion, expected_wait, warm_engines=warm,
        )

    def _aggregate_async(
        self, monitor: Monitor, expected: int, template,
        tenant: str = DEFAULT_TENANT, t_round: Optional[float] = None,
        policy: Optional[ClosePolicy] = None,
        t_round_store: Optional[float] = None,
        fusion: Optional[FusionAlgorithm] = None,
    ) -> Tuple[PyTree, RoundReport]:
        """Arrival-driven round: fuse while stragglers write. The gate
        closes the stream; folded updates are consumed from the tenant's
        partition; stragglers that miss the close age into the tenant's
        next round."""
        fusion = fusion if fusion is not None else self.fusion
        if t_round is None:
            t_round = monitor.clock()
        if t_round_store is None:
            t_round_store = self.store.clock()
        # learn (P, dtype) from the first arrival — or time out empty
        while True:
            count = self.store.count(tenant)
            waited = monitor.clock() - t_round
            if count > 0 or monitor.should_close(count, waited):
                break
            self.store.wait_for_arrival(monitor.poll_interval,
                                        monitor.sleep)
        if self.store.count(tenant) == 0:
            mr = monitor.result(0, monitor.clock() - t_round)
            return self._empty_round(
                mr, async_round=True, tenant=tenant, expected=expected,
            )
        n_now, p, dtype = self.store.meta(tenant)
        row_bytes = self._row_bytes(p, dtype)
        n_proj = max(expected, n_now, 1)
        chunk_rows = self._chunk_rows(n_proj, row_bytes)
        load = Workload(
            update_bytes=row_bytes, n_clients=n_proj,
            dtype_bytes=dtype.itemsize, params=p,
        )
        plan = self.planner.plan(
            load, fusion,
            warm_engines=self._warm_engines(
                n_proj, p, dtype, chunk_rows=chunk_rows,
                fusion=fusion, n_hint=n_proj,
            ),
        )

        closed_at: Dict[str, float] = {}

        def should_close(count: int, _stream_waited: float) -> bool:
            # waited is measured from ROUND start: the pre-first-arrival
            # poll above is part of the same monitor window
            waited = monitor.clock() - t_round
            done = monitor.should_close(count, waited)
            if done and "waited" not in closed_at:
                closed_at["count"] = count
                closed_at["waited"] = waited
            return done

        gamma = self.staleness_discount
        # the maps are shared across tenant round threads; the tenant's
        # round lock keeps this tenant's entries still for the round
        with self._state_lock:
            ages = self._stale_ages.get(tenant, {})
            carry = self._carry.get(tenant)
        folded: List[str] = []
        folded_versions: Dict[str, int] = {}
        io_stats: Dict[str, float] = {}

        def blocks():
            for block, w, ids in self.store.iter_arrivals(
                chunk_rows, should_close,
                poll_interval=monitor.poll_interval,
                clock=monitor.clock, sleep=monitor.sleep,
                versions_out=folded_versions, stats_out=io_stats,
                tenant=tenant,
            ):
                folded.extend(ids)
                if gamma is not None and ages:
                    scale = np.asarray(
                        [gamma ** ages.get(cid, 0) for cid in ids],
                        np.float32,
                    )
                    yield block, w, scale
                else:
                    yield block, w

        # the discounted carry is a new tensor on the device, and
        # fuse_stream copies it again, so no fold writes into _carry
        init = None
        if gamma is not None and carry is not None:
            init = fusion.discount_state(carry, gamma)
        t0 = time.perf_counter()
        fused, srep = self.local.fuse_stream(
            fusion, blocks(), init=init, chunk_rows=chunk_rows,
            device_sem=self.device_sem, n_hint=n_proj,
        )
        dt = time.perf_counter() - t0

        # arrival snapshot BEFORE the consume drops timestamps
        arrivals = self.store.arrival_times(tenant)
        # queue semantics: what was folded is consumed (version-checked —
        # an update re-written mid-round survives for the next round);
        # what raced past the close stays, one round staler
        self.store.remove(folded, versions=folded_versions, tenant=tenant)
        # the next-age map is built BEFORE taking the state lock:
        # client_ids() takes the store lock, and the declared order
        # (state inner-most) forbids acquiring it under _state_lock
        next_ages = {
            cid: ages.get(cid, 0) + 1
            for cid in self.store.client_ids(tenant)
        }
        with self._state_lock:
            if gamma is not None:
                self._carry[tenant] = srep.acc_state
            self._stale_ages[tenant] = next_ages

        overlap = closed_at.get("waited", 0.0)
        mr = monitor.result(
            int(closed_at.get("count", len(folded))), overlap,
        )
        # the engine's ingest clock times next(it), which here is mostly
        # the idle poll; report the block staging I/O instead (the wait
        # itself is the overlap phase)
        phase = {
            "ingest": io_stats.get("load_seconds", 0.0),
            "compile": srep.compile_seconds,
            "compute": srep.compute_seconds,
            "overlap": overlap,
        }
        return self._finish(
            fused, template, plan, srep.n_rows, load, dt, mr,
            expected, True, phase,
            overlap_seconds=overlap, async_round=True,
            tenant=tenant, policy=policy, t_round=t_round_store,
            expected=expected, arrivals=arrivals,
            ingest_bytes=srep.ingest_bytes, fusion=fusion,
        )

    def _empty_round(
        self, monitor_result: MonitorResult, async_round: bool = False,
        tenant: str = DEFAULT_TENANT, expected: Optional[int] = None,
    ) -> Tuple[None, RoundReport]:
        """Timed-out round with nothing to fuse: a structured report (the
        caller keeps the previous model) instead of a LookupError."""
        if self.controller is not None and expected:
            # an empty window is evidence too: the tenant's attainable
            # fraction decays toward zero
            self.controller.observe_round(tenant, [], expected)
        plan = Plan(
            engine="local", workload_class=WorkloadClass.ONCHIP_RESIDENT,
            est_seconds=0.0, breakdown={}, feasible=True,
            reason="empty round: monitor timed out with no arrivals",
        )
        report = RoundReport(
            plan=plan, n_clients=0, update_bytes=0, fuse_seconds=0.0,
            monitor=monitor_result, route_next_to_store=True,
            streamed=False, phase_seconds={}, async_round=async_round,
            empty=True, tenant=tenant,
            store_stats=self.store.stats_for(tenant),
        )
        with self._state_lock:
            self.history.append(report)
            if monitor_result is not None:
                self._last_wait[tenant] = monitor_result.waited
        return None, report

    # -- round epilogue -------------------------------------------------------
    def _finish(
        self, fused, template, plan, n, load, dt, monitor_result,
        expected_clients, streamed, phase,
        overlap_seconds: float = 0.0, async_round: bool = False,
        tenant: str = DEFAULT_TENANT, policy: Optional[ClosePolicy] = None,
        t_round: Optional[float] = None, expected: Optional[int] = None,
        arrivals: Optional[Dict[str, float]] = None,
        ingest_bytes: int = 0,
        fusion: Optional[FusionAlgorithm] = None,
        notes: Tuple[str, ...] = (),
    ):
        fusion = fusion if fusion is not None else self.fusion
        # §III-D3 seamless transition: if next round's projected load
        # would overflow one card, tell clients to write to the store
        next_load = dataclasses.replace(
            load, n_clients=max(n, expected_clients or n),
        )
        route_next = (
            classify(next_load, self.hw) is WorkloadClass.DISTRIBUTED
            or self.planner.plan(next_load, fusion).engine != "local"
        )
        # feed the round's arrival offsets back into the tenant's learned
        # curve (store-gated rounds only)
        if self.controller is not None and arrivals is not None \
                and t_round is not None:
            offsets = [max(t - t_round, 0.0) for t in arrivals.values()]
            self.controller.observe_round(
                tenant, offsets, expected or n, est_seconds=dt,
            )
        report = RoundReport(
            plan=plan,
            n_clients=n,
            update_bytes=load.update_bytes,
            fuse_seconds=dt,
            monitor=monitor_result,
            route_next_to_store=route_next,
            streamed=streamed,
            phase_seconds=phase,
            overlap_seconds=overlap_seconds,
            async_round=async_round,
            tenant=tenant,
            close_policy=policy,
            store_stats=self.store.stats_for(tenant),
            bytes_ingested=ingest_bytes,
            notes=notes,
        )
        with self._state_lock:
            self.history.append(report)
            if monitor_result is not None:
                self._last_wait[tenant] = monitor_result.waited
        if template is not None:
            return flat_vector_to_tree(fused, template), report
        return fused, report

    # -- controller persistence (restart continuity) --------------------------
    def save_controller(self, path: str) -> str:
        """Persist the adaptive controller's learned state as JSON at
        ``<path>.controller.json`` (the reference package's file, which
        it loads too). Returns the written path. Raises ``ValueError`` on
        a non-adaptive service."""
        if self.controller is None:
            raise ValueError(
                "save_controller needs an adaptive service "
                "(AggregationService(adaptive=True))"
            )
        return save_controller_state(path, self.controller)

    def load_controller(self, path: str) -> None:
        """Restore controller state saved by ``save_controller`` (of
        either package). Raises ``ValueError`` on a non-adaptive
        service."""
        if self.controller is None:
            raise ValueError(
                "load_controller needs an adaptive service "
                "(AggregationService(adaptive=True))"
            )
        load_controller_state(path, self.controller)
