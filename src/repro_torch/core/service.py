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

CONCURRENT ROUND EXECUTION, as in ``repro.core.service``: rounds for
different tenants run concurrently on one service (``RoundScheduler``
keeps one worker thread a tenant; ``FairRoundScheduler`` admits rounds
by weighted-fair virtual time under a running cap and a host-staging
capacity gate); rounds for the SAME tenant serialize on a per-tenant
lock, and device execution is bounded by the ``device_concurrency``
semaphore, which the engine holds around each block's copy and fold and
waits for under it. On the card each tenant's rounds run on the
tenant's own CUDA stream, so two tenants' folds may overlap on the
device (``device_concurrency`` > 1) and one tenant's wait never waits
for another tenant's kernels. The round's stream waits for the
caller's stream before it starts, and the caller's stream waits for
the round's work before ``aggregate`` returns.

SECURE AGGREGATION: ``secure=SecureMasking(...)`` declares that clients
write pairwise-masked updates; the masks cancel only under a plain sum,
so it needs a sum-reducible fusion.

MESH ROUNDS (``mesh=`` a ``torch.distributed`` ``DeviceMesh``, see
``repro_torch.launch.mesh``): the service adds the distributed engine,
and the hierarchical one when the mesh has a "pod" dim, and the planner
costs them beside the local engine, as ``repro.core.service`` does. The
reference is one controller; here every rank of the mesh runs the
service (SPMD), and ranks that disagreed on a round's rows would call
different collectives and hang. So the mesh's first rank alone decides
each round — the monitor's close, the plan, which client ids each block
folds, the staleness scales — and broadcasts it; the other ranks fold
exactly those rows, reading them from the spool they share with it
(the disk backend; ``UpdateStore.read_spooled``), and every rank returns
the same fused vector. Only the first rank consumes folded updates.
Rounds on a mesh run one at a time, in the same order on every rank.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
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
    CompressedBlock,
    CompressedUpdate,
    ErrorFeedbackCompressor,
    compressed_bytes,
)
from repro_torch.core.distributed import DistributedEngine
from repro_torch.core.fusion import FusionAlgorithm, get_fusion
from repro_torch.core.local import LocalEngine
from repro_torch.core.monitor import Monitor, MonitorResult
from repro_torch.core.planner import Plan, Planner
from repro_torch.core.store import DEFAULT_TENANT, StoreStats, UpdateStore
from repro_torch.core.workload import Workload, WorkloadClass, classify
from repro_torch.utils.device import DeviceLike, resolve_device, synchronize
from repro_torch.utils.dtypes import host_array, host_dtype, updates_to_device
from repro_torch.utils.mem import HardwareSpec, hardware_spec
from repro_torch.utils.pytree import (
    flat_vector_to_tree,
    tree_leaves,
    tree_to_flat_vector,
)

PyTree = Any


def _stack_rows(rows) -> object:
    """Updates read from the spool, stacked as ``iter_chunks`` stacks a
    homogeneous block: a (c, P) array or a ``CompressedBlock``."""
    if isinstance(rows[0], CompressedUpdate):
        return CompressedBlock(
            codes=np.stack([r.codes for r in rows]),
            scales=np.stack([r.scales for r in rows]),
            dim=rows[0].dim,
        )
    return np.stack(rows)


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
    # store rounds: the client ids folded, in fold order (on a mesh as
    # its first rank decided them, the same on every rank)
    client_ids: Tuple[str, ...] = ()


class AggregationService:
    """Aggregation rounds on one GPU (or the CPU on request), or over a
    device mesh, one process per device."""

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
          device_concurrency: how many rounds may execute on the device
            at once (a bounded semaphore the engine takes per fold step);
            each tenant's rounds run on the tenant's own CUDA stream, so
            raising it lets tenants' folds overlap on the card.
          secure: a ``repro_torch.core.secure.SecureMasking`` declaring
            that clients write pairwise-masked updates; needs a
            sum-reducible fusion (``ValueError`` otherwise).
          mesh: a ``DeviceMesh`` over the ranks of an initialized
            process group — adds the distributed engine (and, with a
            "pod" dim, the hierarchical one). Every rank of the mesh
            constructs the service and calls ``aggregate`` alike; the
            device then defaults to the rank's card, and store rounds
            need a disk spool the ranks share.
        """
        if staleness_discount is not None and not 0 < staleness_discount <= 1:
            raise ValueError("staleness_discount must be in (0, 1] or None")
        self.staleness_discount = staleness_discount
        self.mesh = mesh
        self.distributed: Optional[DistributedEngine] = None
        self.hierarchical: Optional[DistributedEngine] = None
        n_dev, n_pods = 1, 1
        if mesh is not None:
            self.distributed = DistributedEngine(mesh=mesh, device=device)
            device = self.distributed.device
            sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
            if "pod" in sizes:
                self.hierarchical = DistributedEngine(
                    mesh=mesh, hierarchical=True, device=device)
            n_dev, n_pods = int(mesh.size()), int(sizes.get("pod", 1))
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
        self.device_concurrency = device_concurrency
        self.device_sem = threading.BoundedSemaphore(device_concurrency)
        self._state_lock = threading.Lock()
        self._tenant_locks: Dict[str, threading.Lock] = {}  # guarded-by: _state_lock
        # tenant -> the CUDA stream its rounds run on (the card only)
        self._streams: Dict[str, torch.cuda.Stream] = {}  # guarded-by: _state_lock
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
        self.planner = Planner(hw=self.hw, n_devices=n_dev, n_pods=n_pods)
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
        if secure is not None and not self.fusion.reducible:
            raise ValueError(
                "SecureMasking requires a sum-reducible fusion — pairwise "
                "masks only cancel under summation — and "
                f"{self.fusion.name} is not reducible"
            )
        self.secure = secure
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
        engines = [("local", self.local), ("distributed", self.distributed),
                   ("hierarchical", self.hierarchical)]
        warm = set()
        for name, engine in engines:
            if engine is None:
                continue
            if chunk_rows is not None:
                hit = engine.is_warm_stream(
                    fusion, chunk_rows, p, dtype,
                    block=self.compress_block or BLOCK, n_hint=n_hint)
            else:
                hit = engine.is_warm(fusion, n, p, dtype)
            if hit:
                warm.add(name)
        return warm

    def _stream_engine(self, name: str):
        if name == "hierarchical" and self.hierarchical is not None:
            return self.hierarchical
        if name == "distributed" and self.distributed is not None:
            return self.distributed
        return self.local

    def _round_lock(self, tenant: str) -> threading.Lock:
        """The tenant's round-serialization lock (created on first use)."""
        with self._state_lock:
            lock = self._tenant_locks.get(tenant)
            if lock is None:
                lock = self._tenant_locks[tenant] = threading.Lock()
            return lock

    def _tenant_stream(self, tenant: str) -> Optional[torch.cuda.Stream]:
        """The tenant's CUDA stream (created on first use); None on the
        CPU."""
        if self.device.type != "cuda":
            return None
        with self._state_lock:
            stream = self._streams.get(tenant)
            if stream is None:
                stream = self._streams[tenant] = torch.cuda.Stream(
                    self.device)
            return stream

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
            stream = self._tenant_stream(tenant)
            if stream is None:
                return self._aggregate_impl(
                    updates, weights, template, expected_clients,
                    from_store, async_round, tenant, val_grad,
                )
            # the round's device work runs on the tenant's stream: it
            # starts after what the caller queued (its inputs), and the
            # caller's stream waits for it before the result is read
            caller = torch.cuda.current_stream(self.device)
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                fused, report = self._aggregate_impl(
                    updates, weights, template, expected_clients,
                    from_store, async_round, tenant, val_grad,
                )
            caller.wait_stream(stream)
            # the result's memory was allocated on the tenant's stream:
            # the caching allocator must not hand it to the next round
            # before the caller's stream is done with it
            for leaf in tree_leaves(fused):
                if isinstance(leaf, torch.Tensor):
                    leaf.record_stream(caller)
            return fused, report

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
        if from_store:
            return self._store_round(fusion, expected_clients, async_round,
                                     tenant, template)
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
        phase = {"ingest": time.perf_counter() - t0}
        return self._dense_round(fusion, raw, w, template, phase, None,
                                 expected_clients, tenant)

    def _dense_round(
        self, fusion, raw, w, template, phase, monitor_result,
        expected_clients, tenant, policy=None, t_round=None, expected=None,
        arrivals=None, notes: Tuple[str, ...] = (),
        client_ids: Tuple[str, ...] = (),
    ) -> Tuple[PyTree, RoundReport]:
        """The dense path (in-memory round, or a store round that can't
        stream): one plan against the materialized matrix — on a mesh,
        the first rank's plan — then one fuse."""
        n, p = raw.shape
        raw_dtype = host_dtype(raw)
        load = Workload(update_bytes=p * raw_dtype.itemsize, n_clients=n,
                        dtype_bytes=raw_dtype.itemsize)
        plan = self.planner.plan(
            load, fusion,
            warm_engines=self._warm_engines(n, p, raw_dtype, fusion=fusion),
        )
        if self.distributed is not None:
            plan = self.distributed.broadcast(plan)
        t0 = time.perf_counter()
        fused, phase["compile"] = self._fuse_dense(plan, fusion, raw, w)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        phase["compute"] = dt - phase["compile"]
        return self._finish(
            fused, template, plan, n, load, dt, monitor_result,
            expected_clients, False, phase, tenant=tenant,
            policy=policy, t_round=t_round, expected=expected,
            arrivals=arrivals, ingest_bytes=n * p * raw_dtype.itemsize,
            fusion=fusion, notes=notes, client_ids=client_ids,
        )

    def _fuse_dense(self, plan: Plan, fusion, raw, w):
        """(fused, build seconds) of a dense round on the plan's engine."""
        if plan.engine == "local":
            stacked = updates_to_device(raw, self.device)  # one copy
            # the engine holds the semaphore around execution only, so a
            # cold build (outside it, single-flight) never stalls others
            fused = self.local.fuse(fusion, stacked, w,
                                    device_sem=self.device_sem)
            return fused, self.local.last_compile_seconds
        if plan.engine == "hierarchical" and self.hierarchical is not None:
            engine = self.hierarchical
        else:
            assert self.distributed is not None, (
                "planner chose the distributed engine but no mesh was given"
            )
            engine = self.distributed
        # each rank copies only its shard to its device; the mesh engines
        # build inside their fuse paths, so a cold dense mesh round holds
        # the semaphore through its build
        with self.device_sem:
            fused = engine.fuse(fusion, raw, w)
            synchronize(self.device)  # lint: disable=sync-under-sem -- deliberate: the permit must cover device EXECUTION, not just dispatch, or device_concurrency would not bound real device work
        return fused, engine.last_compile_seconds

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

    # -- store rounds: decide, then fold (on a mesh: the first rank decides) --
    def _store_round(
        self, fusion: FusionAlgorithm, expected_clients: Optional[int],
        async_round: bool | str, tenant: str, template,
    ) -> Tuple[PyTree, RoundReport]:
        """A store round: ``_decide_round`` gates and plans it, then the
        plan's engine folds the decided blocks. On a mesh only the first
        rank decides; the decision reaches the others by broadcast."""
        eng = self.distributed
        monitor = decision = None
        if eng is None or eng.is_root:
            monitor, decision = self._decide_round(
                fusion, expected_clients, async_round, tenant)
        if eng is not None:
            decision = eng.broadcast(decision)
        if decision["kind"] == "empty":
            return self._empty_round(
                decision["monitor"], async_round=decision["async"],
                tenant=tenant, expected=decision["expected"],
            )
        if decision["kind"] == "async":
            return self._async_round(fusion, decision, monitor, tenant,
                                     template)
        return self._sync_round(fusion, decision, expected_clients, tenant,
                                template)

    def _decide_round(self, fusion, expected_clients, async_round, tenant):
        """(monitor, decision): the gate; for a synchronous round the wait,
        the stream-or-dense choice, the chunking and the plan; for an
        async round the wait for the first arrival and the plan."""
        expected = expected_clients or self.store.count(tenant)
        use_async = self._resolve_async(async_round, expected, tenant,
                                        fusion=fusion)
        threshold = max(int(expected * self.threshold_frac), 1)
        timeout = self.monitor_timeout
        policy = None
        if self.controller is not None and expected > 0:
            # the adaptive gate: the tenant's learned threshold and
            # deadline (static until its arrival curve has history)
            policy = self.controller.policy(tenant, expected)
            threshold, timeout = policy.threshold, policy.deadline
        if use_async and expected == 0:
            # async rounds start before any arrival; with no expected
            # count a threshold of 1 would close on the first client, so
            # the timeout alone gates (monitor.ready stays False)
            threshold = _TIMEOUT_GATED
            policy = None
        monitor = Monitor(
            self.store, threshold=threshold, timeout=timeout,
            poll_interval=self.poll_interval, clock=self.clock,
            sleep=self.sleep, policy=policy, tenant=tenant,
        )
        t_round = self.clock()
        # arrival offsets are taken on the STORE's clock (the timestamps'
        # timebase), which may differ from the service's under injected
        # test clocks
        base = {"expected": expected, "policy": policy, "async": use_async,
                "t_round": t_round, "t_round_store": self.store.clock()}
        if use_async:
            while True:   # learn (P, dtype) from the first arrival
                count = self.store.count(tenant)
                if count > 0 or monitor.should_close(
                        count, monitor.clock() - t_round):
                    break
                self.store.wait_for_arrival(monitor.poll_interval,
                                            monitor.sleep)
            if self.store.count(tenant) == 0:
                return monitor, dict(base, kind="empty", monitor=monitor
                                     .result(0, monitor.clock() - t_round))
            n_now, p, dtype = self.store.meta(tenant)
            n = max(expected, n_now, 1)
            can_stream, notes = True, ()
        else:
            base["monitor"] = monitor.wait()
            # arrival snapshot at close — the controller's training
            # signal; later stragglers belong to the next round's curve
            base["arrivals"] = self.store.arrival_times(tenant)
            if self.store.count(tenant) == 0:
                return monitor, dict(base, kind="empty")
            n, p, dtype = self.store.meta(tenant)
            can_stream, note = self._stream_mode(
                fusion, p, max(n, expected or 0, 1))
            notes = (note,) if note else ()
        row_bytes = self._row_bytes(p, dtype)
        chunk_rows = self._chunk_rows(n, row_bytes)
        n_hint = max(n, expected or 0, 1)
        load = Workload(update_bytes=row_bytes, n_clients=n,
                        dtype_bytes=dtype.itemsize, params=p)
        plan = self.planner.plan(
            load, fusion,
            warm_engines=self._warm_engines(
                n, p, dtype, chunk_rows=chunk_rows if can_stream else None,
                fusion=fusion, n_hint=n_hint if can_stream else None,
            ),
        )
        return monitor, dict(
            base, kind="async" if use_async else "sync", n=n, load=load,
            chunk_rows=chunk_rows, n_hint=n_hint, can_stream=can_stream,
            notes=notes, plan=plan,
        )

    def _relay(self, source, tenant: str, folded: List[str], end: Dict,
               end_fn=None):
        """A round's blocks, ``(payload, w[, scale])``, drawn from
        ``source``'s ``(payload, w, ids, scale)``; ``folded`` gets the ids
        in order and ``end`` what ``end_fn()`` returns once the blocks are
        done. On a mesh the first rank draws them and broadcasts each
        block's ids, weights and scales, and ``end``; the other ranks
        (``source`` None) read the same rows from the shared spool."""
        eng = self.distributed
        if eng is None or eng.is_root:
            for payload, w, ids, scale in source:
                if eng is not None:
                    eng.broadcast(("block", list(ids),
                                   np.asarray(w, np.float32), scale))
                folded.extend(ids)
                yield (payload, w) if scale is None else (payload, w, scale)
            info = end_fn() if end_fn is not None else {}
            end.update(eng.broadcast(("end", info))[1] if eng is not None
                       else info)
            return
        while True:
            msg = eng.broadcast(None)
            if msg[0] == "end":
                end.update(msg[1])
                return
            _, ids, w, scale = msg
            folded.extend(ids)
            payload = _stack_rows(
                [self.store.read_spooled(cid, tenant) for cid in ids])
            yield (payload, w) if scale is None else (payload, w, scale)

    def _sync_round(self, fusion, d, expected_clients, tenant, template):
        """A synchronous store round: the plan's engine streams the
        snapshot's blocks, or the dense path fuses them stacked."""
        plan, n, load = d["plan"], d["n"], d["load"]
        folded: List[str] = []
        source = None
        if self.distributed is None or self.distributed.is_root:
            # zero-materialization pipeline: (chunk, P) blocks flow from
            # the store into the engine; the dense path stacks one block
            # a payload kind (as ``read_stacked``)
            rows = d["chunk_rows"] if d["can_stream"] else 1 << 62
            source = ((payload, w, ids, None) for payload, w, ids
                      in self.store.iter_chunk_ids(
                          rows, prefetch=d["can_stream"], tenant=tenant))
        blocks = self._relay(source, tenant, folded, {})
        common = dict(tenant=tenant, policy=d["policy"],
                      t_round=d["t_round_store"], expected=d["expected"],
                      arrivals=d["arrivals"], notes=d["notes"])
        if not d["can_stream"]:
            t0 = time.perf_counter()
            ups, ws = [], []
            for block, w in blocks:
                if isinstance(block, CompressedBlock):
                    block = block.dequantize()
                ups.append(block)
                ws.append(w)
            phase = {"ingest": time.perf_counter() - t0}
            return self._dense_round(
                fusion, np.concatenate(ups), np.concatenate(ws), template,
                phase, d["monitor"], expected_clients,
                client_ids=tuple(folded), **common)
        engine = self._stream_engine(plan.engine)
        t0 = time.perf_counter()
        fused, srep = engine.fuse_stream(
            fusion, blocks, chunk_rows=d["chunk_rows"],
            device_sem=self.device_sem, n_hint=d["n_hint"],
        )
        dt = time.perf_counter() - t0
        phase = {
            "ingest": srep.ingest_seconds,
            "compile": srep.compile_seconds,
            "compute": srep.compute_seconds,
        }
        return self._finish(
            fused, template, plan, n, load, dt, d["monitor"],
            expected_clients, True, phase, ingest_bytes=srep.ingest_bytes,
            fusion=fusion, client_ids=tuple(folded), **common,
        )

    def _async_round(self, fusion, d, monitor, tenant, template):
        """Arrival-driven round: fuse while stragglers write. The gate
        closes the stream; folded updates are consumed from the tenant's
        partition; stragglers that miss the close age into the tenant's
        next round. On a mesh the first rank streams the arrivals, with
        their staleness scales, and consumes; the carry stays on every
        rank."""
        plan, load, chunk_rows = d["plan"], d["load"], d["chunk_rows"]
        engine = self._stream_engine(plan.engine)
        gamma = self.staleness_discount
        # the maps are shared across tenant round threads; the tenant's
        # round lock keeps this tenant's entries still for the round
        with self._state_lock:
            ages = self._stale_ages.get(tenant, {})
            carry = self._carry.get(tenant)
        folded: List[str] = []
        end: Dict[str, Any] = {}
        source = end_fn = None
        versions: Dict[str, int] = {}
        lead = self.distributed is None or self.distributed.is_root
        if lead:
            t_round = d["t_round"]
            closed_at: Dict[str, float] = {}
            io_stats: Dict[str, float] = {}

            def should_close(count: int, _stream_waited: float) -> bool:
                # waited is measured from ROUND start: the pre-first-
                # arrival poll is part of the same monitor window
                waited = monitor.clock() - t_round
                done = monitor.should_close(count, waited)
                if done and "waited" not in closed_at:
                    closed_at["count"] = count
                    closed_at["waited"] = waited
                return done

            def arrivals():
                for block, w, ids in self.store.iter_arrivals(
                    chunk_rows, should_close,
                    poll_interval=monitor.poll_interval,
                    clock=monitor.clock, sleep=monitor.sleep,
                    versions_out=versions, stats_out=io_stats,
                    tenant=tenant,
                ):
                    scale = None
                    if gamma is not None and ages:
                        scale = np.asarray(
                            [gamma ** ages.get(cid, 0) for cid in ids],
                            np.float32)
                    yield block, w, ids, scale

            def end_fn():
                waited = closed_at.get("waited", 0.0)
                return {
                    "overlap": waited,
                    "monitor": monitor.result(
                        int(closed_at.get("count", len(folded))), waited),
                    # the arrival snapshot BEFORE the consume drops
                    # timestamps
                    "arrivals": self.store.arrival_times(tenant),
                    # the engine's ingest clock times next(it), here
                    # mostly the idle poll: report the block staging I/O
                    # (the wait itself is the overlap phase)
                    "load_seconds": io_stats.get("load_seconds", 0.0),
                }

            source = arrivals()
        # the discounted carry is a new tensor on the device, and
        # fuse_stream copies it again, so no fold writes into _carry
        init = None
        if gamma is not None and carry is not None:
            init = fusion.discount_state(carry, gamma)
        t0 = time.perf_counter()
        fused, srep = engine.fuse_stream(
            fusion, self._relay(source, tenant, folded, end, end_fn),
            init=init, chunk_rows=chunk_rows, device_sem=self.device_sem,
            n_hint=d["n"],
        )
        dt = time.perf_counter() - t0
        next_ages: Dict[str, int] = {}
        if lead:
            # queue semantics: what was folded is consumed (version-
            # checked — an update re-written mid-round survives for the
            # next round); what raced past the close stays, one round
            # staler. The next-age map is built BEFORE taking the state
            # lock: client_ids() takes the store lock, and the declared
            # order (state inner-most) forbids acquiring it under
            # _state_lock
            self.store.remove(folded, versions=versions, tenant=tenant)
            next_ages = {cid: ages.get(cid, 0) + 1
                         for cid in self.store.client_ids(tenant)}
        with self._state_lock:
            if gamma is not None:
                self._carry[tenant] = srep.acc_state
            self._stale_ages[tenant] = next_ages
        phase = {
            "ingest": end["load_seconds"],
            "compile": srep.compile_seconds,
            "compute": srep.compute_seconds,
            "overlap": end["overlap"],
        }
        return self._finish(
            fused, template, plan, srep.n_rows, load, dt, end["monitor"],
            d["expected"], True, phase, overlap_seconds=end["overlap"],
            async_round=True, tenant=tenant, policy=d["policy"],
            t_round=d["t_round_store"], expected=d["expected"],
            arrivals=end["arrivals"], ingest_bytes=srep.ingest_bytes,
            fusion=fusion, client_ids=tuple(folded),
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
        client_ids: Tuple[str, ...] = (),
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
            client_ids=client_ids,
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


class RoundScheduler:
    """Concurrent round execution for N tenants on ONE service, as
    ``repro.core.service.RoundScheduler``.

    One daemon worker thread a tenant (created on first ``submit``);
    same-tenant rounds queue FIFO behind it, so the service's per-tenant
    round lock never blocks a worker. Rounds for different tenants
    overlap their monitor waits and host staging, each on its tenant's
    CUDA stream, while device execution is bounded by the service's
    ``device_concurrency`` semaphore. Starvation control is the store's
    per-tenant quota (``store.set_quota``).

    Use as a context manager::

        with RoundScheduler(service) as sched:
            futs = [sched.submit(t, from_store=True, async_round=True,
                                 expected_clients=48)
                    for t in ("appA", "appB", "appC")]
            results = [f.result() for f in futs]   # (fused, report)

    or one fan-out-and-wait cycle with ``run_round([...])``. Futures
    carry an ``aggregate`` failure as their exception; shutdown drains
    queued rounds before the workers exit, and joins them."""

    def __init__(self, service: AggregationService):
        self.service = service
        self._lock = threading.Lock()
        self._queues: Dict[str, "queue.Queue"] = {}  # guarded-by: _lock
        self._threads: Dict[str, threading.Thread] = {}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock

    def submit(
        self, tenant: str = DEFAULT_TENANT, **aggregate_kwargs
    ) -> "Future":
        """Enqueue one ``service.aggregate(tenant=..., **kwargs)`` round
        on the tenant's worker; returns a ``concurrent.futures.Future``
        resolving to ``(fused, RoundReport)``."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("RoundScheduler is shut down")
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = queue.Queue()
                t = threading.Thread(
                    target=self._worker, args=(q,),
                    name=f"round-scheduler:{tenant}", daemon=True,
                )
                self._threads[tenant] = t
                t.start()
            # enqueue under the lock: a put after shutdown()'s None
            # sentinel would land on a queue no worker reads and the
            # future would never resolve
            q.put((fut, tenant, aggregate_kwargs))
        return fut

    def run_round(
        self, tenants: Sequence[str], **aggregate_kwargs
    ) -> Dict[str, Tuple[PyTree, RoundReport]]:
        """One concurrent fan-out: submit a round for every tenant, wait
        for all, return ``{tenant: (fused, report)}``."""
        futs = {t: self.submit(t, **aggregate_kwargs) for t in tenants}
        return {t: f.result() for t, f in futs.items()}

    def _worker(self, q: "queue.Queue") -> None:
        while True:
            item = q.get()
            if item is None:
                return
            fut, tenant, kwargs = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(
                    self.service.aggregate(tenant=tenant, **kwargs)
                )
            except BaseException as exc:
                fut.set_exception(exc)

    def tenants(self) -> List[str]:
        """Tenants with a live worker."""
        with self._lock:
            return sorted(self._threads)

    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting rounds; each worker drains its queue and
        exits. With ``wait`` (default) blocks until they have."""
        with self._lock:
            if not self._closed:
                self._closed = True
                for q in self._queues.values():
                    q.put(None)
            threads = list(self._threads.values())
        if wait:
            for t in threads:
                t.join()

    def __enter__(self) -> "RoundScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


class FairRoundScheduler:
    """Waiting / running round admission for N tenants on ONE service,
    as ``repro.core.service.FairRoundScheduler``: submitted rounds join a
    per-tenant WAITING queue, and one admission loop moves them to
    RUNNING under a concurrency cap.

      * ``max_running`` bounds rounds in flight;
      * the next tenant is picked by weighted fair queuing: each tenant's
        virtual time advances by ``1 / weight`` an admitted round, the
        eligible tenant with the smallest (vtime, name) goes next, and an
        idle tenant's vtime is clamped forward to the running tenants'
        minimum on admission (the WFQ no-credit rule);
      * capacity: a round whose projected host-staging footprint (two
        streamed chunks, from the store partition's live ``meta``) does
        not fit ``capacity_bytes`` beside the running rounds' waits,
        EXCEPT when nothing runs (a too-big round runs alone rather than
        deadlock);
      * one round a tenant in flight: same-tenant submissions queue FIFO.

    Use exactly like ``RoundScheduler``."""

    def __init__(
        self,
        service: AggregationService,
        max_running: int = 2,
        weights: Optional[Dict[str, float]] = None,
        capacity_bytes: Optional[int] = None,
    ):
        if max_running < 1:
            raise ValueError("max_running must be >= 1")
        self.service = service
        self.max_running = int(max_running)
        self.capacity_bytes = capacity_bytes
        self._weights = dict(weights or {})
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._waiting: Dict[str, "queue.SimpleQueue"] = {}  # guarded-by: _lock
        self._waiting_count: Dict[str, int] = {}  # guarded-by: _lock
        self._running: Dict[str, int] = {}  # guarded-by: _lock
        self._vtime: Dict[str, float] = {}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._drained = False  # guarded-by: _lock
        self._admission_order: List[str] = []  # guarded-by: _lock
        self._workers: List[threading.Thread] = []  # guarded-by: _lock
        self._loop = threading.Thread(
            target=self._admission_loop, name="fair-scheduler",
            daemon=True,
        )
        self._loop.start()

    # -- submission ----------------------------------------------------------
    def submit(
        self, tenant: str = DEFAULT_TENANT, **aggregate_kwargs
    ) -> "Future":
        """Queue one round; returns a Future resolving to
        ``(fused, RoundReport)`` once the round is admitted AND run."""
        fut: Future = Future()
        with self._wake:
            if self._closed:
                raise RuntimeError("FairRoundScheduler is shut down")
            q = self._waiting.get(tenant)
            if q is None:
                q = self._waiting[tenant] = queue.SimpleQueue()
            q.put((fut, aggregate_kwargs))
            self._waiting_count[tenant] = (
                self._waiting_count.get(tenant, 0) + 1
            )
            self._wake.notify_all()
        return fut

    def run_round(
        self, tenants: Sequence[str], **aggregate_kwargs
    ) -> Dict[str, Tuple[PyTree, RoundReport]]:
        """One fair fan-out: submit a round per tenant, wait for all."""
        futs = {t: self.submit(t, **aggregate_kwargs) for t in tenants}
        return {t: f.result() for t, f in futs.items()}

    # -- admission -----------------------------------------------------------
    def _footprint(self, tenant: str) -> int:
        """Projected host-staging bytes of the tenant's next round: two
        streamed chunks (double buffering), sized from the LIVE store
        partition; an empty partition projects 0."""
        store = getattr(self.service, "store", None)
        if store is None:
            return 0
        try:
            n, p, dtype = store.meta(tenant)
        except LookupError:
            return 0
        row = self.service._row_bytes(p, dtype)
        rows = self.service._chunk_rows(n, row)
        return 2 * rows * row

    def _eligible_locked(self) -> Optional[str]:
        """The weighted-fair pick among tenants with waiting rounds,
        honoring the running cap, one-in-flight-per-tenant and the
        capacity gate. Caller holds ``self._lock``."""
        if len(self._running) >= self.max_running:
            return None
        used = sum(self._running.values())
        best: Optional[Tuple[float, str]] = None
        for tenant, count in self._waiting_count.items():
            if count <= 0 or tenant in self._running:
                continue
            vt = self._vtime.get(tenant, 0.0)
            if best is None or (vt, tenant) < best:
                # only the current best is probed: the footprint reads
                # the store index
                fp = self._footprint(tenant)
                if self.capacity_bytes is not None and self._running \
                        and used + fp > self.capacity_bytes:
                    continue
                best = (vt, tenant)
        return best[1] if best else None

    def _admission_loop(self) -> None:
        while True:
            with self._wake:
                tenant = self._eligible_locked()
                while tenant is None:
                    if self._closed and not any(
                        c > 0 for c in self._waiting_count.values()
                    ) and not self._running:
                        self._drained = True
                        self._wake.notify_all()
                        return
                    self._wake.wait(timeout=0.5)
                    tenant = self._eligible_locked()
                fut, kwargs = self._waiting[tenant].get_nowait()
                self._waiting_count[tenant] -= 1
                self._running[tenant] = self._footprint(tenant)
                # WFQ no-credit rule: an idle tenant resumes at the
                # current virtual time, not at zero
                floor = min(
                    (self._vtime[t] for t in self._running
                     if t in self._vtime), default=0.0,
                )
                vt = max(self._vtime.get(tenant, 0.0), floor)
                weight = max(self._weights.get(tenant, 1.0), 1e-9)
                self._vtime[tenant] = vt + 1.0 / weight
                self._admission_order.append(tenant)
            worker = threading.Thread(
                target=self._run_one, args=(tenant, fut, kwargs),
                name=f"fair-round:{tenant}", daemon=True,
            )
            # tracked so shutdown() can join them: a drained queue only
            # means each worker left _running, not that it has exited
            with self._wake:
                self._workers = [w for w in self._workers if w.is_alive()]
                self._workers.append(worker)
            worker.start()

    def _run_one(self, tenant: str, fut: "Future", kwargs: dict) -> None:
        try:
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(
                        self.service.aggregate(tenant=tenant, **kwargs)
                    )
                except BaseException as exc:
                    fut.set_exception(exc)
        finally:
            with self._wake:
                self._running.pop(tenant, None)
                self._wake.notify_all()

    # -- introspection / shutdown --------------------------------------------
    def running(self) -> List[str]:
        """Tenants with an admitted round in flight."""
        with self._lock:
            return sorted(self._running)

    def waiting(self) -> Dict[str, int]:
        """Waiting round count per tenant."""
        with self._lock:
            return {t: c for t, c in self._waiting_count.items() if c}

    def admission_order(self) -> List[str]:
        """Tenants in admission order (the fairness audit trail)."""
        with self._lock:
            return list(self._admission_order)

    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting submissions; drain waiting rounds, then stop
        the admission loop. ``wait`` blocks until drained and joins the
        loop and every round worker."""
        with self._wake:
            self._closed = True
            self._wake.notify_all()
        if wait:
            with self._wake:
                while not self._drained:
                    self._wake.wait(timeout=0.5)
                workers = list(self._workers)
                self._workers = []
            self._loop.join()
            for worker in workers:
                worker.join()

    def __enter__(self) -> "FairRoundScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
