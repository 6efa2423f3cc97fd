"""Distributed aggregation engine: the paper's Spark-MapReduce path
(§III-D2), the port of ``repro.core.distributed`` to ``torch.distributed``.

The reference is one controller driving ``shard_map`` over a TPU mesh;
here every rank of a ``DeviceMesh`` (``repro_torch.launch.mesh``) runs
the same program on its own device — NCCL between cards, gloo on the
CPU — holds its own shard and calls the collectives itself. The layouts
are the reference's (mesh axes: optional "pod", "data", "model"):

  * reducible fusions: updates (n, P) split over (client axes, "model").
        map    = the rank's partial weighted sum, through the port's
                 ``weighted_sum`` kernel as ``LocalEngine`` routes it,
        reduce = all-reduce over the client axes (one per axis, the
                 innermost first, when ``hierarchical``).
  * coordinate-wise: an all-to-all over each client axis re-shards
        clients -> coordinates (Spark's shuffle before a per-key
        reduce); padding rows are dropped by the real n and the rank's
        columns go through the ``trimmed_mean`` / ``coord_median``
        kernels. Output layout ("model", client axes...).
  * Krum / Zeno / GeoMedian: every rank holds all rows of a column slice
        (client axes..., "model"); the Gram matrix, Zeno's inner
        products and norms, and Weiszfeld's distances are all-reduced
        over all axes; selection is the port's ``select_from_gram`` /
        ``scores``.

``fuse`` and ``fuse_stream`` return the whole (P,) fp32 vector on every
rank, gathered over the output layout — what ``np.asarray`` of the
reference's sharded result gives. Every rank must call them with the
same inputs (or the same block sequence) in the same order: each call
issues collectives, which hang, then time out after ``timeout`` seconds,
when ranks disagree. Built steps live in a ``CompiledCache`` under the
reference's keys (power-of-two row buckets for reducible fusions, P
padded to the shard multiple), so cold rounds report a compile phase and
warm rounds 0.0.

``fuse_stream`` folds (chunk, P) blocks (``UpdateStore.iter_chunks``, or
the service's arrival stream) into the carry the rank holds: the sum
path splits blocks over (client axes, "model") and all-reduces each
block's partial; the carve path holds all rows of a column slice and
carves them locally through ``topk_carve``, with no collective. A
compressed block is staged at its compressed size and, where the rank's
column slice starts on a quantization block, folds through
``weighted_sum_dequant``; otherwise the rank dequantizes its slice on
the device and folds it through ``weighted_sum``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import threading
import time
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.compress import BLOCK, CompressedBlock
from repro_torch.core.fusion.base import FusionAlgorithm
from repro_torch.core.fusion.robust import GeometricMedian, Krum, Zeno, _lowest
from repro_torch.core.local import (
    _KERNEL_WSUM,
    StreamReport,
    _block_weights,
    _check_scale,
    _host_weights,
    _nbytes,
)
from repro_torch.kernels.fused_fusion import kernel
from repro_torch.kernels.robust_fusion import kernel as robust_kernel
from repro_torch.utils.device import DeviceLike, resolve_device, synchronize
from repro_torch.utils.dtypes import host_dtype, to_device, updates_to_device
from repro_torch.utils.jitcache import CompiledCache, bucket_rows, fusion_cache_key


@dataclasses.dataclass(frozen=True)
class _Group:
    """A process group over mesh axes and its members' global ranks in
    group-rank order."""

    group: object
    ranks: Tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.ranks)


# mesh -> {(partition, timeout): _Group}: engines on one mesh (the service's
# flat and hierarchical ones) share their groups. Keyed by id, checked
# through a weak reference, so a new mesh never meets a dead mesh's groups.
_GROUPS_LOCK = threading.Lock()
_MESH_GROUPS: Dict[int, Tuple[weakref.ref, Dict[tuple, _Group]]] = {}  # guarded-by: _GROUPS_LOCK


def _mesh_groups(mesh) -> Dict[tuple, _Group]:
    with _GROUPS_LOCK:
        entry = _MESH_GROUPS.get(id(mesh))
        if entry is None or entry[0]() is not mesh:
            entry = (weakref.ref(mesh), {})
            _MESH_GROUPS[id(mesh)] = entry
        return entry[1]


@dataclasses.dataclass(frozen=True)
class _QSlice:
    """A rank's share of a compressed block on the device: codes (r, nb *
    blk) int8 and scales (r, nb) fp32 of the quantization blocks that
    cover its columns, which start ``start`` columns into the first;
    ``width`` real columns of the rank's ``cols``."""

    codes: torch.Tensor
    scales: torch.Tensor
    blk: int
    start: int
    width: int
    cols: int


def _dequant_slice(qs: _QSlice) -> torch.Tensor:
    """The rank's columns of a compressed block as a dense (r, cols) fp32
    tensor, zero past ``width``."""
    r, nb = qs.scales.shape
    u = (qs.codes.float().reshape(r, nb, qs.blk)
         * qs.scales[:, :, None]).reshape(r, nb * qs.blk)
    u = u[:, qs.start: qs.start + qs.width]
    if qs.width < qs.cols:
        u = torch.nn.functional.pad(u, (0, qs.cols - qs.width))
    return u.contiguous()


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) \
        else tuple(np.shape(x))


@dataclasses.dataclass
class DistributedEngine:
    """Map-reduce fusion over a device mesh, one process per device."""

    mesh: object
    client_axes: Tuple[str, ...] = ("data",)
    param_axis: str = "model"
    hierarchical: bool = False   # reduce within the pod first, then across
    name: str = "distributed"
    device: DeviceLike = None    # the rank's card by default
    timeout: float = 300.0       # seconds a collective may wait for a peer

    def __post_init__(self):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("DistributedEngine needs an initialized "
                               "default process group")
        mesh = self.mesh
        names = tuple(mesh.mesh_dim_names)
        self._names = names
        self._layout = mesh.mesh.cpu().numpy()
        self._sizes = dict(zip(names, self._layout.shape))
        self.client_axes = tuple(a for a in self.client_axes if a in names)
        if "pod" in names and "pod" not in self.client_axes:
            # pods shard clients too (each pod's edge aggregates its region)
            self.client_axes = ("pod",) + self.client_axes
        self._n_client_shards = int(
            np.prod([self._sizes[a] for a in self.client_axes]))
        self._n_param_shards = int(self._sizes.get(self.param_axis, 1))
        self._param = (self.param_axis,) if self.param_axis in names else ()
        self._all_axes = tuple(self.client_axes) + self._param
        self.device = self._resolve_device(self.device)
        rank = dist.get_rank()
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {rank} is not in the mesh")
        self._coord = dict(zip(names, (int(c) for c in coord)))
        self._root = int(self._layout.reshape(-1)[0])
        self._cshard = self._flat_index(self._coord, self.client_axes)
        self._pshard = self._coord.get(self.param_axis, 0)
        self._g_client = self._group(self.client_axes)
        self._g_param = self._group(self._param)
        self._g_all = self._group(self._all_axes)
        self._g_axis = {a: self._group((a,)) for a in self.client_axes}
        for a, g in self._g_axis.items():
            if [self._coord_of(r)[a] for r in g.ranks] != list(range(g.size)):
                raise ValueError(f"mesh ranks must increase along axis {a!r}")
        self.cache = CompiledCache(name=f"distributed:{id(mesh)}")
        # per-THREAD compile accounting — concurrent rounds sharing this
        # engine each see their own fuse call's build phase
        self._tls = threading.local()
        # one call's collectives at a time in this process
        self._coll_lock = threading.Lock()

    def _resolve_device(self, device) -> torch.device:
        """The given device, which must be of the mesh's type, or the
        rank's own: ``cuda:LOCAL_RANK`` (torchrun's), else the rank
        modulo the cards, on a CUDA mesh; the CPU on a CPU mesh."""
        mesh_type = self.mesh.device_type
        if device is None and mesh_type == "cuda":
            local = os.environ.get("LOCAL_RANK")
            count = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            index = int(local) if local is not None \
                else dist.get_rank() % max(count, 1)
            device = f"cuda:{index}"
        elif device is None:
            device = mesh_type
        if torch.device(device).type != mesh_type:
            raise ValueError(f"device {device} does not match the mesh's "
                             f"device type {mesh_type!r}")
        return resolve_device(device)

    # -- groups and layout ------------------------------------------------------
    def _coord_of(self, rank: int) -> Dict[str, int]:
        where = np.argwhere(self._layout == rank)[0]
        return dict(zip(self._names, (int(i) for i in where)))

    def _flat_index(self, coord: Dict[str, int], axes: Sequence[str]) -> int:
        """Row-major index of ``coord`` over ``axes``."""
        idx = 0
        for a in axes:
            idx = idx * int(self._sizes[a]) + coord[a]
        return idx

    def _group(self, axes: Tuple[str, ...]) -> _Group:
        """The group of ranks that differ only along ``axes`` (this rank
        alone for no axes). Every rank builds the same groups in the same
        order, as ``new_group`` requires."""
        idx = [self._names.index(a) for a in axes]
        rest = [i for i in range(len(self._names)) if i not in idx]
        width = int(np.prod([self._layout.shape[i] for i in idx]))
        parts = self._layout.transpose(rest + idx).reshape(-1, width)
        partition = [[int(r) for r in row] for row in parts]
        # one group for each partition: on a (1, 1) mesh every axis set
        # gives the same one
        key = (tuple(map(tuple, partition)), float(self.timeout))
        groups = _mesh_groups(self.mesh)
        g = groups.get(key)
        if g is not None:
            return g
        mine, _ = dist.new_subgroups_by_enumeration(
            partition, timeout=datetime.timedelta(seconds=self.timeout))
        g = _Group(mine, tuple(dist.get_process_group_ranks(mine)))
        groups[key] = g
        return g

    @property
    def is_root(self) -> bool:
        """This rank is the mesh's first: the one that decides round
        membership for the service."""
        return dist.get_rank() == self._root

    def broadcast(self, obj):
        """``obj`` of the mesh's first rank, on every rank (a small
        picklable message: round membership, a plan, block ids)."""
        box = [obj]
        dist.broadcast_object_list(box, src=self._root,
                                   group=self._g_all.group,
                                   device=self.device)
        return box[0]

    def _all_reduce(self, x: torch.Tensor, g: _Group) -> torch.Tensor:
        dist.all_reduce(x, group=g.group)
        return x

    def _reduce_clients(self, x: torch.Tensor) -> torch.Tensor:
        if self.hierarchical:
            # edge stage: reduce within the pod's client shards first,
            # then the (smaller) cross-pod reduce — the paper's
            # client-edge-cloud hierarchy on the pod axis
            for ax in reversed(self.client_axes):
                self._all_reduce(x, self._g_axis[ax])
            return x
        return self._all_reduce(x, self._g_client)

    def _gather(self, x: torch.Tensor, g: _Group,
                order: Sequence[str]) -> torch.Tensor:
        """Every member's ``x`` concatenated along the last dim, member
        slots row-major over the axes ``order``."""
        parts = [torch.empty_like(x) for _ in range(g.size)]
        dist.all_gather(parts, x.contiguous(), group=g.group)
        slots: List[Optional[torch.Tensor]] = [None] * g.size
        for r, part in zip(g.ranks, parts):
            slots[self._flat_index(self._coord_of(r), order)] = part
        return torch.cat(slots, dim=-1)

    def _all_to_all(self, u: torch.Tensor, ax: str) -> torch.Tensor:
        """Tiled all-to-all over ``ax``: split the columns into one piece
        per member, send piece j to member j, stack what arrives along
        the rows in member order."""
        g = self._g_axis[ax]
        A = g.size
        R, C = u.shape
        send = u.reshape(R, A, C // A).permute(1, 0, 2).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=g.group)
        return recv.reshape(A * R, C // A)

    # -- compile accounting -------------------------------------------------------
    @property
    def last_compile_seconds(self) -> float:
        """Build seconds paid by the CURRENT thread's last fuse call
        (0.0 on warm rounds)."""
        return getattr(self._tls, "compile_seconds", 0.0)

    @last_compile_seconds.setter
    def last_compile_seconds(self, value: float) -> None:
        self._tls.compile_seconds = value

    # -- shape bucketing -------------------------------------------------------
    def _padded_rows(self, n: int, reducible: bool) -> int:
        """Reducible rounds bucket n to a power of two (step reuse);
        order-statistic paths pad only to the shard multiple — they drop
        padding by the REAL n, so their steps are n-specific anyway."""
        if reducible:
            b = bucket_rows(n)
            return b + ((-b) % self._n_client_shards)
        return n + ((-n) % self._n_client_shards)

    def _padded_dim(self, P_: int) -> int:
        return P_ + (-P_) % (self._n_param_shards * self._n_client_shards)

    def is_warm(self, fusion, n: int, P_: int, dtype) -> bool:
        """Would this round hit an already-built step?"""
        return self._fuse_key(fusion, n, P_, dtype) in self.cache

    def _fuse_key(self, fusion, n: int, P_: int, dtype):
        pn = self._padded_rows(n, fusion.reducible)
        n_real = None if fusion.reducible else n
        return (fusion_cache_key(fusion), pn, self._padded_dim(P_),
                np.dtype(dtype).str, n_real, self.hierarchical)

    def _key_get(self, key, step, lib=None):
        """The cached step for ``key`` (built now on a miss: the kernel
        library ``lib`` is built and loaded on the card first), with the
        build seconds added to ``last_compile_seconds``."""
        def build():
            if lib is not None and self.device.type == "cuda":
                lib.build()
            return step

        fn, compile_s = self.cache.get(key, build)
        self.last_compile_seconds += compile_s
        return fn

    def _shard(self, x, r0: int, r1: int, c0: int, c1: int,
               cols: int) -> torch.Tensor:
        """Rows [r0, r1) and columns [c0, c1) of a host array or tensor
        on this rank's device, zero columns appended up to ``cols``."""
        u = updates_to_device(x[r0:r1, c0:c1], self.device)
        if c1 - c0 < cols:
            u = torch.nn.functional.pad(u, (0, cols - (c1 - c0)))
        return u

    # -- public -------------------------------------------------------------------
    def fuse(self, fusion: FusionAlgorithm, updates, weights) -> torch.Tensor:
        """updates (n, P) — a host array or a tensor, the same on every
        rank — and weights (n,). Each rank copies only its shard to its
        device. Returns the fused (P,) fp32 vector on every rank."""
        self.last_compile_seconds = 0.0
        n, P_ = updates.shape
        w = torch.ones((n,), dtype=torch.float32) if weights is None \
            else _host_weights(weights)
        w = fusion.effective_weights(w)
        key = self._fuse_key(fusion, n, P_, host_dtype(updates))
        pn, Ppad = self._padded_rows(n, fusion.reducible), self._padded_dim(P_)
        with self._coll_lock:
            if fusion.reducible:
                out = self._fuse_reducible(fusion, updates, w, key, pn, Ppad)
            elif fusion.coordinatewise:
                out = self._fuse_coordinatewise(fusion, updates, key, pn,
                                                Ppad)
            elif isinstance(fusion, (Krum, Zeno, GeometricMedian)):
                out = self._fuse_robust(fusion, updates, w, key, pn, Ppad)
            else:
                raise NotImplementedError(
                    f"no distributed strategy for fusion {fusion.name!r}")
        return out[:P_]

    # -- reducible: map-reduce ------------------------------------------------------
    def _partial_fn(self, fusion):
        """The rank's 'map' stage and the client-axis reduce: (payload,
        w) -> (wsum (cols,), tot ()) summed over the client shards.
        ``payload`` is the rank's (r, cols) slice or a ``_QSlice``; full
        row norms are all-reduced over the parameter shards first when
        the fusion needs them."""
        use_kernel = fusion.name in _KERNEL_WSUM

        def partial(payload, w):
            if isinstance(payload, _QSlice) and not use_kernel:
                payload = _dequant_slice(payload)
            if isinstance(payload, _QSlice):
                r, cols = payload.codes.shape[0], payload.cols
            else:
                r, cols = payload.shape
            dev = self.device
            if r == 0:   # no row of this block lies on this rank
                wsum = torch.zeros((cols,), dtype=torch.float32, device=dev)
                tot = torch.zeros((), dtype=torch.float32, device=dev)
            elif isinstance(payload, _QSlice):
                ws = kernel.weighted_sum_dequant(
                    payload.codes, payload.scales, w, block=payload.blk)
                if payload.width < cols:
                    wsum = torch.zeros((cols,), dtype=torch.float32,
                                       device=dev)
                    wsum[: payload.width] = ws[: payload.width]
                else:
                    wsum = ws[:cols]
                tot = w.sum()
            elif fusion.needs_row_norms:
                norms = torch.linalg.vector_norm(payload.float(), dim=1)
                if self._n_param_shards > 1:   # full rows: sum the squares
                    sq = self._all_reduce(norms.square(), self._g_param)
                    norms = torch.sqrt(sq)
                wsum, tot = fusion.partial_with_norms(payload, w, norms)
            elif use_kernel:
                wsum, tot = kernel.weighted_sum(payload, w), w.sum()
            else:
                wsum, tot = fusion.partial(payload, w)
            # one all-reduce carries both sums
            buf = torch.cat([wsum.float().reshape(-1),
                             tot.float().reshape(1)])
            self._reduce_clients(buf)
            return buf[:cols], buf[cols]

        return partial

    def _fuse_reducible(self, fusion, updates, w, key, pn, Ppad):
        n, P_ = updates.shape
        rows = pn // self._n_client_shards
        cols = Ppad // self._n_param_shards
        r0, c0 = self._cshard * rows, self._pshard * cols
        r1, c1 = min(r0 + rows, n), min(c0 + cols, P_)
        r1 = max(r1, r0)
        partial = self._key_get(key, self._partial_fn(fusion), kernel)
        # padded rows weigh 0: a rank folds only its real rows
        u = self._shard(updates, r0, r1, c0, max(c1, c0), cols)
        wsum, tot = partial(u, w[r0:r1].to(self.device))
        wsum = self._gather(wsum, self._g_param, self._param)
        # combine stays OUTSIDE the cached step: FedAvgM / FedAdam keep
        # server state that must advance every round
        return fusion.combine(wsum, tot)

    # -- coordinate-wise: shuffle (all_to_all) then local ----------------------------
    def _fuse_coordinatewise(self, fusion, updates, key, pn, Ppad):
        n, P_ = updates.shape
        rows = pn // self._n_client_shards
        cols = Ppad // self._n_param_shards
        r0, c0 = self._cshard * rows, self._pshard * cols
        r1, c1 = max(min(r0 + rows, n), r0), max(min(c0 + cols, P_), c0)
        u = self._shard(updates, r0, r1, c0, c1, cols)
        if r1 - r0 < rows:   # padding rows, dropped after the shuffle
            u = torch.nn.functional.pad(u, (0, 0, 0, rows - (r1 - r0)))

        def shuffle_and_reduce(u):
            # which client shard each row block came from, in arrival order
            shards = [dict(self._coord)]
            for ax in self.client_axes:
                u = self._all_to_all(u, ax)
                shards = [dict(c, **{ax: j})
                          for j in range(self._sizes[ax]) for c in shards]
            ids = torch.cat([
                self._flat_index(c, self.client_axes) * rows
                + torch.arange(rows) for c in shards])
            real = torch.nonzero(ids < n).flatten()
            if real.numel() != u.shape[0]:
                u = u.index_select(0, real.to(u.device))
            u = u.contiguous()
            if fusion.name == "coordmedian":
                return robust_kernel.coord_median(u)
            return robust_kernel.trimmed_mean(u, fusion.trim_count(n))

        step = self._key_get(key, shuffle_and_reduce, robust_kernel)
        out = step(u)
        return self._gather(out, self._g_all,
                            self._param + tuple(self.client_axes))

    # -- Krum / Zeno / GeoMedian: all-reduced scores ---------------------------------
    def _fuse_robust(self, fusion, updates, w, key, pn, Ppad):
        n, P_ = updates.shape
        cols = Ppad // (self._n_param_shards * self._n_client_shards)
        c0 = self._flat_index(self._coord, self._all_axes) * cols
        c1 = max(min(c0 + cols, P_), c0)
        uf = self._shard(updates, 0, n, c0, c1, cols).float()
        g_all = self._g_all
        if isinstance(fusion, Krum):
            def step(uf, _extra):
                gram = self._all_reduce(uf @ uf.T, g_all)
                return uf[fusion.select_from_gram(gram)].mean(dim=0)
            extra = None
        elif isinstance(fusion, Zeno):
            def step(uf, g):
                buf = torch.cat([uf @ g, (uf * uf).sum(dim=1)])
                self._all_reduce(buf, g_all)
                s = fusion.scores(buf[:n], buf[n:])
                keep = max(n - fusion.n_suspect, 1)
                return uf[_lowest(-s, keep)].mean(dim=0)
            g_val = fusion._g_val
            if g_val is None:
                # the reference's mean over the row-padded matrix
                extra = uf.sum(dim=0) / pn
            else:
                g_val = g_val.reshape(-1).float()
                extra = torch.zeros((cols,), dtype=torch.float32)
                extra[: c1 - c0] = g_val[c0:c1].cpu()
                extra = extra.to(self.device)
        else:
            def step(uf, wf):
                wf = wf / wf.sum()
                z = torch.einsum("np,n->p", uf, wf)
                for _ in range(fusion.iters):
                    d2 = self._all_reduce(((uf - z[None, :]) ** 2).sum(dim=1),
                                          g_all)
                    beta = wf / torch.clamp(torch.sqrt(d2), min=fusion.smooth)
                    beta = beta / beta.sum()
                    z = torch.einsum("np,n->p", uf, beta)
                return z
            extra = w[:n].to(self.device)
        fn = self._key_get(key, step)
        return self._gather(fn(uf, extra), g_all, self._all_axes)

    # -- streaming: per-shard chunked ingest ------------------------------------------
    def _stream_key(self, fusion, chunk: int, P_: int, dtype, sig):
        pc = chunk + (-chunk) % self._n_client_shards
        return ("stream", fusion_cache_key(fusion), pc, self._padded_dim(P_),
                np.dtype(dtype).str, self.hierarchical, sig)

    def _dequant_key(self, chunk: int, P_: int, blk: int, weighted: bool):
        pc = chunk + (-chunk) % self._n_client_shards
        Pq = -(-P_ // blk) * blk
        return ("dequant", pc, Pq, blk, P_, self._padded_dim(P_), weighted)

    def is_warm_stream(self, fusion, chunk: int, P_: int, dtype,
                       block: Optional[int] = None,
                       n_hint: Optional[int] = None) -> bool:
        """Warm-path probe. ``dtype`` int8 probes the COMPRESSED route:
        its staging step (at quantization block ``block``, default
        ``compress.BLOCK``) AND the fp32 fold step it feeds. ``n_hint``
        sizes an order-statistic carve (its steps are keyed by the carve
        capacity)."""
        if not fusion.streamable:
            return False
        try:
            sig = fusion.state_signature(P_, n_hint)
        except ValueError:   # carve fusion with no n_hint: can't stream
            return False
        if np.dtype(dtype) == np.int8:
            blk = int(block) if block else BLOCK
            return (self._dequant_key(chunk, P_, blk, fusion.weighted)
                    in self.cache
                    and self._stream_key(fusion, chunk, P_, np.float32, sig)
                    in self.cache)
        return self._stream_key(fusion, chunk, P_, dtype, sig) in self.cache

    def _stage_q_fn(self, weighted: bool, cols: int):
        """The compressed block's staging step: (CompressedBlock, rows
        [r0, r1), columns [c0, c1)) -> the rank's payload on the device,
        copied at its compressed size: on the sum path a ``_QSlice`` where
        the columns start on a quantization block, else (and always on
        the carve path) the slice dequantized on the device."""
        dev = self.device

        def stage(block, r0, r1, c0, c1):
            blk = block.block
            b0, b1 = c0 // blk, -(-c1 // blk)
            q = to_device(block.codes[r0:r1, b0 * blk: b1 * blk], dev)
            s = to_device(block.scales[r0:r1, b0:b1], dev)
            qs = _QSlice(q, s, blk, c0 - b0 * blk, c1 - c0, cols)
            if weighted and qs.start == 0:
                return qs
            return _dequant_slice(qs)

        return stage

    def _fold_fn(self, fusion):
        """The per-block fold of the rank's payload into its carry."""
        if fusion.reducible:
            partial = self._partial_fn(fusion)

            def fold(payload, w, *state):
                return tuple(fusion.fold_block(tuple(state), payload, w,
                                               partial=partial))
            return fold, kernel

        def carve(u, valid, ssum, topk, botk):
            return robust_kernel.topk_carve(u.contiguous(), valid, ssum,
                                            topk, botk)

        def fold(payload, w, *state):
            return tuple(fusion.fold_block(tuple(state), payload, w,
                                           carve=carve))
        return fold, robust_kernel

    def fuse_stream(
        self,
        fusion: FusionAlgorithm,
        blocks: Iterable[Tuple[np.ndarray, ...]],
        init: Optional[tuple] = None,
        chunk_rows: Optional[int] = None,
        device_sem=None,
        n_hint: Optional[int] = None,
    ) -> Tuple[torch.Tensor, StreamReport]:
        """Per-shard streaming ingest: fold (chunk, P) blocks (e.g. from
        ``UpdateStore.iter_chunks``) through one cached fold step into the
        carry this rank holds. Every rank must be given the same blocks.
        Block / ``init`` / ``chunk_rows`` / ``n_hint`` / ``device_sem``
        semantics match ``LocalEngine.fuse_stream`` (numeric per-row
        staleness scales; carried state in and out through the
        StreamReport, gathered whole on every rank; a block may be a
        ``CompressedBlock``, staged at its compressed size).

        The SUM path splits each block over (client axes, param axis) and
        all-reduces the partials; the CARVE path gives every rank all of
        a block's rows for its column slice and carves them locally, with
        the (K, P) buffers split over the param axis."""
        if not fusion.streamable:
            raise ValueError(
                f"{fusion.name} is not streamable — streamed aggregation "
                "needs a reducer decomposition (weighted sum or "
                "order-statistic carve)"
            )
        weighted = fusion.weighted
        dev = self.device
        self.last_compile_seconds = 0.0
        rep = StreamReport()
        sem = device_sem if device_sem is not None \
            else contextlib.nullcontext()
        it = iter(blocks)
        steps: dict = {}   # payload dtype -> cached fold step
        stages: dict = {}  # (Pq, blk) -> cached compressed staging step
        state = sig = None
        chunk = dim = None
        pc = pdim = cols = rows_per = 0
        with self._coll_lock:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                rep.ingest_seconds += time.perf_counter() - t0
                block, w = item[0], item[1]
                scale = _check_scale(item[2]) if len(item) > 2 else None
                if scale is not None and not weighted:
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
                    pc = chunk + (-chunk) % self._n_client_shards
                    pdim = self._padded_dim(dim)
                    cols = pdim // self._n_param_shards
                    rows_per = pc // self._n_client_shards
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
                w_eff = _block_weights(fusion, w, scale, rows, pc)
                # the rank's rows: its client shard of the block on the sum
                # path, every row on the carve path
                if weighted:
                    r0 = self._cshard * rows_per
                    r1 = max(min(r0 + rows_per, rows), r0)
                else:
                    r0, r1 = 0, rows
                c0 = self._pshard * cols
                c1 = max(min(c0 + cols, dim), c0)
                t0 = time.perf_counter()
                if compressed:
                    kind = (block.codes.shape[1], block.block)
                    stage = stages.get(kind)
                    if stage is None:
                        key = self._dequant_key(chunk, dim, block.block,
                                                weighted)
                        stage = self._key_get(
                            key, self._stage_q_fn(weighted, cols),
                            kernel if weighted else robust_kernel)
                        stages[kind] = stage
                    payload = stage(block, r0, r1, c0, c1)
                    dtype = np.dtype(np.float32)
                else:
                    payload = self._shard(block, r0, r1, c0, c1, cols)
                    dtype = host_dtype(block)
                w_dev = w_eff[r0:r1].to(dev)
                rep.ingest_seconds += time.perf_counter() - t0
                if state is None:
                    state = self._stream_state(fusion, dim, pdim, cols,
                                               n_hint, init)
                step = steps.get(dtype.str)
                if step is None:
                    fold, lib = self._fold_fn(fusion)
                    step = self._key_get(
                        self._stream_key(fusion, chunk, dim, dtype, sig),
                        fold, lib)
                    steps[dtype.str] = step
                rep.compile_seconds = self.last_compile_seconds
                t0 = time.perf_counter()
                with sem:
                    state = step(payload, w_dev, *state)
                    if device_sem is not None:
                        # launches return at once: the permit must cover
                        # the device's execution, not the dispatch
                        synchronize(dev)  # lint: disable=sync-under-sem -- deliberate: the permit must cover device EXECUTION, not just dispatch (the device_concurrency contract)
                rep.compute_seconds += time.perf_counter() - t0
                rep.n_rows += rows
                rep.n_blocks += 1
            t0 = time.perf_counter()
            if rep.n_blocks == 0:
                if init is None:
                    raise ValueError("fuse_stream: empty block iterator")
                # carry-only round: nothing arrived, finalize the carried
                # state (the same on every rank, so no collective)
                sliced = tuple(self._carried(x) for x in init)
            else:
                # gather the rank's column slices, then drop the padding
                # columns BEFORE finalize: they carry garbage (the carve's
                # inf sentinels) that must never reach the arithmetic
                sliced = tuple(
                    self._gather(x, self._g_param, self._param)[..., :dim]
                    if x.dim() else x
                    for x in state)
        rep.acc_state = sliced
        if fusion.reducible:
            rep.acc_wsum = sliced[0]
            rep.acc_tot = float(sliced[1])
        with sem:
            fused = fusion.finalize(sliced)
            synchronize(dev)  # lint: disable=sync-under-sem -- deliberate: the permit must cover device EXECUTION, not just dispatch (the device_concurrency contract)
        rep.compute_seconds += time.perf_counter() - t0
        return fused, rep

    def _carried(self, x) -> torch.Tensor:
        """A carried leaf as a fresh fp32 tensor on this rank's device."""
        x = x if isinstance(x, torch.Tensor) else np.asarray(x)
        return to_device(x, self.device).float().clone()

    def _stream_state(self, fusion, dim, pdim, cols, n_hint, init):
        """The rank's carry: the fresh (or carried) state's column slice,
        zero-padded on the param axis to the shard multiple."""
        if init is None:
            return tuple(fusion.init_state(cols, n_hint, device=self.device))
        # the shapes alone: a meta tensor holds no memory
        proto = tuple(fusion.init_state(dim, n_hint, device="meta"))
        if len(init) != len(proto):
            raise ValueError(
                f"fuse_stream: carried state has {len(init)} leaves, "
                f"{fusion.name} expects {len(proto)}"
            )
        c0 = self._pshard * cols
        out = []
        for x, p in zip(init, proto):
            if _shape(x) != tuple(p.shape):
                raise ValueError(
                    f"fuse_stream: carried accumulator has shape "
                    f"{_shape(x)}, stream blocks have dim {dim}"
                )
            leaf = self._carried(x)
            if leaf.dim():
                if pdim != dim:
                    leaf = torch.nn.functional.pad(leaf, (0, pdim - dim))
                leaf = leaf[..., c0:c0 + cols].contiguous()
            out.append(leaf)
        return tuple(out)
