"""UpdateStore — the HDFS analogue.

Clients write model updates here instead of pushing them over a single
server's NIC (the paper's webHDFS path, §III-D2). The store is the
communication substrate of the distributed engine: placement is sharded
(round-robin over simulated datanodes), capacity is cluster-level rather
than single-node, and reads hand the distributed engine per-shard slices.

Two backends:
  * memory — dict of flat vectors in the CLIENT'S dtype (fast; benchmarks).
  * disk   — one .npy per update under a spool dir (restart-safe; the
             end-to-end example and fault-tolerance tests use this).

The spool is TENANT-PARTITIONED: every write lands in exactly one
tenant's partition (``tenant="default"`` unless tagged), and every read
path — ``count`` / ``client_ids`` / ``meta`` / ``iter_chunks`` /
``iter_arrivals`` / ``arrival_times`` / ``read_stacked`` — takes a
``tenant`` filter, so concurrent applications sharing one store (the
paper's multi-application edge aggregator) interleave open rounds
without folding each other's updates. ``remove`` consumes within a
single tenant's partition; client ids only need to be unique WITHIN a
tenant. ``tenant=None`` on the read paths means the legacy whole-spool
view. On disk, the default tenant spools at the root (restart-compatible
with pre-tenant spools) and every other tenant under
``spool_dir/<tenant>/``.

The aggregator-side read path is STREAMING-first: ``iter_chunks`` hands
the engine fixed-size (chunk, P) blocks with the next block prefetched on
a reader thread (double buffering), so a round never materializes the
dense (n, P) matrix on the host — peak ingest allocation is O(chunk * P).
``iter_arrivals`` is the arrival-driven variant (the async-round
substrate): it yields a block as soon as ``chunk_rows`` NEW updates land,
snapshot-free, with the caller's threshold/timeout gate deciding when the
stream *closes* rather than when it starts — fusion overlaps the
straggler wait. ``read_stacked`` remains for order-statistic fusions that
genuinely need all rows at once.

Stored dtype is preserved (bf16 updates stay 2 bytes on the wire and in
the spool; the seed force-cast to fp32, doubling bytes); only integer /
bool inputs are promoted to fp32. Updates may be numpy arrays, tensors
on any device (copied to the host) or pytrees of either; bf16 rows are
kept as raw 16-bit words under ``repro_torch.utils.dtypes.BF16``, which
needs no numpy bfloat16 type, and spool with the same ``.dtype`` sidecar
as the reference package's store.

COMPRESSED TRANSPORT: ``write`` also accepts a
:class:`repro_torch.core.compress.CompressedUpdate` (int8 block-quantized
codes + fp32 per-block scales). On disk the codes spool as the ``.npy``
blob with a ``.scale`` sidecar (the fp32 scale vector, npy format) and
a ``.dim`` sidecar (the logical parameter count, text) — the same
sidecar mechanism the ``.dtype`` sidecar uses for extension floats.
External writers route compressed blobs the same way (codes blob +
``.scale`` next to it); ``ingest_external`` / ``SpoolTailer`` move and
register the sidecar set atomically-enough (blob last). The streaming
read paths — ``iter_chunks`` / ``iter_arrivals`` — yield compressed
rows as :class:`repro_torch.core.compress.CompressedBlock` WITHOUT host-side
dequantization (the engines fold the scales in-kernel); a round may mix
dense and compressed entries (stragglers may be uncompressed), in which
case each yielded block is homogeneous: rows are grouped by payload
kind, only the per-kind final block is ragged. Quota/byte accounting
(``tenant_bytes``, ``StoreStats.bytes*``, ``TenantQuota.max_bytes``)
counts the REAL compressed size (codes + scales), not the logical fp32
size — compressing buys actual quota headroom.

Every registered write is TIMESTAMPED on the store's injectable clock
(``arrival_times()``) — the adaptive controller's training signal — and
notifies an arrival condition, so arrival-driven readers
(``iter_arrivals``, ``Monitor.wait``) wake event-driven instead of
sleep-polling. ``SpoolTailer`` extends the same arrival path to blobs
written DIRECTLY into a disk spool by external processes: inotify when
the platform has it, directory polling elsewhere. External writers
route blobs to a tenant by writing into the tenant's subdirectory, or
by dropping a ``<cid>.npy.tenant`` sidecar next to a root-level blob
(the tailer then moves the files into the named partition).

Ingest-time accounting mirrors the paper's Fig. 12 'average write time':
bytes / per-datanode bandwidth with ``replication`` copies — kept both
spool-globally (``stats``, the legacy view) and PER TENANT
(``stats_for(tenant)``: writes, bytes, reads, evictions). Tenants can
carry a capacity quota (``set_quota`` — update-count / byte budgets
with a reject-or-evict policy, :class:`TenantQuota`) so one noisy
application cannot starve the rest of a shared spool; evictions bump
the victim's write-version first, so in-flight streaming reads and
closing rounds skip superseded entries instead of folding
half-unlinked bytes.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import (
    Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np

from repro_torch.core.compress import CompressedBlock, CompressedUpdate
from repro_torch.utils.dtypes import dtype_from_name, dtype_name, host_array
from repro_torch.utils.pytree import tree_to_flat_vector

# the partition untagged writes land in; also the root of a disk spool
DEFAULT_TENANT = "default"

# (tenant, client_id) — the store's internal index key
_Key = Tuple[str, str]


def _stat_identity(path: str) -> Tuple[int, int, int]:
    """(st_mtime_ns, st_size, st_ino) — the identity a registered root
    blob's bytes are recognized by. Any rewrite moves at least one
    component: in-place writes bump mtime/size, rename-based writers
    change the inode even under coarse filesystem timestamps."""
    st = os.stat(path)
    return (st.st_mtime_ns, st.st_size, st.st_ino)


def _valid_tenant(tenant: str) -> bool:
    """A tenant name must be a single path component: it becomes a
    spool subdirectory, so separators / '..' would escape the spool
    (path traversal via a crafted ``.tenant`` sidecar)."""
    return bool(tenant) and tenant not in (".", "..") \
        and os.path.basename(tenant) == tenant \
        and "/" not in tenant and "\\" not in tenant


@dataclasses.dataclass
class StoreStats:
    writes: int = 0
    bytes_written: int = 0
    sim_write_seconds: float = 0.0  # modeled (bandwidth-based), not wall
    reads: int = 0
    bytes_read: int = 0
    peak_block_bytes: int = 0       # largest single ingest block staged
    evictions: int = 0              # quota / re-submission evictions


class QuotaExceededError(RuntimeError):
    """A write would exceed its tenant's capacity quota under the
    ``reject`` policy (or no eviction could make room under ``evict``:
    the update alone is bigger than the tenant's byte budget)."""


@dataclasses.dataclass
class TenantQuota:
    """Per-tenant capacity budget — the resource-awareness knob that
    keeps one noisy tenant from starving the rest of a shared spool.

    ``max_updates`` / ``max_bytes`` bound the tenant's resident
    partition (logical stored bytes, before replication); ``None``
    leaves that dimension unbounded. ``policy``:

      * ``"reject"`` — an over-budget ``write`` raises
        :class:`QuotaExceededError`; an over-budget external blob stays
        unregistered on disk until capacity frees.
      * ``"evict"``  — the tenant's OLDEST resident updates (by arrival
        time) are evicted to make room; evictions bump the victims'
        write-version so in-flight folds and closing rounds skip them
        (never a half-unlinked fold), and count into the tenant's
        ``StoreStats.evictions``.

    Enforcement is exact while a tenant's writes are serialized (one
    writer, or the RoundScheduler's per-tenant worker); concurrent
    writers to ONE tenant can overshoot by the writes in flight."""

    max_updates: Optional[int] = None
    max_bytes: Optional[int] = None
    policy: str = "reject"

    def __post_init__(self):
        if self.policy not in ("reject", "evict"):
            raise ValueError(
                f"quota policy must be 'reject' or 'evict', "
                f"got {self.policy!r}"
            )


class UpdateStore:
    """Thread-safe, tenant-partitioned spool of
    ``(tenant, client_id) -> (flat update, weight)``.

    Locking discipline: ``self._lock`` guards ONLY the in-memory index
    (``_mem`` / ``_weights``) and stats. Disk I/O happens outside the
    critical section so concurrent client writes overlap on the
    (simulated) datanodes instead of serializing behind one spindle.
    Readers snapshot the index under the lock, then read blob data
    lock-free.
    """

    def __init__(
        self,
        backend: str = "memory",
        spool_dir: Optional[str] = None,
        n_datanodes: int = 3,
        replication: int = 2,
        datanode_bw: float = 117e6,  # ~1 GbE in bytes/s, paper's testbed
        clock: Callable[[], float] = time.monotonic,
        sidecar_grace_seconds: float = 0.5,
        wall_clock: Callable[[], float] = time.monotonic,
    ):
        assert backend in ("memory", "disk")
        self.backend = backend
        self.spool_dir = spool_dir
        if backend == "disk":
            assert spool_dir, "disk backend needs spool_dir"
            os.makedirs(spool_dir, exist_ok=True)
        self.n_datanodes = n_datanodes
        self.replication = replication
        self.datanode_bw = datanode_bw
        self.clock = clock   # arrival timestamping; injectable for tests
        # sidecar grace windows measure REAL elapsed time, not the
        # arrival timebase — separately injectable so grace-expiry
        # tests run on a scripted clock instead of sleeping it out
        self.wall_clock = wall_clock
        # all index maps are keyed (tenant, client_id) — the partition key
        self._mem: Dict[_Key, Tuple[np.ndarray, float]] = {}  # guarded-by: _lock
        self._weights: Dict[_Key, float] = {}  # guarded-by: _lock
        # per-key write counter: lets a version-aware remove() keep an
        # update that was re-written after a round folded its predecessor
        self._versions: Dict[_Key, int] = {}  # guarded-by: _lock
        # per-key arrival timestamp (self.clock timebase) — the adaptive
        # controller's training signal (repro/core/adaptive.py)
        self._arrivals: Dict[_Key, float] = {}  # guarded-by: _lock
        # external blobs first sighted without a weight sidecar:
        # key -> wall time first seen. They register at the default
        # weight only after sidecar_grace_seconds, so a sidecar landing
        # just behind its blob (the documented writer order) wins.
        self.sidecar_grace_seconds = sidecar_grace_seconds
        self._ext_seen: Dict[_Key, float] = {}  # guarded-by: _lock
        # ROOT-blob ownership (disk): a (st_mtime_ns, st_size,
        # st_ino) identity triple recorded at registration. The root
        # staging area is shared between default-tenant clients and
        # sidecar-routed external writers, so ingest_external uses this
        # to tell a stray late ``.tenant`` sidecar (bytes unchanged:
        # live entry wins) from a genuine re-submission (bytes
        # replaced: evict + re-ingest); rename-based rewrites change
        # the inode even on filesystems with coarse mtime ticks.
        self._blob_mtime: Dict[_Key, Tuple[int, int, int]] = {}  # guarded-by: _lock
        # per-tenant entry count — the monitor's per-wake poll reads
        # this, so it must be O(1), not a scan of the whole index
        self._counts: Dict[str, int] = {}  # guarded-by: _lock
        # per-key logical stored bytes + per-tenant running total —
        # what TenantQuota.max_bytes budgets against
        self._nbytes: Dict[_Key, int] = {}  # guarded-by: _lock
        self._tenant_bytes: Dict[str, int] = {}  # guarded-by: _lock
        self._quotas: Dict[str, TenantQuota] = {}  # guarded-by: _lock
        # per-tenant accounting next to the legacy spool-global stats
        self._tenant_stats: Dict[str, StoreStats] = {}  # guarded-by: _lock
        # tenant subdirectories already created (write() hot path must
        # not re-stat the directory on every update)
        self._made_dirs: set = set()
        self._lock = threading.Lock()
        # notified on every registered arrival: arrival-driven readers
        # (iter_arrivals) block here instead of sleep-polling
        self._arrival_cv = threading.Condition(self._lock)
        self.stats = StoreStats()  # guarded-by: _lock
        if backend == "disk":
            # fault tolerance (the HDFS property the paper leans on):
            # recover updates spooled by a previous aggregator incarnation
            # — weights persist in a sidecar next to each blob, tenants
            # in the directory layout
            recovered = self._recover()
            self._weights.update(recovered)
            now = self.clock()
            self._arrivals.update({key: now for key in recovered})
            for t, _ in recovered:
                self._counts[t] = self._counts.get(t, 0) + 1
            for t, cid in recovered:
                # root-blob ownership survives restarts: without the
                # recorded mtime a post-restart external re-submission
                # would misread as "unchanged bytes" and never re-ingest
                if t == DEFAULT_TENANT:
                    try:
                        self._blob_mtime[(t, cid)] = _stat_identity(
                            self._path(cid, t)
                        )
                    except OSError:
                        pass
            for t, cid in recovered:
                # byte accounting survives restarts too, or a recovered
                # partition would look empty to its tenant's quota
                path = self._path(cid, t)
                try:
                    raw = int(np.load(path, mmap_mode="r").nbytes)
                except Exception:
                    raw = 0
                try:
                    # compressed blobs count their .scale sidecar too
                    raw += int(np.load(
                        path + ".scale", mmap_mode="r"
                    ).nbytes)
                except Exception:
                    pass
                self._nbytes[(t, cid)] = raw
                self._tenant_bytes[t] = self._tenant_bytes.get(t, 0) + raw

    # -- per-tenant accounting / quotas --------------------------------------
    def _tstats(self, tenant: str) -> StoreStats:
        """The tenant's live stats record (created on first touch).
        Caller holds ``self._lock``."""
        st = self._tenant_stats.get(tenant)
        if st is None:
            st = self._tenant_stats[tenant] = StoreStats()
        return st

    def stats_for(self, tenant: Optional[str] = None) -> StoreStats:
        """Snapshot of one tenant's accounting (writes / bytes / reads /
        evictions), or of the legacy spool-global aggregate with
        ``tenant=None`` — the aggregate keeps counting everything, so
        pre-tenant dashboards reading ``store.stats`` see no change."""
        with self._lock:
            src = self.stats if tenant is None \
                else self._tenant_stats.get(tenant, StoreStats())
            return dataclasses.replace(src)

    def set_quota(
        self,
        tenant: str,
        max_updates: Optional[int] = None,
        max_bytes: Optional[int] = None,
        policy: str = "reject",
    ) -> None:
        """Install (or, with both bounds ``None``, remove) ``tenant``'s
        capacity quota — see :class:`TenantQuota` for semantics."""
        if not _valid_tenant(tenant):
            raise ValueError(f"invalid tenant name {tenant!r}")
        with self._lock:
            if max_updates is None and max_bytes is None:
                self._quotas.pop(tenant, None)
            else:
                self._quotas[tenant] = TenantQuota(
                    max_updates=max_updates, max_bytes=max_bytes,
                    policy=policy,
                )

    def quota(self, tenant: str) -> Optional[TenantQuota]:
        with self._lock:
            q = self._quotas.get(tenant)
            return dataclasses.replace(q) if q is not None else None

    def tenant_bytes(self, tenant: str) -> int:
        """Logical resident bytes in ``tenant``'s partition (what
        ``TenantQuota.max_bytes`` budgets against)."""
        with self._lock:
            return self._tenant_bytes.get(tenant, 0)

    def _evict_locked(self, key: _Key) -> None:
        """Evict one resident update (quota pressure or external
        re-submission). Bumps the key's write-version FIRST so every
        in-flight version-checked consumer — a closing round's
        ``remove``, a streaming ``_load_block`` read — sees the entry
        as superseded and skips it instead of folding half-unlinked
        bytes or unlinking a successor's blob. Caller holds
        ``self._lock`` and unlinks the spool files outside it."""
        self._versions[key] = self._versions.get(key, 0) + 1
        self._drop_index_entry(key)
        self.stats.evictions += 1
        self._tstats(key[0]).evictions += 1

    def _unlink_evicted(
        self, victims: Dict[_Key, Tuple[int, Optional[Tuple]]]
    ) -> None:
        """Unlink quota-eviction victims' spool files, guarded two ways
        so a victim RE-WRITTEN around the eviction keeps its fresh
        blob: the key's version is re-checked right before its files go
        (the ``remove`` guard — catches rewrites that already
        registered), and the on-disk blob's stat identity is compared
        to the identity the EVICTED entry owned (catches a rewrite that
        has staged its new bytes but not yet registered — ``write``
        saves the blob before taking the lock). ``victims`` maps
        key -> (version at eviction, owned blob identity).

        Residual lock-free-spool window (same class ``remove``
        documents): a rewrite whose ``np.save`` lands in the
        microseconds between the identity stat and the unlink can
        still lose its blob — the guards NARROW the race to that
        window, they cannot close it without per-key file locks."""
        if self.backend != "disk":
            return
        for key, (ver, ident) in victims.items():
            with self._lock:
                if key in self._weights or key in self._mem or \
                        self._versions.get(key, 0) != ver:
                    continue   # re-registered since the eviction
            path = self._path(key[1], key[0])
            try:
                if ident is not None and _stat_identity(path) != ident:
                    continue   # fresh bytes staged by an in-flight write
            except OSError:
                continue       # already gone
            self._unlink([key])

    def _quota_check_locked(
        self, key: _Key, raw_bytes: int,
        pend_counts: Optional[Dict[str, int]] = None,
        pend_bytes: Optional[Dict[str, int]] = None,
        pend_raw: Optional[Dict[_Key, int]] = None,
    ) -> Tuple[str, Dict[_Key, Tuple[int, Optional[Tuple]]]]:
        """Decide what admitting ``key`` (``raw_bytes`` logical bytes)
        does to its tenant's quota. Returns ``(verdict, victims)``:
        verdict ``"ok"`` (victims already evicted from the index;
        caller passes the returned {key -> (eviction version, owned
        blob identity)} map to ``_unlink_evicted`` outside the lock)
        or ``"reject"``. Caller holds ``self._lock``.

        ``pend_*`` carry a ``write_batch``'s earlier items — admitted
        and staged but not yet registered — so intra-batch admissions
        can't over-fill the budget the registrations will consume."""
        tenant = key[0]
        q = self._quotas.get(tenant)
        if q is None:
            return "ok", {}
        p_counts = (pend_counts or {}).get(tenant, 0)
        p_bytes = (pend_bytes or {}).get(tenant, 0)
        p_raw = pend_raw or {}
        replacing = key in self._nbytes or key in p_raw
        prior_raw = (p_raw[key] if key in p_raw
                     else self._nbytes.get(key, 0)) if replacing else 0
        new_count = self._counts.get(tenant, 0) + p_counts \
            + (0 if replacing else 1)
        new_bytes = self._tenant_bytes.get(tenant, 0) + p_bytes \
            + raw_bytes - prior_raw
        over_count = q.max_updates is not None and new_count > q.max_updates
        over_bytes = q.max_bytes is not None and new_bytes > q.max_bytes
        if not over_count and not over_bytes:
            return "ok", {}
        if q.policy == "reject":
            return "reject", {}
        # evict policy: drop the tenant's oldest arrivals (never the
        # incoming key itself) until the newcomer fits
        order = sorted(
            (ts, k) for k, ts in self._arrivals.items()
            if k[0] == tenant and k != key
        )
        victims: List[_Key] = []
        for _, k in order:
            if (q.max_updates is None or new_count <= q.max_updates) and \
                    (q.max_bytes is None or new_bytes <= q.max_bytes):
                break
            new_count -= 1
            new_bytes -= self._nbytes.get(k, 0)
            victims.append(k)
        still_over = (
            (q.max_updates is not None and new_count > q.max_updates)
            or (q.max_bytes is not None and new_bytes > q.max_bytes)
        )
        if still_over:
            # the update alone busts the budget: nothing to evict for it
            return "reject", {}
        evicted: Dict[_Key, Tuple[int, Optional[Tuple]]] = {}
        for k in victims:
            ident = self._blob_mtime.get(k)   # before the drop pops it
            self._evict_locked(k)
            evicted[k] = (self._versions.get(k, 0), ident)
        return "ok", evicted

    def _account_write_locked(self, key: _Key, raw_bytes: int) -> None:
        """Byte accounting for a registered write. Caller holds
        ``self._lock`` and has already updated ``_counts``."""
        tenant = key[0]
        self._tenant_bytes[tenant] = (
            self._tenant_bytes.get(tenant, 0) + raw_bytes
            - self._nbytes.get(key, 0)
        )
        self._nbytes[key] = raw_bytes

    # -- client side --------------------------------------------------------
    def _normalize_update(
        self, update
    ) -> Tuple[Optional[CompressedUpdate], Optional[np.ndarray], int]:
        """``(cu, vec, raw_bytes)`` for one incoming update: exactly
        one of ``cu``/``vec`` is set; ``raw`` is the logical stored
        payload the quota/stats budget against."""
        if isinstance(update, CompressedUpdate):
            # quota/stats budget the REAL stored payload: codes + scales
            return update, None, update.nbytes
        vec = host_array(
            update if getattr(update, "ndim", None) == 1
            else tree_to_flat_vector(update)
        )
        if vec.dtype.kind in "biu":   # ints/bools promote; floats keep
            vec = vec.astype(np.float32)
        return None, vec, int(vec.nbytes)

    def write(
        self,
        client_id: str,
        update,
        weight: float = 1.0,
        tenant: str = DEFAULT_TENANT,
    ) -> float:
        """Store one update (pytree or flat vector) in ``tenant``'s
        partition. Returns the modeled write latency (bandwidth model,
        paper Fig. 12). Concurrent writes to the SAME (tenant,
        client_id) are last-writer-wins; the same client_id under two
        tenants are independent updates. With a :class:`TenantQuota`
        installed for ``tenant``, an over-budget write raises
        :class:`QuotaExceededError` (``reject``) or evicts the tenant's
        oldest resident updates to make room (``evict``)."""
        res = self.write_batch([(client_id, update, weight, tenant)])[0]
        if isinstance(res, BaseException):
            raise res
        return res

    def write_batch(
        self, items: Sequence[Tuple[str, object, float, str]]
    ) -> List[object]:
        """Land several updates with ONE registration-lock acquisition
        and ONE arrival notification — the batched commit path an
        ingest front-end coalesces concurrent uploads into.

        ``items`` is a sequence of ``(client_id, update, weight,
        tenant)``. Returns one result per item, in order: the modeled
        write latency (float) on success, or the exception instance
        (``ValueError`` for an invalid tenant, ``QuotaExceededError``
        on a reject-policy refusal) — per-item failures never abort the
        rest of the batch, and a rejected item stages NO blob, exactly
        like a rejected ``write``.

        Semantics match N sequential ``write`` calls: per-item quota
        decisions see earlier batch items (the in-flight bytes/counts
        are carried into each check), duplicate keys are last-writer-
        wins, and stats count every item."""
        results: List[object] = [None] * len(items)
        # per-tenant deltas from earlier batch items admitted but not
        # yet registered — the quota check must see them or a batch
        # could over-admit past the budget
        pend_counts: Dict[str, int] = {}
        pend_bytes: Dict[str, int] = {}
        pend_raw: Dict[_Key, int] = {}
        staged = []
        for i, (client_id, update, weight, tenant) in enumerate(items):
            if not _valid_tenant(tenant):
                results[i] = ValueError(
                    f"invalid tenant name {tenant!r}: must be a "
                    "non-empty single path component (it names a "
                    "spool subdirectory)"
                )
                continue
            key = (tenant, client_id)
            cu, vec, raw = self._normalize_update(update)
            nbytes = raw * self.replication
            latency = nbytes / (self.datanode_bw * self.n_datanodes)
            # quota enforcement BEFORE any blob lands on disk: a
            # rejected write never leaves an orphan file, and evict-
            # policy victims free their budget before the newcomer
            # stages. The unlocked emptiness probe keeps the no-quota
            # ingest hot path at ONE lock acquisition per batch (a
            # quota installed concurrently can miss at most the writes
            # already in flight — the documented bound).
            verdict, victims = "ok", {}
            if self._quotas:  # lint: disable=guarded-access -- unlocked emptiness probe; one lock per batch on the no-quota hot path, staleness bound documented above
                with self._lock:
                    verdict, victims = self._quota_check_locked(
                        key, raw,
                        pend_counts=pend_counts, pend_bytes=pend_bytes,
                        pend_raw=pend_raw,
                    )
            self._unlink_evicted(victims)
            if verdict == "reject":
                results[i] = QuotaExceededError(
                    f"tenant {tenant!r}: update of {raw} B for "
                    f"{client_id!r} exceeds the tenant quota "
                    f"{self._quotas.get(tenant)}"  # lint: disable=guarded-access -- read-only repr for the error message; the verdict was computed under the lock
                )
                continue
            mtime = self._stage_disk(client_id, tenant, cu, vec, weight)
            if key in pend_raw:          # replaces an earlier batch item
                pend_bytes[tenant] = (
                    pend_bytes.get(tenant, 0) - pend_raw[key]
                )
            elif key in self._nbytes:    # lint: disable=guarded-access -- intra-batch pending accounting; staleness bounded by the one-lock-per-batch design documented above
                pend_bytes[tenant] = (
                    pend_bytes.get(tenant, 0)
                    - self._nbytes[key]  # lint: disable=guarded-access -- same intra-batch pending-accounting bound as the elif above
                )
            else:                        # a genuinely new key
                pend_counts[tenant] = pend_counts.get(tenant, 0) + 1
            pend_bytes[tenant] = pend_bytes.get(tenant, 0) + raw
            pend_raw[key] = raw
            staged.append((i, key, cu, vec, weight, mtime, raw,
                           nbytes, latency))
        if staged:
            with self._lock:
                for (i, key, cu, vec, weight, mtime, raw, nbytes,
                     latency) in staged:
                    self._register_locked(key, cu, vec, weight, mtime,
                                          raw, nbytes, latency)
                    results[i] = latency
                self._arrival_cv.notify_all()
        return results

    def _stage_disk(
        self,
        client_id: str,
        tenant: str,
        cu: Optional[CompressedUpdate],
        vec: Optional[np.ndarray],
        weight: float,
    ) -> Optional[Tuple[int, int, int]]:
        """Stage one update's blob + sidecars on the datanode (no
        lock). Returns the staged blob's identity triple (disk
        backend) or None (memory backend)."""
        if self.backend != "disk":
            return None
        # blob + sidecar land on the datanode OUTSIDE the lock.
        # bf16 has no numpy dtype to round-trip through np.save, so it
        # spools as raw bytes + a dtype sidecar.
        # Compressed updates spool their int8 codes as the blob plus
        # a .scale sidecar (fp32 scale vector, npy format — written
        # through an open file so np.save can't append '.npy') and a
        # .dim sidecar (logical parameter count, text).
        path = self._path(client_id, tenant)
        if tenant != DEFAULT_TENANT and tenant not in self._made_dirs:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._made_dirs.add(tenant)
        dpath = path + ".dtype"
        if cu is not None:
            np.save(path, cu.codes)
            with open(path + ".scale", "wb") as f:
                np.save(f, cu.scales)
            with open(path + ".dim", "w") as f:
                f.write(str(int(cu.dim)))
            try:
                os.remove(dpath)   # stale sidecar from a dense write
            except FileNotFoundError:
                pass
        else:
            if vec.dtype.kind == "V":
                np.save(path, np.ascontiguousarray(vec).view(np.uint8))
                with open(dpath, "w") as f:
                    f.write(dtype_name(vec.dtype))
            else:
                np.save(path, vec)
                try:
                    os.remove(dpath)   # stale sidecar, prior dtype
                except FileNotFoundError:
                    pass
            for suffix in (".scale", ".dim"):
                try:   # stale sidecars from a prior compressed write
                    os.remove(path + suffix)
                except FileNotFoundError:
                    pass
        with open(path + ".w", "w") as f:
            f.write(repr(float(weight)))
        try:
            return _stat_identity(path)
        except OSError:
            return None

    def _register_locked(
        self,
        key: _Key,
        cu: Optional[CompressedUpdate],
        vec: Optional[np.ndarray],
        weight: float,
        mtime: Optional[Tuple[int, int, int]],
        raw: int,
        nbytes: int,
        latency: float,
    ) -> None:
        """Register one staged update in the index + stats. Caller
        holds ``self._lock`` and notifies ``_arrival_cv`` after the
        last registration it batches."""
        tenant = key[0]
        src = self._mem if self.backend == "memory" else self._weights
        if key not in src:
            self._counts[tenant] = self._counts.get(tenant, 0) + 1
        if self.backend == "memory":
            self._mem[key] = (cu if cu is not None else vec, weight)
        else:
            self._weights[key] = weight
            if mtime is not None:
                self._blob_mtime[key] = mtime
        self._versions[key] = self._versions.get(key, 0) + 1
        self._arrivals[key] = self.clock()
        self._account_write_locked(key, raw)
        self.stats.writes += 1
        self.stats.bytes_written += nbytes
        self.stats.sim_write_seconds += latency
        ts = self._tstats(tenant)
        ts.writes += 1
        ts.bytes_written += nbytes
        ts.sim_write_seconds += latency

    def _drop_index_entry(self, key: _Key) -> None:
        """Drop one key from every per-key index map and decrement its
        tenant's O(1) count. Caller holds ``self._lock``. ``_versions``
        is deliberately NOT dropped: the counter must never rewind
        while an old round's version snapshot is in flight."""
        if key in self._mem or key in self._weights:
            left = self._counts.get(key[0], 0) - 1
            if left > 0:
                self._counts[key[0]] = left
            else:
                self._counts.pop(key[0], None)
            freed = self._nbytes.get(key, 0)
            left_b = self._tenant_bytes.get(key[0], 0) - freed
            if left_b > 0:
                self._tenant_bytes[key[0]] = left_b
            else:
                self._tenant_bytes.pop(key[0], None)
        self._mem.pop(key, None)
        self._weights.pop(key, None)
        self._nbytes.pop(key, None)
        self._arrivals.pop(key, None)
        self._blob_mtime.pop(key, None)

    # -- aggregator side ----------------------------------------------------
    def _keys(self, tenant: Optional[str]) -> List[_Key]:
        """Sorted index keys of one tenant's partition, or of the whole
        spool (``tenant=None``). Callers must hold ``self._lock``."""
        src = self._mem if self.backend == "memory" else self._weights
        if tenant is None:
            return sorted(src.keys())
        return sorted(k for k in src.keys() if k[0] == tenant)

    def count(self, tenant: Optional[str] = None) -> int:
        """Updates present in ``tenant``'s partition (``None``: whole
        spool). O(1) either way — this is the monitor's per-wake
        poll, so a per-tenant counter is maintained instead of scanning
        the index."""
        with self._lock:
            src = self._mem if self.backend == "memory" else self._weights
            if tenant is None:
                return len(src)
            return self._counts.get(tenant, 0)

    def client_ids(self, tenant: Optional[str] = None) -> List[str]:
        """Sorted client ids in ``tenant``'s partition. With
        ``tenant=None`` (whole spool) an id shared by two tenants
        appears once per tenant."""
        with self._lock:
            return [cid for _, cid in self._keys(tenant)]

    def tenants(self) -> List[str]:
        """Sorted tenants that currently hold at least one update."""
        with self._lock:
            src = self._mem if self.backend == "memory" else self._weights
            return sorted({t for t, _ in src.keys()})

    def arrival_times(
        self, tenant: Optional[str] = None
    ) -> Dict[str, float]:
        """Snapshot of {client_id -> arrival timestamp} for ``tenant``'s
        partition (``None``: whole spool; last tenant wins on a shared
        id) on the store's ``clock`` timebase (``time.monotonic`` by
        default). This is the adaptive controller's training signal:
        the service subtracts the round's start time to get per-client
        arrival offsets."""
        with self._lock:
            return {
                cid: ts for (t, cid), ts in self._arrivals.items()
                if tenant is None or t == tenant
            }

    def wait_for_arrival(self, timeout: float, sleep=time.sleep) -> None:
        """Block until a new arrival is registered or ``timeout`` elapses.
        Event-driven (condition wait, woken by ``write`` /
        ``ingest_external``) under the real clock; with an INJECTED sleep
        (scripted test clocks) the caller's sleep drives time instead.
        The condition is spool-global: a waiter filtering on one tenant
        re-checks its partition on wake (spurious wakes are benign)."""
        if sleep is not time.sleep:
            sleep(timeout)
            return
        with self._arrival_cv:
            self._arrival_cv.wait(timeout)

    def read(
        self, client_id: str, tenant: str = DEFAULT_TENANT
    ) -> Tuple[np.ndarray, float]:
        u, w, _ = self._read_versioned((tenant, client_id))
        return u, w

    def _read_versioned(self, key: _Key) -> Tuple[np.ndarray, float, int]:
        """(update, weight, write-version). For the memory backend the
        array and version are captured under ONE lock, so version-checked
        removal is exact; the disk backend's blob read is lock-free as
        ever, so a racing overwrite can at worst cause a harmless re-fold
        next round (never a lost update).

        The disk path RE-CHECKS the version after the blob (and its
        dtype sidecar) are read: an entry evicted or superseded
        mid-read — quota eviction, external re-submission — bumped its
        version under the lock before any file was touched, so the
        re-check raises ``KeyError`` and the consumer skips the row
        instead of folding a half-unlinked blob (e.g. a bf16 payload
        whose ``.dtype`` sidecar vanished between the two reads)."""
        tenant, client_id = key
        if self.backend == "memory":
            with self._lock:
                arr, weight = self._mem[key]
                version = self._versions.get(key, 0)
            # hand out a read-only VIEW: the spool keeps the only mutable
            # reference, so a caller scribbling on a block cannot corrupt
            # what a concurrent (or later) round will read
            if isinstance(arr, CompressedUpdate):
                return self._readonly_cu(arr), weight, version
            view = arr.view()
            view.flags.writeable = False
            return view, weight, version
        with self._lock:
            weight = self._weights[key]
            version = self._versions.get(key, 0)
        path = self._path(client_id, tenant)
        blob = np.load(path)
        scales = self._sidecar_scales(path)
        if scales is not None:
            blob = CompressedUpdate(
                codes=blob, scales=scales,
                dim=self._sidecar_dim(path, default=int(blob.shape[0])),
            )
        else:
            dt = self._sidecar_dtype(path)
            if dt is not None:
                blob = blob.view(dt)
        with self._lock:
            if key not in self._weights or \
                    self._versions.get(key, 0) != version:
                raise KeyError(key)   # evicted/superseded mid-read
        return blob, weight, version

    @staticmethod
    def _readonly_cu(cu: CompressedUpdate) -> CompressedUpdate:
        codes, scales = cu.codes.view(), cu.scales.view()
        codes.flags.writeable = False
        scales.flags.writeable = False
        return CompressedUpdate(codes=codes, scales=scales, dim=cu.dim)

    @staticmethod
    def _sidecar_dtype(path: str) -> Optional[np.dtype]:
        try:
            with open(path + ".dtype") as f:
                return dtype_from_name(f.read().strip())
        except FileNotFoundError:
            return None

    @staticmethod
    def _sidecar_scales(path: str) -> Optional[np.ndarray]:
        """The ``.scale`` sidecar (fp32 per-block scale vector) marking
        a compressed blob, or None for a dense one."""
        try:
            with open(path + ".scale", "rb") as f:
                return np.load(f)
        except FileNotFoundError:
            return None

    @staticmethod
    def _sidecar_dim(path: str, default: int) -> int:
        """Logical parameter count of a compressed blob. External
        writers may omit it — the codes length (no padding) is assumed
        then."""
        try:
            with open(path + ".dim") as f:
                return int(f.read().strip())
        except (FileNotFoundError, ValueError):
            return default

    def meta(
        self, tenant: Optional[str] = None
    ) -> Tuple[int, int, np.dtype]:
        """(n_clients, update_dim, stored dtype) for ``tenant``'s
        partition (``None``: whole spool) without loading the set —
        what the planner needs BEFORE choosing an engine. A compressed
        first entry reports its LOGICAL dim and dtype int8 (the planner
        sizes chunks from ``compressed_bytes``, not ``dim * 1``)."""
        with self._lock:
            keys = self._keys(tenant)
        if not keys:
            raise LookupError(
                "empty store" if tenant is None
                else f"empty store partition for tenant {tenant!r}"
            )
        first = keys[0]
        if self.backend == "memory":
            with self._lock:
                vec, _ = self._mem[first]
            if isinstance(vec, CompressedUpdate):
                return len(keys), int(vec.dim), np.dtype(np.int8)
            return len(keys), int(vec.shape[0]), vec.dtype
        path = self._path(first[1], first[0])
        blob = np.load(path, mmap_mode="r")  # header only
        if os.path.exists(path + ".scale"):
            dim = self._sidecar_dim(path, default=int(blob.shape[0]))
            return len(keys), dim, np.dtype(np.int8)
        dt = self._sidecar_dtype(path)
        if dt is not None:
            return len(keys), int(blob.nbytes // dt.itemsize), dt
        return len(keys), int(blob.shape[0]), blob.dtype

    def iter_chunks(
        self,
        chunk_rows: int,
        prefetch: bool = True,
        tenant: Optional[str] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (updates, weights (c,) fp32) blocks from ``tenant``'s
        partition (``None``: whole spool) — updates is a dense (c, P)
        stored-dtype array, or a :class:`CompressedBlock` for int8
        block-quantized rows (no host-side dequantization). c ==
        chunk_rows except for ragged final blocks; in a MIXED
        dense/compressed partition each chunk splits into one
        homogeneous block per payload kind (see ``_load_block``).

        With ``prefetch`` a reader thread stages block k+1 while the
        engine consumes block k (double buffering): at most two blocks are
        resident, so peak host-side ingest memory is O(2 * chunk * P)
        regardless of n. The iterator works over a snapshot of the client
        index — updates written after the call don't shift the blocks.
        """
        blocks = self.iter_chunk_ids(chunk_rows, prefetch, tenant)
        try:
            for payload, w, _ in blocks:
                yield payload, w
        finally:
            blocks.close()   # an abandoned consumer releases the reader

    def iter_chunk_ids(
        self,
        chunk_rows: int,
        prefetch: bool = True,
        tenant: Optional[str] = None,
    ) -> Iterator[Tuple[object, np.ndarray, List[str]]]:
        """``iter_chunks`` with each block's client ids: ``(updates,
        weights, ids)``. A mesh service's first rank reads its rounds so,
        to tell the other ranks which rows each block holds."""
        with self._lock:
            keys = self._keys(tenant)
        chunk_rows = max(int(chunk_rows), 1)
        batches = [
            keys[i:i + chunk_rows] for i in range(0, len(keys), chunk_rows)
        ]
        load = self._load_block

        def ided(blks):
            return [(payload, w, [cid for _, cid in loaded])
                    for payload, w, loaded in blks]

        if not prefetch:
            for batch in batches:
                blks = load(batch)
                if blks is not None:  # None: whole batch raced a consume
                    yield from ided(blks)
            return

        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()   # set when the consumer abandons us

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def reader():
            try:
                for batch in batches:
                    if stop.is_set():
                        return
                    blks = load(batch)
                    if blks is None:  # whole batch raced a consume
                        continue
                    for item in ided(blks):
                        if not put(("block", item)):
                            return
                put(("done", None))
            except BaseException as exc:  # surface in the consumer
                put(("error", exc))

        t = threading.Thread(
            target=reader, name="updatestore-prefetch", daemon=True
        )
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "done":
                    break
                if kind == "error":
                    raise payload
                yield payload
        finally:
            # consumer done or bailed early (exception / dropped
            # generator): release the reader so it never blocks holding
            # a staged block
            stop.set()
            t.join()

    def read_spooled(
        self, client_id: str, tenant: str = DEFAULT_TENANT,
    ) -> object:
        """One update read straight from the disk spool, without the
        index: a dense array (bf16 as ``BF16`` words) or a
        ``CompressedUpdate``. The other ranks of a mesh service share
        the first rank's spool, not its index, and read the rows it
        chose this way. Raises ``ValueError`` on the memory backend."""
        if self.backend != "disk":
            raise ValueError("read_spooled needs the disk backend: the "
                             "ranks of a mesh share a spool directory")
        path = self._path(client_id, tenant)
        blob = np.load(path)
        scales = self._sidecar_scales(path)
        if scales is not None:
            return CompressedUpdate(
                codes=blob, scales=scales,
                dim=self._sidecar_dim(path, default=int(blob.shape[0])),
            )
        dt = self._sidecar_dtype(path)
        return blob.view(dt) if dt is not None else blob

    def _load_block(
        self,
        batch: List[_Key],
        versions_out: Optional[Dict[str, int]] = None,
        keys_out: Optional[List[_Key]] = None,
    ) -> Optional[List[Tuple[object, np.ndarray, List[_Key]]]]:
        """Stack one batch of index keys into homogeneous sub-blocks
        ``[(payload, (c,) weights, loaded keys), ...]`` where payload is
        a dense (c, P) stored-dtype array or a :class:`CompressedBlock`
        — blob reads happen lock-free, stats update under the lock.

        Rows are GROUPED by payload kind (dense dtype+width, or
        compressed codes-width+block): an all-dense or all-compressed
        batch yields exactly one sub-block (the common case — grouping
        costs nothing), a mixed batch one per kind, in first-seen
        order, so the engines' fixed-shape step executables each see
        rectangular input. A key that vanished between the caller's
        snapshot and the read (consumed by a concurrent round's
        ``remove``, or evicted by the tailer's re-submission handling)
        is SKIPPED, honoring the read contract — a racing consume is at
        worst a smaller block, never a crashed round; ``None`` is
        returned when every key vanished. ``versions_out`` collects
        each id's write-version AS READ, for version-checked
        consumption (``remove``); it is keyed by client id, so it is
        only meaningful for single-tenant batches. ``keys_out``
        collects the keys actually loaded."""
        groups: Dict[tuple, Tuple[list, list, List[_Key]]] = {}
        n_loaded = 0
        for key in batch:
            try:
                u, w, v = self._read_versioned(key)
            except (KeyError, FileNotFoundError):
                continue   # consumed/evicted mid-flight: skip the row
            if versions_out is not None:
                versions_out[key[1]] = v
            if keys_out is not None:
                keys_out.append(key)
            if isinstance(u, CompressedUpdate):
                kind = ("q", u.codes.shape[0], u.scales.shape[0], u.dim)
            else:
                kind = ("d", u.dtype.str, u.shape[0])
            ups, ws, loaded = groups.setdefault(kind, ([], [], []))
            ups.append(u)
            ws.append(w)
            loaded.append(key)
            n_loaded += 1
        if not n_loaded:
            return None
        out: List[Tuple[object, np.ndarray, List[_Key]]] = []
        total_bytes = 0
        per_tenant: Dict[str, Tuple[int, int]] = {}
        for kind, (ups, ws, loaded) in groups.items():
            if kind[0] == "q":
                payload: object = CompressedBlock(
                    codes=np.stack([cu.codes for cu in ups]),
                    scales=np.stack([cu.scales for cu in ups]),
                    dim=kind[3],
                )
                nbytes = payload.nbytes
            else:
                payload = np.stack(ups)
                nbytes = payload.nbytes
            out.append((payload, np.asarray(ws, np.float32), loaded))
            total_bytes += nbytes
            row_bytes = nbytes // max(len(ups), 1)
            for t, _ in loaded:
                n_r, b_r = per_tenant.get(t, (0, 0))
                per_tenant[t] = (n_r + 1, b_r + row_bytes)
        with self._lock:
            self.stats.reads += n_loaded
            self.stats.bytes_read += total_bytes
            self.stats.peak_block_bytes = max(
                self.stats.peak_block_bytes, total_bytes
            )
            for t, (n_r, b_r) in per_tenant.items():
                ts = self._tstats(t)
                ts.reads += n_r
                ts.bytes_read += b_r
                ts.peak_block_bytes = max(ts.peak_block_bytes, b_r)
        return out

    def iter_arrivals(
        self,
        chunk_rows: int,
        should_close: Callable[[int, float], bool],
        poll_interval: float = 0.01,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        versions_out: Optional[Dict[str, int]] = None,
        stats_out: Optional[Dict[str, float]] = None,
        tenant: Optional[str] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, List[str]]]:
        """Arrival-driven streaming read — the async-round substrate.

        Yields (block, (c,) weights, client_ids) — block a dense (c, P)
        array or a :class:`CompressedBlock` (mixed partitions split each
        chunk into homogeneous per-kind blocks) — as soon as
        ``chunk_rows`` NEW updates have landed in ``tenant``'s partition
        (``None``: whole spool), without snapshotting the index up
        front: updates written while the stream is live are picked up on
        the next poll, so an engine can fold partial sums while
        stragglers are still writing — and writes tagged for OTHER
        tenants never enter this stream, which is what makes interleaved
        open rounds safe on one shared store. ``should_close(count,
        waited)`` — the Monitor's threshold/timeout gate — is consulted
        every poll with the total number of matching updates observed so
        far and the seconds since the call; once it returns True the
        stream CLOSES: everything already landed is drained (full
        blocks, then one ragged remainder) and iteration stops. Only the
        final block can be ragged, which is the contract the engines'
        fixed-shape step executables rely on. Updates written after the
        close belong to the next round.

        NOTE the third tuple element is the block's client ids — the
        engines' ``fuse_stream`` block protocol instead expects an
        optional numeric per-row scale there, so adapt (as
        ``AggregationService._async_round`` does) rather than feeding
        this iterator to an engine directly. ``versions_out`` collects
        write-versions as read (for version-checked ``remove``);
        ``stats_out["load_seconds"]`` accumulates actual block-staging
        I/O time, separate from the idle poll wait.
        """
        chunk_rows = max(int(chunk_rows), 1)
        seen: set = set()
        pending: List[_Key] = []
        start = clock()
        while True:
            with self._lock:
                keys = self._keys(tenant)
            fresh = [key for key in keys if key not in seen]
            seen.update(fresh)
            pending.extend(fresh)
            closed = should_close(len(seen), clock() - start)
            while len(pending) >= chunk_rows or (closed and pending):
                batch, pending = pending[:chunk_rows], pending[chunk_rows:]
                t0 = time.perf_counter()
                blks = self._load_block(batch, versions_out=versions_out)
                if stats_out is not None:
                    stats_out["load_seconds"] = (
                        stats_out.get("load_seconds", 0.0)
                        + time.perf_counter() - t0
                    )
                if blks is None:  # whole batch raced a consume/eviction
                    continue
                # ids of the rows ACTUALLY loaded — a key that raced a
                # concurrent consume is skipped, so the caller's folded
                # bookkeeping stays exact
                for payload, w, loaded in blks:
                    yield payload, w, [cid for _, cid in loaded]
            if closed:
                return
            # event-driven under the real clock: wake on the next write's
            # condition notify instead of burning the full poll interval
            self.wait_for_arrival(poll_interval, sleep)

    def read_stacked(
        self, tenant: Optional[str] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """All of ``tenant``'s updates as (n, P) + weights (n,) — the
        DENSE engine input. Order-statistic fusions still need this;
        reducible rounds should stream via ``iter_chunks`` instead.
        Compressed entries ARE dequantized here (host-side, fp32): the
        dense path exists precisely for fusions that need the full
        matrix."""
        ups, ws = [], []
        for block, w in self.iter_chunks(
            chunk_rows=1 << 62, prefetch=False, tenant=tenant
        ):
            if isinstance(block, CompressedBlock):
                block = block.dequantize()
            ups.append(block)
            ws.append(w)
        return np.concatenate(ups), np.concatenate(ws)

    def partition(
        self, n_parts: int, tenant: Optional[str] = None
    ) -> List[List[str]]:
        """Round-robin client placement over partitions (Spark-style),
        within ``tenant``'s partition (``None``: whole spool)."""
        ids = self.client_ids(tenant)
        return [ids[i::n_parts] for i in range(n_parts)]

    def remove(
        self,
        client_ids: Iterable[str],
        versions: Optional[Dict[str, int]] = None,
        tenant: str = DEFAULT_TENANT,
    ) -> None:
        """Consume updates from ``tenant``'s partition — async rounds
        treat the store as a queue and remove what they fold, so late
        stragglers are what remains for the next round, and a round can
        only ever consume its OWN tenant's updates. With ``versions``
        (id -> write-version as folded, from ``iter_arrivals``), an id
        whose version has since advanced is KEPT: a client that re-wrote
        mid-round keeps its newer update for the next round instead of
        losing it. Index entries drop under the lock; blob deletion,
        like all disk I/O, happens outside the critical section.

        The version guard is exact for the memory backend. On disk,
        ``write`` saves the blob before registering it, so a re-write
        racing the unlink batch is re-checked per id right before its
        files go; a write landing inside that last microsecond window can
        still lose its blob (lock-free spool limitation)."""
        keys = [(tenant, cid) for cid in client_ids]
        doomed = []
        with self._lock:
            for key in keys:
                if versions is not None and \
                        self._versions.get(key, 0) != \
                        versions.get(key[1], -1):
                    continue    # re-written since the fold: keep it
                self._drop_index_entry(key)
                doomed.append(key)
        if self.backend != "disk":
            return
        for key in doomed:
            if versions is not None:
                with self._lock:
                    if self._versions.get(key, 0) != \
                            versions.get(key[1], -1):
                        continue    # re-registered while we were unlinking
            self._unlink([key])

    def clear(self, tenant: Optional[str] = None) -> None:
        """Drop every update in ``tenant``'s partition — or the whole
        spool with ``tenant=None``, which also resets stats for a fresh
        round sequence. Keys are snapshotted under the lock; spool blobs
        are deleted outside it (the store's locking discipline: no disk
        I/O in the critical section)."""
        with self._lock:
            keys = self._keys(tenant)
            doomed = keys if self.backend == "disk" else []
            for key in keys:
                self._drop_index_entry(key)
            # grace timestamps purge by TENANT, not by index key —
            # grace-pending external blobs are in _ext_seen but not yet
            # in the index, and a stale first-seen time would skip the
            # grace window for the next blob with that id
            for key in [k for k in self._ext_seen
                        if tenant is None or k[0] == tenant]:
                self._ext_seen.pop(key, None)
            if tenant is None:
                self.stats = StoreStats()
                self._tenant_stats = {}
        self._unlink(doomed)

    def _unlink(self, keys: Iterable[_Key]) -> None:
        for tenant, cid in keys:
            base = self._path(cid, tenant)
            for path in (base, base + ".w", base + ".dtype",
                         base + ".scale", base + ".dim",
                         base + ".tenant"):
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass

    def _tenant_dir(self, tenant: str) -> str:
        """One tenant's disk partition: the spool root for the default
        tenant (restart-compatible with pre-tenant spools), a
        subdirectory for every other tenant."""
        if tenant == DEFAULT_TENANT:
            return self.spool_dir
        return os.path.join(self.spool_dir, tenant)

    def _path(self, client_id: str, tenant: str = DEFAULT_TENANT) -> str:
        return os.path.join(self._tenant_dir(tenant), f"{client_id}.npy")

    # -- external spool writers (tailing) ------------------------------------
    def _ext_register(
        self, cid: str, tenant: str, from_root: bool = False
    ) -> Optional[str]:
        """Try to register one externally written blob into ``tenant``'s
        partition. Returns the cid when newly registered, None when
        skipped (partial write, sidecar grace, already known)."""
        key = (tenant, cid)
        path = self._path(cid, tenant)
        try:
            blob = np.load(path, mmap_mode="r")
            nbytes = int(blob.nbytes)
            mtime = _stat_identity(path)
        except Exception:
            return None   # partial write: next pass gets it
        try:
            # a compressed external blob's .scale sidecar counts into
            # its quota/stats bytes — real on-disk size, like write()
            scales = np.load(path + ".scale", mmap_mode="r")
            nbytes += int(scales.nbytes)
        except Exception:
            pass   # dense blob (no sidecar) or sidecar mid-write
        try:
            with open(path + ".w") as f:
                weight = float(f.read())
        except (FileNotFoundError, ValueError):
            now = self.wall_clock()   # real elapsed, not self.clock
            with self._lock:
                first = self._ext_seen.setdefault(key, now)
            if now - first < self.sidecar_grace_seconds:
                return None   # sidecar may still be in flight
            weight = 1.0
        with self._lock:
            self._ext_seen.pop(key, None)
            if from_root:
                # a sidecar-routed ROOT blob was grace-tracked under
                # the DEFAULT key while its .tenant sidecar was in
                # flight — drop that too, or a later root re-submission
                # of this cid would read the stale first-seen time as
                # an already-expired grace window. (Subdir
                # registrations must NOT pop it: an unrelated root blob
                # with the same cid may be mid-grace.)
                self._ext_seen.pop((DEFAULT_TENANT, cid), None)
        victims: Dict[_Key, Tuple[int, Optional[Tuple]]] = {}
        try:
            with self._arrival_cv:
                if key in self._weights:
                    return None   # a concurrent write() beat us to it
                verdict, victims = self._quota_check_locked(key, nbytes)
                if verdict == "reject":
                    # over budget: the blob stays on disk unregistered
                    # (re-tried each pass) until capacity frees
                    return None
                self._weights[key] = weight
                self._counts[tenant] = self._counts.get(tenant, 0) + 1
                self._versions[key] = self._versions.get(key, 0) + 1
                self._arrivals[key] = self.clock()
                self._blob_mtime[key] = mtime
                self._account_write_locked(key, nbytes)
                self.stats.writes += 1
                self.stats.bytes_written += nbytes * self.replication
                ts = self._tstats(tenant)
                ts.writes += 1
                ts.bytes_written += nbytes * self.replication
                self._arrival_cv.notify_all()
        finally:
            self._unlink_evicted(victims)
        return cid

    def _ext_sidecar_tenant(self, cid: str) -> str:
        """Peek a ROOT-level external blob's ``.tenant`` sidecar — no
        side effects, so callers can consult the index BEFORE any files
        move. No sidecar (or one naming the default) -> the default
        tenant."""
        try:
            path = os.path.join(self.spool_dir, f"{cid}.npy.tenant")
            with open(path) as f:
                tenant = f.read().strip()
        except FileNotFoundError:
            return DEFAULT_TENANT
        return tenant or DEFAULT_TENANT

    def _ext_move_to_partition(
        self, cid: str, src_dir: str, tenant: str
    ) -> bool:
        """Move an external blob set (blob + sidecars) from ``src_dir``
        into ``tenant``'s partition directory, in place for
        registration. Returns False to defer: the ``.w`` weight sidecar
        may still be in flight behind the blob/``.tenant`` (the
        documented writer order blob -> .tenant -> .w) — moving before
        it lands would orphan the weight behind — so the move waits for
        ``.w`` or the sidecar grace window; an OSError (racing
        concurrent pass) also re-tries next tick."""
        src_base = os.path.join(src_dir, f"{cid}.npy")
        if not os.path.exists(src_base + ".w"):
            now = self.wall_clock()
            with self._lock:
                first = self._ext_seen.setdefault((tenant, cid), now)
            if now - first < self.sidecar_grace_seconds:
                return False   # defer until .w lands (or grace expires)
        dest_dir = self._tenant_dir(tenant)
        os.makedirs(dest_dir, exist_ok=True)
        try:
            # blob moves LAST, so a half-moved set never registers
            # half-done (the .scale/.dim sidecars of a compressed blob
            # are in place before the codes land)
            for suffix in (".w", ".dtype", ".scale", ".dim", ""):
                src = src_base + suffix
                if os.path.exists(src):
                    os.replace(src, self._path(cid, tenant) + suffix)
            try:
                os.remove(src_base + ".tenant")
            except FileNotFoundError:
                pass
        except OSError:
            return False
        return True

    def ingest_external(self) -> List[str]:
        """Register spool blobs written DIRECTLY into ``spool_dir`` by
        external processes (clients mounting the spool, not calling
        ``write``). Disk backend only; returns the newly registered
        client ids (across all tenants).

        Tenant routing: a blob inside ``spool_dir/<tenant>/`` registers
        in that tenant's partition; a root-level blob registers for the
        default tenant unless a ``<cid>.npy.tenant`` sidecar names one,
        in which case the files are moved into the named partition
        first. Writers using the sidecar route must emit it BEFORE the
        ``.w`` weight sidecar (blob -> .tenant -> .w): registration
        happens as soon as the weight is readable. COMPRESSED external
        blobs spool their int8 codes as the ``.npy`` plus ``.scale``
        (and optionally ``.dim``) sidecars, emitted before ``.w`` like
        ``.tenant`` — the registered bytes then count codes + scales,
        and reads yield the entry compressed.

        An unreadable blob (a write still in flight under the polling
        fallback) is skipped and picked up on a later pass — external
        writers should write-to-temp-then-rename so the inotify
        ``IN_MOVED_TO`` event always sees a complete file. Weight comes
        from the ``.w`` sidecar when present. A blob with NO sidecar yet
        is deferred for ``sidecar_grace_seconds`` (wall clock) before it
        registers at weight 1.0: writers emit blob-then-sidecar, so
        registering on first sight would race the sidecar and freeze the
        weight at the default — the sidecar's own close event (or the
        next poll tick) re-passes within the grace window.

        A re-submission that collides with a live default entry while
        the round folding that entry is CLOSING is safe: the eviction
        bumps the entry's write-version under the lock, so the close's
        version-checked ``remove`` skips its unlink batch (the
        re-submitted blob survives) and a streaming read that raced the
        eviction discards the stale bytes instead of folding them —
        see ``_evict_locked``."""
        if self.backend != "disk":
            return []
        with self._lock:
            known = set(self._weights)
        new: List[str] = []
        for name in sorted(os.listdir(self.spool_dir)):
            full = os.path.join(self.spool_dir, name)
            if os.path.isdir(full):
                for sub in sorted(os.listdir(full)):
                    if not sub.endswith(".npy"):
                        continue
                    cid = sub[: -len(".npy")]
                    if (name, cid) in known:
                        continue
                    if name == DEFAULT_TENANT:
                        # a literal 'default/' subdirectory: its files
                        # belong to the root partition — move them there
                        # (paths for the default tenant resolve to the
                        # root; registering in place would np.load a
                        # nonexistent root blob forever)
                        if not self._ext_move_to_partition(
                            cid, full, DEFAULT_TENANT
                        ):
                            continue
                    if self._ext_register(cid, name) is not None:
                        new.append(cid)
                continue
            if not name.endswith(".npy"):
                continue
            cid = name[: -len(".npy")]
            dkey = (DEFAULT_TENANT, cid)
            if dkey in known:
                if not os.path.exists(full + ".tenant"):
                    # common case — registered, no routing intent: one
                    # existence probe per pass, nothing else to do (a
                    # sidecar-less external re-write waits until the
                    # entry is consumed, like subdirectory re-writes)
                    continue
                # the root staging area is shared between default-
                # tenant clients and sidecar-routed external writers.
                # Ownership check: unchanged bytes (mtime as recorded
                # at registration) belong to the live entry — a stray
                # late .tenant sidecar must not move them out from
                # under the index; changed bytes are a NEW external
                # submission — evict the stale entry (its payload is
                # gone from disk) and re-ingest, honoring the sidecar.
                with self._lock:
                    recorded = self._blob_mtime.get(dkey)
                try:
                    current = _stat_identity(full)
                except OSError:
                    continue
                if recorded is None or current == recorded:
                    try:   # live entry owns the bytes: drop stray sidecar
                        os.remove(full + ".tenant")
                    except FileNotFoundError:
                        pass
                    continue
                with self._lock:
                    # eviction bumps the version, so a round CLOSING on
                    # the stale entry right now sees it as superseded:
                    # its version-checked remove skips the unlink (the
                    # re-submitted blob survives) and an in-flight
                    # _load_block read of the old bytes is discarded —
                    # the PR-4 evict-vs-closing-round race is closed
                    self._evict_locked(dkey)
                known.discard(dkey)
            # peek the tenant BEFORE moving anything: a blob registered
            # under the NAMED tenant must not have its files moved/
            # overwritten out from under that entry's version guard —
            # such a re-submission waits at the root until the
            # registered one is consumed, like subdirectory re-writes do
            tenant = self._ext_sidecar_tenant(cid)
            if not _valid_tenant(tenant):
                continue   # poisoned sidecar (path separators, ..): never route
            if (tenant, cid) in known:
                continue
            if tenant != DEFAULT_TENANT and not \
                    self._ext_move_to_partition(cid, self.spool_dir,
                                                tenant):
                continue
            if self._ext_register(cid, tenant, from_root=True) \
                    is not None:
                new.append(cid)
        return new

    def _recover(self) -> Dict[_Key, float]:
        """Rebuild the weight index from the spool after a restart —
        root blobs into the default tenant, one subdirectory per other
        tenant. Blobs still awaiting external ROUTING are left
        unregistered for ``ingest_external`` / the tailer: a root blob
        with a ``.tenant`` sidecar naming another tenant (registering
        it under default would steal it cross-tenant), and anything in
        a literal ``default/`` subdirectory (its files must move to the
        root before the default partition's paths resolve)."""

        def scan(directory: str, tenant: str) -> Dict[_Key, float]:
            weights: Dict[_Key, float] = {}
            for name in os.listdir(directory):
                if not name.endswith(".npy") or not \
                        os.path.isfile(os.path.join(directory, name)):
                    continue   # a subdirectory named *.npy is not a blob
                cid = name[: -len(".npy")]
                wpath = os.path.join(directory, name + ".w")
                try:
                    with open(wpath) as f:
                        weights[(tenant, cid)] = float(f.read())
                except (FileNotFoundError, ValueError):
                    weights[(tenant, cid)] = 1.0
            return weights

        recovered = scan(self.spool_dir, DEFAULT_TENANT)
        for cid in [c for _, c in recovered]:
            if self._ext_sidecar_tenant(cid) != DEFAULT_TENANT:
                recovered.pop((DEFAULT_TENANT, cid))   # pending routing
        for name in os.listdir(self.spool_dir):
            full = os.path.join(self.spool_dir, name)
            if os.path.isdir(full) and name != DEFAULT_TENANT:
                recovered.update(scan(full, name))
        return recovered


class _InotifyWatch:
    """Minimal ctypes inotify(7) binding: block until something lands in
    one of a set of directories. Raises ``OSError`` where inotify is
    unavailable (non-Linux, exhausted watch quota) — callers fall back
    to polling."""

    # no IN_CREATE: waking on creation would pass over files whose
    # contents (and sidecars) are still being written
    _IN_CLOSE_WRITE = 0x00000008
    _IN_MOVED_TO = 0x00000080

    def __init__(self, path: str):
        import ctypes
        import ctypes.util

        libc_name = ctypes.util.find_library("c") or "libc.so.6"
        self._libc = ctypes.CDLL(libc_name, use_errno=True)
        self._fd = self._libc.inotify_init()
        if self._fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init failed")
        self._watched: set = set()
        try:
            self.add(path)
        except OSError:
            os.close(self._fd)
            raise

    def add(self, path: str) -> None:
        """Watch one more directory (idempotent). Tenant subdirectories
        created after the tailer started are added this way."""
        import ctypes

        if path in self._watched:
            return
        mask = self._IN_CLOSE_WRITE | self._IN_MOVED_TO
        wd = self._libc.inotify_add_watch(
            self._fd, os.fsencode(path), mask
        )
        if wd < 0:
            raise OSError(
                ctypes.get_errno(), f"inotify_add_watch({path}) failed"
            )
        self._watched.add(path)

    def wait(self, timeout: float) -> bool:
        """True if at least one filesystem event fired within ``timeout``
        seconds (the event buffer is drained either way)."""
        import select

        ready, _, _ = select.select([self._fd], [], [], timeout)
        if not ready:
            return False
        try:
            os.read(self._fd, 65536)   # drain; content doesn't matter
        except OSError:
            return False
        return True

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass


class SpoolTailer:
    """Arrival-driven tailing of a DISK spool written by external
    processes: a daemon thread registers foreign blobs into the store
    index the moment they land, so ``iter_arrivals`` / the monitor see
    them like any ``write()``. Blobs are routed to their tenant
    partition by subdirectory (``spool_dir/<tenant>/``) or by a
    ``.tenant`` sidecar at the spool root (see
    ``UpdateStore.ingest_external``).

    Uses inotify (``IN_CLOSE_WRITE`` / ``IN_MOVED_TO``) when the
    platform provides it — arrivals wake the tailer immediately instead
    of on the next poll tick — and degrades to mtime-free directory
    polling at ``poll_interval`` elsewhere; ``event_driven`` reports
    which mode is live. Tenant subdirectories are discovered (and
    watched) as they appear, at poll cadence. Use as a context manager
    around a round::

        with SpoolTailer(store) as tailer:
            service.aggregate(from_store=True, async_round=True)
    """

    def __init__(self, store: UpdateStore, poll_interval: float = 0.25):
        if store.backend != "disk":
            raise ValueError("SpoolTailer tails DISK spools only")
        self.store = store
        self.poll_interval = poll_interval
        self.event_driven = False
        self._watch: Optional[_InotifyWatch] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _watch_tenant_dirs(self) -> None:
        """Add inotify watches for tenant subdirectories created since
        the last pass (no-op under the polling fallback)."""
        if self._watch is None:
            return
        for name in os.listdir(self.store.spool_dir):
            full = os.path.join(self.store.spool_dir, name)
            if os.path.isdir(full):
                try:
                    self._watch.add(full)
                except OSError:
                    pass   # quota/teardown race: polling still covers it

    def start(self) -> "SpoolTailer":
        try:
            self._watch = _InotifyWatch(self.store.spool_dir)
            self.event_driven = True
        except Exception:
            self._watch = None   # polling fallback
        self._watch_tenant_dirs()
        self.store.ingest_external()   # catch anything already spooled
        self._thread = threading.Thread(
            target=self._run, name="spool-tailer", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._watch is not None:
                self._watch.wait(self.poll_interval)
            else:
                self._stop.wait(self.poll_interval)
            if self._stop.is_set():
                return
            self._watch_tenant_dirs()
            self.store.ingest_external()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._watch is not None:
            self._watch.close()
            self._watch = None

    def __enter__(self) -> "SpoolTailer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
