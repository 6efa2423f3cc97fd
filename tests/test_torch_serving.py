"""The port's serving layer (``repro_torch.serving``, ``repro_torch.fl``,
``repro_torch.launch.serve``) against the JAX package's, on the CPU.

Twins of the 18 tests of ``tests/test_serving.py`` that need no
benchmark, on port services with ``device="cpu"``: the socket round is
bitwise the in-process round (dense, compressed, mixed frames); every
admission rejection (401 / 404 / 400 / 413 / 411 / 429 / 503) lands
nothing; uploads coalesce into batched commits; the four fair-scheduler
cases, here driven through ``EdgeAggregatorServer``'s scheduler; and the
trace-replayed multi-tenant smoke at rtol 1e-5, atol 1e-5, which with
the coalescing test runs under the reference's lock-order witness fitted
onto the port's service. ``test_ingest_benchmark_quick_smoke`` has no
twin: it drives ``benchmarks/ingest_service.py``, which is not ported.

Across the packages: either package's ``HttpStoreClient`` uploads to the
other's ``IngestServer`` and ``store.read`` returns the sent rows and
weights bit for bit; both packages fuse the same uploads to vectors
equal at Eq. 1's tolerance (rtol 2e-5, atol 1e-6); and the serve CLI
runs on the CPU in-process and in a subprocess, and without a card
raises the port's "no CUDA device" error.
"""
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.analysis.witness import LockOrderWitness, instrument_service
from repro.core import AggregationService as JService
from repro.core import UpdateStore as JStore
from repro.core.compress import compress_update as jcompress_update
from repro.serving import HttpStoreClient as JClient
from repro.serving import IngestServer as JServer
from repro_torch.core import AggregationService, UpdateStore
from repro_torch.core.compress import CompressedUpdate, compress_update
from repro_torch.fl import EdgeAggregatorServer
from repro_torch.launch import serve
from repro_torch.serving import (
    AdmissionController,
    BackpressureError,
    HttpStoreClient,
    IngestError,
    IngestQueue,
    IngestServer,
    encode_update,
)
from repro_torch.utils.dtypes import BF16, host_array

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

TOKENS = {"tok-a": "appa", "tok-b": "appb"}
CLIENT_TOKENS = {"appa": "tok-a", "appb": "tok-b"}
RTOL, ATOL = 2e-5, 1e-6   # Eq. 1's tolerance (tests/test_kernels.py)


def _mk_service(store, timeout=5.0, **kw):
    return AggregationService(
        fusion="fedavg", store=store, threshold_frac=1.0,
        monitor_timeout=timeout, device="cpu", **kw,
    )


def _payloads(n, p, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(p,)).astype(np.float32) for _ in range(n)]


def _post_raw(port, body, token="tok-a", path="/v1/upload",
              content_length=None):
    """One raw POST, returning (status, headers, body)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST",
        headers={"Authorization": f"Bearer {token}",
                 "Content-Type": "application/octet-stream"},
    )
    if content_length is not None:
        req.add_header("Content-Length", str(content_length))
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.fixture
def port_witness(monkeypatch):
    """The reference's lock-order witness on every port service built
    while the fixture is active (the port's twin of ``lock_witness``)."""
    witness = LockOrderWitness()
    orig_init = AggregationService.__init__

    def patched(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        instrument_service(self, witness)

    monkeypatch.setattr(AggregationService, "__init__", patched)
    yield witness
    witness.check()


# -- e2e exactness -----------------------------------------------------------

def _u_for(mode, i, vec):
    if mode == "dense" or (mode == "mixed" and i % 2 == 0):
        return vec
    return compress_update(vec, block=256)


@pytest.mark.parametrize("mode", ["dense", "compressed", "mixed"])
def test_socket_round_bit_identical_to_inprocess(mode):
    """upload -> round == store.write -> round, bitwise, for dense,
    compressed, and mixed payload populations."""
    n, p = 6, 1500
    payloads = _payloads(n, p)

    ref_store = UpdateStore()
    for i, vec in enumerate(payloads):
        ref_store.write(f"c{i}", _u_for(mode, i, vec), weight=1.0 + i,
                        tenant="appa")
    ref_fused, ref_rep = _mk_service(ref_store).aggregate(
        from_store=True, expected_clients=n, tenant="appa")

    store = UpdateStore()
    svc = _mk_service(store)
    with IngestServer(store, TOKENS) as srv:
        cli = HttpStoreClient("127.0.0.1", srv.port,
                              tokens=CLIENT_TOKENS)
        for i, vec in enumerate(payloads):
            cli.write(f"c{i}", _u_for(mode, i, vec), weight=1.0 + i,
                      tenant="appa")
        fused, rep = svc.aggregate(from_store=True,
                                   expected_clients=n, tenant="appa")
    assert rep.n_clients == ref_rep.n_clients == n
    assert fused.dtype == ref_fused.dtype
    assert torch.equal(fused, ref_fused), "socket round diverged bitwise"


def test_upload_weights_and_bytes_land_exactly():
    store = UpdateStore()
    vec = np.arange(300, dtype=np.float32)
    with IngestServer(store, TOKENS) as srv:
        cli = HttpStoreClient("127.0.0.1", srv.port, token="tok-a")
        lat = cli.write("c0", vec, weight=3.5, tenant="appa")
        assert lat > 0   # the modeled store latency came back
        got, w = store.read("c0", tenant="appa")
        assert w == 3.5
        assert np.array_equal(np.asarray(got), vec)
        st = store.stats_for("appa")
        assert st.writes == 1
        assert st.bytes_written == vec.nbytes * store.replication


# -- auth / malformed / oversized: fail closed -------------------------------

def test_bad_token_is_401_and_lands_nothing():
    store = UpdateStore()
    with IngestServer(store, TOKENS) as srv:
        body = encode_update("c0", np.ones(8, np.float32))
        status, _, _ = _post_raw(srv.port, body, token="tok-nope")
        assert status == 401
        status, _, _ = _post_raw(srv.port, body, token="")
        assert status == 401
        assert srv.metrics().get("unauthorized") == 2
    assert store.count() == 0


def test_unknown_route_is_404():
    with IngestServer(UpdateStore(), TOKENS) as srv:
        status, _, _ = _post_raw(srv.port, b"x", path="/v1/nope")
        assert status == 404
        status = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/v1/healthz", timeout=5
        ).status
        assert status == 200


@pytest.mark.parametrize("mangle", [
    lambda b: b[:-3],                      # truncated tail
    lambda b: b + b"\x00\x01",             # trailing garbage
    lambda b: b"XXXX" + b[4:],             # bad magic
    lambda b: b[:4] + b"\x07" + b[5:],     # unknown kind
    lambda b: b"",                         # empty body
], ids=["truncated", "trailing", "magic", "kind", "empty"])
def test_malformed_frame_is_400_and_lands_nothing(mangle):
    store = UpdateStore()
    good = encode_update("c0", np.ones(64, np.float32), weight=2.0)
    with IngestServer(store, TOKENS) as srv:
        status, _, body = _post_raw(srv.port, mangle(good))
        assert status == 400, body
        assert store.count() == 0
        # the connection / server stay usable after a reject
        status, _, _ = _post_raw(srv.port, good)
        assert status == 200
    assert store.count() == 1


def test_oversized_body_is_413_and_lands_nothing():
    store = UpdateStore()
    with IngestServer(store, TOKENS, max_body_bytes=1024) as srv:
        body = encode_update("c0", np.ones(4096, np.float32))
        status, _, _ = _post_raw(srv.port, body)
        assert status == 413
        assert srv.metrics().get("shed_413") == 1
    assert store.count() == 0


def test_missing_content_length_is_411():
    with IngestServer(UpdateStore(), TOKENS) as srv:
        # raw socket: POST with no Content-Length at all
        s = socket.create_connection(("127.0.0.1", srv.port),
                                     timeout=5)
        try:
            s.sendall(b"POST /v1/upload HTTP/1.1\r\n"
                      b"Host: x\r\nAuthorization: Bearer tok-a\r\n"
                      b"\r\n")
            resp = s.recv(4096)
        finally:
            s.close()
        assert b"411" in resp.split(b"\r\n", 1)[0]
        assert srv.metrics().get("bad_length") == 1


# -- rate limiting / quotas --------------------------------------------------

def test_rate_limit_429_with_retry_after_and_no_partial_blob():
    store = UpdateStore()
    with IngestServer(store, TOKENS, rate=1e-3, burst=2.0) as srv:
        body = encode_update("c0", np.ones(32, np.float32))
        # burst=2 admits two, third sheds
        assert _post_raw(srv.port, body)[0] == 200
        assert _post_raw(srv.port,
                         encode_update("c1",
                                       np.ones(32, np.float32)))[0] \
            == 200
        status, headers, _ = _post_raw(
            srv.port, encode_update("c2", np.ones(32, np.float32)))
        assert status == 429
        assert float(headers["Retry-After"]) > 0
        # the shed upload landed NOTHING; the admitted two are intact
        assert store.count(tenant="appa") == 2
        assert sorted(store.client_ids(tenant="appa")) == ["c0", "c1"]
        # and rate limits are per tenant: appb is unaffected
        status, _, _ = _post_raw(
            srv.port, encode_update("b0", np.ones(32, np.float32)),
            token="tok-b")
        assert status == 200


def _spool_files(root):
    return sorted(os.path.join(r, f) for r, _, fs in os.walk(root)
                  for f in fs)


def test_quota_429_never_lands_a_partial_blob(tmp_path):
    """Quota rejection on a DISK store: no orphan file, no index entry,
    byte accounting untouched."""
    store = UpdateStore(backend="disk", spool_dir=str(tmp_path))
    store.set_quota("appa", max_updates=2, policy="reject")
    with IngestServer(store, TOKENS) as srv:
        cli = HttpStoreClient("127.0.0.1", srv.port, token="tok-a",
                              max_attempts=2, sleep=lambda s: None)
        cli.write("c0", np.ones(64, np.float32), tenant="appa")
        cli.write("c1", np.ones(64, np.float32), tenant="appa")
        before = _spool_files(tmp_path)
        bytes_before = store.tenant_bytes("appa")
        with pytest.raises(IngestError) as ei:
            cli.write("c2", np.ones(64, np.float32), tenant="appa")
        assert "429" in str(ei.value) or ei.value.status == 429
        assert store.count(tenant="appa") == 2
        assert store.tenant_bytes("appa") == bytes_before
        assert _spool_files(tmp_path) == before, "429 left an orphan blob"
        assert srv.metrics().get("shed_429", 0) >= 1


def test_store_quota_reject_at_commit_time_is_429(tmp_path):
    """With the admission pre-check disabled, the store's own quota
    check at commit time is authoritative: it surfaces as the same 429,
    lands nothing — and, knowing the client_id, lets a resident client
    be replaced at full count quota."""
    store = UpdateStore(backend="disk", spool_dir=str(tmp_path))
    store.set_quota("appa", max_updates=2, policy="reject")
    admission = AdmissionController(TOKENS)   # no store: no pre-check
    with IngestServer(store, TOKENS, admission=admission) as srv:
        cli = HttpStoreClient("127.0.0.1", srv.port, token="tok-a",
                              max_attempts=2, sleep=lambda s: None)
        cli.write("c0", np.ones(64, np.float32), tenant="appa")
        cli.write("c1", np.ones(64, np.float32), tenant="appa")
        with pytest.raises(IngestError):
            cli.write("c2", np.ones(64, np.float32), tenant="appa")
        assert srv.metrics().get("quota_reject", 0) >= 1
        assert store.count(tenant="appa") == 2
        assert cli.write("c0", np.zeros(64, np.float32),
                         tenant="appa") > 0
        got, _ = store.read("c0", tenant="appa")
        assert not np.any(np.asarray(got))


# -- backpressure ------------------------------------------------------------

class _GatedStore:
    """Store proxy whose write_batch blocks on an Event — makes the
    committer hang so the IngestQueue saturates deterministically."""

    def __init__(self, store, gate):
        self._store = store
        self._gate = gate

    def write_batch(self, items):
        self._gate.wait(timeout=30)
        return self._store.write_batch(items)

    def __getattr__(self, name):
        return getattr(self._store, name)


def _wait_drained(q):
    deadline = time.time() + 5
    while q.depth() > 0 and time.time() < deadline:
        time.sleep(0.01)
    return q.depth()


def test_backpressure_503_when_queue_saturated():
    store = UpdateStore()
    gate = threading.Event()
    q = IngestQueue(_GatedStore(store, gate), maxsize=2, batch_max=2)
    with IngestServer(store, TOKENS, ingest_queue=q,
                      commit_timeout=30.0) as srv:
        # the committer takes the first submission (depth back to 0),
        # then two more fill the queue
        futs = [q.submit("h0", np.ones(16, np.float32))]
        assert _wait_drained(q) == 0, "committer never picked up the head"
        futs.append(q.submit("h1", np.ones(16, np.float32)))
        futs.append(q.submit("h2", np.ones(16, np.float32)))
        assert q.depth() == 2
        body = encode_update("c99", np.ones(16, np.float32))
        status, headers, _ = _post_raw(srv.port, body)
        assert status == 503
        assert float(headers["Retry-After"]) > 0
        assert srv.metrics().get("backpressure") == 1
        assert q.stats()["shed"] >= 1
        gate.set()           # release the committer; queued commits land
        for f in futs:
            assert f.result(timeout=10) > 0
        status, _, _ = _post_raw(srv.port, body)
        assert status == 200
    assert sorted(store.client_ids()) == ["c99", "h0", "h1", "h2"]


def test_ingest_queue_backpressure_error_direct():
    gate = threading.Event()
    q = IngestQueue(_GatedStore(UpdateStore(), gate), maxsize=1,
                    batch_max=4)
    q.submit("a", np.ones(4, np.float32))
    _wait_drained(q)     # committer picked up the first
    q.submit("b", np.ones(4, np.float32))   # fills the queue
    with pytest.raises(BackpressureError) as ei:
        q.submit("c", np.ones(4, np.float32))
    assert ei.value.retry_after > 0
    gate.set()
    q.close()
    assert q.stats()["committed"] == 2 and q.stats()["shed"] == 1


# -- batched commits ---------------------------------------------------------

def test_concurrent_uploads_coalesce_into_batches(port_witness):
    """Stalled uploads coalesce into batched commits; the witnessed store
    lock is the one the committer takes, and a round folds the batch."""
    store = UpdateStore()
    svc = _mk_service(store)   # witnessed: wraps the store's lock
    gate = threading.Event()
    q = IngestQueue(_GatedStore(store, gate), maxsize=64, batch_max=16)
    rows = [np.full(8, i, np.float32) for i in range(12)]
    futs = [q.submit(f"c{i}", rows[i], weight=1.0, tenant="appa")
            for i in range(12)]
    gate.set()
    for f in futs:
        assert f.result(timeout=10) > 0
    stats = q.stats()
    q.close()
    assert stats["committed"] == 12
    assert stats["batches"] < 12
    assert stats["max_batch"] > 1
    assert store.count(tenant="appa") == 12
    fused, rep = svc.aggregate(from_store=True, expected_clients=12,
                               tenant="appa")
    assert rep.n_clients == 12
    np.testing.assert_allclose(fused.numpy(), np.full(8, 5.5), rtol=RTOL,
                               atol=ATOL)


# -- fair scheduler, through EdgeAggregatorServer ----------------------------

class _Recorder:
    """Stands in for a port service's ``aggregate``: records concurrency
    and tenants, blocks until released."""

    def __init__(self):
        self.lock = threading.Lock()
        self.active = 0
        self.peak = 0
        self.calls = []
        self.block = threading.Event()

    def __call__(self, tenant=None, **kw):
        with self.lock:
            self.active += 1
            self.peak = max(self.peak, self.active)
            self.calls.append(tenant)
        self.block.wait(timeout=10)
        time.sleep(0.01)
        with self.lock:
            self.active -= 1
        return (torch.zeros(2), None)


def _edge(store=None, **kw):
    """An EdgeAggregatorServer over a CPU service whose rounds the
    recorder stands in for."""
    svc = _mk_service(store if store is not None else UpdateStore())
    rec = _Recorder()
    svc.aggregate = rec
    return EdgeAggregatorServer(svc, TOKENS, **kw), rec


def _wait_running(sched, count):
    deadline = time.time() + 5
    while len(sched.running()) < count and time.time() < deadline:
        time.sleep(0.01)
    return sched.running()


def test_fair_scheduler_bounds_concurrency():
    edge, rec = _edge(max_running=2)
    with edge:
        futs = [edge.submit_round(f"t{i}") for i in range(6)]
        assert len(_wait_running(edge.scheduler, 2)) == 2
        assert edge.metrics()["rounds_running"] == 2
        rec.block.set()
        for f in futs:
            f.result(timeout=10)
        assert edge.metrics()["rounds_admitted"] == 6
    assert rec.peak <= 2
    assert sorted(rec.calls) == sorted(f"t{i}" for i in range(6))


def test_fair_scheduler_weighted_share():
    """Under contention (max_running=1, standing backlog) a weight-2
    tenant is admitted twice as often as a weight-1 tenant."""
    edge, rec = _edge(max_running=1, weights={"heavy": 2.0, "light": 1.0})
    with edge:
        futs = [edge.submit_round("heavy") for _ in range(8)] + \
               [edge.submit_round("light") for _ in range(4)]
        _wait_running(edge.scheduler, 1)
        rec.block.set()
        for f in futs:
            f.result(timeout=30)
        order = edge.scheduler.admission_order()
    for i in range(1, len(order) + 1):
        h, lt = order[:i].count("heavy"), order[:i].count("light")
        assert abs(h - 2 * lt) <= 2, f"2:1 share violated at {order[:i]}"


def test_fair_scheduler_same_tenant_rounds_serialize():
    edge, rec = _edge(max_running=4)
    rec.block.set()
    with edge:
        futs = [edge.submit_round("only") for _ in range(3)]
        for f in futs:
            f.result(timeout=10)
    assert rec.peak == 1   # one in flight per tenant, ever


def test_fair_scheduler_capacity_gate():
    """A tenant whose projected footprint busts capacity waits until
    the running set drains — but runs alone rather than deadlocking.
    The footprint is read from the live store: 4 rows of 1000 fp32 a
    tenant, 2 * 4 * 4000 = 32000 B."""
    store = UpdateStore()
    for t in ("a", "b"):
        for i in range(4):
            store.write(f"c{i}", np.zeros(1000, np.float32), tenant=t)
    edge, rec = _edge(store, max_running=2, capacity_bytes=40_000)
    with edge:
        f1 = edge.submit_round("a")
        assert _wait_running(edge.scheduler, 1) == ["a"]
        f2 = edge.submit_round("b")   # 32000 + 32000 > 40000: b waits
        time.sleep(0.3)
        assert edge.scheduler.running() == ["a"]
        assert edge.scheduler.waiting().get("b") == 1
        rec.block.set()
        f1.result(timeout=10)
        f2.result(timeout=10)
    assert sorted(rec.calls) == ["a", "b"]


# -- trace-replayed multi-tenant smoke ---------------------------------------

def test_trace_replayed_multitenant_smoke(port_witness):
    """A seeded WorkloadSpec trace driving the port's serving stack: K
    tenants replay over real sockets, rounds run through the fair
    scheduler, and every tenant's fused vector matches the formula."""
    from repro_torch.workload import (
        FixedSize, RegimeSchedule, UniformArrivals, WorkloadSpec,
        start_writer, trace_payload,
    )

    k, n, p, seed = 3, 8, 600, 7
    spec = WorkloadSpec(
        tenants=tuple(f"app{i}" for i in range(k)),
        n_clients=n, rounds=1,
        regimes=RegimeSchedule.single(UniformArrivals(spread=0.2)),
        sizes=FixedSize(dim=p),
    )
    trace = spec.build(seed)
    tenants = [tr.tenant for tr in trace.rounds[0].tenants]
    tokens = {f"tok-{t}": t for t in tenants}
    store = UpdateStore()
    svc = _mk_service(store, timeout=20.0)
    with EdgeAggregatorServer(svc, tokens, max_running=2) as edge:
        writers = [
            start_writer(
                None, tr, seed,
                writer=HttpStoreClient(
                    "127.0.0.1", edge.port, token=f"tok-{tr.tenant}"
                ).write,
            )
            for tr in trace.rounds[0].tenants
        ]
        results = edge.run_rounds(tenants, expected_clients=n)
        for w in writers:
            w.join(timeout=30)
            assert not w.is_alive()
    for tr in trace.rounds[0].tenants:
        fused, rep = results[tr.tenant]
        assert rep.n_clients == n
        u = np.stack([trace_payload(seed, tr.tenant, ev.client_id, p)
                      for ev in tr.events])
        w = np.asarray([ev.weight for ev in tr.events], np.float32)
        ref = np.einsum("np,n->p", u, w) / (w.sum() + 1e-6)
        np.testing.assert_allclose(fused.numpy(), ref, rtol=1e-5,
                                   atol=1e-5, err_msg=tr.tenant)
    assert len(edge.scheduler.admission_order()) == k
    assert edge.metrics()["accepted"] == k * n


# -- across the packages -----------------------------------------------------

def _sent(kind, i, p=700):
    """(the port's payload, the reference's payload) with the same bits,
    and the bytes ``store.read`` must return."""
    vec = np.random.default_rng(100 + i).normal(size=(p,)).astype(np.float32)
    if kind == "fp32":
        return vec, vec, vec.tobytes()
    if kind == "bf16":
        words = host_array(torch.from_numpy(vec).to(torch.bfloat16))
        return (words, words.view(np.uint16).view(ml_dtypes.bfloat16),
                words.tobytes())
    ours = compress_update(vec, block=128)
    return ours, jcompress_update(vec, block=128), \
        ours.codes.tobytes() + ours.scales.tobytes()


def _read_bytes(got):
    if hasattr(got, "codes"):
        return np.asarray(got.codes).tobytes() \
            + np.asarray(got.scales).tobytes()
    return np.asarray(got).tobytes()


@pytest.mark.parametrize("kind", ["fp32", "bf16", "compressed"])
@pytest.mark.parametrize("direction", ["jax-client-to-port-server",
                                       "port-client-to-jax-server"])
def test_clients_upload_across_packages_bitwise(direction, kind):
    to_port = direction == "jax-client-to-port-server"
    store = UpdateStore() if to_port else JStore()
    server_cls = IngestServer if to_port else JServer
    client_cls = JClient if to_port else HttpStoreClient
    with server_cls(store, TOKENS) as srv:
        cli = client_cls("127.0.0.1", srv.port, tokens=CLIENT_TOKENS)
        for i in range(3):
            ours, theirs, _ = _sent(kind, i)
            cli.write(f"c{i}", theirs if to_port else ours,
                      weight=0.5 + i, tenant="appb")
        cli.close()
    assert store.count(tenant="appb") == 3
    for i in range(3):
        got, w = store.read(f"c{i}", tenant="appb")
        assert w == 0.5 + i
        assert _read_bytes(got) == _sent(kind, i)[2]
        if to_port and kind == "bf16":
            assert got.dtype == BF16
        if to_port and kind == "compressed":
            assert isinstance(got, CompressedUpdate)


@pytest.mark.parametrize("mode", ["dense", "compressed", "mixed"])
def test_fused_vectors_agree_across_packages(mode):
    """The same uploads through each package's client and server, and
    each package's round: equal at Eq. 1's tolerance."""
    n, p = 6, 1500
    payloads = _payloads(n, p, seed=3)
    store, jstore = UpdateStore(), JStore()
    svc = _mk_service(store)
    jsvc = JService(fusion="fedavg", local_strategy="jnp", store=jstore,
                    threshold_frac=1.0, monitor_timeout=5.0)
    with IngestServer(store, TOKENS) as srv, JServer(jstore, TOKENS) as jsrv:
        cli = HttpStoreClient("127.0.0.1", srv.port, token="tok-a")
        jcli = JClient("127.0.0.1", jsrv.port, token="tok-a")
        for i, vec in enumerate(payloads):
            compressed = _u_for(mode, i, vec) is not vec
            cli.write(f"c{i}", compress_update(vec, block=256)
                      if compressed else vec, weight=1.0 + i, tenant="appa")
            jcli.write(f"c{i}", jcompress_update(vec, block=256)
                       if compressed else vec, weight=1.0 + i,
                       tenant="appa")
    fused, rep = svc.aggregate(from_store=True, expected_clients=n,
                               tenant="appa")
    jfused, jrep = jsvc.aggregate(from_store=True, expected_clients=n,
                                  tenant="appa")
    assert rep.n_clients == jrep.n_clients == n
    assert rep.bytes_ingested == jrep.bytes_ingested
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused), rtol=RTOL,
                               atol=ATOL)


# -- the serve CLI -------------------------------------------------------------

def _cli_oracle(argv, rounds):
    """Each round's fused vectors against the trace's formula."""
    from repro_torch.workload import trace_payload

    args = serve.parse_args(argv)
    trace = serve.build_spec(args).build(args.seed)
    for rt, results in zip(trace.rounds, rounds):
        assert sorted(results) == [tr.tenant for tr in rt.tenants]
        for tr in rt.tenants:
            fused, rep = results[tr.tenant]
            assert rep.n_clients == args.clients and not rep.empty
            u = np.stack([trace_payload(args.seed, tr.tenant, ev.client_id,
                                        args.dim) for ev in tr.events])
            w = np.asarray([ev.weight for ev in tr.events], np.float64)
            ref = np.einsum("np,n->p", u.astype(np.float64), w) / w.sum()
            # an int8 row (error feedback on) is within one quantization
            # step of its fp32 row, and so is their weighted mean
            atol = np.abs(u).max() / 127 if args.compress else ATOL
            np.testing.assert_allclose(fused.numpy(), ref, rtol=RTOL,
                                       atol=atol)


@pytest.mark.parametrize("extra", [[], ["--compress", "--rate", "5",
                                        "--burst", "2"]],
                         ids=["fp32", "int8-rate-limited"])
def test_serve_cli_in_process(extra):
    argv = ["--device", "cpu", "--tenants", "2", "--clients", "6",
            "--dim", "3000", "--rounds", "2", *extra]
    rounds, metrics = serve.main(argv)
    assert len(rounds) == 2
    _cli_oracle(argv, rounds)
    assert metrics["accepted"] == 2 * 6 * 2
    assert metrics["committed"] == 2 * 6 * 2
    assert metrics["rounds_admitted"] == 4
    if extra:   # 2 + 5 * 0.3 tokens for 6 uploads in 0.3 s: some shed
        assert metrics.get("shed_429", 0) > 0


def test_serve_cli_subprocess():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--tenants", "2", "--clients", "4", "--dim", "2000"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "uploads=8 " in res.stdout
    assert res.stdout.count("included=4/4") == 2


def test_serve_cli_defaults_to_the_card():
    args = serve.parse_args([])
    assert args.device == "cuda" and args.local_strategy == "kernel"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--tenants", "1", "--clients", "2"])
