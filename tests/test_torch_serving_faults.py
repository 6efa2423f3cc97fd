"""Fault injection against the port's ingest front-end (CPU).

Twins of the 6 tests of ``tests/test_serving_faults.py``, with the same
invariant — a failed upload lands NOTHING, a recovered server loses
NOTHING:

  * mid-upload disconnect (FIN short of Content-Length) or mid-header:
    counted, no registration, the client's retry lands exactly once;
  * slow-loris (stalled body): the read timeout turns a pinned handler
    thread into a 408, and other tenants' uploads are not held up;
  * front-end kill + restart over a DISK spool, dense and compressed: a
    fresh ``UpdateStore`` recovers every committed update with no
    duplicate and no phantom, and the recovered round equals the formula
    (rtol 1e-5, atol 1e-5) and the reference service's round on a
    reference store recovered from the same spool (Eq. 1's rtol 2e-5,
    atol 1e-6).
"""
import os
import socket
import time

import numpy as np

from repro.core import AggregationService as JService
from repro.core import UpdateStore as JStore
from repro_torch.core import AggregationService, UpdateStore
from repro_torch.core.compress import compress_update
from repro_torch.serving import HttpStoreClient, IngestServer, encode_update

TOKENS = {"tok-a": "appa", "tok-b": "appb"}


def _partial_upload(port, token, body, fraction=0.5):
    """Send the request head declaring the FULL Content-Length, then
    only ``fraction`` of the body, then FIN (a deterministic mid-upload
    disconnect)."""
    cut = max(1, int(len(body) * fraction))
    head = (
        f"POST /v1/upload HTTP/1.1\r\n"
        f"Host: 127.0.0.1\r\n"
        f"Authorization: Bearer {token}\r\n"
        f"Content-Length: {len(body)}\r\n\r\n"
    ).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    try:
        s.sendall(head + body[:cut])
    finally:
        s.close()


def _wait_metric(srv, name, at_least, deadline_s=10.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if srv.metrics().get(name, 0) >= at_least:
            return True
        time.sleep(0.02)
    return False


# -- mid-upload disconnect ---------------------------------------------------

def test_mid_upload_disconnect_lands_nothing_then_retry_lands_once():
    store = UpdateStore()
    vec = np.arange(2000, dtype=np.float32)
    body = encode_update("c0", vec, weight=2.0)
    with IngestServer(store, TOKENS) as srv:
        for frac in (0.1, 0.5, 0.9):
            _partial_upload(srv.port, "tok-a", body, fraction=frac)
        assert _wait_metric(srv, "disconnect", 3), srv.metrics()
        assert store.count() == 0, "a torn upload landed a blob"
        cli = HttpStoreClient("127.0.0.1", srv.port, token="tok-a")
        cli.write("c0", vec, weight=2.0, tenant="appa")
        assert store.count(tenant="appa") == 1
        got, w = store.read("c0", tenant="appa")
        assert w == 2.0 and np.array_equal(np.asarray(got), vec)
        assert srv.metrics().get("accepted") == 1


def test_disconnect_even_mid_header_does_not_wedge_the_server():
    store = UpdateStore()
    with IngestServer(store, TOKENS) as srv:
        for _ in range(4):
            s = socket.create_connection(("127.0.0.1", srv.port),
                                         timeout=5.0)
            s.sendall(b"POST /v1/upload HT")   # torn mid-request-line
            s.close()
        cli = HttpStoreClient("127.0.0.1", srv.port, token="tok-a")
        cli.write("c1", np.ones(32, np.float32), tenant="appa")
        assert store.count(tenant="appa") == 1


# -- slow-loris --------------------------------------------------------------

def _stall_head(port, token, body, sent):
    head = (
        f"POST /v1/upload HTTP/1.1\r\nHost: 127.0.0.1\r\n"
        f"Authorization: Bearer {token}\r\n"
        f"Content-Length: {len(body)}\r\n\r\n"
    ).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=10.0)
    s.sendall(head + body[:sent])   # ...then stall, socket open
    return s


def test_slow_loris_body_stall_times_out_with_408():
    store = UpdateStore()
    body = encode_update("c0", np.ones(4000, np.float32))
    with IngestServer(store, TOKENS, read_timeout=0.3) as srv:
        s = _stall_head(srv.port, "tok-a", body, 64)
        try:
            t0 = time.monotonic()
            resp = s.recv(4096)           # server must give up first
            waited = time.monotonic() - t0
        finally:
            s.close()
        assert b"408" in resp.split(b"\r\n", 1)[0], resp
        assert waited < 5.0, "read timeout did not bound the stall"
        assert srv.metrics().get("read_timeout") == 1
        assert store.count() == 0
        cli = HttpStoreClient("127.0.0.1", srv.port, token="tok-a")
        cli.write("c0", np.ones(8, np.float32), tenant="appa")
        assert store.count(tenant="appa") == 1


def test_slow_loris_does_not_block_other_tenants():
    """A stalled upload must not head-of-line block concurrent
    uploads (threaded handlers + per-connection timeouts)."""
    store = UpdateStore()
    body = encode_update("c0", np.ones(4000, np.float32))
    with IngestServer(store, TOKENS, read_timeout=2.0) as srv:
        s = _stall_head(srv.port, "tok-a", body, 16)   # stall appa
        try:
            t0 = time.monotonic()
            cli = HttpStoreClient("127.0.0.1", srv.port, token="tok-b")
            cli.write("b0", np.ones(64, np.float32), tenant="appb")
            elapsed = time.monotonic() - t0
        finally:
            s.close()
        assert elapsed < 1.0, "stalled upload blocked a healthy one"
        assert store.count(tenant="appb") == 1


# -- kill / restart recovery -------------------------------------------------

def _fedavg(u, w):
    return np.einsum("np,n->p", u, w) / (w.sum() + 1e-6)


def test_frontend_restart_recovers_spool_without_dup_or_phantom(tmp_path):
    n, p = 6, 500
    rng = np.random.default_rng(3)
    payloads = {f"c{i}": rng.normal(size=(p,)).astype(np.float32)
                for i in range(n)}
    weights = {f"c{i}": 1.0 + 0.5 * i for i in range(n)}

    store = UpdateStore(backend="disk", spool_dir=str(tmp_path))
    with IngestServer(store, TOKENS) as srv:
        cli = HttpStoreClient("127.0.0.1", srv.port,
                              tokens={"appa": "tok-a", "appb": "tok-b"})
        for cid, vec in payloads.items():
            cli.write(cid, vec, weight=weights[cid], tenant="appa")
        cli.write("b0", np.ones(p, np.float32), tenant="appb")
        # a torn upload right before the "crash": must not resurrect
        _partial_upload(srv.port, "tok-a",
                        encode_update("ghost", np.ones(p, np.float32)))
        assert _wait_metric(srv, "disconnect", 1)
        st = store.stats_for("appa")
        assert st.writes == n
        assert st.bytes_written == sum(
            v.nbytes for v in payloads.values()) * store.replication
        bytes_before = store.tenant_bytes("appa")
    # front-end killed (closed); a FRESH store recovers the spool
    store2 = UpdateStore(backend="disk", spool_dir=str(tmp_path))
    assert store2.count(tenant="appa") == n
    assert store2.count(tenant="appb") == 1
    assert sorted(store2.client_ids(tenant="appa")) == sorted(payloads)
    assert "ghost" not in store2.client_ids(tenant="appa")
    assert store2.tenant_bytes("appa") == bytes_before
    for cid, vec in payloads.items():
        got, w = store2.read(cid, tenant="appa")
        assert w == weights[cid]
        assert np.array_equal(np.asarray(got), vec), cid
    # serving resumes on the recovered spool: a round folds exactly the
    # recovered set, and a re-upload REPLACES rather than duplicates
    svc = AggregationService(fusion="fedavg", store=store2,
                             threshold_frac=1.0, monitor_timeout=5.0,
                             device="cpu")
    with IngestServer(store2, TOKENS) as srv2:
        cli = HttpStoreClient("127.0.0.1", srv2.port, token="tok-a")
        cli.write("c0", payloads["c0"], weight=weights["c0"],
                  tenant="appa")
        assert store2.count(tenant="appa") == n   # replaced, not added
        fused, rep = svc.aggregate(from_store=True, expected_clients=n,
                                   tenant="appa")
    assert rep.n_clients == n
    u = np.stack([payloads[f"c{i}"] for i in range(n)])
    w = np.asarray([weights[f"c{i}"] for i in range(n)], np.float32)
    np.testing.assert_allclose(fused.numpy(), _fedavg(u, w), rtol=1e-5,
                               atol=1e-5)
    # the reference recovers the same spool to the same round
    jsvc = JService(fusion="fedavg", local_strategy="jnp",
                    store=JStore(backend="disk", spool_dir=str(tmp_path)),
                    threshold_frac=1.0, monitor_timeout=5.0)
    jfused, jrep = jsvc.aggregate(from_store=True, expected_clients=n,
                                  tenant="appa")
    assert jrep.n_clients == n
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused),
                               rtol=2e-5, atol=1e-6)


def test_restart_preserves_compressed_uploads(tmp_path):
    """Compressed uploads (codes + .scale/.dim sidecars) survive the
    restart with their real (compressed) byte accounting, and the
    reference's store recovers the same container."""
    store = UpdateStore(backend="disk", spool_dir=str(tmp_path))
    vec = np.linspace(-1, 1, 1024).astype(np.float32)
    cu = compress_update(vec, block=256)
    with IngestServer(store, TOKENS) as srv:
        cli = HttpStoreClient("127.0.0.1", srv.port, token="tok-a")
        cli.write("c0", cu, weight=1.0, tenant="appa")
        bytes_before = store.tenant_bytes("appa")
        assert bytes_before < vec.nbytes   # compression bought headroom
    store2 = UpdateStore(backend="disk", spool_dir=str(tmp_path))
    assert store2.count(tenant="appa") == 1
    assert store2.tenant_bytes("appa") == bytes_before
    got, w = store2.read("c0", tenant="appa")
    assert w == 1.0
    assert got.dim == cu.dim
    assert np.array_equal(np.asarray(got.codes), np.asarray(cu.codes))
    assert np.array_equal(np.asarray(got.scales), np.asarray(cu.scales))
    jgot, jw = JStore(backend="disk", spool_dir=str(tmp_path)).read(
        "c0", tenant="appa")
    assert jw == 1.0 and jgot.dim == cu.dim
    assert np.asarray(jgot.codes).tobytes() == cu.codes.tobytes()
    assert np.asarray(jgot.scales).tobytes() == cu.scales.tobytes()
    assert sorted(os.listdir(tmp_path)) == ["appa"]
