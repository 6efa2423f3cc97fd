"""The port's async rounds against the JAX package's, on the same numpy
data and the same scripted clocks (CPU).

Each case runs one scenario through both packages — the twin of a
non-distributed case of ``tests/test_async_rounds.py``, of
``tests/test_equivalence.py::test_async_round_matches_sync_streamed``, or
a two-round γ = 0.5 carry with stragglers — and holds the port to the
reference: the fused vectors at rtol 2e-5, and close count, readiness,
``overlap_seconds``, the ids each round consumed and the straggler ages
equal. The reference test's own checks then run on the port's result.
"""
import bisect
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from repro.core import AggregationService as JService
from repro.core import LocalEngine as JLocalEngine
from repro.core import Monitor as JMonitor
from repro.core import Planner as JPlanner
from repro.core import UpdateStore as JStore
from repro.core.fusion import get_fusion as j_get_fusion
from repro_torch.core.fusion import REGISTRY, get_fusion
from repro_torch.core.local import LocalEngine
from repro_torch.core.monitor import Monitor
from repro_torch.core.planner import Planner
from repro_torch.core.service import AggregationService
from repro_torch.core.store import UpdateStore
from repro_torch.core.workload import Workload
from repro_torch.kernels.fused_fusion import kernel
from repro_torch.utils import jitcache

RTOL, ATOL = 2e-5, 1e-6
REDUCIBLE = sorted(name for name, cls in REGISTRY.items() if cls.reducible)

TORCH = types.SimpleNamespace(
    Service=AggregationService, Store=UpdateStore, Monitor=Monitor,
    kw={"local_strategy": "kernel", "device": "cpu"})
JAX = types.SimpleNamespace(
    Service=JService, Store=JStore, Monitor=JMonitor,
    kw={"local_strategy": "jnp"})


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"weighted_sum": 0, "weighted_sum_dequant": 0}


class ScriptedClock:
    """``sleep`` advances time and fires the writes scheduled inside the
    elapsed window."""

    def __init__(self):
        self.t = 0.0
        self._events = []

    def at(self, t, fn):
        bisect.insort(self._events, (t, id(fn), fn))

    def clock(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds
        while self._events and self._events[0][0] <= self.t:
            _, _, fn = self._events.pop(0)
            fn()


def _mk(n, p, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, p)).astype(np.float32),
            rng.uniform(1, 5, size=(n,)).astype(np.float32))


def _fedavg(u, w):
    return np.einsum("np,n->p", u, w) / (w.sum() + 1e-6)


def _service(pkg, store, clk=None, fusion="fedavg", **kw):
    kw.setdefault("threshold_frac", 1.0)
    if clk is not None:
        kw.update(clock=clk.clock, sleep=clk.sleep)
    return pkg.Service(fusion=fusion, store=store, **pkg.kw, **kw)


def _host(fused):
    if fused is None:
        return None
    if isinstance(fused, torch.Tensor):
        return fused.cpu().numpy()
    return np.asarray(fused)


def _summary(rep):
    """What must agree between the packages, report by report."""
    pol = rep.close_policy
    mon = rep.monitor
    return {
        "n_clients": rep.n_clients, "empty": rep.empty,
        "async_round": rep.async_round, "streamed": rep.streamed,
        "ready": None if mon is None else mon.ready,
        "count": None if mon is None else mon.count,
        "waited": None if mon is None else mon.waited,
        "overlap_seconds": rep.overlap_seconds,
        "phases": sorted(rep.phase_seconds), "notes": rep.notes,
        "tenant": rep.tenant, "bytes_ingested": rep.bytes_ingested,
        "close_policy": None if pol is None else dataclasses.astuple(pol),
    }


class Run:
    """One package's run of a scenario: each round's fused vector,
    report summary, remaining store ids and straggler ages."""

    def __init__(self):
        self.rounds = []

    def round(self, svc, tenant="default", **kw):
        fused, rep = svc.aggregate(from_store=True, tenant=tenant, **kw)
        self.rounds.append({
            "fused": _host(fused), "rep": rep, "summary": _summary(rep),
            "left": svc.store.client_ids(tenant),
            "ages": {t: dict(a) for t, a in svc._stale_ages.items()},
        })
        return _host(fused), rep


def _parity(scenario):
    """Run ``scenario(pkg, run)`` for both packages and hold the port to
    the reference round by round; returns the port's run."""
    ours, theirs = Run(), Run()
    scenario(TORCH, ours)
    scenario(JAX, theirs)
    assert len(ours.rounds) == len(theirs.rounds) > 0
    for k, (a, b) in enumerate(zip(ours.rounds, theirs.rounds)):
        assert a["summary"] == b["summary"], k
        assert a["left"] == b["left"], k
        assert a["ages"] == b["ages"], k
        if b["fused"] is None:
            assert a["fused"] is None, k
        else:
            np.testing.assert_allclose(a["fused"], b["fused"], rtol=RTOL,
                                       atol=ATOL, err_msg=f"round {k}")
    return ours


# -- monitor gate edge cases ---------------------------------------------------


def test_async_timeout_zero_arrivals_empty_report():
    def scenario(pkg, run):
        clk = ScriptedClock()
        svc = _service(pkg, pkg.Store(), clk, monitor_timeout=1.0)
        run.round(svc, expected_clients=5, async_round=True)

    (r,) = _parity(scenario).rounds
    rep = r["rep"]
    assert r["fused"] is None and rep.empty and rep.async_round
    assert not rep.monitor.ready and rep.monitor.count == 0
    assert rep.monitor.waited >= 1.0
    assert rep.n_clients == 0 and rep.fuse_seconds == 0.0


def test_sync_timeout_empty_store_no_crash():
    def scenario(pkg, run):
        svc = _service(pkg, pkg.Store(), ScriptedClock(),
                       monitor_timeout=0.5)
        run.round(svc)

    (r,) = _parity(scenario).rounds
    assert r["fused"] is None and r["rep"].empty and not r["rep"].async_round
    assert not r["rep"].monitor.ready


def test_async_timeout_partial_arrivals():
    """3 of 8 land before the deadline: the round folds exactly those."""
    n, p = 8, 96
    u, w = _mk(n, p, 1)

    def scenario(pkg, run):
        clk = ScriptedClock()
        store = pkg.Store()
        for i in range(3):
            clk.at(0.2 * (i + 1), lambda i=i: store.write(
                f"c{i}", u[i], weight=float(w[i])))
        svc = _service(pkg, store, clk, monitor_timeout=2.0)
        run.round(svc, expected_clients=n, async_round=True)

    (r,) = _parity(scenario).rounds
    assert not r["rep"].monitor.ready and r["rep"].monitor.count == 3
    assert r["rep"].n_clients == 3
    np.testing.assert_allclose(r["fused"], _fedavg(u[:3], w[:3]),
                               rtol=RTOL, atol=ATOL)


def test_threshold_reached_exactly_at_timeout():
    """The last required update lands at t == timeout: the threshold wins
    the tie, for ``Monitor.wait`` and for the async gate."""
    n, p, timeout = 4, 32, 1.0
    u, w = _mk(n, p, 2)

    def schedule(clk, store):
        for i in range(n - 1):
            clk.at(0.2, lambda i=i: store.write(f"c{i}", u[i],
                                                weight=float(w[i])))
        clk.at(timeout, lambda: store.write(f"c{n - 1}", u[n - 1],
                                            weight=float(w[n - 1])))

    waits = []
    for pkg in (TORCH, JAX):
        clk, store = ScriptedClock(), pkg.Store()
        schedule(clk, store)
        mon = pkg.Monitor(store, threshold=n, timeout=timeout,
                          poll_interval=0.1, clock=clk.clock,
                          sleep=clk.sleep)
        res = mon.wait()
        assert res.ready and res.count == n and res.waited >= timeout
        waits.append(res.waited)
    assert waits[0] == waits[1]

    def scenario(pkg, run):
        clk, store = ScriptedClock(), pkg.Store()
        schedule(clk, store)
        svc = _service(pkg, store, clk, monitor_timeout=timeout)
        run.round(svc, expected_clients=n, async_round=True)

    (r,) = _parity(scenario).rounds
    assert r["rep"].monitor.ready and r["rep"].n_clients == n
    np.testing.assert_allclose(r["fused"], _fedavg(u, w), rtol=RTOL,
                               atol=ATOL)


def test_late_writes_land_during_inflight_stream():
    """The port's store picks up writes scheduled after the stream
    opened, in the same blocks as the reference's."""
    n, p, chunk = 9, 40, 2
    u, w = _mk(n, p, 3)
    out = {}
    for name, pkg in (("torch", TORCH), ("jax", JAX)):
        clk, store = ScriptedClock(), pkg.Store()
        for i in range(2):
            store.write(f"c{i:02d}", u[i], weight=float(w[i]))
        for i in range(2, n):
            clk.at(0.1 * i, lambda i=i, s=store: s.write(
                f"c{i:02d}", u[i], weight=float(w[i])))
        seen = []

        def gate(count, waited, seen=seen):
            seen.append(count)
            return count >= n or waited >= 5.0

        got = list(store.iter_arrivals(chunk, gate, poll_interval=0.05,
                                       clock=clk.clock, sleep=clk.sleep))
        out[name] = (got, seen)
    got, seen = out["torch"]
    jgot, jseen = out["jax"]
    assert seen == jseen and seen[0] < n and max(seen) == n
    assert [ids for _, _, ids in got] == [ids for _, _, ids in jgot]
    assert all(b.shape[0] == chunk for b, _, _ in got[:-1])
    stacked = np.concatenate([b for b, _, _ in got])
    ws = np.concatenate([wb for _, wb, _ in got])
    np.testing.assert_allclose(_fedavg(stacked, ws), _fedavg(u, w),
                               rtol=RTOL, atol=ATOL)


# -- queue + staleness semantics ----------------------------------------------


def test_async_consumes_folded_and_ages_stragglers():
    n, p, g = 6, 48, 0.5
    u, w = _mk(n, p, 4)

    def scenario(pkg, run):
        store = pkg.Store()
        for i in range(4):
            store.write(f"c{i}", u[i], weight=float(w[i]))
        svc = _service(pkg, store, ScriptedClock(), monitor_timeout=0.5,
                       staleness_discount=g)
        run.round(svc, expected_clients=4, async_round=True)
        store.write("late", u[4], weight=float(w[4]))
        run.round(svc, expected_clients=1, async_round=True)

    r1, r2 = _parity(scenario).rounds
    assert r1["left"] == [] and r2["left"] == []
    ws2 = g * np.einsum("np,n->p", u[:4], w[:4]) + w[4] * u[4]
    tot2 = g * w[:4].sum() + w[4]
    np.testing.assert_allclose(r2["fused"], ws2 / (tot2 + 1e-6),
                               rtol=RTOL, atol=ATOL)


def test_staleness_carry_with_stragglers_two_rounds():
    """γ = 0.5 over two rounds: round 1 closes on its threshold of 4, and
    two stragglers land after the close but before the consume (the
    store's ``remove`` is wrapped to write them there). They fold in
    round 2 at γ¹, on top of round 1's carry discounted by γ, beside
    round 2's fresh rows. Chunks of 2 rows, so blocks fold while the
    round is open."""
    n, p, g = 9, 257, 0.5
    u, w = _mk(n, p, 5)

    def scenario(pkg, run):
        clk = ScriptedClock()
        store = pkg.Store()
        svc = _service(pkg, store, clk, monitor_timeout=5.0,
                       staleness_discount=g,
                       stream_chunk_bytes=2 * p * 4)
        for i in range(4):
            clk.at(0.1 * (i + 1), lambda i=i: store.write(
                f"c{i}", u[i], weight=float(w[i])))
        consume = store.remove

        def late_then_remove(*args, **kw):
            for i in (4, 5):
                store.write(f"c{i}", u[i], weight=float(w[i]))
            store.remove = consume
            return consume(*args, **kw)

        store.remove = late_then_remove
        run.round(svc, expected_clients=4, async_round=True)
        base = clk.t
        for i in range(6, n):
            clk.at(base + 0.1 * (i - 5), lambda i=i: store.write(
                f"c{i}", u[i], weight=float(w[i])))
        run.round(svc, expected_clients=5, async_round=True)

    r1, r2 = _parity(scenario).rounds
    assert r1["rep"].n_clients == 4 and r1["left"] == ["c4", "c5"]
    assert r1["ages"] == {"default": {"c4": 1, "c5": 1}}
    ws1 = np.einsum("np,n->p", u[:4].astype(np.float64), w[:4])
    tot1 = float(w[:4].sum())
    np.testing.assert_allclose(r1["fused"], ws1 / (tot1 + 1e-6),
                               rtol=RTOL, atol=ATOL)
    ws2 = g * ws1 + g * np.einsum("np,n->p", u[4:6], w[4:6]) \
        + np.einsum("np,n->p", u[6:], w[6:])
    tot2 = g * tot1 + g * w[4:6].sum() + w[6:].sum()
    assert r2["rep"].n_clients == 5 and r2["left"] == []
    assert r2["ages"] == {"default": {}}
    np.testing.assert_allclose(r2["fused"], ws2 / (tot2 + 1e-6),
                               rtol=RTOL, atol=ATOL)


def test_staleness_discount_validation():
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            AggregationService(device="cpu", staleness_discount=bad)
    with pytest.raises(ValueError, match="weighted fusion"):
        AggregationService(device="cpu", fusion="coordmedian",
                           staleness_discount=0.5)
    with pytest.raises(ValueError):
        AggregationService(device="cpu", cost_bias=-0.1)


def test_async_falls_back_to_sync_for_non_streamable():
    n, p = 6, 32
    u, _ = _mk(n, p, 6)

    def scenario(pkg, run):
        store = pkg.Store()
        for i in range(n):
            store.write(f"c{i}", u[i])
        svc = _service(pkg, store, ScriptedClock(), fusion="krum",
                       monitor_timeout=0.5, threshold_frac=0.8)
        run.round(svc, expected_clients=n, async_round=True)

    (r,) = _parity(scenario).rounds
    assert not r["rep"].async_round and not r["rep"].streamed
    ref = get_fusion("krum").fuse(torch.from_numpy(u), torch.ones(n))
    np.testing.assert_allclose(r["fused"], ref.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_async_falls_back_to_sync_over_carve_budget():
    n, p = 6, 32
    u, _ = _mk(n, p, 7)

    def scenario(pkg, run):
        store = pkg.Store()
        for i in range(n):
            store.write(f"c{i}", u[i])
        svc = _service(pkg, store, ScriptedClock(), fusion="coordmedian",
                       monitor_timeout=0.5, threshold_frac=0.8,
                       robust_state_budget=64)
        run.round(svc, expected_clients=n, async_round=True)

    (r,) = _parity(scenario).rounds
    assert not r["rep"].async_round and not r["rep"].streamed
    assert r["rep"].notes and "budget" in r["rep"].notes[0]
    np.testing.assert_allclose(r["fused"], np.median(u, axis=0),
                               rtol=1e-5, atol=1e-6)


def test_async_streamed_coordmedian():
    """Within the carve budget an order-statistic round streams async
    through the top-k carve, with no staleness scales."""
    n, p = 7, 64
    u, _ = _mk(n, p, 8)

    def scenario(pkg, run):
        clk, store = ScriptedClock(), pkg.Store()
        store.write("c0", u[0])
        for i in range(1, n):
            clk.at(0.1 * i, lambda i=i: store.write(f"c{i}", u[i]))
        svc = _service(pkg, store, clk, fusion="coordmedian",
                       monitor_timeout=5.0, stream_chunk_bytes=3 * p * 4)
        run.round(svc, expected_clients=n, async_round=True)

    (r,) = _parity(scenario).rounds
    assert r["rep"].async_round and r["rep"].streamed
    assert r["rep"].n_clients == n and r["left"] == []
    np.testing.assert_allclose(r["fused"], np.median(u, axis=0),
                               rtol=1e-5, atol=1e-6)


def test_async_without_expected_clients_is_timeout_gated():
    n, p = 5, 32
    u, w = _mk(n, p, 9)

    def scenario(pkg, run):
        clk, store = ScriptedClock(), pkg.Store()
        for i in range(n):
            clk.at(0.3 * (i + 1), lambda i=i: store.write(
                f"c{i}", u[i], weight=float(w[i])))
        svc = _service(pkg, store, clk, monitor_timeout=2.0)
        run.round(svc, async_round=True)

    (r,) = _parity(scenario).rounds
    assert r["rep"].n_clients == n and not r["rep"].monitor.ready
    np.testing.assert_allclose(r["fused"], _fedavg(u, w), rtol=RTOL,
                               atol=ATOL)


def test_async_rewrite_during_round_not_lost():
    """A client that re-writes after its fold survives the consume, with
    its new version, for the next round."""
    n, p = 4, 32
    u, w = _mk(n + 1, p, 10)
    stores = {}

    def scenario(pkg, run):
        clk, store = ScriptedClock(), pkg.Store()
        for i in range(n):
            store.write(f"c{i}", u[i], weight=float(w[i]))
        clk.at(0.3, lambda: store.write("c0", u[n], weight=9.0))
        clk.at(0.5, lambda: store.write("late-filler", u[n], weight=1.0))
        svc = _service(pkg, store, clk, monitor_timeout=2.0,
                       stream_chunk_bytes=2 * p * 4)
        run.round(svc, expected_clients=n + 1, async_round=True)
        stores[pkg is TORCH] = store

    (r,) = _parity(scenario).rounds
    assert r["left"] == ["c0"]
    nv, nw = stores[True].read("c0")
    assert nw == 9.0
    np.testing.assert_array_equal(np.asarray(nv), u[n])


def test_fuse_stream_rejects_raw_iter_arrivals():
    store = UpdateStore()
    for i in range(4):
        store.write(f"c{i}", np.ones(8, np.float32))
    eng = LocalEngine(device="cpu")
    with pytest.raises(TypeError, match="iter_arrivals"):
        eng.fuse_stream(get_fusion("fedavg"),
                        store.iter_arrivals(2, lambda c, t: c >= 4))


def test_async_variable_close_counts_share_one_step():
    """Rounds closing at different counts reuse the step keyed on the
    configured chunk, the key ``_warm_engines`` probes."""
    p = 40
    u, w = _mk(8, p, 11)
    f = get_fusion("fedavg")
    eng = LocalEngine(device="cpu")
    out1, rep1 = eng.fuse_stream(f, [(u[:5], w[:5])], chunk_rows=8)
    assert rep1.chunk_rows == 8 and eng.is_warm_stream(f, 8, p, np.float32)
    before = jitcache.trace_count()
    out2, rep2 = eng.fuse_stream(f, [(u[:7], w[:7])], chunk_rows=8)
    assert jitcache.trace_count() == before and rep2.compile_seconds == 0.0
    want, _ = JLocalEngine(strategy="jnp").fuse_stream(
        j_get_fusion("fedavg"), [(u[:7], w[:7])], chunk_rows=8)
    np.testing.assert_allclose(out2.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_async_phase_ingest_excludes_idle_wait():
    n, p = 6, 64
    u, w = _mk(n, p, 12)

    def scenario(pkg, run):
        clk, store = ScriptedClock(), pkg.Store()
        for i in range(n):
            clk.at(0.5 * (i + 1), lambda i=i: store.write(
                f"c{i}", u[i], weight=float(w[i])))
        svc = _service(pkg, store, clk, monitor_timeout=10.0)
        run.round(svc, expected_clients=n, async_round=True)

    (r,) = _parity(scenario).rounds
    rep = r["rep"]
    assert rep.overlap_seconds >= 3.0
    assert rep.phase_seconds["overlap"] == rep.overlap_seconds
    assert rep.phase_seconds["ingest"] < 1.0


# -- the equivalence invariant, async == sync streamed ------------------------


@pytest.mark.parametrize("name", REDUCIBLE)
def test_async_round_matches_sync_streamed(name):
    """Fixed client set, arrivals spread over the window, no discount:
    the port's overlapped round equals the reference's, and its own
    serialized streamed round."""
    n, p = 11, 301
    u, w = _mk(n, p, 13)
    cap = 3 * p * 4 * 2

    def scenario(pkg, run):
        clk, store = ScriptedClock(), pkg.Store()
        for i in range(n):
            clk.at(0.05 * (i + 1), lambda i=i: store.write(
                f"c{i:02d}", u[i], weight=float(w[i])))
        svc = _service(pkg, store, clk, fusion=name, monitor_timeout=60.0,
                       memory_cap_bytes=cap)
        run.round(svc, expected_clients=n, async_round=True)

    (r,) = _parity(scenario).rounds
    rep = r["rep"]
    assert rep.async_round and rep.streamed and rep.monitor.ready
    assert rep.n_clients == n and rep.overlap_seconds > 0
    assert r["left"] == []
    store = UpdateStore()
    for i in range(n):
        store.write(f"c{i:02d}", u[i], weight=float(w[i]))
    sync = AggregationService(fusion=name, store=store, device="cpu",
                              monitor_timeout=1.0, memory_cap_bytes=cap)
    fused, srep = sync.aggregate(from_store=True, expected_clients=n)
    assert srep.streamed and not srep.async_round
    np.testing.assert_allclose(r["fused"], fused.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_auto_async_on_a_cold_round_and_after():
    """``async_round="auto"``: with nothing landed the wait is all there
    is, so the first round overlaps. The second finds every row landed
    and plans on the tenant's last wait: at 1 KB a round the drain
    residue outweighs the fold it would hide, so it serializes."""
    n, p = 4, 64
    u, w = _mk(n, p, 14)

    def scenario(pkg, run):
        clk, store = ScriptedClock(), pkg.Store()
        for i in range(n):
            clk.at(0.2 * (i + 1), lambda i=i: store.write(
                f"c{i}", u[i], weight=float(w[i])))
        svc = _service(pkg, store, clk, monitor_timeout=5.0)
        run.round(svc, expected_clients=n, async_round="auto")
        for i in range(n):
            store.write(f"c{i}", u[i], weight=float(w[i]))
        run.round(svc, expected_clients=n, async_round="auto")

    r1, r2 = _parity(scenario).rounds
    assert r1["rep"].async_round and not r2["rep"].async_round
    for r in (r1, r2):
        np.testing.assert_allclose(r["fused"], _fedavg(u, w), rtol=RTOL,
                                   atol=ATOL)


# -- planner overlap costing ---------------------------------------------------


def test_planner_overlap_model_matches_reference():
    """Handed the same Plan, the port's overlap estimate and round
    objective are the reference's arithmetic; ``prefer_async`` keeps its
    shape on the port's own plan."""
    planner, jplanner = Planner(), JPlanner(n_devices=1)
    assert planner.overlap_drain_seconds == jplanner.overlap_drain_seconds
    f = get_fusion("fedavg")
    load = Workload(update_bytes=4 << 20, n_clients=64)
    jplan = jplanner.plan(load, j_get_fusion("fedavg"))
    for wait in (0.0, 0.01, 5.0):
        assert planner.overlap_estimate(jplan, wait) \
            == jplanner.overlap_estimate(jplan, wait)
    for args in [(1.0, 0.8, 0.5, 30.0), (40.0, 0.1, 0.0, 30.0),
                 (3.0, 0.5, 1.0, 30.0, 9.0), (0.2, 1.0, 0.3, 5.0, 0.1)]:
        assert planner.round_objective(*args) \
            == jplanner.round_objective(*args)
    assert planner.prefer_async(load, f, expected_wait=5.0)
    assert not planner.prefer_async(load, f, expected_wait=0.0)
    assert not planner.prefer_async(load, get_fusion("krum"), 5.0)
    plan = planner.plan(load, f)
    ser, ovl = planner.overlap_estimate(plan, expected_wait=5.0)
    assert ser == pytest.approx(5.0 + plan.est_seconds)
    assert ovl == pytest.approx(
        max(5.0, plan.est_seconds) + planner.overlap_drain_seconds)


# -- store ---------------------------------------------------------------------


def test_store_read_returns_immutable_view():
    store = UpdateStore()
    store.write("a", np.arange(8, dtype=np.float32))
    u, _ = store.read("a")
    assert not u.flags.writeable
    with pytest.raises(ValueError):
        u[0] = 99.0
    assert store.read("a")[0][0] == 0.0


def test_store_clear_resets_stats_and_unlinks(tmp_path):
    store = UpdateStore(backend="disk", spool_dir=str(tmp_path))
    store.write("a", np.ones(16, np.float32), weight=2.0)
    store.write("b", np.ones(16, np.float32))
    store.read_stacked()
    assert store.stats.writes == 2 and store.stats.reads == 2
    assert store.stats.peak_block_bytes > 0
    store.clear()
    assert store.count() == 0
    assert store.stats.writes == 0 and store.stats.bytes_written == 0
    assert store.stats.reads == 0 and store.stats.peak_block_bytes == 0
    assert os.listdir(tmp_path) == []
    assert UpdateStore(backend="disk", spool_dir=str(tmp_path)).count() == 0


def test_store_remove_consumes_subset(tmp_path):
    for backend, kw in (("memory", {}),
                        ("disk", {"spool_dir": str(tmp_path)})):
        store = UpdateStore(backend=backend, **kw)
        for i in range(5):
            store.write(f"c{i}", np.full(4, i, np.float32))
        store.remove(["c1", "c3", "missing-id"])
        assert store.client_ids() == ["c0", "c2", "c4"]
        assert store.read("c2")[0][0] == 2.0
