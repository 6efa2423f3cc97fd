"""The port's concurrent round execution against the JAX package's (CPU).

Twins of ``tests/test_concurrent_service.py`` (the 4-tenant stress, FIFO
rounds of one tenant, the closed scheduler, concurrent adaptive rounds,
``device_concurrency`` validation, the single-flight build cache), of the
four ``FairRoundScheduler`` cases of ``tests/test_serving.py`` (each
script run through both packages' schedulers, whose ``admission_order()``
must be equal), of ``tests/test_lint.py``'s shutdown-joins-workers case,
and the reference's lock-order witness fitted onto the port's service.
Every fused vector is held to the dense formula and to the reference
service on the same round data at rtol 1e-4, atol 1e-5.
"""
import threading
import time

import numpy as np
import pytest

from repro.analysis.witness import LockOrderWitness, instrument_service
from repro.core import AggregationService as JService
from repro.core import FairRoundScheduler as JFair
from repro.core import RoundScheduler as JScheduler
from repro.core import UpdateStore as JStore
from repro_torch.core import FairRoundScheduler, RoundScheduler
from repro_torch.core.service import AggregationService
from repro_torch.core.store import UpdateStore
from repro_torch.kernels.fused_fusion import kernel
from repro_torch.utils.jitcache import CompiledCache

RTOL, ATOL = 1e-4, 1e-5
RNG = np.random.default_rng(7)


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"weighted_sum": 0, "weighted_sum_dequant": 0}


def fedavg_formula(u, w):
    return np.einsum("np,n->p", u.astype(np.float64), w) / w.sum()


def _service(store, **kw):
    return AggregationService(fusion="fedavg", store=store, device="cpu",
                              **kw)


def _live_workers(before):
    return [t for t in threading.enumerate()
            if t not in before and t is not threading.current_thread()]


# -- the 4-tenant stress -----------------------------------------------------


def test_stress_concurrent_tenants_on_one_service():
    """4 tenants x 5 rounds on ONE port service and ONE reference
    service, all tenants' rounds in flight at once with writers racing
    them; each round equals the formula and the reference's round on the
    same data, and the port's shared engine built one step."""
    k, rounds, n, p = 4, 5, 6, 256
    tenants = [f"app{i}" for i in range(k)]
    u = RNG.normal(size=(k, rounds, n, p)).astype(np.float32)
    w = RNG.uniform(1, 5, size=(k, rounds, n)).astype(np.float32)
    store, jstore = UpdateStore(), JStore()
    witness = LockOrderWitness()
    svc = _service(store, threshold_frac=1.0, monitor_timeout=60.0)
    instrument_service(svc, witness)
    jsvc = JService(fusion="fedavg", local_strategy="jnp", store=jstore,
                    threshold_frac=1.0, monitor_timeout=60.0)
    errors = []

    def run_tenant(kk, tenant, sched, jsched):
        try:
            for r in range(rounds):
                def write(kk=kk, r=r, tenant=tenant):
                    for i in range(n):
                        for s in (store, jstore):
                            s.write(f"c{i}", u[kk, r, i],
                                    weight=float(w[kk, r, i]), tenant=tenant)
                wt = threading.Thread(target=write, daemon=True)
                wt.start()
                kw = dict(from_store=True, expected_clients=n,
                          async_round=True)
                fut = sched.submit(tenant, **kw)
                jfut = jsched.submit(tenant, **kw)
                fused, rep = fut.result(timeout=120)
                jfused, jrep = jfut.result(timeout=120)
                wt.join(timeout=60)
                assert not wt.is_alive()
                assert rep.n_clients == jrep.n_clients == n, (tenant, r)
                got = fused.numpy()
                np.testing.assert_allclose(
                    got, fedavg_formula(u[kk, r], w[kk, r]), rtol=RTOL,
                    atol=ATOL, err_msg=f"{tenant} round {r}")
                np.testing.assert_allclose(
                    got, np.asarray(jfused), rtol=RTOL, atol=ATOL,
                    err_msg=f"{tenant} round {r} vs the reference")
                assert store.count(tenant) == 0
        except BaseException as exc:  # surfaced in the main thread
            errors.append((tenant, exc))

    with RoundScheduler(svc) as sched, JScheduler(jsvc) as jsched:
        runners = [threading.Thread(target=run_tenant,
                                    args=(kk, t, sched, jsched),
                                    daemon=True)
                   for kk, t in enumerate(tenants)]
        for r in runners:
            r.start()
        for r in runners:
            r.join(timeout=600)
        assert not any(r.is_alive() for r in runners)
    assert not errors, errors
    witness.check()
    assert svc.local.cache.misses == 1   # one shape bucket, one build
    for t in tenants:
        assert store.stats_for(t).writes == rounds * n
    assert store.stats.writes == k * rounds * n


# -- one tenant, the closed scheduler, adaptive tenants ------------------------


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_scheduler_same_tenant_rounds_serialize_fifo(pkg):
    """Two rounds of one tenant run in submission order on its one
    worker, each folding its own writes; both packages agree."""
    n, p = 4, 64
    rng = np.random.default_rng(11)
    u1 = rng.normal(size=(n, p)).astype(np.float32)
    u2 = rng.normal(size=(n, p)).astype(np.float32)
    w1 = np.ones(n, np.float32)
    if pkg == "torch":
        store = UpdateStore()
        svc, sched_cls = _service(store, threshold_frac=1.0,
                                  monitor_timeout=5.0), RoundScheduler
    else:
        store = JStore()
        svc, sched_cls = JService(fusion="fedavg", store=store,
                                  threshold_frac=1.0,
                                  monitor_timeout=5.0), JScheduler
    with sched_cls(svc) as sched:
        for i in range(n):
            store.write(f"c{i}", u1[i], tenant="a")
        f1 = sched.submit("a", from_store=True, expected_clients=n,
                          async_round=True)
        fused1, _ = f1.result(timeout=60)
        for i in range(n):
            store.write(f"c{i}", u2[i], tenant="a")
        f2 = sched.submit("a", from_store=True, expected_clients=n,
                          async_round=True)
        fused2, _ = f2.result(timeout=60)
        assert sched.tenants() == ["a"]
    np.testing.assert_allclose(np.asarray(fused1), fedavg_formula(u1, w1),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.asarray(fused2), fedavg_formula(u2, w1),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sched_cls", [RoundScheduler, FairRoundScheduler])
def test_submit_after_shutdown_raises(sched_cls):
    svc = _service(UpdateStore(), threshold_frac=1.0, monitor_timeout=1.0)
    sched = sched_cls(svc)
    sched.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        sched.submit("a", from_store=True)
    sched.shutdown()   # a second shutdown is a no-op


def test_concurrent_adaptive_rounds_share_controller_safely():
    """Two tenants' adaptive rounds at once on one port service: both
    end with their own learned curves, and every round equals the
    reference's on the same data."""
    n, p = 4, 64
    store, jstore = UpdateStore(), JStore()
    kw = dict(threshold_frac=1.0, monitor_timeout=5.0, adaptive=True)
    svc = _service(store, **kw)
    jsvc = JService(fusion="fedavg", store=jstore, **kw)
    with RoundScheduler(svc) as sched, JScheduler(jsvc) as jsched:
        for _ in range(3):
            for t in ("a", "b"):
                for i in range(n):
                    row = RNG.normal(size=(p,)).astype(np.float32)
                    store.write(f"c{i}", row, tenant=t)
                    jstore.write(f"c{i}", row, tenant=t)
            rkw = dict(from_store=True, expected_clients=n, async_round=True)
            res = sched.run_round(["a", "b"], **rkw)
            jres = jsched.run_round(["a", "b"], **rkw)
            for t in ("a", "b"):
                assert res[t][1].n_clients == n
                np.testing.assert_allclose(res[t][0].numpy(),
                                           np.asarray(jres[t][0]),
                                           rtol=RTOL, atol=ATOL)
    assert set(svc.controller.tenants()) == {"a", "b"}
    assert svc.controller.model("a").rounds == 3


@pytest.mark.parametrize("bad", [0, -1])
def test_device_concurrency_validates(bad):
    for make in (lambda: AggregationService(device="cpu",
                                            device_concurrency=bad),
                 lambda: JService(fusion="fedavg", device_concurrency=bad)):
        with pytest.raises(ValueError, match="device_concurrency"):
            make()
    assert AggregationService(device="cpu",
                              device_concurrency=2).device_concurrency == 2


# -- the single-flight build cache ---------------------------------------------


def test_compiled_cache_single_flight_under_race():
    cache = CompiledCache("race")
    built = []
    all_started = threading.Event()

    def build():
        built.append(1)
        # hold the build slot until every racer runs (event-gated)
        all_started.wait(timeout=10.0)
        return lambda x: x + 1

    results = []

    def hit():
        results.append(cache.get(("k",), build))

    threads = [threading.Thread(target=hit) for _ in range(8)]
    for t in threads:
        t.start()
    all_started.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1           # one build, shared by all racers
    assert cache.misses == 1 and cache.hits == 7
    assert len([dt for _, dt in results if dt > 0.0]) == 1
    assert len({id(fn) for fn, _ in results}) == 1


def test_compiled_cache_failed_build_releases_slot():
    cache = CompiledCache("fail")
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) == 1:
            raise RuntimeError("first build dies")
        return lambda x: x * 2

    with pytest.raises(RuntimeError):
        cache.get(("k",), flaky)
    fn, dt = cache.get(("k",), flaky)   # the slot was released
    assert len(attempts) == 2 and dt > 0.0
    assert fn(3) == 6 and cache.misses == 1


# -- FairRoundScheduler: the four cases, both packages -------------------------


class _FakeService:
    """Records aggregate() concurrency; no store unless given one."""

    def __init__(self, meta=None):
        self.lock = threading.Lock()
        self.active = 0
        self.peak = 0
        self.calls = []
        self.store = meta
        self.block = threading.Event()

    def aggregate(self, tenant=None, **kw):
        with self.lock:
            self.active += 1
            self.peak = max(self.peak, self.active)
            self.calls.append(tenant)
        self.block.wait(timeout=10)
        time.sleep(0.01)
        with self.lock:
            self.active -= 1
        return (np.zeros(2), None)

    def _row_bytes(self, p, dtype):
        return p * 4

    def _chunk_rows(self, n, row_bytes):
        return n


class _Meta:
    def meta(self, tenant):
        return (4, 1000, np.float32)   # footprint 2 * 4 * 4000 = 32000


def _wait_running(sched, count):
    deadline = time.time() + 5
    while len(sched.running()) < count and time.time() < deadline:
        time.sleep(0.01)
    return sched.running()


def _script_bounds(fair_cls):
    svc = _FakeService()
    with fair_cls(svc, max_running=2) as sched:
        futs = [sched.submit(f"t{i}") for i in range(6)]
        assert len(_wait_running(sched, 2)) == 2
        svc.block.set()
        for f in futs:
            f.result(timeout=10)
    assert svc.peak <= 2
    assert sorted(svc.calls) == sorted(f"t{i}" for i in range(6))
    return sched.admission_order()


def _script_weighted(fair_cls):
    """Under contention (max_running=1, standing backlog) a weight-2
    tenant is admitted twice as often as a weight-1 tenant."""
    svc = _FakeService()
    sched = fair_cls(svc, max_running=1, weights={"heavy": 2.0, "light": 1.0})
    try:
        futs = [sched.submit("heavy") for _ in range(8)] + \
               [sched.submit("light") for _ in range(4)]
        _wait_running(sched, 1)
        svc.block.set()
        for f in futs:
            f.result(timeout=30)
        order = sched.admission_order()
        for i in range(1, len(order) + 1):
            h, lt = order[:i].count("heavy"), order[:i].count("light")
            assert abs(h - 2 * lt) <= 2, f"2:1 violated at {order[:i]}"
    finally:
        sched.shutdown()
    return order


def _script_same_tenant(fair_cls):
    svc = _FakeService()
    svc.block.set()
    with fair_cls(svc, max_running=4) as sched:
        futs = [sched.submit("only") for _ in range(3)]
        for f in futs:
            f.result(timeout=10)
    assert svc.peak == 1   # one in flight a tenant, ever
    return sched.admission_order()


def _script_capacity(fair_cls):
    """A round whose footprint busts capacity waits for the running set
    to drain — and then runs alone rather than deadlocking."""
    svc = _FakeService(meta=_Meta())
    with fair_cls(svc, max_running=2, capacity_bytes=40_000) as sched:
        f1 = sched.submit("a")
        assert _wait_running(sched, 1) == ["a"]
        f2 = sched.submit("b")   # 32000 + 32000 > 40000: b waits
        time.sleep(0.3)
        assert sched.running() == ["a"]
        assert sched.waiting().get("b") == 1
        svc.block.set()
        f1.result(timeout=10)
        f2.result(timeout=10)
    assert sorted(svc.calls) == ["a", "b"]
    return sched.admission_order()


@pytest.mark.parametrize("script", [_script_bounds, _script_weighted,
                                    _script_same_tenant, _script_capacity],
                         ids=lambda f: f.__name__[len("_script_"):])
def test_fair_scheduler_matches_reference(script):
    """Each script holds its own checks on both packages' schedulers, and
    the two admission orders are equal."""
    ours = script(FairRoundScheduler)
    theirs = script(JFair)
    assert ours == theirs
    assert len(ours) == {"_script_bounds": 6, "_script_weighted": 12,
                         "_script_same_tenant": 3,
                         "_script_capacity": 2}[script.__name__]


# -- shutdown hygiene and the lock-order witness -------------------------------


@pytest.mark.parametrize("fair", [True, False], ids=["fair", "round"])
def test_scheduler_shutdown_joins_round_workers(fair):
    before = set(threading.enumerate())
    store = UpdateStore()
    svc = _service(store, threshold_frac=1.0, monitor_timeout=5.0)
    n, p = 4, 64
    sched = FairRoundScheduler(svc, max_running=2) if fair \
        else RoundScheduler(svc)
    futs = []
    for tenant in ("a", "b", "c"):
        for i in range(n):
            store.write(f"c{i}", RNG.normal(size=p).astype(np.float32),
                        tenant=tenant)
        futs.append(sched.submit(tenant, from_store=True,
                                 expected_clients=n))
    for f in futs:
        assert f.result(timeout=60)[1].n_clients == n
    sched.shutdown()
    leftover = [t for t in _live_workers(before) if t.is_alive()]
    assert leftover == [], f"threads outlived shutdown(): {leftover}"


def test_witness_gate_concurrent_port_service_clean():
    """The reference's lock-order witness wrapped around a port service:
    3 tenants' async rounds race on it; the acquisition graph honors the
    declared order (state < store < round), has no cycle, and saw the
    round -> store and round -> state nesting."""
    w = LockOrderWitness()
    store = UpdateStore()
    svc = _service(store, threshold_frac=1.0, monitor_timeout=10.0)
    instrument_service(svc, w)
    k, n, p, rounds = 3, 6, 128, 3
    tenants = [f"app{i}" for i in range(k)]
    u = RNG.normal(size=(k, rounds, n, p)).astype(np.float32)
    with RoundScheduler(svc) as sched:
        for r in range(rounds):
            def writes(kk, tenant, r=r):
                for i in range(n):
                    store.write(f"c{i}", u[kk, r, i], tenant=tenant)
            wt = [threading.Thread(target=writes, args=(kk, t), daemon=True)
                  for kk, t in enumerate(tenants)]
            for t_ in wt:
                t_.start()
            futs = {t: sched.submit(t, from_store=True, async_round=True,
                                    expected_clients=n)
                    for t in tenants}
            for t_ in wt:
                t_.join(timeout=60)
            for kk, (tenant, fut) in enumerate(futs.items()):
                fused, rep = fut.result(timeout=60)
                assert rep.n_clients == n
                np.testing.assert_allclose(
                    fused.numpy(), u[kk, r].astype(np.float64).mean(0),
                    rtol=RTOL, atol=ATOL)
    w.check()
    edges = set(w.edges)
    assert any(a.startswith("round:") and b == "store" for a, b in edges)
    assert any(a.startswith("round:") and b == "state" for a, b in edges)
