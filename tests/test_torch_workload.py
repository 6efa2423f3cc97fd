"""The port's workload generator and replay against the JAX package's.

Twins of the 24 cases of ``tests/test_workload.py``, each run on the
port (``repro_torch.workload``) and, where it builds something, held
bit for bit to the reference (``repro.workload``): the same spec and seed
give the same ``WorkloadTrace``, the same canonical JSON bytes, the same
``trace_hash`` and the same ``trace_payload`` bits. Replay runs on a
scripted clock into both packages' stores, which must then hold the same
arrival offsets and rows; and a 3-tenant trace with no dropout replays
through both packages' ``RoundScheduler``, whose fused vectors must match
a tenant and a round at a time.
"""
import bisect
import json

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.workload as J
import repro_torch.workload as T
from repro.core import AggregationService as JService
from repro.core import RoundScheduler as JScheduler
from repro.core import UpdateStore as JStore
from repro_torch.configs.cnn_suite import CNN_SUITE
from repro_torch.core.compress import BLOCK, compressed_bytes
from repro_torch.core.service import AggregationService, RoundScheduler
from repro_torch.core.store import UpdateStore
from repro_torch.kernels.fused_fusion import kernel

PKGS = {"torch": T, "jax": J}


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"weighted_sum": 0, "weighted_sum_dequant": 0}


class ScriptedClock:
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


def _spec(m, rounds=10, tenants=("app0", "app1"), n=8, **kw):
    defaults = dict(
        regimes=m.RegimeSchedule([
            m.Regime("uniform", m.UniformArrivals(spread=0.4), 0),
            m.Regime("bursty", m.BurstyArrivals(spread=0.4, arrive_frac=0.75),
                     max(rounds // 2, 1)),
        ]),
        sizes=m.LognormalSize(median_dim=2000, sigma=0.4),
        churn=m.TenantChurn(scheduled_joins=((rounds // 2, None),)),
    )
    defaults.update(kw)
    return m.WorkloadSpec(tenants=tuple(tenants), n_clients=n,
                          rounds=rounds, **defaults)


def _same_trace(ours, theirs):
    """Bit-equal traces: canonical JSON, hash, and every event."""
    assert ours.canonical_json() == theirs.canonical_json()
    assert ours.trace_hash() == theirs.trace_hash()
    assert ours.to_dict() == theirs.to_dict()


# -- seeded determinism --------------------------------------------------------


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_same_seed_identical_trace(seed):
    spec = _spec(T)
    a, b = spec.build(seed), spec.build(seed)
    assert a == b and a.trace_hash() == b.trace_hash()
    assert a.trace_hash() != spec.build(seed + 1).trace_hash()
    _same_trace(a, _spec(J).build(seed))


@pytest.mark.parametrize("seed", [0, 7, 4242])
def test_same_seed_identical_trace_file(tmp_path, seed):
    """Two builds under one seed write IDENTICAL files, byte for byte the
    reference's."""
    paths = [tmp_path / f"{name}{i}.json" for name in ("t", "j")
             for i in range(2)]
    _spec(T).build(seed).to_json(str(paths[0]))
    _spec(T).build(seed).to_json(str(paths[1]))
    _spec(J).build(seed).to_json(str(paths[2]))
    _spec(J).build(seed).to_json(str(paths[3]))
    assert len({p.read_bytes() for p in paths}) == 1


def test_trace_insensitive_to_build_order():
    wide = _spec(T, tenants=("app0", "app1", "app2"), churn=None).build(3)
    narrow = _spec(T, tenants=("app2",), churn=None).build(3)
    for r in range(wide.n_rounds):
        assert wide.rounds[r].tenant("app2").events == \
            narrow.rounds[r].tenant("app2").events
    _same_trace(wide, _spec(J, tenants=("app0", "app1", "app2"),
                            churn=None).build(3))


# -- serialization -------------------------------------------------------------


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_trace_json_roundtrip_equality(seed, tmp_path_factory):
    """A trace file written by either package loads in the other as the
    same trace."""
    tmp = tmp_path_factory.mktemp("trace")
    trace = _spec(T).build(seed)
    ours, theirs = str(tmp / f"t{seed}.json"), str(tmp / f"j{seed}.json")
    trace.to_json(ours)
    _spec(J).build(seed).to_json(theirs)
    back = T.WorkloadTrace.from_json(theirs)
    assert back == trace and back.trace_hash() == trace.trace_hash()
    _same_trace(J.WorkloadTrace.from_json(ours), back)


def test_spec_roundtrip_rebuilds_identical_trace():
    spec = _spec(T)
    trace = spec.build(11)
    d = json.loads(json.dumps(spec.to_dict()))
    assert d == json.loads(json.dumps(_spec(J).to_dict()))
    assert T.WorkloadSpec.from_dict(d).build(11).trace_hash() == \
        trace.trace_hash() == J.WorkloadSpec.from_dict(d).build(11).trace_hash()


def test_arrival_dict_roundtrip_every_kind():
    for m in (T, J):
        procs = [
            m.UniformArrivals(spread=0.7, arrive_frac=0.9),
            m.PoissonArrivals(rate=12.5),
            m.BurstyArrivals(spread=0.5, arrive_frac=0.8, window=(0.1, 0.4)),
            m.LognormalArrivals(spread=1.1, sigma=0.3, drop_clients=1),
            m.DiurnalArrivals(period=2.0, base_rate=1.0, peak_rate=9.0),
        ]
        dicts = []
        for p in procs:
            d = json.loads(json.dumps(p.to_dict()))
            assert m.arrival_from_dict(d) == p and d == p.to_dict()
            dicts.append(d)
        with pytest.raises(ValueError):
            m.arrival_from_dict({"kind": "nope"})
        with pytest.raises(ValueError):
            m.arrival_from_dict({"kind": "uniform", "bogus_field": 1})
        if m is T:
            ours = dicts
    assert ours == dicts


def test_size_dict_roundtrip_every_kind():
    for m in (T, J):
        for s in (m.FixedSize(dim=123), m.LognormalSize(median_dim=500),
                  m.ModelConfigSize(models=("CNN4.6",), scale=500)):
            assert m.size_from_dict(json.loads(json.dumps(s.to_dict()))) == s
        with pytest.raises(ValueError):
            m.size_from_dict({"kind": "nope"})
        with pytest.raises(ValueError):
            m.ModelConfigSize(models=("NOT_A_MODEL",))


def test_trace_version_guard():
    d = _spec(T, rounds=2).build(0).to_dict()
    d["version"] = 999
    for m in (T, J):
        with pytest.raises(ValueError):
            m.WorkloadTrace.from_dict(d)


# -- arrival statistics --------------------------------------------------------


@settings(max_examples=10, deadline=None)
@given(rate=st.floats(2.0, 25.0), seed=st.integers(0, 1000))
def test_poisson_interarrival_mean(rate, seed):
    offs = T.PoissonArrivals(rate=rate).sample(np.random.default_rng(seed),
                                               4000)
    gaps = np.diff(np.concatenate([[0.0], offs]))
    assert len(offs) == 4000 and np.all(np.diff(offs) >= 0)
    assert np.mean(gaps) == pytest.approx(1.0 / rate, rel=0.15)
    assert np.array_equal(offs, J.PoissonArrivals(rate=rate).sample(
        np.random.default_rng(seed), 4000))


@settings(max_examples=10, deadline=None)
@given(n=st.integers(4, 200), frac=st.floats(0.3, 1.0),
       seed=st.integers(0, 1000))
def test_bursty_window_and_dropout(n, frac, seed):
    kw = dict(spread=2.0, arrive_frac=frac, window=(0.05, 0.15))
    offs = T.BurstyArrivals(**kw).sample(np.random.default_rng(seed), n)
    assert len(offs) == max(int(n * frac), 1)
    assert np.all(offs >= 0.05 * 2.0) and np.all(offs <= 0.15 * 2.0)
    assert np.all(np.diff(offs) >= 0)
    assert np.array_equal(offs, J.BurstyArrivals(**kw).sample(
        np.random.default_rng(seed), n))


def test_uniform_matches_classic_schedule():
    offs = T.UniformArrivals(spread=1.0).sample(np.random.default_rng(0), 10)
    np.testing.assert_allclose(offs, [(i + 1) * 0.1 for i in range(10)])
    assert np.array_equal(offs, J.UniformArrivals(spread=1.0).sample(
        np.random.default_rng(0), 10))


def test_lognormal_drops_and_clips():
    offs = T.LognormalArrivals(spread=0.5, drop_clients=2).sample(
        np.random.default_rng(3), 12)
    assert len(offs) == 10
    assert np.all(offs >= 0.0) and np.all(offs <= 0.5)
    assert np.array_equal(offs, J.LognormalArrivals(
        spread=0.5, drop_clients=2).sample(np.random.default_rng(3), 12))


def test_diurnal_bounded_and_rate_sensitive():
    kws = (dict(period=4.0, base_rate=0.5, peak_rate=2.0),
           dict(period=4.0, base_rate=8.0, peak_rate=64.0))
    counts = []
    for kw in kws:
        proc = T.DiurnalArrivals(**kw)
        draws = [proc.sample(np.random.default_rng(s), 64) for s in range(8)]
        for s, offs in enumerate(draws):
            assert np.all(offs >= 0.0) and np.all(offs < 4.0)
            assert np.array_equal(offs, J.DiurnalArrivals(**kw).sample(
                np.random.default_rng(s), 64))
        counts.append(np.mean([len(o) for o in draws]))
    assert counts[1] > counts[0]


def test_diurnal_phase_advances_with_round_index():
    proc = T.DiurnalArrivals(period=4.0, base_rate=0.5, peak_rate=32.0,
                             round_advance=0.5)
    a = proc.sample(np.random.default_rng(1), 64, round_index=0)
    b = proc.sample(np.random.default_rng(1), 64, round_index=1)
    assert len(a) != len(b) or not np.allclose(a, b)
    assert np.array_equal(b, J.DiurnalArrivals(
        period=4.0, base_rate=0.5, peak_rate=32.0, round_advance=0.5).sample(
            np.random.default_rng(1), 64, round_index=1))


# -- regime schedule -----------------------------------------------------------


@settings(max_examples=15, deadline=None)
@given(boundary=st.integers(1, 99))
def test_regime_shift_boundary_exact(boundary):
    sched = T.RegimeSchedule([
        T.Regime("before", T.UniformArrivals(spread=1.0), 0),
        T.Regime("after", T.BurstyArrivals(spread=1.0), boundary),
    ])
    assert sched.at(boundary - 1).name == "before"
    assert sched.at(boundary).name == "after"
    assert sched.at(boundary + 1).name == "after"
    assert sched.at(0).name == "before"
    assert sched.to_dict() == J.RegimeSchedule.from_dict(
        sched.to_dict()).to_dict()


def test_regime_schedule_validation():
    for m in (T, J):
        with pytest.raises(ValueError):
            m.RegimeSchedule([])
        with pytest.raises(ValueError):
            m.RegimeSchedule([m.Regime("late", m.UniformArrivals(), 5)])
        with pytest.raises(ValueError):
            m.RegimeSchedule([m.Regime("a", m.UniformArrivals(), 0),
                              m.Regime("b", m.BurstyArrivals(), 0)])
        with pytest.raises(ValueError):
            m.RegimeSchedule.single(m.UniformArrivals()).at(-1)


def test_trace_rounds_carry_regime_labels():
    trace = _spec(T, rounds=6, churn=None).build(0)
    assert [rt.tenants[0].regime for rt in trace.rounds] == \
        ["uniform"] * 3 + ["bursty"] * 3
    _same_trace(trace, _spec(J, rounds=6, churn=None).build(0))


# -- churn ---------------------------------------------------------------------


def test_scheduled_churn_joins_exactly():
    churn = T.TenantChurn(scheduled_joins=((3, 2), (5, None)))
    active = churn.schedule(np.random.default_rng(0), 8)
    assert active[2] == []
    assert active[3] == ["churn0"] and active[4] == ["churn0"]
    assert active[5] == ["churn1"] and active[7] == ["churn1"]
    assert churn.to_dict() == J.TenantChurn(
        scheduled_joins=((3, 2), (5, None))).to_dict()
    with pytest.raises(ValueError):
        T.TenantChurn(scheduled_joins=((9, None),)).schedule(
            np.random.default_rng(0), 8)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 500))
def test_random_churn_deterministic_per_seed(seed):
    churn = T.TenantChurn(join_rate=0.4, lifetime_rounds=5)
    a = churn.schedule(np.random.default_rng(seed), 30)
    assert a == churn.schedule(np.random.default_rng(seed), 30)
    assert a == J.TenantChurn(join_rate=0.4, lifetime_rounds=5).schedule(
        np.random.default_rng(seed), 30)


# -- sizes ---------------------------------------------------------------------


def test_tenant_dim_stable_across_rounds():
    trace = _spec(T, rounds=6).build(5)
    dims = {}
    for rt in trace.rounds:
        for tr in rt.tenants:
            dims.setdefault(tr.tenant, set()).add(tr.dim)
    assert all(len(ds) == 1 for ds in dims.values())
    _same_trace(trace, _spec(J, rounds=6).build(5))


def test_size_distributions_sample_sanely():
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    assert T.FixedSize(dim=777).sample(rng) == 777
    ours = [T.LognormalSize(median_dim=100, min_dim=64).sample(rng)
            for _ in range(50)]
    assert all(d >= 64 for d in ours)
    assert ours == [J.LognormalSize(median_dim=100, min_dim=64).sample(jrng)
                    for _ in range(50)]
    dim = T.ModelConfigSize(models=("CNN4.6",), scale=1000).sample(rng)
    assert dim == CNN_SUITE["CNN4.6"].num_params // 1000
    assert dim == J.ModelConfigSize(models=("CNN4.6",), scale=1000).sample(
        jrng)


# -- replay --------------------------------------------------------------------


def test_replay_lands_arrivals_at_traced_offsets():
    """On scripted clocks both packages' stores hold the traced offsets
    exactly, and the same rows and weights."""
    trace = _spec(T, rounds=1, churn=None).build(9)
    tr = trace.rounds[0].tenant("app0")
    stores = {}
    for name, m, store_cls in (("torch", T, UpdateStore),
                               ("jax", J, JStore)):
        clk = ScriptedClock()
        store = store_cls(clock=clk.clock)
        wrote = m.replay_round(store, tr, seed=9, clock=clk.clock,
                               sleep=clk.sleep)
        assert wrote == len(tr.events)
        stores[name] = store
    arrivals = stores["torch"].arrival_times("app0")
    assert arrivals == stores["jax"].arrival_times("app0")
    for ev in tr.events:
        assert arrivals[ev.client_id] == pytest.approx(ev.offset, abs=1e-12)
        u, w = stores["torch"].read(ev.client_id, tenant="app0")
        ju, jw = stores["jax"].read(ev.client_id, tenant="app0")
        assert w == pytest.approx(ev.weight) and w == jw
        assert np.array_equal(u, T.trace_payload(9, "app0", ev.client_id,
                                                 tr.dim))
        assert np.array_equal(u, ju)


@pytest.mark.parametrize("seed", [0, 1, 99])
@pytest.mark.parametrize("dim", [1, 128, 4099])
def test_trace_payload_deterministic_and_distinct(seed, dim):
    a = T.trace_payload(seed, "app0", "client00000", dim)
    assert np.array_equal(a, T.trace_payload(seed, "app0", "client00000",
                                             dim))
    assert a.dtype == np.float32 and a.shape == (dim,)
    assert not a.flags.writeable
    assert a.tobytes() == J.trace_payload(seed, "app0", "client00000",
                                          dim).tobytes()
    if dim > 1:
        assert not np.array_equal(a, T.trace_payload(seed, "app1",
                                                     "client00000", dim))
        assert not np.array_equal(a, T.trace_payload(seed + 1, "app0",
                                                     "client00000", dim))


# -- the classifier re-export and the compressed-bytes fix ---------------------


def test_classify_uses_real_compressed_bytes():
    """int8 rounds move ~4x fewer bytes than fp32: a fleet whose fp32 S
    overflows the card's memory but whose compressed S fits classifies
    HBM_LOCAL (the port classifies against the H100's 80 GB at 75%)."""
    num_params, n = 1_000_000, 20_000     # fp32 S = 80 GB > 60 GB cap
    dense = T.Workload.for_params(num_params, n)
    packed = T.Workload.for_params(num_params, n, compressed=True)
    assert T.classify(dense) is T.WorkloadClass.DISTRIBUTED
    assert T.classify(packed) is T.WorkloadClass.HBM_LOCAL
    assert packed.update_bytes == compressed_bytes(num_params, BLOCK)
    assert packed.num_params == dense.num_params == num_params
    assert packed.total_bytes < dense.total_bytes / 3.5
    jpacked = J.Workload.for_params(num_params, n, compressed=True)
    assert (packed.update_bytes, packed.n_clients) == \
        (jpacked.update_bytes, jpacked.n_clients)


# -- a 3-tenant trace through both packages' RoundScheduler --------------------


def test_trace_replay_through_round_schedulers_matches_reference():
    """3 tenants x 4 rounds with no dropout (every client arrives, so
    the close sets are equal): each round's writers replay the trace
    while both packages' schedulers run the tenants' async rounds, and
    the fused vectors match a tenant and a round at a time."""
    tenants = ("app0", "app1", "app2")
    seed, n, rounds = 13, 6, 4

    def spec(m):
        return m.WorkloadSpec(
            tenants=tenants, n_clients=n, rounds=rounds,
            regimes=m.RegimeSchedule.single(m.UniformArrivals(spread=0.05)),
            sizes=m.FixedSize(dim=257))

    trace = spec(T).build(seed)
    _same_trace(trace, spec(J).build(seed))
    store, jstore = UpdateStore(), JStore()
    kw = dict(fusion="fedavg", threshold_frac=1.0, monitor_timeout=30.0)
    svc = AggregationService(store=store, device="cpu", **kw)
    jsvc = JService(store=jstore, local_strategy="jnp", **kw)
    with RoundScheduler(svc) as sched, JScheduler(jsvc) as jsched:
        for rt in trace.rounds:
            writers = [T.start_writer(store, tr, seed) for tr in rt.tenants]
            writers += [J.start_writer(jstore, tr, seed) for tr in rt.tenants]
            rkw = dict(from_store=True, expected_clients=n, async_round=True)
            res = sched.run_round(list(tenants), **rkw)
            jres = jsched.run_round(list(tenants), **rkw)
            for w in writers:
                w.join(timeout=60)
                assert not w.is_alive()
            for tr in rt.tenants:
                fused, rep = res[tr.tenant]
                assert rep.n_clients == jres[tr.tenant][1].n_clients == n
                rows = np.stack([T.trace_payload(seed, tr.tenant,
                                                 ev.client_id, tr.dim)
                                 for ev in tr.events]).astype(np.float64)
                w = np.array([ev.weight for ev in tr.events])
                np.testing.assert_allclose(
                    fused.numpy(), w @ rows / w.sum(), rtol=1e-4, atol=1e-5,
                    err_msg=f"{tr.tenant} round {rt.index}")
                np.testing.assert_allclose(
                    fused.numpy(), np.asarray(jres[tr.tenant][0]),
                    rtol=1e-4, atol=1e-5,
                    err_msg=f"{tr.tenant} round {rt.index} vs reference")
                assert store.count(tr.tenant) == jstore.count(tr.tenant) == 0
