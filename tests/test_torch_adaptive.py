"""The port's adaptive rounds against the JAX package's (CPU).

* ``ArrivalModel`` / ``AdaptiveController``: the same offset sequences
  through both packages' controllers give equal ``policy()`` (threshold,
  deadline, source) and an equal ``state_dict()`` after every step —
  warmup, prior borrowing, drift widening, re-warmup, the cost-bias
  extremes — and the reference tests' own checks hold on the port's.
* ``.controller.json``: written by each package, loaded by the other.
* ``AggregationService(adaptive=True)``: the learned gate on scripted
  clocks, against the JAX service's gate and fused vector.
* The copied ``SpoolTailer`` and ``ingest_external``, the tailed
  arrivals feeding an async round.
"""
import bisect
import dataclasses
import math
import threading
import time

import numpy as np
import pytest

from repro.checkpoint import load_controller_state as j_load_state
from repro.checkpoint import save_controller_state as j_save_state
from repro.core import AggregationService as JService
from repro.core import UpdateStore as JStore
from repro.core.adaptive import AdaptiveController as JController
from repro.core.adaptive import ArrivalModel as JArrivalModel
from repro.core.planner import Planner as JPlanner
from repro_torch.checkpoint import (
    load_controller_state,
    save_controller_state,
)
from repro_torch.core.adaptive import (
    AdaptiveController,
    ArrivalModel,
    ClosePolicy,
)
from repro_torch.core.monitor import Monitor
from repro_torch.core.planner import Planner
from repro_torch.core.service import AggregationService
from repro_torch.core.store import SpoolTailer, UpdateStore
from repro_torch.kernels.fused_fusion import kernel

RTOL, ATOL = 2e-5, 1e-6


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


def _mk(n, p, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, p)).astype(np.float32),
            rng.uniform(1, 5, size=(n,)).astype(np.float32))


def _fedavg(u, w):
    return np.einsum("np,n->p", u, w) / (w.sum() + 1e-6)


# -- twin models and controllers -----------------------------------------------


class TwinModel:
    """An ``ArrivalModel`` of each package fed the same rounds; every
    step holds the port's state to the reference's."""

    def __init__(self, **kw):
        self.ours, self.theirs = ArrivalModel(**kw), JArrivalModel(**kw)

    def observe(self, offsets, expected):
        self.ours.observe(offsets, expected)
        self.theirs.observe(offsets, expected)
        assert self.ours.state_dict() == self.theirs.state_dict()

    def wait_for(self, frac):
        got, want = self.ours.wait_for(frac), self.theirs.wait_for(frac)
        assert got == want or (math.isinf(got) and math.isinf(want))
        return got


class Twin:
    """An ``AdaptiveController`` of each package driven by the same
    calls: every policy and every state_dict must be equal."""

    def __init__(self, **kw):
        self.ours, self.theirs = AdaptiveController(**kw), JController(**kw)

    def check(self):
        assert self.ours.state_dict() == self.theirs.state_dict()

    def observe_round(self, *args, **kw):
        self.ours.observe_round(*args, **kw)
        self.theirs.observe_round(*args, **kw)
        self.check()

    def policy(self, tenant, expected):
        got = self.ours.policy(tenant, expected)
        want = self.theirs.policy(tenant, expected)
        assert isinstance(got, ClosePolicy)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        self.check()
        return got

    def model(self, tenant):
        return self.ours.model(tenant)


def _trained(cost_bias, offsets, expected, rounds=3, timeout=30.0):
    c = Twin(cost_bias=cost_bias, threshold_frac=0.8, timeout=timeout)
    for _ in range(rounds):
        c.observe_round("m", offsets, expected, est_seconds=0.01)
    return c


# -- ArrivalModel --------------------------------------------------------------


def test_arrival_model_learns_uniform_quantiles():
    m = TwinModel(n_quantiles=10, ema=0.5)
    for _ in range(4):
        m.observe(np.linspace(0.1, 1.0, 10), expected=10)
    assert m.ours.rounds == 4 and m.ours.attainable == pytest.approx(1.0)
    assert m.wait_for(0.5) == pytest.approx(0.5, abs=0.05)
    assert m.wait_for(1.0) == pytest.approx(1.0, abs=0.05)


def test_arrival_model_censors_missing_fractions():
    m = TwinModel(n_quantiles=10, ema=0.5)
    for _ in range(5):
        m.observe(np.linspace(0.1, 0.5, 5), expected=10)
    assert m.wait_for(0.5) == pytest.approx(0.5, abs=0.05)
    assert math.isinf(m.wait_for(0.9))
    assert m.ours.attainable == pytest.approx(0.5, abs=0.02)


def test_arrival_model_ema_tracks_shift():
    m = TwinModel(n_quantiles=10, ema=0.5)
    for _ in range(3):
        m.observe(np.linspace(0.2, 2.0, 10), expected=10)
    slow = m.wait_for(1.0)
    for _ in range(4):
        m.observe(np.linspace(0.02, 0.2, 10), expected=10)
    assert m.wait_for(1.0) < slow / 3


def test_arrival_model_state_dict_loads_across_packages():
    m = TwinModel(n_quantiles=8, ema=0.4)
    m.observe(np.linspace(0.1, 0.4, 4), expected=8)
    for src, cls in ((m.theirs, ArrivalModel), (m.ours, JArrivalModel)):
        back = cls.from_state_dict(src.state_dict())
        assert back.state_dict() == src.state_dict()
        assert back.wait_for(0.5) == pytest.approx(src.wait_for(0.5))
        assert math.isinf(back.wait_for(1.0))


def test_drift_tracks_regime_change_and_decays():
    m = TwinModel(n_quantiles=10, ema=0.5)
    for _ in range(3):
        m.observe(np.linspace(0.1, 1.0, 10), expected=10)
    assert m.ours.drift == pytest.approx(0.0, abs=1e-9)
    m.observe(np.linspace(0.4, 4.0, 10), expected=10)
    assert m.ours.drift > 0.3
    for _ in range(6):
        m.observe(np.linspace(0.4, 4.0, 10), expected=10)
    assert m.ours.drift < 0.1


# -- AdaptiveController --------------------------------------------------------


def test_controller_static_until_warmup_then_prior():
    c = Twin(threshold_frac=0.8, timeout=9.0, warmup_rounds=2)
    assert c.policy("m", 10).source == "static"
    c.observe_round("m", [0.1] * 10, 10)
    assert c.policy("m", 10).source == "static"
    c.observe_round("m", [0.1] * 10, 10)
    assert c.policy("m", 10).source == "learned"
    assert c.policy("other", 10).source == "prior"
    assert c.ours.static_policy(10) == ClosePolicy(
        threshold=8, deadline=9.0, threshold_frac=0.8,
        expected_wait=9.0, source="static")
    assert c.policy("m", 0).source == "static"


def test_cost_bias_extremes():
    offsets = np.concatenate([np.linspace(0.05, 0.3, 8), [4.0, 5.0]])
    for_inclusion = _trained(1.0, offsets, 10).policy("m", 10)
    for_speed = _trained(0.0, offsets, 10).policy("m", 10)
    assert for_inclusion.threshold == 10
    assert for_inclusion.expected_wait == pytest.approx(5.0, abs=0.3)
    assert for_speed.threshold < for_inclusion.threshold
    assert for_speed.expected_wait < 0.5
    assert for_speed.deadline < for_inclusion.deadline


def test_balanced_bias_skips_expensive_tail():
    offsets = np.concatenate([np.linspace(0.05, 0.4, 8), [25.0, 28.0]])
    pol = _trained(0.5, offsets, 10).policy("m", 10)
    assert pol.source == "learned" and pol.threshold == 8
    assert pol.deadline < 5.0


def test_learned_deadline_never_exceeds_timeout():
    assert _trained(1.0, [50.0] * 10, 10, timeout=10.0).policy(
        "m", 10).deadline <= 10.0


def test_dropout_fleet_learns_attainable_threshold():
    pol = _trained(0.5, np.linspace(0.1, 1.0, 8), 10).policy("m", 10)
    assert pol.source == "learned" and pol.threshold == 8
    assert pol.deadline < 2.0
    assert pol(8, 0.9) and not pol(7, 0.9) and pol(7, pol.deadline)


def test_controller_validates_cost_bias():
    with pytest.raises(ValueError):
        AdaptiveController(cost_bias=1.5)
    with pytest.raises(ValueError):
        AggregationService(device="cpu", adaptive=True, cost_bias=-0.1)


def test_per_tenant_controller_isolation():
    c = Twin(cost_bias=0.5, threshold_frac=1.0, timeout=30.0)
    for _ in range(3):
        c.observe_round("fast", np.linspace(0.01, 0.1, 10), 10)
        c.observe_round("slow", np.linspace(0.5, 8.0, 10), 10)
    fast, slow = c.policy("fast", 10), c.policy("slow", 10)
    assert fast.deadline < slow.deadline
    assert fast.expected_wait < slow.expected_wait


def test_cold_start_tenant_borrows_prior():
    c = Twin(cost_bias=0.5, threshold_frac=1.0, timeout=30.0)
    for _ in range(3):
        c.observe_round("A", np.linspace(0.1, 1.0, 8), 10)
    pol = c.policy("fresh-tenant", 10)
    assert pol.source == "prior" and pol.threshold == 8
    assert pol.deadline < 5.0
    c.observe_round("fresh-tenant", np.linspace(0.05, 0.2, 10), 10)
    own = c.policy("fresh-tenant", 10)
    assert own.source == "learned" and own.deadline < pol.deadline


def test_empty_rounds_do_not_pollute_prior():
    c = Twin(cost_bias=0.5, threshold_frac=1.0, timeout=30.0)
    for _ in range(3):
        c.observe_round("healthy", np.linspace(0.1, 1.0, 10), 10)
        c.observe_round("dead", [], 10)
    assert c.model("dead").attainable == pytest.approx(0.0, abs=0.2)
    assert c.ours.prior_model().attainable == pytest.approx(1.0)
    pol = c.policy("fresh", 10)
    assert pol.source == "prior" and pol.threshold == 10


def test_drift_widens_learned_deadline_capped_at_timeout():
    steady = Twin(cost_bias=0.5, threshold_frac=1.0, timeout=30.0)
    shifted = Twin(cost_bias=0.5, threshold_frac=1.0, timeout=30.0)
    for _ in range(3):
        for c in (steady, shifted):
            c.observe_round("m", np.linspace(0.1, 1.0, 10), 10)
    shifted.observe_round("m", np.linspace(0.3, 3.0, 10), 10)
    pol_steady, pol_shifted = steady.policy("m", 10), shifted.policy("m", 10)
    assert shifted.model("m").drift > steady.model("m").drift
    assert pol_shifted.deadline / pol_shifted.expected_wait \
        > 1.2 * pol_steady.deadline / pol_steady.expected_wait
    assert pol_shifted.deadline <= 30.0


def test_drift_saturation_forces_rewarm_and_resets_curve():
    c = Twin(threshold_frac=1.0, timeout=10.0, rewarm_drift=0.5,
             rewarm_patience=2)
    for _ in range(3):
        c.observe_round("t", [0.1 * i for i in range(1, 11)], 10)
    assert c.policy("t", 10).source == "learned"
    for r in range(3):
        c.observe_round("t", [5.0 + 30 * r + 0.3 * i
                              for i in range(1, 11)], 10)
    assert c.model("t").drift >= 0.5
    pol = c.policy("t", 10)
    assert pol.source == "rewarm" and pol.deadline == 10.0
    assert c.model("t").rounds == 0
    assert c.policy("t", 10).source == "static"
    c.observe_round("t", [0.1 * i for i in range(1, 11)], 10)
    assert c.policy("t", 10).source == "learned"


def test_steady_drift_never_triggers_rewarm():
    c = Twin(rewarm_drift=0.5, rewarm_patience=2)
    for _ in range(10):
        c.observe_round("t", [0.1 * i for i in range(1, 9)], 8,
                        est_seconds=0.002)
    assert c.policy("t", 8).source == "learned"


def test_round_objective_monotonicity_and_reference_values():
    pl, jpl = Planner(), JPlanner()
    base = pl.round_objective(1.0, 0.8, cost_bias=0.5, horizon=30.0)
    assert pl.round_objective(5.0, 0.8, 0.5, 30.0) > base
    assert pl.round_objective(1.0, 0.95, 0.5, 30.0) < base
    assert pl.round_objective(9.0, 0.1, cost_bias=1.0, horizon=30.0) \
        == pytest.approx(0.9)
    assert pl.round_objective(3.0, 0.1, cost_bias=0.0, horizon=30.0) \
        == pytest.approx((3.0 + pl.overlap_drain_seconds) / 30.0)
    assert pl.round_objective(3.0, 0.5, 0.0, 30.0, est_seconds=1.0) \
        == pl.round_objective(3.0, 0.5, 0.0, 30.0)
    assert pl.round_objective(3.0, 0.5, 0.0, 30.0, est_seconds=9.0) \
        > pl.round_objective(3.0, 0.5, 0.0, 30.0)
    rng = np.random.default_rng(5)
    for _ in range(50):
        wait, inc, bias, est = rng.uniform(0, 40), rng.uniform(), \
            rng.uniform(), rng.uniform(0, 10)
        assert pl.round_objective(wait, inc, bias, 30.0, est) \
            == jpl.round_objective(wait, inc, bias, 30.0, est)


# -- .controller.json across packages ------------------------------------------


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_controller_json_loads_across_packages(tmp_path, writer):
    c = Twin(cost_bias=0.5, threshold_frac=1.0, timeout=30.0,
             rewarm_drift=0.5, rewarm_patience=2)
    for r in range(4):
        c.observe_round("m", np.linspace(0.1, 1.0, 8), 10,
                        est_seconds=0.02)
        c.observe_round("drifting", [1.0 + 30 * r + 0.2 * i
                                     for i in range(1, 9)], 8)
    c.observe_round("gone", [], 6)
    save, src = ((save_controller_state, c.ours) if writer == "torch"
                 else (j_save_state, c.theirs))
    path = save(str(tmp_path / "round7.npz"), src)
    assert path == str(tmp_path / "round7.controller.json")
    fresh = Twin(cost_bias=0.5, threshold_frac=1.0, timeout=30.0,
                 rewarm_drift=0.5, rewarm_patience=2)
    state = load_controller_state(str(tmp_path / "round7.npz"), fresh.ours)
    assert state == j_load_state(path, fresh.theirs)
    fresh.check()
    assert fresh.ours.state_dict() == c.ours.state_dict()
    assert fresh.ours.tenants() == ["drifting", "gone", "m"]
    for tenant in ("m", "drifting", "gone", "unseen"):
        assert dataclasses.astuple(fresh.policy(tenant, 10)) \
            == dataclasses.astuple(c.policy(tenant, 10))


# -- the service's learned gate (scripted clocks) ------------------------------


TORCH = {"cls": AggregationService, "store": UpdateStore,
         "kw": {"local_strategy": "kernel", "device": "cpu"}}
JAX = {"cls": JService, "store": JStore, "kw": {"local_strategy": "jnp"}}


def _service(pkg, store, clk=None, **kw):
    kw.setdefault("threshold_frac", 1.0)
    kw.setdefault("monitor_timeout", 30.0)
    if clk is not None:
        kw.update(clock=clk.clock, sleep=clk.sleep)
    return pkg["cls"](fusion="fedavg", store=store, **pkg["kw"], **kw)


def _curves(svc):
    """The controller's learned curves, less the fuse-wall estimates
    (measured times, which differ between the packages)."""
    state = svc.controller.state_dict()
    del state["est_seconds"], state["prior_est"]
    return state


def _gates(scenario):
    """Run ``scenario(pkg) -> (service, [(fused, report), ...])`` on both
    packages; the gates, inclusion, waits, fused vectors and learned
    curves must agree. Returns the port's rounds and service."""
    svc, ours = scenario(TORCH)
    jsvc, theirs = scenario(JAX)
    assert len(ours) == len(theirs) > 0
    for k, ((f, r), (jf, jr)) in enumerate(zip(ours, theirs)):
        assert dataclasses.astuple(r.close_policy) \
            == dataclasses.astuple(jr.close_policy), k
        assert (r.n_clients, r.monitor.count, r.monitor.ready,
                r.monitor.waited, r.overlap_seconds, r.async_round) \
            == (jr.n_clients, jr.monitor.count, jr.monitor.ready,
                jr.monitor.waited, jr.overlap_seconds, jr.async_round), k
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=RTOL,
                                   atol=ATOL, err_msg=f"round {k}")
    assert _curves(svc) == _curves(jsvc)
    return ours, svc


def test_service_learns_to_close_dropout_rounds_early():
    """Expected 10, 8 land within 1 s, 2 never: the static first round
    burns the 30 s timeout; the learned second closes in about 1 s at the
    same inclusion."""
    n, p = 8, 40
    u, w = _mk(n, p, 21)

    def scenario(pkg):
        clk = ScriptedClock()
        store = pkg["store"](clock=clk.clock)
        svc = _service(pkg, store, clk, adaptive=True)
        out = []
        for _ in range(2):
            base = clk.t
            for i in range(n):
                clk.at(base + 0.1 * (i + 1), lambda i=i: store.write(
                    f"c{i}", u[i], weight=float(w[i])))
            out.append(svc.aggregate(from_store=True, expected_clients=10,
                                     async_round=True))
        return svc, out

    (r1, r2), _ = _gates(scenario)
    assert r1[1].close_policy.source == "static"
    assert r1[1].monitor.waited >= 30.0 and r1[1].n_clients == n
    assert r2[1].close_policy.source == "learned"
    assert r2[1].n_clients == n and r2[1].monitor.waited < 3.0
    np.testing.assert_allclose(r2[0].numpy(), _fedavg(u, w), rtol=RTOL,
                               atol=ATOL)


def test_service_serialized_adaptive_round_learns_too():
    n, p = 6, 32
    u, w = _mk(n, p, 22)

    def scenario(pkg):
        clk = ScriptedClock()
        store = pkg["store"](clock=clk.clock)
        svc = _service(pkg, store, clk, adaptive=True)
        out = []
        for _ in range(2):
            base = clk.t
            for i in range(n):
                clk.at(base + 0.2 * (i + 1), lambda i=i: store.write(
                    f"c{i}", u[i], weight=float(w[i])))
            out.append(svc.aggregate(from_store=True, expected_clients=8))
            store.clear()
        return svc, out

    (r1, r2), _ = _gates(scenario)
    assert r1[1].monitor.waited >= 30.0
    assert r2[1].close_policy.source == "learned"
    assert r2[1].monitor.waited < 4.0 and r2[1].n_clients == n


def test_service_cold_tenant_closes_on_prior():
    n, p = 8, 24
    u, w = _mk(n, p, 23)

    def scenario(pkg):
        clk = ScriptedClock()
        store = pkg["store"](clock=clk.clock)
        svc = _service(pkg, store, clk, adaptive=True)
        out = []
        for tenant in ("A", "B"):
            base = clk.t
            for i in range(n):
                clk.at(base + 0.1 * (i + 1), lambda i=i, t=tenant:
                       store.write(f"c{i}", u[i], weight=float(w[i]),
                                   tenant=t))
            out.append(svc.aggregate(from_store=True, expected_clients=10,
                                     async_round=True, tenant=tenant))
        return svc, out

    (r1, r2), _ = _gates(scenario)
    assert r1[1].close_policy.source == "static"
    assert r1[1].monitor.waited >= 30.0
    assert r2[1].close_policy.source == "prior"
    assert r2[1].n_clients == n and r2[1].monitor.waited < 3.0


def test_per_tenant_carry_isolation():
    """Interleaved tenants with a staleness discount: each tenant's carry
    evolves from its own rounds only, on the port as on the reference."""
    p, g = 24, 0.5
    u, w = _mk(6, p, 24)

    def scenario(pkg):
        clk = ScriptedClock()
        store = pkg["store"](clock=clk.clock)
        svc = _service(pkg, store, clk, monitor_timeout=0.5,
                       staleness_discount=g, adaptive=True,
                       cost_bias=0.3)
        out = []
        for rows, tenant in ((slice(0, 2), "A"), (slice(2, 4), "B"),
                             (slice(4, 5), "A"), (slice(5, 6), "B")):
            for cid, (uu, ww) in enumerate(zip(u[rows], w[rows])):
                store.write(f"{tenant}-{cid}", uu, weight=float(ww),
                            tenant=tenant)
            out.append(svc.aggregate(
                from_store=True, expected_clients=len(u[rows]),
                async_round=True, tenant=tenant))
        return svc, out

    rounds, svc = _gates(scenario)
    for k, t, old, new in ((2, "A", slice(0, 2), 4), (3, "B", slice(2, 4), 5)):
        ws = g * np.einsum("np,n->p", u[old], w[old]) + w[new] * u[new]
        tot = g * w[old].sum() + w[new]
        np.testing.assert_allclose(rounds[k][0].numpy(), ws / (tot + 1e-6),
                                   rtol=RTOL, atol=ATOL)
        assert rounds[k][1].tenant == t
    assert {r.tenant for r in svc.history} == {"A", "B"}
    assert set(svc._carry) == {"A", "B"}
    assert all(s[0].device == svc.device for s in svc._carry.values())


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_restarted_service_resumes_learned_across_packages(tmp_path, writer):
    """A service of one package saves its controller after a static
    round; a fresh service of the other loads it and closes its first
    round on the learned gate."""
    n, p = 8, 24
    u, w = _mk(n, p, 25)
    ckpt = str(tmp_path / "model")
    first, second = (TORCH, JAX) if writer == "torch" else (JAX, TORCH)

    def run(pkg, load):
        clk = ScriptedClock()
        store = pkg["store"](clock=clk.clock)
        svc = _service(pkg, store, clk, adaptive=True)
        if load:
            svc.load_controller(ckpt)
        for i in range(n):
            clk.at(0.1 * (i + 1), lambda i=i: store.write(
                f"c{i}", u[i], weight=float(w[i])))
        return svc, svc.aggregate(from_store=True, expected_clients=10,
                                  async_round=True)

    svc1, (_, rep1) = run(first, load=False)
    assert rep1.close_policy.source == "static"
    assert svc1.save_controller(ckpt).endswith("model.controller.json")
    svc2, (fused, rep2) = run(second, load=True)
    assert rep2.close_policy.source == "learned"
    assert rep2.n_clients == n and rep2.monitor.waited < 3.0
    np.testing.assert_allclose(np.asarray(fused), _fedavg(u, w),
                               rtol=RTOL, atol=ATOL)
    plain = AggregationService(device="cpu")
    with pytest.raises(ValueError):
        plain.save_controller(str(tmp_path / "x"))
    with pytest.raises(ValueError):
        plain.load_controller(ckpt)


def test_monitor_pluggable_policy_overrides_static_gate():
    clk = ScriptedClock()
    store = UpdateStore(clock=clk.clock)
    u, w = _mk(4, 48, 26)
    for i in range(3):
        clk.at(0.2 * (i + 1), lambda i=i: store.write(
            f"c{i}", u[i], weight=float(w[i])))
    pol = ClosePolicy(threshold=3, deadline=5.0, threshold_frac=0.75,
                      expected_wait=0.6, source="learned")
    res = Monitor(store, threshold=3, timeout=60.0, poll_interval=0.1,
                  clock=clk.clock, sleep=clk.sleep, policy=pol).wait()
    assert res.ready and res.count == 3 and res.waited < 1.0


# -- store arrival capture and the spool tailer --------------------------------


def test_store_arrival_times_follow_store_clock():
    clk = ScriptedClock()
    store = UpdateStore(clock=clk.clock)
    store.write("a", np.ones(4, np.float32))
    clk.sleep(2.5)
    store.write("b", np.ones(4, np.float32))
    at = store.arrival_times()
    assert at["b"] - at["a"] == pytest.approx(2.5)
    store.remove(["a"])
    assert "a" not in store.arrival_times()
    store.clear()
    assert store.arrival_times() == {}


def test_wait_for_arrival_wakes_on_write_not_timeout():
    store = UpdateStore()
    t = threading.Timer(0.15, lambda: store.write(
        "x", np.ones(4, np.float32)))
    t.start()
    t0 = time.perf_counter()
    store.wait_for_arrival(timeout=10.0)
    elapsed = time.perf_counter() - t0
    t.join()
    assert store.count() == 1 and elapsed < 5.0


def test_spool_tailer_ingests_external_writes(tmp_path):
    store = UpdateStore(backend="disk", spool_dir=str(tmp_path))
    with SpoolTailer(store, poll_interval=0.05):
        def foreign_writer():
            np.save(tmp_path / "ext0.npy", np.full(8, 3.0, np.float32))
            with open(tmp_path / "ext0.npy.w", "w") as f:
                f.write("2.5")
        th = threading.Thread(target=foreign_writer)
        th.start()
        deadline = time.time() + 5.0
        while store.count() < 1 and time.time() < deadline:
            store.wait_for_arrival(timeout=0.2)
        th.join()
        assert store.count() == 1, "tailer never saw the external blob"
        upd, weight = store.read("ext0")
        assert weight == 2.5
        np.testing.assert_array_equal(np.asarray(upd),
                                      np.full(8, 3.0, np.float32))
        assert "ext0" in store.arrival_times()
    np.save(tmp_path / "ext1.npy", np.ones(8, np.float32))
    assert store.count() == 1   # the tailer thread was joined


def test_ingest_external_skips_partial_blobs(tmp_path):
    wall = ScriptedClock()
    store = UpdateStore(backend="disk", spool_dir=str(tmp_path),
                        sidecar_grace_seconds=0.05, wall_clock=wall.clock)
    (tmp_path / "broken.npy").write_bytes(b"\x93NUMPY garbage")
    np.save(tmp_path / "good.npy", np.ones(4, np.float32))
    assert store.ingest_external() == []
    wall.sleep(0.1)
    assert store.ingest_external() == ["good"]
    assert store.client_ids() == ["good"]
    assert store.read("good")[1] == 1.0
    assert store.ingest_external() == []


def test_ingest_external_waits_for_inflight_sidecar(tmp_path):
    wall = ScriptedClock()
    store = UpdateStore(backend="disk", spool_dir=str(tmp_path),
                        wall_clock=wall.clock)
    np.save(tmp_path / "c7.npy", np.ones(4, np.float32))
    assert store.ingest_external() == []
    assert store.ingest_external() == []
    with open(tmp_path / "c7.npy.w", "w") as f:
        f.write("42.0")
    assert store.ingest_external() == ["c7"]
    assert store.read("c7")[1] == 42.0


def test_spool_tailer_rejects_memory_backend():
    with pytest.raises(ValueError):
        SpoolTailer(UpdateStore())


def test_tailed_arrivals_feed_async_round(tmp_path):
    """External spool writes only, found by the tailer and folded by the
    port's async round, equal to the JAX service's round over the same
    rows."""
    u, w = _mk(5, 16, 27)
    store = UpdateStore(backend="disk", spool_dir=str(tmp_path))
    svc = AggregationService(store=store, device="cpu", threshold_frac=1.0,
                             monitor_timeout=10.0, poll_interval=0.02)

    def foreign_writer():
        for i in range(5):
            np.save(tmp_path / f"e{i}.npy", u[i])
            with open(tmp_path / f"e{i}.npy.w", "w") as f:
                f.write(repr(float(w[i])))

    with SpoolTailer(store, poll_interval=0.05):
        th = threading.Thread(target=foreign_writer)
        th.start()
        fused, rep = svc.aggregate(from_store=True, expected_clients=5,
                                   async_round=True)
        th.join()
    assert rep.n_clients == 5 and rep.monitor.ready and rep.async_round
    assert store.count() == 0
    jstore = JStore()
    for i in range(5):
        jstore.write(f"e{i}", u[i], weight=float(w[i]))
    want, _ = JService(store=jstore, local_strategy="jnp",
                       monitor_timeout=1.0).aggregate(
        from_store=True, expected_clients=5, async_round=True)
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(fused.numpy(), _fedavg(u, w), rtol=RTOL,
                               atol=ATOL)
