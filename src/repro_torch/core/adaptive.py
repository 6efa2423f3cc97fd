"""Adaptive aggregation controller — the paper's headline claim made
real: "the first adaptive FL aggregator at the Edge, enabling users to
manage the cost and efficiency trade-off" (arXiv:2204.07767, §V).

This is ``repro.core.adaptive`` with the port's ``Planner``; its
``state_dict`` is the reference's key for key, so a ``.controller.json``
written by either package loads in the other.

The static gate closes a round at a fixed ``threshold_frac`` of
expected clients or a fixed timeout. That wastes wall-clock whenever the
observed arrival behavior diverges from the deadline: a fleet whose
stragglers reliably land at 1.2 s idles out a 30 s timeout the first
time two clients drop; a bursty fleet that fully arrives at 0.3 s still
pays the threshold poll cadence. This module LEARNS the arrival curve
and re-derives the gate every round:

  ``ArrivalModel``       per-tenant exponentially-weighted empirical
                         quantile curve of arrival offsets (seconds from
                         round start to each client's store write), with
                         censoring: fractions that did not arrive within
                         a round's window stay unknown rather than
                         polluting the curve, an EW *attainable
                         fraction* tracks client drop-out, and an EW
                         *drift* score tracks how fast the curve itself
                         is moving round-over-round.
  ``AdaptiveController`` owns one model per tenant PLUS a cross-tenant
                         prior (the pooled curve cold-start tenants
                         borrow until they have their own mass), turns
                         the selected curve into a ``ClosePolicy`` by
                         minimizing the planner's cost-vs-staleness
                         objective (``Planner.round_objective``) over a
                         fraction grid — widening the learned deadline
                         while the tenant's drift score says arrival
                         behavior is shifting faster than the EW window
                         tracks — and persists across rounds (and — via
                         ``state_dict`` — across aggregator restarts;
                         ``repro_torch.checkpoint.save_controller_state``
                         writes it next to model checkpoints).
  ``ClosePolicy``        the pluggable gate predicate ``Monitor``
                         accepts: close at a learned threshold count OR
                         a learned deadline, whichever first.

The user knob is ``cost_bias`` in [0, 1]: 0 optimizes round wall-clock
alone (cost — close as soon as the marginal straggler is not worth the
wait), 1 optimizes update inclusion alone (efficiency — wait for every
client the curve says will come). 0.5 balances them. The controller
never waits past the static timeout: the learned deadline is capped, so
a fleet whose behavior shifts degrades to the static gate, not worse.
A shift the EW window cannot catch at all — drift saturated for
``rewarm_patience`` consecutive rounds — triggers RE-WARMUP: one forced
static round (``ClosePolicy.source == "rewarm"``) with the tenant's
curve reset, so the gate re-learns the new regime instead of widening a
stale deadline forever.

The controller is THREAD-SAFE: one instance serves every tenant's
concurrent rounds (the RoundScheduler's workers call ``policy`` /
``observe_round`` from per-tenant threads), so all public entry points
serialize on an internal lock — model blends and policy derivation are
numpy state mutations that must not interleave.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.planner import Planner


@dataclasses.dataclass
class ClosePolicy:
    """A concrete round-close gate: close once ``threshold`` updates
    have landed OR ``deadline`` seconds have elapsed. Callable with the
    ``(count, waited)`` signature ``Monitor`` and
    ``UpdateStore.iter_arrivals`` expect, so it plugs into either."""

    threshold: int          # arrival count that closes the gate
    deadline: float         # seconds after which the gate closes anyway
    threshold_frac: float   # threshold / expected (for reporting)
    expected_wait: float    # learned t(threshold_frac); deadline basis
    # "static" — the configured threshold_frac/timeout gate;
    # "learned" — derived from this tenant's own arrival curve;
    # "prior"  — derived from the cross-tenant prior curve (cold-start
    #            tenant borrowing pooled mass until it has its own);
    # "rewarm" — the static gate FORCED for one round after the
    #            tenant's drift stayed saturated (the curve was reset
    #            and re-learns from this round's arrivals)
    source: str = "static"

    def __call__(self, count: int, waited: float) -> bool:
        return count >= self.threshold or waited >= self.deadline


class ArrivalModel:
    """Exponentially-weighted empirical quantile curve of one tenant's
    arrival offsets.

    ``observe(offsets, expected)`` folds one round's arrival times
    (seconds since round start, one per client that landed) into the
    curve: quantile k is the offset by which fraction ``fracs[k]`` of
    the EXPECTED fleet had arrived. Fractions the round never reached
    (stragglers that missed the window, dropped clients) are censored —
    the stored quantile keeps its previous estimate and the EW
    ``attainable`` fraction decays instead, so the policy stops aiming
    at fractions the fleet no longer delivers.

    ``drift`` is an EW score of how much the freshly observed quantiles
    disagree with the stored curve (relative error over the fractions
    both reached, capped at 1.0): ~0 for a fleet in steady state, large
    while arrival behavior is shifting faster than the EW window has
    caught up. The controller widens the learned deadline while drift
    is high, so a regime change degrades toward the static timeout
    instead of closing rounds against a stale curve.

    ``ema`` is the weight of the NEWEST round (0.5 adapts within ~2
    rounds; lower is smoother).
    """

    # relative-error floor (seconds): offsets below this are all jitter
    _DRIFT_DENOM_FLOOR = 1e-2

    def __init__(self, n_quantiles: int = 20, ema: float = 0.5):
        if not 0 < ema <= 1:
            raise ValueError("ema must be in (0, 1]")
        self.fracs = np.arange(1, n_quantiles + 1) / n_quantiles
        self.quantiles = np.full(n_quantiles, np.nan)
        self.attainable: Optional[float] = None
        # the exact attainable tail — EW of the LAST arrival's offset —
        # so the policy can aim at "everyone who actually comes" even
        # when that fraction falls between grid points
        self.tail_wait: Optional[float] = None
        # EW round-over-round curve disagreement (None until two rounds
        # have reached at least one common fraction)
        self.drift: Optional[float] = None
        self.ema = ema
        self.rounds = 0

    def observe(self, offsets: Sequence[float], expected: int) -> None:
        arr = np.sort(np.asarray(list(offsets), np.float64))
        expected = max(int(expected), len(arr), 1)
        fresh = np.full_like(self.quantiles, np.nan)
        for k, f in enumerate(self.fracs):
            need = max(int(math.ceil(f * expected)), 1)
            if need <= len(arr):
                fresh[k] = max(arr[need - 1], 0.0)
        a = self.ema
        # drift BEFORE blending: how far did this round land from the
        # curve we believed? Only fractions observed on both sides count
        # (censored tails are the attainable fraction's business, not
        # drift's — permanent drop-out must not read as endless drift).
        both = ~np.isnan(fresh) & ~np.isnan(self.quantiles)
        if both.any():
            rel = np.abs(fresh[both] - self.quantiles[both]) / np.maximum(
                np.abs(self.quantiles[both]), self._DRIFT_DENOM_FLOOR
            )
            shift = float(np.minimum(rel, 1.0).mean())
            self.drift = (
                shift if self.drift is None
                else (1 - a) * self.drift + a * shift
            )
        keep = np.isnan(fresh)
        seed = np.isnan(self.quantiles)
        blended = (1 - a) * self.quantiles + a * fresh
        self.quantiles = np.where(
            keep, self.quantiles, np.where(seed, fresh, blended)
        )
        arrived_frac = len(arr) / expected
        self.attainable = (
            arrived_frac if self.attainable is None
            else (1 - a) * self.attainable + a * arrived_frac
        )
        if len(arr):
            tail = max(float(arr[-1]), 0.0)
            self.tail_wait = (
                tail if self.tail_wait is None
                else (1 - a) * self.tail_wait + a * tail
            )
        self.rounds += 1

    def wait_for(self, frac: float) -> float:
        """Learned seconds from round start until ``frac`` of the fleet
        has arrived; ``inf`` for fractions the curve has never seen."""
        finite = ~np.isnan(self.quantiles)
        if not finite.any() or frac > self.fracs[finite].max():
            return math.inf
        return float(
            np.interp(frac, self.fracs[finite], self.quantiles[finite])
        )

    # -- restart persistence -------------------------------------------------
    def state_dict(self) -> Dict:
        return {
            "fracs": self.fracs.tolist(),
            "quantiles": [
                None if np.isnan(q) else float(q) for q in self.quantiles
            ],
            "attainable": self.attainable,
            "tail_wait": self.tail_wait,
            "drift": self.drift,
            "ema": self.ema,
            "rounds": self.rounds,
        }

    @classmethod
    def from_state_dict(cls, state: Dict) -> "ArrivalModel":
        m = cls(n_quantiles=len(state["fracs"]), ema=state["ema"])
        m.fracs = np.asarray(state["fracs"], np.float64)
        m.quantiles = np.asarray(
            [np.nan if q is None else q for q in state["quantiles"]],
            np.float64,
        )
        m.attainable = state["attainable"]
        m.tail_wait = state.get("tail_wait")
        m.drift = state.get("drift")
        m.rounds = int(state["rounds"])
        return m


class AdaptiveController:
    """Per-tenant round-close policy learner (Algorithm 1, made
    adaptive).

    Lifecycle per round, per tenant::

        pol = controller.policy(tenant, expected)   # before the monitor
        ... run the round with pol as the gate ...
        controller.observe_round(tenant, offsets, expected,
                                 est_seconds=report.fuse_seconds)

    ``policy`` selects the curve to derive the gate from:

      * the tenant's OWN model once it has ``warmup_rounds``
        observations (``source="learned"``);
      * else the cross-tenant PRIOR — every observed round of every
        tenant also folds into one pooled curve, so a cold-start tenant
        borrows the fleet-wide arrival behavior instead of burning
        static timeouts while its own curve warms up
        (``source="prior"``);
      * else the STATIC gate (``threshold_frac`` / ``timeout``, exactly
        the non-adaptive service's gate; also the fallback whenever a
        curve yields no finite candidate).

    The selected curve is minimized against
    ``Planner.round_objective(wait, inclusion, cost_bias)`` over its
    fraction grid and emitted as a learned threshold/deadline. The
    deadline is ``deadline_slack * t(f*) * widen + deadline_margin``
    capped at the static ``timeout`` — the controller can only ever
    close EARLIER than the static gate's worst case, never later —
    where ``widen >= 1`` grows with the model's drift score
    (``1 + drift_gain * max(drift - drift_tolerance, 0)``): while
    arrival behavior is shifting faster than the EW window tracks, the
    deadline backstop loosens toward the static timeout instead of
    cutting off a fleet the stale curve mispredicts.

    ``est_seconds`` (the tenant's observed fuse wall) enters the
    objective through ``max(wait, est)``: waiting for stragglers is free
    while the engine is still folding the updates already present.
    """

    def __init__(
        self,
        cost_bias: float = 0.5,
        threshold_frac: float = 0.8,
        timeout: float = 30.0,
        planner: Optional[Planner] = None,
        ema: float = 0.5,
        n_quantiles: int = 20,
        warmup_rounds: int = 1,
        deadline_slack: float = 1.25,
        deadline_margin: float = 0.25,
        drift_tolerance: float = 0.25,
        drift_gain: float = 4.0,
        rewarm_drift: float = 0.75,
        rewarm_patience: int = 3,
    ):
        if not 0 <= cost_bias <= 1:
            raise ValueError("cost_bias must be in [0, 1]")
        self.cost_bias = cost_bias
        self.threshold_frac = threshold_frac
        self.timeout = timeout
        self.planner = planner or Planner()
        self.ema = ema
        self.n_quantiles = n_quantiles
        self.warmup_rounds = warmup_rounds
        self.deadline_slack = deadline_slack
        self.deadline_margin = deadline_margin
        # drift below the tolerance is steady-state jitter; above it the
        # deadline widens by drift_gain per unit of excess drift
        self.drift_tolerance = drift_tolerance
        self.drift_gain = drift_gain
        # re-warmup: drift at or above rewarm_drift for rewarm_patience
        # CONSECUTIVE rounds means the EW curve is chasing a regime it
        # cannot catch — widening the deadline forever is strictly worse
        # than re-learning, so the next policy() forces ONE static-gated
        # round (source="rewarm") and resets the tenant's curve
        self.rewarm_drift = rewarm_drift
        self.rewarm_patience = max(int(rewarm_patience), 1)
        self._models: Dict[str, ArrivalModel] = {}  # guarded-by: _lock
        self._est_seconds: Dict[str, float] = {}  # guarded-by: _lock
        self._drift_sat: Dict[str, int] = {}  # guarded-by: _lock -- consecutive saturated rounds
        self._rewarm_pending: set = set()  # guarded-by: _lock
        # tenants re-learning after a rewarm reset: they skip the prior
        # borrow (it may carry the stale regime they just abandoned)
        # until their fresh curve reaches warmup
        self._rewarmed: set = set()  # guarded-by: _lock
        # the cross-tenant prior: every tenant's rounds pool here, and
        # tenants without their own mass borrow it (cold-start transfer)
        self._prior = ArrivalModel(n_quantiles=n_quantiles, ema=ema)  # guarded-by: _lock
        self._prior_est: Optional[float] = None  # guarded-by: _lock
        # one controller serves every tenant's concurrent rounds: model
        # mutation (numpy EW blends) and policy derivation are not
        # atomic, so all public entry points serialize here. RLock —
        # policy() consults state_dict-free internals re-entrantly.
        self._lock = threading.RLock()

    # -- learning ------------------------------------------------------------
    def observe_round(
        self,
        tenant: str,
        offsets: Sequence[float],
        expected: int,
        est_seconds: Optional[float] = None,
    ) -> None:
        """Fold one closed round's arrival offsets (seconds from round
        start per landed client) into the tenant's curve AND the
        cross-tenant prior (the pooled curve cold-start tenants
        borrow). An EMPTY round is evidence for the tenant's own curve
        (its attainable fraction decays) but is kept OUT of the prior:
        one dead tenant's fleet must not drag every cold-start tenant's
        borrowed threshold toward zero."""
        offsets = list(offsets)
        with self._lock:
            model = self._models.get(tenant)
            if model is None:
                model = self._models[tenant] = ArrivalModel(
                    n_quantiles=self.n_quantiles, ema=self.ema
                )
            model.observe(offsets, expected)
            # drift-saturation bookkeeping for the re-warmup trigger
            if model.drift is not None and \
                    model.drift >= self.rewarm_drift:
                sat = self._drift_sat.get(tenant, 0) + 1
                self._drift_sat[tenant] = sat
                if sat >= self.rewarm_patience:
                    self._rewarm_pending.add(tenant)
                    self._drift_sat[tenant] = 0
            else:
                self._drift_sat[tenant] = 0
            if offsets:
                self._prior.observe(offsets, expected)
            if est_seconds is not None:
                prev = self._est_seconds.get(tenant)
                self._est_seconds[tenant] = (
                    est_seconds if prev is None
                    else (1 - self.ema) * prev + self.ema * est_seconds
                )
                self._prior_est = (
                    est_seconds if self._prior_est is None
                    else (1 - self.ema) * self._prior_est
                    + self.ema * est_seconds
                )

    def model(self, tenant: str) -> Optional[ArrivalModel]:
        """The tenant's own arrival curve (None before its first
        observed round)."""
        with self._lock:
            return self._models.get(tenant)

    def prior_model(self) -> ArrivalModel:
        """The cross-tenant prior curve (pooled over every tenant's
        observed rounds)."""
        with self._lock:
            return self._prior

    # -- policy --------------------------------------------------------------
    def static_policy(self, expected: int) -> ClosePolicy:
        """The configured static gate for an ``expected``-client round —
        what ``policy`` falls back to before any curve has mass."""
        return ClosePolicy(
            threshold=max(int(expected * self.threshold_frac), 1),
            deadline=self.timeout,
            threshold_frac=self.threshold_frac,
            expected_wait=self.timeout,
            source="static",
        )

    def policy(self, tenant: str, expected: int) -> ClosePolicy:
        """The gate for the tenant's next round: its own learned curve
        once warmed up, the cross-tenant prior while cold, the static
        gate before anything has mass — and, after the tenant's drift
        stayed saturated for ``rewarm_patience`` consecutive rounds,
        ONE forced static round (``source="rewarm"``) with the EW curve
        reset, so the tenant re-learns the new regime instead of
        widening a stale deadline forever."""
        if expected <= 0:
            return self.static_policy(1)
        with self._lock:
            if tenant in self._rewarm_pending:
                self._rewarm_pending.discard(tenant)
                # reset the EW curve: the saturated drift said it no
                # longer describes the fleet. The static round observed
                # next seeds the fresh model (cold-start borrows are
                # skipped on purpose — the prior may carry the same
                # stale regime this tenant just abandoned).
                self._models[tenant] = ArrivalModel(
                    n_quantiles=self.n_quantiles, ema=self.ema
                )
                self._drift_sat[tenant] = 0
                self._rewarmed.add(tenant)
                pol = self.static_policy(expected)
                return dataclasses.replace(pol, source="rewarm")
            model = self._models.get(tenant)
            if model is not None and model.rounds >= self.warmup_rounds:
                self._rewarmed.discard(tenant)
                return self._derive(
                    model, expected, self._est_seconds.get(tenant, 0.0),
                    source="learned",
                )
            if self._prior.rounds >= self.warmup_rounds and \
                    tenant not in self._rewarmed:
                return self._derive(
                    self._prior, expected,
                    self._est_seconds.get(tenant, self._prior_est or 0.0),
                    source="prior",
                )
            return self.static_policy(expected)

    def _derive(
        self, model: ArrivalModel, expected: int, est: float, source: str
    ) -> ClosePolicy:
        """Minimize the planner objective over ``model``'s curve and
        emit the close gate (threshold count + drift-widened deadline
        backstop, capped at the static timeout)."""
        attainable = model.attainable if model.attainable is not None \
            else 1.0
        candidates = []
        for f in model.fracs:
            # a small margin keeps a fraction reachable through EW noise
            if f > min(attainable * 1.02, 1.0):
                break
            wait = model.wait_for(float(f))
            if not math.isfinite(wait):
                break
            candidates.append((float(f), wait))
        if model.tail_wait is not None:
            # the exact attainable fleet ("everyone who actually comes")
            # — the grid rounds this fraction away, so offer it directly
            candidates.append(
                (min(attainable, 1.0), float(model.tail_wait))
            )
        # ascending f, so the <= tie-break below resolves toward the
        # HIGHER-inclusion candidate (the tail candidate can fall
        # between grid points)
        candidates.sort()
        best_f, best_wait, best_j = None, None, math.inf
        for f, wait in candidates:
            j = self.planner.round_objective(
                expected_wait=wait,
                inclusion=f,
                cost_bias=self.cost_bias,
                horizon=self.timeout,
                est_seconds=est,
            )
            # <= so ties resolve toward higher inclusion
            if j <= best_j:
                best_f, best_wait, best_j = f, wait, j
        if best_f is None:
            return self.static_policy(expected)
        # slack + a fixed margin: the threshold closes the common path,
        # the deadline is a jitter-tolerant backstop — widened while the
        # curve is drifting, never past the static timeout
        widen = 1.0 + self.drift_gain * max(
            (model.drift or 0.0) - self.drift_tolerance, 0.0
        )
        deadline = min(
            self.deadline_slack * best_wait * widen + self.deadline_margin,
            self.timeout,
        )
        return ClosePolicy(
            threshold=max(int(math.ceil(best_f * expected)), 1),
            deadline=deadline,
            threshold_frac=best_f,
            expected_wait=best_wait,
            source=source,
        )

    # -- restart persistence -------------------------------------------------
    def state_dict(self) -> Dict:
        """JSON-able controller state (per-tenant curves, the
        cross-tenant prior, and fuse-wall estimates) so an aggregator
        restart resumes learned, not cold.
        ``repro_torch.checkpoint.save_controller_state`` persists this next to
        model checkpoints; ``AggregationService.save_controller`` /
        ``load_controller`` are the service-level hooks."""
        with self._lock:
            return {
                "models": {
                    t: m.state_dict() for t, m in self._models.items()
                },
                "est_seconds": dict(self._est_seconds),
                "prior": self._prior.state_dict(),
                "prior_est": self._prior_est,
                "drift_sat": dict(self._drift_sat),
                "rewarm_pending": sorted(self._rewarm_pending),
                "rewarmed": sorted(self._rewarmed),
            }

    def load_state_dict(self, state: Dict) -> None:
        """Restore ``state_dict`` output (older checkpoints without a
        prior or re-warmup section restore those parts fresh)."""
        with self._lock:
            self._models = {
                t: ArrivalModel.from_state_dict(s)
                for t, s in state.get("models", {}).items()
            }
            self._est_seconds = dict(state.get("est_seconds", {}))
            prior = state.get("prior")
            self._prior = (
                ArrivalModel.from_state_dict(prior) if prior
                else ArrivalModel(
                    n_quantiles=self.n_quantiles, ema=self.ema
                )
            )
            self._prior_est = state.get("prior_est")
            self._drift_sat = dict(state.get("drift_sat", {}))
            self._rewarm_pending = set(state.get("rewarm_pending", []))
            self._rewarmed = set(state.get("rewarmed", []))

    def tenants(self) -> List[str]:
        """Tenants with at least one observed round."""
        with self._lock:
            return sorted(self._models)

    def snapshot(self, tenant: str) -> Dict:
        """One consistent trajectory row (soak benches, monitoring):
        the tenant's curve state under a single lock hold — reading
        ``model(t).drift`` / rewarm flags piecemeal can interleave
        with a concurrent ``observe_round``."""
        with self._lock:
            m = self._models.get(tenant)
            return {
                "tenant": tenant,
                "rounds": 0 if m is None else m.rounds,
                "drift": None if m is None else m.drift,
                "attainable": None if m is None else m.attainable,
                "tail_wait": None if m is None else m.tail_wait,
                "est_seconds": self._est_seconds.get(tenant),
                "drift_saturated": self._drift_sat.get(tenant, 0),
                "rewarm_pending": tenant in self._rewarm_pending,
                "rewarmed": tenant in self._rewarmed,
                "prior_rounds": self._prior.rounds,
            }
