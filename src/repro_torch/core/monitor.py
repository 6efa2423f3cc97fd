"""Monitor — Algorithm 1's ``monitor(T_h, P)``: wait until a threshold
count of client updates has landed in the store, or a timeout elapses
(straggler control). The clock is injectable for deterministic tests.

``wait()`` is the serialized gate (block, then aggregate). The async
round mode instead threads ``should_close`` into
``UpdateStore.iter_arrivals`` so the SAME threshold/timeout policy
decides when an in-flight arrival stream closes — the aggregator folds
partial sums for the whole window the serialized path spends idle.

The gate is PLUGGABLE: pass ``policy`` (any ``(count, waited) -> bool``
predicate, e.g. a learned ``repro.core.adaptive.ClosePolicy``) to
replace the built-in static threshold/timeout test while keeping the
wait loop, injectable clock, and result reporting."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.core.store import UpdateStore


@dataclasses.dataclass
class MonitorResult:
    ready: bool           # threshold reached (False -> timed out)
    count: int            # updates present when the monitor returned
    waited: float         # seconds waited


class Monitor:
    """Round-close gate over an :class:`UpdateStore`.

    ``threshold`` / ``timeout`` define the static gate and the
    ``ready`` semantics of :class:`MonitorResult`; ``policy`` (optional)
    overrides the close predicate itself — the adaptive controller
    passes its learned :class:`~repro.core.adaptive.ClosePolicy` here
    with ``threshold`` / ``timeout`` mirroring the learned values so
    reporting stays truthful. ``tenant`` scopes the count to one store
    partition, so concurrent tenants' monitors never gate on each
    other's arrivals (``None``: whole spool, the single-tenant
    behavior). ``clock`` / ``sleep`` are injectable for deterministic
    tests.

    Concurrent-round note: each round owns its own Monitor instance
    (nothing here is shared), and N tenants' monitors may block in
    ``wait()`` simultaneously — the store's arrival condition is
    spool-global, so any tenant's write wakes every waiter, each
    re-checks its OWN tenant's O(1) count, and non-owners go back to
    sleep. Spurious wakes cost one counter read; arrivals are never
    missed."""

    def __init__(
        self,
        store: UpdateStore,
        threshold: int,
        timeout: float = 30.0,
        poll_interval: float = 0.01,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        policy: Optional[Callable[[int, float], bool]] = None,
        tenant: Optional[str] = None,
    ):
        self.store = store
        self.threshold = threshold
        self.timeout = timeout
        self.poll_interval = poll_interval
        self.clock = clock
        self.sleep = sleep
        self.policy = policy
        self.tenant = tenant

    def should_close(self, count: int, waited: float) -> bool:
        """The gate, as a pure predicate: True once the threshold is met
        OR the timeout has elapsed. Threshold wins when both land on the
        same poll (a round that fills exactly at the deadline is ready).
        With a pluggable ``policy`` installed, that predicate decides
        instead."""
        if self.policy is not None:
            return self.policy(count, waited)
        return count >= self.threshold or waited >= self.timeout

    def result(self, count: int, waited: float) -> MonitorResult:
        """Structured outcome for a gate that closed at (count, waited)."""
        return MonitorResult(
            ready=count >= self.threshold, count=count, waited=waited
        )

    def wait(self) -> MonitorResult:
        start = self.clock()
        while True:
            count = self.store.count(self.tenant)
            waited = self.clock() - start
            if self.should_close(count, waited):
                return self.result(count, waited)
            # event-driven under the real clock (woken by the store's
            # arrival condition); injected sleeps drive scripted time
            self.store.wait_for_arrival(self.poll_interval, self.sleep)
