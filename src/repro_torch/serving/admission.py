"""Admission control for the ingest front-end.

Every upload passes four gates, cheapest first, BEFORE its body is
read off the socket:

  1. auth        — the bearer token must map to a tenant (401);
  2. size        — Content-Length within ``max_body_bytes`` (413);
  3. rate        — the tenant's token bucket has a token (429 +
                   Retry-After with the exact refill wait);
  4. quota       — the tenant's :class:`~repro_torch.core.TenantQuota` has
                   headroom for the declared bytes (429 + Retry-After).

The quota gate here is a conservative PRE-check against the declared
Content-Length (an upper bound on stored payload bytes): it sheds
over-budget uploads before they consume socket reads and queue slots.
The store's own quota check at commit time stays authoritative — a
reject there (e.g. a replacement write racing an eviction) surfaces as
the same 429, and in neither case does a rejected upload land a blob.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Tuple


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``
    capacity. Thread-safe; ``try_acquire`` never blocks — on refusal it
    returns the exact wait until a token exists (the Retry-After)."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError(
                f"rate and burst must be > 0, got rate={rate} "
                f"burst={burst}"
            )
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)  # guarded-by: _lock
        self._last = clock()  # guarded-by: _lock
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> Tuple[bool, float]:
        """``(granted, retry_after_seconds)`` — retry_after is 0.0 when
        granted."""
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            return False, (n - self._tokens) / self.rate


@dataclasses.dataclass(frozen=True)
class Decision:
    """One admission verdict, carrying its HTTP shape."""

    admitted: bool
    status: int = 200
    reason: str = ""
    retry_after: Optional[float] = None


class AdmissionController:
    """Token → tenant auth plus the size / rate / quota gates.

    ``tokens`` maps bearer token → tenant name. ``rate``/``burst``
    install one token bucket per authenticated tenant (None disables
    rate limiting); ``per_tenant_rates`` overrides ``(rate, burst)``
    for specific tenants. ``store`` (optional) enables the quota
    headroom pre-check against ``store.quota(tenant)``."""

    #: Retry-After when the quota (not the rate limiter) rejects: the
    #: wait is bounded by round cadence, not a refill rate, so a fixed
    #: hint is the honest answer.
    quota_retry_after = 1.0

    def __init__(
        self,
        tokens: Dict[str, str],
        store=None,
        rate: Optional[float] = None,
        burst: Optional[float] = None,
        per_tenant_rates: Optional[Dict[str, Tuple[float, float]]] = None,
        max_body_bytes: int = 64 << 20,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._tokens = dict(tokens)
        self._store = store
        self._clock = clock
        self.max_body_bytes = int(max_body_bytes)
        self._buckets: Dict[str, TokenBucket] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._default_rate: Optional[Tuple[float, float]] = None
        if rate is not None:
            self._default_rate = (float(rate), float(burst or rate))
        self._per_tenant_rates = dict(per_tenant_rates or {})

    def tenant_for(self, token: Optional[str]) -> Optional[str]:
        """The tenant a bearer token authenticates, or None (401)."""
        if not token:
            return None
        return self._tokens.get(token)

    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        cfg = self._per_tenant_rates.get(tenant, self._default_rate)
        if cfg is None:
            return None
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = TokenBucket(
                    cfg[0], cfg[1], clock=self._clock
                )
            return b

    def admit(self, tenant: str, content_length: int) -> Decision:
        """Gate one authenticated upload of ``content_length`` declared
        body bytes."""
        if content_length > self.max_body_bytes:
            return Decision(
                admitted=False, status=413,
                reason=f"body of {content_length} B exceeds the "
                       f"{self.max_body_bytes} B upload cap",
            )
        bucket = self._bucket(tenant)
        if bucket is not None:
            ok, wait = bucket.try_acquire()
            if not ok:
                return Decision(
                    admitted=False, status=429,
                    reason=f"tenant {tenant!r} over its upload rate",
                    retry_after=wait,
                )
        if self._store is not None:
            q = self._store.quota(tenant)
            # evict-policy tenants trade old updates for new ones at
            # the store — only reject-policy quotas shed at the door
            if q is not None and q.policy == "reject":
                count = self._store.count(tenant=tenant)
                tbytes = self._store.tenant_bytes(tenant)
                over_count = (q.max_updates is not None
                              and count + 1 > q.max_updates)
                over_bytes = (q.max_bytes is not None
                              and tbytes + content_length > q.max_bytes)
                if over_count or over_bytes:
                    return Decision(
                        admitted=False, status=429,
                        reason=f"tenant {tenant!r} quota has no "
                               f"headroom for {content_length} B",
                        retry_after=self.quota_retry_after,
                    )
        return Decision(admitted=True)
