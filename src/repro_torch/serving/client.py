"""HTTP upload client — ``store.write`` over the wire.

``HttpStoreClient.write`` has the same signature as
``UpdateStore.write`` (client_id, update, weight, tenant), so a trace
replay or benchmark writer swaps transports by passing
``writer=client.write`` — everything downstream (payloads, weights,
rounds) is unchanged, which is what makes socket-vs-in-process
bit-identity a testable claim.

Retries honor the server's Retry-After on 429 (rate/quota) and 503
(backpressure), and reconnect on transport errors; any other non-200
raises :class:`IngestError`. NOT thread-safe — one client per writer
thread (each holds one keep-alive connection)."""
from __future__ import annotations

import http.client
import json
import time
from typing import Callable, Dict, Optional

from repro_torch.core.store import DEFAULT_TENANT
from repro_torch.serving.protocol import encode_update


class IngestError(RuntimeError):
    """A non-retryable upload failure (or retries exhausted)."""

    def __init__(self, msg: str, status: Optional[int] = None):
        super().__init__(msg)
        self.status = status


class HttpStoreClient:
    """One tenant-authenticated uploader over a keep-alive connection.

    ``tokens`` maps tenant -> bearer token (a plain ``token=`` works
    for single-tenant writers)."""

    def __init__(
        self,
        host: str,
        port: int,
        token: Optional[str] = None,
        tokens: Optional[Dict[str, str]] = None,
        timeout: float = 10.0,
        max_attempts: int = 8,
        retry_wait_cap: float = 2.0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.host = host
        self.port = int(port)
        self._tokens = dict(tokens or {})
        self._token = token
        self.timeout = float(timeout)
        self.max_attempts = int(max_attempts)
        self.retry_wait_cap = float(retry_wait_cap)
        self._sleep = sleep
        self._conn: Optional[http.client.HTTPConnection] = None

    def _token_for(self, tenant: str) -> str:
        tok = self._tokens.get(tenant, self._token)
        if tok is None:
            raise IngestError(f"no token configured for tenant "
                              f"{tenant!r}")
        return tok

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
        return self._conn

    def _drop_connection(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def write(self, client_id: str, update, weight: float = 1.0,
              tenant: str = DEFAULT_TENANT) -> float:
        """Upload one update; returns the server-modeled write latency
        (the same float ``store.write`` returns)."""
        body = encode_update(client_id, update, weight=weight)
        headers = {
            "Authorization": f"Bearer {self._token_for(tenant)}",
            "Content-Type": "application/octet-stream",
        }
        last = "no attempt made"
        for _ in range(self.max_attempts):
            conn = self._connection()
            try:
                conn.request("POST", "/v1/upload", body=body,
                             headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException) as e:
                self._drop_connection()
                last = f"transport error: {e}"
                continue
            if resp.getheader("Connection", "") == "close":
                self._drop_connection()
            if resp.status == 200:
                return float(
                    json.loads(data).get("sim_write_seconds", 0.0)
                )
            if resp.status in (429, 503):
                wait = float(resp.getheader("Retry-After", "0.05"))
                self._sleep(min(max(wait, 0.0), self.retry_wait_cap))
                last = f"{resp.status}: {data[:200]!r}"
                continue
            raise IngestError(
                f"upload rejected ({resp.status}): {data[:500]!r}",
                status=resp.status,
            )
        raise IngestError(
            f"upload failed after {self.max_attempts} attempts "
            f"(last: {last})"
        )

    def close(self) -> None:
        self._drop_connection()

    def __enter__(self) -> "HttpStoreClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
