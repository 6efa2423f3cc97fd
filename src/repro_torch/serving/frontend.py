"""Threaded HTTP ingest front-end over the ``UpdateStore``.

``IngestServer`` binds a stdlib ``ThreadingHTTPServer`` (no new deps)
and serves:

  * ``POST /v1/upload``    — one wire frame
                             (``repro_torch.serving.protocol``) per
                             request; replies 200 JSON only after
                             the update is durably committed through
                             the batching :class:`IngestQueue`.
  * ``GET  /v1/healthz``   — liveness + queue depth + counters.
  * ``GET  /v1/stats``     — ``StoreStats`` snapshot (``?tenant=``).

Handler threads only authenticate, gate, read and parse — commits are
coalesced by the queue's single committer, so hundreds of concurrent
clients cost hundreds of (cheap, mostly-blocked) reader threads but
only ONE writer into the store's registration lock.

Error surface (all JSON bodies, all fail closed — nothing lands):

  401 bad/missing token            408 read timed out (slow-loris)
  400 malformed frame              411 missing Content-Length
  413 body over the upload cap     429 rate limit / quota, Retry-After
  503 ingest queue full, Retry-After
"""
from __future__ import annotations

import json
import socket
import sys
import threading
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from repro_torch.core.store import QuotaExceededError
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.ingest import BackpressureError, IngestQueue
from repro_torch.serving.protocol import WireError, parse_update


class _Httpd(ThreadingHTTPServer):
    daemon_threads = True
    # the stdlib default backlog of 5 makes hundreds of clients
    # connecting at once retransmit SYNs (a ~1s latency cliff)
    request_queue_size = 128
    # one IngestServer per httpd, attached after construction
    ingest: "IngestServer"

    def handle_error(self, request, client_address) -> None:
        # torn connections (mid-request RST, keep-alive races) are a
        # counted workload condition, not a stack trace
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, socket.timeout,
                            TimeoutError, BrokenPipeError)):
            self.ingest.count("disconnect")
            return
        super().handle_error(request, client_address)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: _Httpd

    def setup(self) -> None:
        # slow-loris guard: BaseHTTPRequestHandler applies self.timeout
        # to the connection socket, so a stalled body read raises
        # socket.timeout instead of pinning the handler thread forever
        self.timeout = self.server.ingest.read_timeout
        super().setup()

    def log_message(self, fmt, *args) -> None:   # quiet by default
        pass

    # -- plumbing ------------------------------------------------------------
    def _send(self, status: int, payload: dict,
              retry_after: Optional[float] = None,
              close: bool = False) -> None:
        body = json.dumps(payload).encode("utf-8")
        try:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After", f"{retry_after:.3f}")
            if close:
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            # client went away while we replied — nothing to salvage
            self.close_connection = True

    def _token(self) -> Optional[str]:
        auth = self.headers.get("Authorization", "")
        if auth.startswith("Bearer "):
            return auth[len("Bearer "):].strip()
        return self.headers.get("X-Tenant-Token")

    def _read_exact(self, n: int) -> Optional[bytes]:
        """Read exactly ``n`` body bytes. None = client disconnected
        (EOF short of Content-Length); socket.timeout propagates."""
        chunks = []
        remaining = n
        while remaining > 0:
            chunk = self.rfile.read(remaining)
            if not chunk:
                return None
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    # -- routes --------------------------------------------------------------
    def do_POST(self) -> None:
        ing = self.server.ingest
        if self.path != "/v1/upload":
            self._send(404, {"error": f"no such route {self.path}"},
                       close=True)
            return
        tenant = ing.admission.tenant_for(self._token())
        if tenant is None:
            ing.count("unauthorized")
            self._send(401, {"error": "unknown or missing tenant "
                                      "token"}, close=True)
            return
        try:
            length = int(self.headers.get("Content-Length", ""))
        except ValueError:
            length = -1
        if length < 0:
            ing.count("bad_length")
            self._send(411, {"error": "Content-Length required"},
                       close=True)
            return
        decision = ing.admission.admit(tenant, length)
        if not decision.admitted:
            ing.count("shed_429" if decision.status == 429
                      else "shed_413")
            # the body was never read — drop the connection rather
            # than desync keep-alive framing on the unread bytes
            self._send(decision.status, {"error": decision.reason},
                       retry_after=decision.retry_after, close=True)
            return
        try:
            body = self._read_exact(length)
        except (socket.timeout, TimeoutError):
            ing.count("read_timeout")
            self._send(408, {"error": f"body read exceeded "
                                      f"{ing.read_timeout}s"},
                       close=True)
            return
        except (ConnectionError, OSError):
            # hard mid-upload disconnect (RST): nothing landed
            ing.count("disconnect")
            self.close_connection = True
            return
        if body is None:
            # mid-upload disconnect: nothing to reply to, nothing lands
            ing.count("disconnect")
            self.close_connection = True
            return
        try:
            parsed = parse_update(body)
        except WireError as e:
            ing.count("malformed")
            self._send(400, {"error": str(e)})
            return
        try:
            fut = ing.queue.submit(parsed.client_id, parsed.update,
                                   weight=parsed.weight, tenant=tenant)
        except BackpressureError as e:
            ing.count("backpressure")
            self._send(503, {"error": str(e)},
                       retry_after=e.retry_after, close=True)
            return
        try:
            latency = fut.result(timeout=ing.commit_timeout)
        except QuotaExceededError as e:
            ing.count("quota_reject")
            self._send(429, {"error": str(e)},
                       retry_after=ing.admission.quota_retry_after)
            return
        except FutureTimeout:
            ing.count("commit_timeout")
            self._send(504, {"error": "commit timed out"}, close=True)
            return
        except (WireError, ValueError) as e:
            ing.count("malformed")
            self._send(400, {"error": str(e)})
            return
        ing.count("accepted")
        self._send(200, {
            "status": "ok", "tenant": tenant,
            "client_id": parsed.client_id,
            "sim_write_seconds": latency,
        })

    def do_GET(self) -> None:
        ing = self.server.ingest
        url = urlparse(self.path)
        if url.path == "/v1/healthz":
            self._send(200, {
                "status": "ok",
                "queue_depth": ing.queue.depth(),
                "metrics": ing.metrics(),
            })
            return
        if url.path == "/v1/stats":
            qs = parse_qs(url.query)
            tenant = qs.get("tenant", [None])[0]
            st = ing.store.stats_for(tenant)
            self._send(200, {
                "tenant": tenant, "writes": st.writes,
                "bytes_written": st.bytes_written,
                "reads": st.reads, "bytes_read": st.bytes_read,
                "evictions": st.evictions,
            })
            return
        self._send(404, {"error": f"no such route {url.path}"},
                   close=True)


class IngestServer:
    """The network ingest front-end: bind, serve, account, shut down.

    ``tokens`` maps bearer token -> tenant (the auth table). Admission
    and queue knobs pass through to :class:`AdmissionController` /
    :class:`IngestQueue`; pre-built instances can be injected for
    tests. Serving starts on construction; ``close()`` (or the context
    manager) drains the queue and releases the port."""

    def __init__(
        self,
        store,
        tokens: Dict[str, str],
        host: str = "127.0.0.1",
        port: int = 0,
        admission: Optional[AdmissionController] = None,
        ingest_queue: Optional[IngestQueue] = None,
        rate: Optional[float] = None,
        burst: Optional[float] = None,
        per_tenant_rates: Optional[Dict[str, Tuple[float, float]]] = None,
        max_body_bytes: int = 64 << 20,
        read_timeout: float = 5.0,
        commit_timeout: float = 30.0,
        queue_size: int = 256,
        batch_max: int = 32,
    ):
        self.store = store
        self.read_timeout = float(read_timeout)
        self.commit_timeout = float(commit_timeout)
        self.admission = admission or AdmissionController(
            tokens, store=store, rate=rate, burst=burst,
            per_tenant_rates=per_tenant_rates,
            max_body_bytes=max_body_bytes,
        )
        self.queue = ingest_queue or IngestQueue(
            store, maxsize=queue_size, batch_max=batch_max
        )
        self._counters: Dict[str, int] = {}  # guarded-by: _clock_lock
        self._clock_lock = threading.Lock()
        self._httpd = _Httpd((host, port), _Handler)
        self._httpd.ingest = self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name=f"ingest-frontend:{self.port}", daemon=True,
        )
        self._thread.start()
        self._closed = False

    # -- accounting ----------------------------------------------------------
    def count(self, name: str) -> None:
        with self._clock_lock:
            self._counters[name] = self._counters.get(name, 0) + 1

    def metrics(self) -> dict:
        with self._clock_lock:
            out = dict(self._counters)
        out.update(self.queue.stats())
        return out

    # -- lifecycle -----------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._thread.join(timeout=10.0)
        self._httpd.server_close()
        self.queue.close()

    def __enter__(self) -> "IngestServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
