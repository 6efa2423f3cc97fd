"""Replay — drive a trace's tenant-round against a live ``UpdateStore``.

``replay_round`` writes each traced client at its offset on an
injectable clock: real ``time.perf_counter``/``time.sleep`` in
benchmarks (``start_writer`` wraps it in a daemon thread, the
``spread_writer`` idiom), or a test's scripted clock for fully
deterministic arrival timestamps. Payloads are deterministic in
``(seed, tenant, client_id, dim)`` via ``trace_payload``, so a replay
is reproducible end to end — the fused vector included.
"""
from __future__ import annotations

import threading
import time
import zlib
from functools import lru_cache
from typing import Callable, Optional

import numpy as np

from repro_torch.workload.trace import PAYLOAD_STREAM, TenantRound


@lru_cache(maxsize=1024)
def _payload_cached(seed: int, tenant: str, client_id: str,
                    dim: int) -> np.ndarray:
    rng = np.random.default_rng([
        seed, PAYLOAD_STREAM,
        zlib.crc32(tenant.encode()), zlib.crc32(client_id.encode()),
    ])
    arr = rng.normal(size=(dim,)).astype(np.float32)
    arr.flags.writeable = False
    return arr


def trace_payload(seed: int, tenant: str, client_id: str,
                  dim: int) -> np.ndarray:
    """The deterministic fp32 update a traced client writes.

    Round-independent by design — a client re-sends the same update
    every round, like the fixed client matrices of the per-scenario
    benches — so payloads are cached (read-only) across rounds and
    synthesis is paid once per client, not once per round. The cache
    keeps up to 1024 rows of ``4 * dim`` host bytes: 4.7 GB at CNN4.6's
    width, 93 GB at Resnet50's."""
    return _payload_cached(seed, tenant, client_id, dim)


def replay_round(
    store,
    tenant_round: TenantRound,
    seed: int,
    clock: Callable[[], float] = time.perf_counter,
    sleep: Callable[[float], None] = time.sleep,
    transform: Optional[Callable[[str, np.ndarray], object]] = None,
    writer: Optional[Callable[..., float]] = None,
) -> int:
    """Write every traced event at its offset (measured on ``clock``,
    waited on ``sleep``). ``transform(client_id, update)`` hooks
    client-side processing — e.g. ``svc.compress_update`` for int8
    transport. Returns the number of writes.

    ``writer`` swaps the transport: it defaults to ``store.write`` but
    takes any callable with the same ``(client_id, update, weight=,
    tenant=)`` signature — an HTTP upload client's ``write``, say, to
    replay the SAME trace through an ingest front-end (then ``store``
    may be None).

    Payloads (and transforms) are materialized BEFORE the replay clock
    starts: the trace's offsets model network arrival times, and a
    client's update exists before it is sent — synthesis cost must not
    skew the arrival schedule or the measured round wall."""
    if writer is None:
        writer = store.write
    ready = []
    for ev in tenant_round.events:
        u = trace_payload(seed, tenant_round.tenant, ev.client_id,
                          tenant_round.dim)
        if transform is not None:
            u = transform(ev.client_id, u)
        ready.append((ev, u))
    t0 = clock()
    for ev, u in ready:
        lag = ev.offset - (clock() - t0)
        if lag > 0:
            sleep(lag)
        writer(ev.client_id, u, weight=ev.weight,
               tenant=tenant_round.tenant)
    return len(tenant_round.events)


def start_writer(
    store,
    tenant_round: TenantRound,
    seed: int,
    clock: Callable[[], float] = time.perf_counter,
    sleep: Callable[[float], None] = time.sleep,
    transform: Optional[Callable[[str, np.ndarray], object]] = None,
    writer: Optional[Callable[..., float]] = None,
) -> threading.Thread:
    """``replay_round`` on a started daemon thread — arrivals land
    WHILE the round is open (the benchmarks' writer idiom)."""
    t = threading.Thread(  # lint: disable=thread-join -- the handle is RETURNED; callers (benchmarks, soak harness) own the join
        target=replay_round,
        args=(store, tenant_round, seed),
        kwargs={"clock": clock, "sleep": sleep, "transform": transform,
                "writer": writer},
        name=f"trace-writer-{tenant_round.tenant}",
        daemon=True,
    )
    t.start()
    return t
