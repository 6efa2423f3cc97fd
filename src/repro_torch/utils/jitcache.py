"""Shape-bucketed caches of built fold steps, persistent across rounds.

PyTorch runs eagerly, so nothing is traced or compiled per shape. What
the port keeps from ``repro.utils.jitcache`` is the bookkeeping the
service and planner read: a step callable is built once per key (the
keys of ``repro.core.local``: fusion, strategy, row bucket or chunk,
P, dtype, carry signature), the first kernel step of a process also
builds and loads the CUDA library, and the build time is reported as
the round's compile phase — ``0.0`` on warm rounds. ``trace_count()``
counts builds.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Hashable, Tuple

_BUILD_LOCK = threading.Lock()
_BUILD_COUNT = 0   # guarded-by: _BUILD_LOCK


def note_trace() -> None:
    """Count one step build."""
    global _BUILD_COUNT
    with _BUILD_LOCK:
        _BUILD_COUNT += 1


def trace_count() -> int:
    """Step builds so far in this process (flat across warm rounds)."""
    with _BUILD_LOCK:
        return _BUILD_COUNT


def round_up_pow2(n: int, floor: int = 1) -> int:
    n = max(int(n), int(floor))
    return 1 << (n - 1).bit_length()


def bucket_rows(n: int, floor: int = 8) -> int:
    """Client-count bucket: next power of two, with a small floor so tiny
    rounds (1..8 clients) all land in one bucket."""
    return round_up_pow2(n, floor)


def fusion_cache_key(fusion) -> Hashable:
    """Stable cache key for a fusion instance: name + hyperparameters.
    (Server state such as FedAvgM's velocity lives in ``_``-prefixed
    attributes, not dataclass fields, so it never enters the key.)"""
    if dataclasses.is_dataclass(fusion):
        fields = tuple(
            (f.name, getattr(fusion, f.name))
            for f in dataclasses.fields(fusion)
        )
        return (fusion.name, fields)
    return (fusion.name,)


class CompiledCache:
    """key -> built step callable, with hit/miss and build-time stats.

    Single-flight per key: threads racing the same key wait for the one
    build in flight and share it as a hit, so ``misses`` counts builds
    actually paid. Builds for different keys run concurrently (outside
    the cache lock). A failed build releases its slot to a waiter."""

    def __init__(self, name: str = "cache"):
        self.name = name
        self._entries: Dict[Hashable, Callable] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._building: Dict[Hashable, threading.Event] = {}  # guarded-by: _lock
        self.hits = 0               # guarded-by: _lock
        self.misses = 0             # guarded-by: _lock
        self.compile_seconds = 0.0  # guarded-by: _lock

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def get(self, key: Hashable,
            build: Callable[[], Callable]) -> Tuple[Callable, float]:
        """``(step, build_seconds_spent_now)``; the seconds are 0.0 on a
        hit, so callers can report a compile phase."""
        done = self._claim(key)
        if done is not None:
            return done
        try:
            t0 = time.perf_counter()
            fn = build()
            dt = time.perf_counter() - t0
            note_trace()
            with self._lock:
                self._entries[key] = fn
                self.misses += 1
                self.compile_seconds += dt
        finally:
            self._release(key)
        return fn, dt

    def _claim(self, key: Hashable):
        """The cached ``(fn, 0.0)`` on a hit; otherwise claim the key's
        build slot and return None (the caller builds, then releases)."""
        while True:
            with self._lock:
                fn = self._entries.get(key)
                if fn is not None:
                    self.hits += 1
                    return fn, 0.0
                ev = self._building.get(key)
                if ev is None:
                    self._building[key] = threading.Event()
                    return None
            ev.wait()

    def _release(self, key: Hashable) -> None:
        with self._lock:
            ev = self._building.pop(key, None)
        if ev is not None:
            ev.set()
