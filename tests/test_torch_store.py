"""The port's UpdateStore copy against the JAX package's: the same
sequence of operations on both gives the same observable state (CPU).
Round-level parity lives in test_torch_service.py."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core import store as jstore
from repro_torch.core import store as tstore
from repro_torch.core.monitor import Monitor
from repro_torch.utils.dtypes import BF16

MODULES = {"repro": jstore, "repro_torch": tstore}


def _vec(seed, p=64):
    return np.random.default_rng(seed).normal(size=(p,)).astype(np.float32)


def _both(**kw):
    return {name: mod.UpdateStore(**kw) for name, mod in MODULES.items()}


def _state(store, tenants=("default", "a", "b")):
    out = {}
    for t in tenants:
        st = store.stats_for(t)
        out[t] = (store.count(t), store.client_ids(t), store.tenant_bytes(t),
                  dataclasses.astuple(st)[:2] + dataclasses.astuple(st)[3:])
    return out


@pytest.mark.parametrize("policy", ["reject", "evict"])
def test_quota_policies_match(policy):
    stores = _both()
    outcomes = {}
    for name, store in stores.items():
        store.set_quota("a", max_updates=3, policy=policy)
        res = []
        for i in range(5):
            try:
                store.write(f"c{i}", _vec(i), weight=float(i + 1), tenant="a")
                res.append("ok")
            except MODULES[name].QuotaExceededError:
                res.append("rejected")
        outcomes[name] = res
    assert outcomes["repro"] == outcomes["repro_torch"]
    assert _state(stores["repro"]) == _state(stores["repro_torch"])


def test_tenant_partitions_and_versioned_remove_match():
    stores = _both()
    for store in stores.values():
        for i in range(4):
            store.write(f"c{i}", _vec(i), weight=1.0 + i)
            store.write(f"c{i}", _vec(10 + i), weight=2.0, tenant="b")
        versions = {}
        list(store.iter_arrivals(2, lambda count, waited: count >= 4,
                                 versions_out=versions, tenant="b"))
        store.write("c1", _vec(99), weight=5.0, tenant="b")   # re-written
        store.remove(["c0", "c1"], versions=versions, tenant="b")
    assert _state(stores["repro"]) == _state(stores["repro_torch"])
    assert stores["repro_torch"].client_ids("b") == ["c1", "c2", "c3"]
    for name, store in stores.items():
        n, p, dt = store.meta("b")
        assert (n, p, dt) == (3, 64, np.float32), name


def test_write_batch_results_match():
    stores = _both()
    results = {}
    for name, store in stores.items():
        store.set_quota("a", max_updates=1)
        res = store.write_batch([
            ("x", _vec(1), 1.0, "a"), ("y", _vec(2), 1.0, "a"),
            ("z", _vec(3), 1.0, "../evil"), ("w", _vec(4), 2.0, "default"),
        ])
        results[name] = [type(r).__name__ if isinstance(r, BaseException)
                         else "ok" for r in res]
    assert results["repro"] == results["repro_torch"] == [
        "ok", "QuotaExceededError", "ValueError", "ok"]


def test_iter_chunks_blocks_match():
    stores = _both()
    for store in stores.values():
        for i in range(7):
            store.write(f"c{i}", _vec(i, p=33), weight=float(i))
    got = list(stores["repro_torch"].iter_chunks(3))
    want = list(stores["repro"].iter_chunks(3))
    assert [b.shape for b, _ in got] == [b.shape for b, _ in want]
    for (b, w), (jb, jw) in zip(got, want):
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_array_equal(w, jw)
    assert stores["repro_torch"].stats_for("default").peak_block_bytes == \
        stores["repro"].stats_for("default").peak_block_bytes


def test_store_takes_tensors_and_keeps_bf16_as_words():
    store = tstore.UpdateStore()
    v = torch.randn(10)
    store.write("f", v, weight=1.0)
    store.write("h", v.to(torch.bfloat16), weight=1.0, tenant="a")
    np.testing.assert_array_equal(store.read("f")[0], v.numpy())
    words, _ = store.read("h", tenant="a")
    assert words.dtype == BF16 and words.nbytes == 20
    back = torch.from_numpy(words.view(np.int16).copy()).view(torch.bfloat16)
    assert torch.equal(back, v.to(torch.bfloat16))
    assert store.meta("a") == (1, 10, BF16)


def test_external_blob_routing_matches(tmp_path):
    """Blobs dropped straight into a disk spool — one in a tenant
    subdirectory, one routed by a ``.tenant`` sidecar — register the same
    way in both packages' stores."""
    results = {}
    for name, mod in MODULES.items():
        spool = tmp_path / name
        store = mod.UpdateStore(backend="disk", spool_dir=str(spool),
                                sidecar_grace_seconds=0.0)
        os.makedirs(spool / "a")
        np.save(spool / "a" / "x.npy", _vec(1))
        with open(spool / "a" / "x.npy.w", "w") as f:
            f.write("3.0")
        np.save(spool / "y.npy", _vec(2))
        with open(spool / "y.npy.tenant", "w") as f:
            f.write("b")
        with open(spool / "y.npy.w", "w") as f:
            f.write("2.0")
        new = sorted(store.ingest_external())
        results[name] = (new, _state(store))
        assert store.read("y", tenant="b")[1] == 2.0
    assert results["repro"] == results["repro_torch"]


def test_monitor_gate_matches_reference():
    from repro.core.monitor import Monitor as JMonitor

    stores = _both()
    for store in stores.values():
        for i in range(3):
            store.write(f"c{i}", _vec(i), tenant="a")
    ticks = iter(range(1000))
    mon = Monitor(stores["repro_torch"], threshold=3, timeout=5.0,
                  clock=lambda: float(next(ticks)), sleep=lambda s: None,
                  tenant="a")
    jticks = iter(range(1000))
    jmon = JMonitor(stores["repro"], threshold=3, timeout=5.0,
                    clock=lambda: float(next(jticks)), sleep=lambda s: None,
                    tenant="a")
    assert dataclasses.astuple(mon.wait()) == dataclasses.astuple(jmon.wait())
    ticks = iter(range(1000))
    jticks = iter(range(1000))
    late = Monitor(stores["repro_torch"], threshold=4, timeout=5.0,
                   clock=lambda: float(next(ticks)), sleep=lambda s: None,
                   tenant="a")
    jlate = JMonitor(stores["repro"], threshold=4, timeout=5.0,
                     clock=lambda: float(next(jticks)), sleep=lambda s: None,
                     tenant="a")
    res, jres = late.wait(), jlate.wait()
    assert (res.ready, res.count, res.waited) == \
        (jres.ready, jres.count, jres.waited) == (False, 3, 5.0)
