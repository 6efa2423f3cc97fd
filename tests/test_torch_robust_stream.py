"""Streamed robust aggregation in the port against the JAX package's: the
order-statistic reducers (TrimmedMean / CoordMedian) fold (chunk, P)
blocks through the top-k carve, strategy ``kernel`` against ``pallas``
(interpret mode) and ``torch`` against ``jnp``, on the same seeded numpy
inputs (CPU; the kernel strategy runs the carve's plain version here).

Covered: odd and even n with a ragged tail, fp32 and bf16 blocks,
compressed and mixed rounds, the service's ``robust_state_budget``
routing and its note, the refusals, the memory-capped dense fuse, a JAX
carry resumed in the port, the caller's ``init`` left untouched by an
in-place fold, Zeno's per-call validation gradient and the CLI.
"""
import os
import re
import subprocess
import sys
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.compress import CompressedBlock as JBlock
from repro.core.compress import compress_update as j_compress_update
from repro.core.fusion import get_fusion as j_get_fusion
from repro.core.local import LocalEngine as JLocalEngine
from repro.core.service import AggregationService as JService
from repro.core.store import UpdateStore as JStore
from repro_torch.convert import carry_from_numpy
from repro_torch.core.compress import CompressedBlock, compress_update
from repro_torch.core.fusion import get_fusion
from repro_torch.core.local import LocalEngine
from repro_torch.core.service import AggregationService
from repro_torch.core.store import UpdateStore
from repro_torch.kernels.robust_fusion import kernel as robust_kernel
from repro_torch.kernels.robust_fusion import ref
from repro_torch.utils import jitcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5        # tests/test_robust_stream.py's
PAIRS = [("kernel", "pallas"), ("torch", "jnp")]
CARVES = [("trimmedmean", {"beta": 0.1}), ("trimmedmean", {"beta": 0.2}),
          ("coordmedian", {})]


def _ids(x):
    if isinstance(x, tuple) and isinstance(x[1], dict):
        return x[0] + "".join(f"-{k}{v}" for k, v in x[1].items())
    return x[0] if isinstance(x, tuple) else str(x)


def _fusions(spec):
    name, kw = spec
    return get_fusion(name, **kw), j_get_fusion(name, **kw)


def _blocks(u, w, chunk):
    for lo in range(0, u.shape[0], chunk):
        yield u[lo:lo + chunk], w[lo:lo + chunk]


def _data(n, p, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, p)).astype(np.float32),
            rng.uniform(0.5, 9.0, size=(n,)).astype(np.float32))


def _close(got, want):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _same_carry(rep, jrep):
    """The carve buffers select input values: bit for bit; the sum and
    count to the stream tolerance."""
    assert len(rep.acc_state) == len(jrep.acc_state) == 4
    ssum, cnt, topk, botk = (t.numpy() for t in rep.acc_state)
    np.testing.assert_array_equal(topk, jrep.acc_state[2])
    np.testing.assert_array_equal(botk, jrep.acc_state[3])
    np.testing.assert_allclose(ssum, jrep.acc_state[0], rtol=RTOL, atol=ATOL)
    assert float(cnt) == float(jrep.acc_state[1])
    assert rep.acc_wsum is None and jrep.acc_wsum is None


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("spec", CARVES, ids=_ids)
@pytest.mark.parametrize("n,p,chunk", [
    (9, 257, 1),     # chunk 1: every row its own fold
    (13, 301, 3),    # odd n, ragged final block
    (16, 64, 8),     # even n, exact blocks
    (12, 200, 5),    # even n, ragged final block
])
def test_carve_stream_matches(spec, pair, n, p, chunk):
    u, w = _data(n, p, n * 100 + chunk)
    ours, theirs = _fusions(spec)
    got, rep = LocalEngine(strategy=pair[0], device="cpu").fuse_stream(
        ours, _blocks(u, w, chunk), chunk_rows=chunk, n_hint=n)
    want, jrep = JLocalEngine(strategy=pair[1]).fuse_stream(
        theirs, _blocks(u, w, chunk), chunk_rows=chunk, n_hint=n)
    _close(got, want)
    _same_carry(rep, jrep)
    for field in ("n_rows", "n_blocks", "chunk_rows", "ingest_bytes"):
        assert getattr(rep, field) == getattr(jrep, field), field
    # weights are ignored: the dense oracle of the unweighted statistic
    _close(got, ours.fuse(torch.from_numpy(u), None))


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("spec", CARVES[1:], ids=_ids)
def test_bf16_carve_stream_matches_in_fp32(spec, pair):
    u, w = _data(11, 129, 3)
    u16 = u.astype(ml_dtypes.bfloat16)
    ours, theirs = _fusions(spec)
    got, rep = LocalEngine(strategy=pair[0], device="cpu").fuse_stream(
        ours, _blocks(u16, w, 4), chunk_rows=4, n_hint=11)
    want, jrep = JLocalEngine(strategy=pair[1]).fuse_stream(
        theirs, _blocks(u16, w, 4), chunk_rows=4, n_hint=11)
    _close(got, want)
    _same_carry(rep, jrep)


def _compressed(u, w, chunk, block, mixed=False):
    """(ours, theirs) block lists: every row compressed, or (mixed)
    every other block left dense fp32, as a straggler writes it."""
    ours, theirs = [], []
    for i, lo in enumerate(range(0, u.shape[0], chunk)):
        rows, wb = u[lo:lo + chunk], w[lo:lo + chunk]
        if mixed and i % 2:
            ours.append((rows, wb))
            theirs.append((rows, wb))
            continue
        tq = [compress_update(r, block) for r in rows]
        jq = [j_compress_update(r, block) for r in rows]
        ours.append((CompressedBlock(np.stack([c.codes for c in tq]),
                                     np.stack([c.scales for c in tq]),
                                     u.shape[1]), wb))
        theirs.append((JBlock(np.stack([c.codes for c in jq]),
                              np.stack([c.scales for c in jq]),
                              u.shape[1]), wb))
    return ours, theirs


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("mixed", [False, True], ids=["compressed", "mixed"])
@pytest.mark.parametrize("spec", [CARVES[0], CARVES[2]], ids=_ids)
def test_compressed_carve_stream_matches(spec, mixed, pair):
    """Compressed blocks are dequantized on the device (bit-identical to
    the host dequant) and carved; mixed rounds share one carry."""
    u, w = _data(10, 700, 12)
    ob, tb = _compressed(u, w, 3, 256, mixed)
    ours, theirs = _fusions(spec)
    eng = LocalEngine(strategy=pair[0], device="cpu")
    got, rep = eng.fuse_stream(ours, iter(ob), chunk_rows=3, n_hint=10)
    want, jrep = JLocalEngine(strategy=pair[1]).fuse_stream(
        theirs, iter(tb), chunk_rows=3, n_hint=10)
    _close(got, want)
    _same_carry(rep, jrep)
    assert rep.ingest_bytes == jrep.ingest_bytes and rep.n_blocks == 4
    assert eng.is_warm_stream(ours, 3, 700, np.int8, block=256, n_hint=10)
    assert not eng.is_warm_stream(ours, 3, 700, np.int8, block=256)


class _InPlaceCarve:
    """Stands in for the CUDA carve, which writes the carry in place."""

    def __init__(self):
        self.calls = 0

    def __call__(self, block, valid, ssum, topk, botk):
        self.calls += 1
        new = ref.topk_carve_ref(block, valid, ssum, topk, botk)
        for dst, src in zip((ssum, topk, botk), new):
            dst.copy_(src)
        return ssum, topk, botk


def test_carried_init_is_copied_before_an_in_place_fold(monkeypatch):
    """A caller's carried state goes in as ``init``; the in-place fold
    must write into a copy, never into the caller's tensors."""
    fake = _InPlaceCarve()
    monkeypatch.setattr(robust_kernel, "topk_carve", fake)
    u, w = _data(11, 90, 4)
    f = get_fusion("coordmedian")
    eng = LocalEngine(strategy="kernel", device="cpu")
    _, rep1 = eng.fuse_stream(f, _blocks(u[:6], w[:6], 3), chunk_rows=3,
                              n_hint=11)
    init = rep1.acc_state
    before = [t.clone() for t in init]
    fused, rep2 = eng.fuse_stream(f, _blocks(u[6:], w[6:], 3), init=init,
                                  chunk_rows=3, n_hint=11)
    assert fake.calls == 4
    for got, want in zip(init, before):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert all(a is not b for a, b in zip(rep2.acc_state, init))
    _close(fused, np.median(u, axis=0))


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
def test_jax_carve_acc_state_resumes_stream(pair):
    """acc_state of a JAX stream (its +/-inf sentinels included) seeds a
    port stream; the result is one pass over the concatenated rows."""
    n1, n2, p = 3, 8, 90       # K = 5 > 3 rows: sentinels remain
    rng = np.random.default_rng(21)
    u1 = rng.normal(size=(n1, p)).astype(np.float32)
    u2 = rng.normal(size=(n2, p)).astype(np.float32)
    n = n1 + n2
    _, jrep = JLocalEngine(strategy=pair[1]).fuse_stream(
        j_get_fusion("coordmedian"), _blocks(u1, np.ones(n1, np.float32), 3),
        chunk_rows=3, n_hint=n)
    assert np.isinf(np.asarray(jrep.acc_state[2])).any()
    init = carry_from_numpy(jrep.acc_state, device="cpu")
    fused, rep = LocalEngine(strategy=pair[0], device="cpu").fuse_stream(
        get_fusion("coordmedian"), _blocks(u2, np.ones(n2, np.float32), 3),
        init=init, chunk_rows=3, n_hint=n)
    _close(fused, np.median(np.vstack([u1, u2]), axis=0))
    assert rep.n_rows == n2
    # a carry-only round finalizes the JAX carry as it stands
    got, _ = LocalEngine(strategy=pair[0], device="cpu").fuse_stream(
        get_fusion("coordmedian"), iter(()), init=init)
    _close(got, np.median(u1, axis=0))


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("spec", [CARVES[1], CARVES[2]], ids=_ids)
def test_memory_capped_dense_fuse_streams_the_carve(spec, pair):
    u, w = _data(13, 300, 8)
    cap = 300 * 4 * 4            # four rows at a time, ragged tail of one
    ours, theirs = _fusions(spec)
    got = LocalEngine(strategy=pair[0], device="cpu",
                      memory_cap_bytes=cap).fuse(ours, u, w)
    want = JLocalEngine(strategy=pair[1], memory_cap_bytes=cap).fuse(
        theirs, u, w)
    _close(got, want)
    _close(got, ours.fuse(torch.from_numpy(u), None))
    with pytest.raises(MemoryError, match="not streamable"):
        LocalEngine(strategy=pair[0], device="cpu",
                    memory_cap_bytes=cap).fuse(get_fusion("krum"), u, w)


def test_refusals():
    u, w = _data(6, 16, 9)
    f = get_fusion("trimmedmean")
    eng = LocalEngine(strategy="kernel", device="cpu")

    def scaled():
        yield u[:3], w[:3], np.full((3,), 0.5, np.float32)

    with pytest.raises(ValueError, match="staleness"):
        eng.fuse_stream(f, scaled(), chunk_rows=3, n_hint=6)
    state = f.init_state(16, 6)
    with pytest.raises(ValueError, match="staleness"):
        f.fold_block(state, torch.from_numpy(u), torch.ones(6),
                     scale=torch.ones(6))
    with pytest.raises(ValueError, match="staleness-discounted"):
        f.discount_state(state, 0.5)
    with pytest.raises(ValueError, match="empty round"):
        f.finalize(state)
    with pytest.raises(ValueError, match="empty block iterator"):
        eng.fuse_stream(f, iter(()), n_hint=6)
    with pytest.raises(ValueError, match="n_hint"):
        eng.fuse_stream(f, _blocks(u, w, 3))
    with pytest.raises(ValueError, match="n_hint"):
        f.state_nbytes(16)
    assert not eng.is_warm_stream(f, 3, 16, np.float32)
    for name in ("krum", "zeno", "geomedian"):
        with pytest.raises(ValueError, match="not streamable"):
            eng.fuse_stream(get_fusion(name), _blocks(u, w, 3), n_hint=6)
    with pytest.raises(ValueError, match="budget"):
        AggregationService(fusion="trimmedmean", device="cpu",
                           robust_state_budget=0)
    with pytest.raises(ValueError, match="validation"):
        AggregationService(fusion="fedavg", device="cpu").aggregate(
            updates=list(u), val_grad=np.ones(16, np.float32))


def test_warm_carve_step_is_reused_across_rounds():
    n, p = 8, 128
    store = UpdateStore()
    svc = AggregationService(fusion=get_fusion("trimmedmean", beta=0.2),
                             store=store, monitor_timeout=0.5,
                             stream_chunk_bytes=4 * p * 3, device="cpu")
    for rnd in range(2):
        u, _ = _data(n, p, 40 + rnd)
        for i in range(n):
            store.write(f"c{i}", u[i])
        if rnd == 1:
            builds = jitcache.trace_count()
        fused, rep = svc.aggregate(from_store=True, expected_clients=n)
        assert rep.streamed
        _close(fused, ref.trimmedmean_ref(torch.from_numpy(u), 1))
        store.clear()
    assert jitcache.trace_count() == builds
    assert rep.phase_seconds["compile"] == 0.0


def _report_fields(rep):
    return (rep.n_clients, rep.update_bytes, rep.streamed, rep.bytes_ingested,
            rep.empty, rep.notes, rep.tenant)


@pytest.mark.parametrize("strategy", PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("budget,streams", [("default", True),
                                            ("tiny", False),
                                            ("exact", True),
                                            ("one_under", False)])
@pytest.mark.parametrize("spec", [CARVES[1], CARVES[2]], ids=_ids)
def test_service_routes_by_robust_state_budget(spec, budget, streams,
                                               strategy):
    """Under the budget a store round streams the carve; over it the
    round reads dense, with the reference's note, word for word."""
    n, p = 12, 200
    u, w = _data(n, p, 50)
    ours_f, theirs_f = _fusions(spec)
    need = theirs_f.state_nbytes(p, n)
    kw = {"default": {}, "tiny": {"robust_state_budget": 128},
          "exact": {"robust_state_budget": need},
          "one_under": {"robust_state_budget": need - 1}}[budget]
    ts, js = UpdateStore(), JStore()
    for store in (ts, js):
        for i in range(n):
            store.write(f"c{i}", u[i], weight=float(w[i]))
    ours = AggregationService(fusion=ours_f, store=ts, device="cpu",
                              local_strategy=strategy[0],
                              stream_chunk_bytes=4 * p * 5, **kw)
    theirs = JService(fusion=theirs_f, store=js, local_strategy=strategy[1],
                      stream_chunk_bytes=4 * p * 5, **kw)
    got, rep = ours.aggregate(from_store=True, expected_clients=n)
    want, jrep = theirs.aggregate(from_store=True, expected_clients=n)
    _close(got, want)
    assert rep.streamed is streams
    assert _report_fields(rep) == _report_fields(jrep)
    if not streams:
        assert rep.notes and rep.notes[0].startswith(
            "robust stream fallback:")


def test_service_compressed_and_mixed_carve_round():
    """Stragglers may write dense fp32 into a compressed round; the carve
    folds both payload kinds (oracle: host dequant, then the statistic)."""
    n, p = 10, 200
    u, _ = _data(n, p, 60)
    ours = AggregationService(fusion=get_fusion("trimmedmean", beta=0.2),
                              store=UpdateStore(), monitor_timeout=0.5,
                              compress=True, device="cpu")
    theirs = JService(fusion=j_get_fusion("trimmedmean", beta=0.2),
                      store=JStore(), monitor_timeout=0.5, compress=True)
    mixed = np.empty_like(u)
    for i in range(n):
        if i % 3 == 0:
            ours.store.write(f"c{i}", u[i])
            theirs.store.write(f"c{i}", u[i])
            mixed[i] = u[i]
        else:
            cu = ours.compress_update(f"c{i}", u[i])
            ours.store.write(f"c{i}", cu)
            theirs.store.write(f"c{i}", theirs.compress_update(f"c{i}", u[i]))
            mixed[i] = cu.dequantize()[:p]
    got, rep = ours.aggregate(from_store=True, expected_clients=n)
    want, jrep = theirs.aggregate(from_store=True, expected_clients=n)
    assert rep.streamed and jrep.streamed
    _close(got, want)
    _close(got, ref.trimmedmean_ref(torch.from_numpy(mixed), 2))
    assert _report_fields(rep) == _report_fields(jrep)


def test_zeno_val_grad_is_per_call_state():
    """Two tenants score against different validation gradients on one
    service, concurrently; neither touches the shared fusion."""
    n, p = 6, 64
    u, _ = _data(n, p, 70)
    grads = {"a": np.ones((p,), np.float32), "b": -np.ones((p,), np.float32)}
    want = {t: np.asarray(j_get_fusion("zeno").with_val_grad(jnp.asarray(g))
                          .fuse(jnp.asarray(u), None))
            for t, g in grads.items()}
    svc = AggregationService(fusion="zeno", device="cpu")
    results, errors = {}, []

    def round_for(tenant):
        try:
            results[tenant], _ = svc.aggregate(
                updates=list(u), val_grad=grads[tenant], tenant=tenant)
        except Exception as exc:  # pragma: no cover - surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=round_for, args=(t,)) for t in grads]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for tenant in grads:
        _close(results[tenant], want[tenant])
    assert svc.fusion._g_val is None


def _fused_head(out: str) -> np.ndarray:
    m = re.search(r"fused\[:5\]=\[([^\]]*)\]", out)
    assert m, out
    return np.array([float(x) for x in m.group(1).split()])


@pytest.mark.parametrize("fusion,streamed", [("trimmedmean", True),
                                             ("krum", False)])
def test_cli_matches_reference_cli(fusion, streamed):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    common = ["--model", "CNN4.6", "--clients", "8", "--fusion", fusion]
    ours = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.aggregate", "--device",
         "cpu", *common],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert ours.returncode == 0, ours.stderr
    theirs = subprocess.run(
        [sys.executable, "-m", "repro.launch.aggregate", *common],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert theirs.returncode == 0, theirs.stderr
    np.testing.assert_allclose(_fused_head(ours.stdout),
                               _fused_head(theirs.stdout),
                               rtol=RTOL, atol=ATOL)
    assert f"streamed={streamed}" in ours.stdout
    assert f"streamed={streamed}" in theirs.stdout
