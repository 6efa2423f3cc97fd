"""The port's distributed engine and ``AggregationService(mesh=...)``
across 8 CPU ranks on gloo, one process per rank, against the JAX
package's ``DistributedEngine`` on 8 forced host devices.

One spawn per layout, holding all its cases:

  * (2, 2, 2) ("pod", "data", "model"): every fusion of
    ``tests/test_engines.py``'s list, flat and hierarchical, at a row
    count and a width that both need padding; a streamed TrimmedMean
    carve and a streamed int8 FedAvg; then a synchronous store round and
    two async rounds (a staleness-discounted carry, stragglers) through
    ``AggregationService(mesh=...)`` on a spool the ranks share;
  * (4, 2) ("data", "model"): the streamed ClippedAvg of
    ``tests/test_equivalence.py`` against the dense map-reduce and the
    local engine.

The ranks and the reference run side by side as subprocesses of this
file (``python tests/test_torch_distributed_mesh.py rank|reference``),
each under a 120 s limit, with a 60 s gloo timeout; they hand their
outputs over as ``.npz`` / ``.json`` files. Every rank must return the
same bits, and rank 0 must match the reference at rtol 1e-4, atol 1e-5.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
PROC_TIMEOUT = 120      # seconds a rank or the reference may take
GLOO_TIMEOUT = 60       # seconds a collective may wait for a peer
RTOL, ATOL = 1e-4, 1e-5
LAYOUTS = {"pod": ((2, 2, 2), ("pod", "data", "model")),
           "data": ((4, 2), ("data", "model"))}
FUSIONS = ["fedavg", "iteravg", "clippedavg", "coordmedian", "trimmedmean",
           "krum", "zeno", "geomedian"]
N, P = 13, 257            # 13 rows over 4 client shards, 257 over 8 slices
SVC_N, SVC_P, SVC_CHUNK = 12, 266, 5
STALL_TIMEOUT, STALL_SLEEP = 3, 20   # a peer that never joins


def _fusion(pkg, name):
    """The fusion of ``tests/test_engines.py``'s list, from ``pkg``'s
    fusion module."""
    kw = {"clippedavg": {"clip_norm": 3.0}, "trimmedmean": {"beta": 0.2},
          "krum": {"n_byzantine": 2}, "zeno": {"n_suspect": 2}}
    return pkg.get_fusion(name, **kw.get(name, {}))


def _dense():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(N, P)).astype(np.float32),
            rng.uniform(1, 5, size=(N,)).astype(np.float32))


def _clipped():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(21, 266)).astype(np.float32),
            rng.uniform(1, 5, size=(21,)).astype(np.float32))


def _svc_rows():
    rng = np.random.default_rng(11)
    return (rng.normal(size=(34, SVC_P)).astype(np.float32),
            rng.uniform(1, 5, size=(34,)).astype(np.float32))


def _blocks(u, w, chunk):
    return [(u[lo:lo + chunk], w[lo:lo + chunk])
            for lo in range(0, u.shape[0], chunk)]


def _q_blocks(u, w, chunk, compress_update, CompressedBlock):
    cus = [compress_update(row, block=64) for row in u]
    out = []
    for lo in range(0, len(cus), chunk):
        part = cus[lo:lo + chunk]
        out.append((CompressedBlock(
            codes=np.stack([c.codes for c in part]),
            scales=np.stack([c.scales for c in part]), dim=u.shape[1]),
            w[lo:lo + chunk]))
    return out


# -- the reference, on 8 forced host devices -------------------------------------
def _reference(out_dir):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from repro.core import DistributedEngine, LocalEngine
    from repro.core import fusion as jfusion
    from repro.core.compress import CompressedBlock, compress_update
    from repro.utils.compat import make_mesh

    res = {}
    mesh = make_mesh(*LAYOUTS["pod"])
    u, w = _dense()
    for hier in (False, True):
        eng = DistributedEngine(mesh=mesh, hierarchical=hier)
        for name in FUSIONS:
            res[f"fuse/{name}/{hier}"] = np.asarray(
                eng.fuse(_fusion(jfusion, name), u, w))
    eng = DistributedEngine(mesh=mesh)
    out, _ = eng.fuse_stream(_fusion(jfusion, "trimmedmean"),
                             _blocks(u, w, 4), chunk_rows=4, n_hint=N)
    res["stream/trimmedmean"] = np.asarray(out)
    out, _ = eng.fuse_stream(
        jfusion.get_fusion("fedavg"),
        _q_blocks(u, w, 4, compress_update, CompressedBlock), chunk_rows=4)
    res["stream/fedavg_int8"] = np.asarray(out)
    mesh = make_mesh(*LAYOUTS["data"])
    uc, wc = _clipped()
    f = jfusion.get_fusion("clippedavg")
    res["clipped/dense"] = np.asarray(DistributedEngine(mesh=mesh)
                                      .fuse(f, uc, wc))
    res["clipped/local"] = np.asarray(LocalEngine(strategy="jnp")
                                      .fuse(f, uc, wc))
    np.savez(os.path.join(out_dir, "reference.npz"), **res)


# -- one rank of the port ----------------------------------------------------------
def _rank(rank, store_path, out_dir, layout):
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=GLOO_TIMEOUT))
    from repro_torch.core import fusion as tfusion
    from repro_torch.core.compress import CompressedBlock, compress_update
    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.core.local import LocalEngine
    from repro_torch.core.service import AggregationService
    from repro_torch.core.store import UpdateStore
    from repro_torch.launch.mesh import make_local_mesh

    shape, _axes = LAYOUTS[layout]
    mesh = make_local_mesh(*shape[-2:], pod=shape[0] if layout == "pod"
                           else 0, device_type="cpu")
    res, meta = {}, {}

    def engine(**kw):
        return DistributedEngine(mesh=mesh, device="cpu",
                                 timeout=GLOO_TIMEOUT, **kw)

    if layout == "data":
        uc, wc = _clipped()
        f = tfusion.get_fusion("clippedavg")
        eng = engine()
        res["clipped/dense"] = eng.fuse(f, uc, wc).numpy()
        out, rep = eng.fuse_stream(f, _blocks(uc, wc, 6), chunk_rows=6)
        res["clipped/stream"] = out.numpy()
        meta["clipped/n_rows"] = rep.n_rows
        res["clipped/local"] = LocalEngine(device="cpu").fuse(
            f, uc, wc).numpy()
    else:
        u, w = _dense()
        for hier in (False, True):
            eng = engine(hierarchical=hier)
            for name in FUSIONS:
                res[f"fuse/{name}/{hier}"] = eng.fuse(
                    _fusion(tfusion, name), u, w).numpy()
        eng = engine()
        for n in (2, 5):   # padding past the last client shard
            res[f"median/{n}"] = eng.fuse(tfusion.get_fusion("coordmedian"),
                                          u[:n], None).numpy()
        out, _ = eng.fuse_stream(_fusion(tfusion, "trimmedmean"),
                                 _blocks(u, w, 4), chunk_rows=4, n_hint=N)
        res["stream/trimmedmean"] = out.numpy()
        out, _ = eng.fuse_stream(
            tfusion.get_fusion("fedavg"),
            _q_blocks(u, w, 4, compress_update, CompressedBlock),
            chunk_rows=4)
        res["stream/fedavg_int8"] = out.numpy()
        _service_rounds(rank, mesh, out_dir, res, meta, AggregationService,
                        UpdateStore)
    np.savez(os.path.join(out_dir, f"{layout}_rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"{layout}_rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def _service_rounds(rank, mesh, out_dir, res, meta, AggregationService,
                    UpdateStore):
    """A synchronous store round, then two async rounds with a carry of
    gamma 0.5, on a disk spool the ranks share; rank 0 alone writes."""
    rows, ws = _svc_rows()
    store = UpdateStore(backend="disk",
                        spool_dir=os.path.join(out_dir, "spool"))
    svc = AggregationService(
        "fedavg", mesh=mesh, store=store, device="cpu", threshold_frac=0.75,
        staleness_discount=0.5, stream_chunk_bytes=SVC_CHUNK * SVC_P * 4)
    # no fixed cost of going distributed: the planner picks the mesh
    svc.planner.dispatch_overhead = 0.0

    def write(tenant, ids):
        if rank == 0:
            for i in ids:
                store.write(f"c{i:02d}", rows[i], weight=float(ws[i]),
                            tenant=tenant)

    write("sync", range(SVC_N))
    fused, rep = svc.aggregate(from_store=True, expected_clients=SVC_N,
                               tenant="sync")
    res["svc/sync"] = fused.numpy()
    meta["svc/sync"] = [list(rep.client_ids), rep.plan.engine, rep.streamed]
    write("async", range(10))
    consume = store.remove

    def late_then_remove(*args, **kw):
        # two stragglers land after round 0's close, before its consume
        write("async", (10, 11))
        store.remove = consume
        return consume(*args, **kw)

    store.remove = late_then_remove
    for r in range(2):
        fused, rep = svc.aggregate(from_store=True, async_round=True,
                                   expected_clients=SVC_N, tenant="async")
        res[f"svc/async{r}"] = fused.numpy()
        meta[f"svc/async{r}"] = [list(rep.client_ids), rep.plan.engine,
                                 rep.n_clients]
        write("async", range(12, 22) if r == 0 else ())


def _stall(rank, store_path, out_dir):
    """Two ranks that disagree: rank 0 fuses, rank 1 never joins. Rank 0's
    collective must fail at the engine's timeout, not hang."""
    import time

    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2)
    from repro_torch.core import fusion as tfusion
    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.launch.mesh import make_local_mesh

    eng = DistributedEngine(mesh=make_local_mesh(2, 1, device_type="cpu"),
                            device="cpu", timeout=STALL_TIMEOUT)
    done = os.path.join(out_dir, "stall.json")
    if rank == 1:   # stays up until rank 0 has its answer, or the limit
        t0 = time.perf_counter()
        while not os.path.exists(done) \
                and time.perf_counter() - t0 < STALL_SLEEP:
            time.sleep(0.1)
        os._exit(0)
    u, w = _dense()
    t0 = time.perf_counter()
    try:
        eng.fuse(tfusion.get_fusion("fedavg"), u, w)
        outcome = "returned"
    except RuntimeError:
        outcome = "raised"
    elapsed = time.perf_counter() - t0
    with open(done + ".tmp", "w") as f:
        json.dump([outcome, elapsed], f)
    os.replace(done + ".tmp", done)
    os._exit(0)


# -- the test side ------------------------------------------------------------------
def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"),
                JAX_PLATFORMS="cpu", GLOO_SOCKET_IFNAME="lo",
                OMP_NUM_THREADS="1")


def _run_all(tmp):
    me = str(Path(__file__).resolve())
    procs = [subprocess.Popen(
        [sys.executable, me, "reference", str(tmp)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    for layout in LAYOUTS:
        d = tmp / layout
        d.mkdir()
        procs += [subprocess.Popen(
            [sys.executable, me, "rank", str(r), str(d / "rendezvous"),
             str(tmp), layout], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    procs += [subprocess.Popen(
        [sys.executable, me, "stall", str(r), str(tmp / "stall-rdv"),
         str(tmp)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=PROC_TIMEOUT)
            logs.append((p.args, p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for args, rc, out in logs:
        assert rc == 0, f"{args[2:]} exited {rc}:\n{out[-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    _run_all(tmp)
    ref = dict(np.load(tmp / "reference.npz"))
    ranks = {layout: [(dict(np.load(tmp / f"{layout}_rank{r}.npz")),
                       json.loads((tmp / f"{layout}_rank{r}.json")
                                  .read_text()))
                      for r in range(WORLD)] for layout in LAYOUTS}
    ranks["stall"] = json.loads((tmp / "stall.json").read_text())
    return ref, ranks


def _same_on_every_rank(ranks, key):
    first = ranks[0][0][key]
    for arrays, _ in ranks[1:]:
        assert arrays[key].tobytes() == first.tobytes(), key
    return first


@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
@pytest.mark.parametrize("name", FUSIONS)
def test_pod_mesh_fuse_matches_reference(runs, name, hier):
    """(2, 2, 2): every fusion, flat and hierarchical, against the
    reference's DistributedEngine; bitwise equal on every rank."""
    ref, ranks = runs
    key = f"fuse/{name}/{hier}"
    got = _same_on_every_rank(ranks["pod"], key)
    assert got.shape == (P,)
    np.testing.assert_allclose(got, ref[key], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [2, 5])
def test_pod_mesh_all_to_all_keeps_the_real_rows(runs, n):
    """n = 2 and 5 over 4 client shards put padding in more than the
    last shard. After the per-axis all-to-all the rows arrive in (data,
    pod) shard order, and the reference's ``u[:n_real]`` then keeps
    padding and drops real rows, so its median is not ``np.median``'s;
    the port tracks each row's client shard and keeps exactly the n real
    ones: the exact median."""
    _, ranks = runs
    u, _ = _dense()
    np.testing.assert_allclose(_same_on_every_rank(ranks["pod"],
                                                   f"median/{n}"),
                               np.median(u[:n].astype(np.float64), axis=0),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["trimmedmean", "fedavg_int8"])
def test_pod_mesh_streams_match_reference(runs, case):
    """The carve path (rows on every rank, columns split) and the
    compressed sum path: 64-column quantization blocks, so the second of
    the two 132-column param slices starts mid-block and dequantizes on
    its ranks while the first folds through ``weighted_sum_dequant``."""
    ref, ranks = runs
    key = f"stream/{case}"
    np.testing.assert_allclose(_same_on_every_rank(ranks["pod"], key),
                               ref[key], rtol=RTOL, atol=ATOL)


def test_data_mesh_streamed_clippedavg(runs):
    """(4, 2): the streamed ClippedAvg (row norms all-reduced over the
    param shards) equals the dense map-reduce and the local engine, of
    both packages."""
    ref, ranks = runs
    ranks = ranks["data"]
    stream = _same_on_every_rank(ranks, "clipped/stream")
    dense = _same_on_every_rank(ranks, "clipped/dense")
    assert ranks[0][1]["clipped/n_rows"] == 21
    np.testing.assert_allclose(stream, dense, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(stream, ranks[0][0]["clipped/local"],
                               rtol=RTOL, atol=ATOL)
    for key in ("clipped/dense", "clipped/local"):
        np.testing.assert_allclose(stream, ref[key], rtol=RTOL, atol=ATOL)


def _eq1(rows, w):
    rows, w = np.asarray(rows, np.float64), np.asarray(w, np.float64)
    return (w[:, None] * rows).sum(0), w.sum()


def test_service_sync_round_on_the_mesh(runs):
    """The first rank's blocks of 5 rows (the last ragged, on one client
    shard only) through the hierarchical engine: every rank folds the
    same ids and returns the same bits, float64 Eq. 1's value."""
    _, ranks = runs
    ranks = ranks["pod"]
    fused = _same_on_every_rank(ranks, "svc/sync")
    metas = [m["svc/sync"] for _, m in ranks]
    assert all(m == metas[0] for m in metas)
    ids, engine, streamed = metas[0]
    assert ids == [f"c{i:02d}" for i in range(SVC_N)]
    assert engine == "hierarchical" and streamed
    rows, w = _svc_rows()
    ws, tot = _eq1(rows[:SVC_N], w[:SVC_N])
    np.testing.assert_allclose(fused, ws / (tot + 1e-6), rtol=RTOL, atol=ATOL)


def test_service_async_rounds_carry_on_the_mesh(runs):
    """Round 0 closes at 10 of 12 (threshold 9), and two stragglers land
    after its close, before its consume; round 1 folds them at gamma 0.5
    (the scales the first rank sends) and ten new clients, on 0.5 x
    round 0's carry. Every rank: the same ids, the same bits."""
    _, ranks = runs
    ranks = ranks["pod"]
    rows, w = _svc_rows()
    ids = [f"c{i:02d}" for i in range(22)]
    metas = [(m["svc/async0"], m["svc/async1"]) for _, m in ranks]
    assert all(m == metas[0] for m in metas)
    (ids0, eng0, n0), (ids1, eng1, n1) = metas[0]
    assert ids0 == ids[:10] and sorted(ids1) == ids[10:22]
    assert eng0 == eng1 == "hierarchical" and (n0, n1) == (10, 12)
    ws0, tot0 = _eq1(rows[:10], w[:10])
    np.testing.assert_allclose(_same_on_every_rank(ranks, "svc/async0"),
                               ws0 / (tot0 + 1e-6), rtol=RTOL, atol=ATOL)
    scale = np.where(np.arange(10, 22) < 12, 0.5, 1.0)
    ws1, tot1 = _eq1(rows[10:22], w[10:22] * scale)
    want = (0.5 * ws0 + ws1) / (0.5 * tot0 + tot1 + 1e-6)
    np.testing.assert_allclose(_same_on_every_rank(ranks, "svc/async1"),
                               want, rtol=RTOL, atol=ATOL)


def test_disagreeing_ranks_fail_at_the_timeout(runs):
    """A rank whose peer never calls the collective raises once the
    engine's group timeout (3 s) has passed, while the peer is still up."""
    outcome, seconds = runs[1]["stall"]
    assert outcome == "raised"
    assert STALL_TIMEOUT - 0.5 <= seconds < STALL_SLEEP - 5


if __name__ == "__main__":
    sys.path.insert(0, str(REPO / "src"))
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    elif sys.argv[1] == "stall":
        _stall(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        _rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
