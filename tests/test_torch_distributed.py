"""The port's DistributedEngine at world size 1, in process, on gloo:
twins of the reference's (1, 1)-mesh cases (``tests/test_engines.py``
47-54, ``tests/test_equivalence.py`` 124-161, ``tests/test_streaming.py``
133-149, ``tests/test_async_rounds.py`` 424-450), one compressed stream,
the planner's mesh plan against the reference's, and the mesh tooling.
The same seeded numpy inputs go through both packages, held at rtol
1e-4, atol 1e-5. The 8-rank layouts are ``test_torch_distributed_mesh.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.compress import CompressedBlock as JCompressedBlock
from repro.core.compress import compress_update as j_compress_update
from repro.core.distributed import DistributedEngine as JDistributedEngine
from repro.core.fusion import get_fusion as j_get_fusion
from repro.core.local import LocalEngine as JLocalEngine
from repro.core.planner import Planner as JPlanner
from repro.core.workload import Workload as JWorkload
from repro.utils.compat import make_mesh
from repro.utils.mem import TPU_V5E
from repro_torch.core.compress import CompressedBlock, compress_update
from repro_torch.core.distributed import DistributedEngine
from repro_torch.core.fusion import REGISTRY, get_fusion
from repro_torch.core.planner import Planner
from repro_torch.core.service import AggregationService
from repro_torch.core.workload import Workload
from repro_torch.kernels.fused_fusion import kernel
from repro_torch.kernels.robust_fusion import kernel as robust_kernel
from repro_torch.launch.mesh import (
    data_axis_names,
    make_local_mesh,
    n_data_shards,
)
from repro_torch.utils import jitcache
from repro_torch.utils.mem import H100_SXM

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
# tests/test_engines.py's list
ALL = [("fedavg", {}), ("iteravg", {}), ("clippedavg", {"clip_norm": 3.0}),
       ("coordmedian", {}), ("trimmedmean", {"beta": 0.2}),
       ("krum", {"n_byzantine": 2}), ("zeno", {"n_suspect": 2}),
       ("geomedian", {})]
REDUCIBLE = sorted(n for n, cls in REGISTRY.items() if cls.reducible)


@pytest.fixture(scope="module", autouse=True)
def group(tmp_path_factory):
    """A world of one gloo rank for the module, rendezvous by FileStore."""
    path = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", store=dist.FileStore(str(path), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    robust_kernel.reset_launches()
    yield
    assert not any(kernel.LAUNCHES.values())
    assert not any(robust_kernel.LAUNCHES.values())


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh(1, 1, device_type="cpu")


def _engine(mesh, **kw):
    return DistributedEngine(mesh=mesh, device="cpu", **kw)


def _j_engine(**kw):
    return JDistributedEngine(mesh=make_mesh((1, 1), ("data", "model")), **kw)


def _mk(n, p, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, p)).astype(np.float32),
            rng.uniform(1, 5, size=(n,)).astype(np.float32))


def _blocks(u, w, chunk):
    for lo in range(0, u.shape[0], chunk):
        yield u[lo:lo + chunk], w[lo:lo + chunk]


def _close(got, want):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# -- tests/test_engines.py 47-54 ----------------------------------------------
@pytest.mark.parametrize("name,kw", ALL, ids=[n for n, _ in ALL])
def test_distributed_1dev_matches_reference(mesh, name, kw):
    """Every fusion on the (1, 1) mesh against the reference's engine on
    its (1, 1) mesh and its local jnp engine, two rounds (FedAvgM-style
    state would advance) and tensor inputs."""
    u, w = _mk(13, 517, seed=1)
    ours, theirs = _engine(mesh), _j_engine()
    got = ours.fuse(get_fusion(name, **kw), u, w)
    _close(got, theirs.fuse(j_get_fusion(name, **kw), u, w))
    _close(got, JLocalEngine(strategy="jnp").fuse(
        j_get_fusion(name, **kw), u, w))
    _close(ours.fuse(get_fusion(name, **kw), torch.from_numpy(u), None),
           theirs.fuse(j_get_fusion(name, **kw), u, None))


@pytest.mark.parametrize("name", ["fedavgm", "fedadam", "gradavg"])
def test_server_optimizers_advance_every_round(mesh, name):
    """combine stays outside the cached step: the server state moves."""
    ours, theirs = _engine(mesh), _j_engine()
    tf, jf = get_fusion(name), j_get_fusion(name)
    for seed in (1, 2, 3):
        u, w = _mk(11, 130, seed)
        _close(ours.fuse(tf, u, w), theirs.fuse(jf, u, w))


# -- tests/test_equivalence.py 124-161 ----------------------------------------
@pytest.mark.parametrize("name", REDUCIBLE)
def test_distributed_stream_matches_dense(mesh, name):
    n, p, chunk = 13, 257, 4
    u, w = _mk(n, p)
    dense = JLocalEngine(strategy="jnp").fuse(j_get_fusion(name), u, w)
    eng = _engine(mesh)
    streamed, rep = eng.fuse_stream(get_fusion(name), _blocks(u, w, chunk))
    _close(streamed, dense)
    assert rep.n_rows == n and rep.n_blocks == -(-n // chunk)
    assert rep.compile_seconds > 0.0   # cold
    streamed2, rep2 = eng.fuse_stream(get_fusion(name), _blocks(u, w, chunk))
    assert rep2.compile_seconds == 0.0  # warm: the cached step
    _close(streamed2, dense)
    ref, _ = _j_engine().fuse_stream(j_get_fusion(name), _blocks(u, w, chunk))
    _close(streamed2, ref)


def test_distributed_stream_accumulator_carry(mesh):
    """Carried partial sums split across two streams equal one stream,
    and the carry is the reference's."""
    u, w = _mk(12, 130)
    eng, f = _engine(mesh), get_fusion("fedavg")
    full, _ = eng.fuse_stream(f, [(u, w)])
    _, rep1 = eng.fuse_stream(f, [(u[:5], w[:5])])
    part2, rep2 = eng.fuse_stream(f, [(u[5:], w[5:])],
                                  init=(rep1.acc_wsum, rep1.acc_tot))
    _close(part2, full.numpy())
    jeng, jf = _j_engine(), j_get_fusion("fedavg")
    _, jrep1 = jeng.fuse_stream(jf, [(u[:5], w[:5])])
    _close(rep1.acc_wsum, jrep1.acc_wsum)
    assert rep1.acc_tot == pytest.approx(jrep1.acc_tot, rel=1e-6)
    # a carry-only round finalizes what it was given
    carried, rep3 = eng.fuse_stream(f, [], init=rep2.acc_state)
    _close(carried, part2.numpy())
    assert rep3.n_blocks == 0


@pytest.mark.parametrize("name", ["trimmedmean", "coordmedian"])
def test_distributed_carve_stream_matches_reference(mesh, name):
    """The carve path with a carried state handed over mid-stream."""
    n, p = 14, 200
    u, w = _mk(n, p, seed=3)
    eng = _engine(mesh)
    got, rep = eng.fuse_stream(get_fusion(name), _blocks(u[:8], w[:8], 3),
                               chunk_rows=3, n_hint=n)
    got, _ = eng.fuse_stream(get_fusion(name), _blocks(u[8:], w[8:], 3),
                             chunk_rows=3, n_hint=n, init=rep.acc_state)
    want, _ = _j_engine().fuse_stream(j_get_fusion(name), _blocks(u, w, 3),
                                      chunk_rows=3, n_hint=n)
    _close(got, want)


# -- tests/test_streaming.py 133-149 ------------------------------------------
def test_distributed_bucket_cache_no_rebuild(mesh):
    eng, f = _engine(mesh), get_fusion("fedavg")
    p = 257
    for i, n in enumerate((11, 13)):
        u, w = _mk(n, p, seed=10 + i)
        before = jitcache.trace_count()
        fused = eng.fuse(f, u, w)
        _close(fused, np.einsum("np,n->p", u, w) / (w.sum() + 1e-6))
        if i:
            assert jitcache.trace_count() == before, "same-bucket rebuild"
    assert eng.is_warm(f, 16, p, np.float32)
    assert not eng.is_warm(f, 17, p, np.float32)


# -- tests/test_async_rounds.py 424-450 ---------------------------------------
def test_distributed_cold_vs_warm_compile_phase(mesh):
    eng, f = _engine(mesh), get_fusion("iteravg")
    u, w = _mk(10, 129)
    ref = JLocalEngine(strategy="jnp").fuse(j_get_fusion("iteravg"), u, w)
    out1 = eng.fuse(f, u, w)
    cold = eng.last_compile_seconds
    out2 = eng.fuse(f, u, w)
    warm = eng.last_compile_seconds
    assert cold > 0.0 and warm == 0.0
    _close(out1, ref)
    _close(out2, ref)


def test_distributed_is_warm_stream(mesh):
    eng, f = _engine(mesh), get_fusion("fedavg")
    u, w = _mk(8, 64)
    assert not eng.is_warm_stream(f, 4, 64, np.float32)
    eng.fuse_stream(f, [(u[:4], w[:4]), (u[4:], w[4:])])
    assert eng.is_warm_stream(f, 4, 64, np.float32)
    assert not eng.is_warm_stream(f, 5, 64, np.float32)
    assert not eng.is_warm_stream(get_fusion("trimmedmean"), 4, 64,
                                  np.float32)   # no n_hint: cannot stream
    assert not eng.is_warm_stream(get_fusion("krum"), 4, 64, np.float32)


# -- compressed ------------------------------------------------------------------
@pytest.mark.parametrize("name", ["fedavg", "clippedavg", "trimmedmean"])
def test_distributed_compressed_stream_matches_reference(mesh, name):
    """int8 blocks (quantization block 64) mixed with a dense fp32
    straggler block: both kinds fold into one carry, as the reference's
    engine folds them; the int8 route is warm only with both steps."""
    n, p, chunk, blk = 10, 300, 4, 64
    u, w = _mk(n, p, seed=5)

    def blocks(pkg_compress, pkg_block):
        cus = [pkg_compress(r, block=blk) for r in u[:8]]
        for lo in range(0, 8, chunk):
            part = cus[lo:lo + chunk]
            yield (pkg_block(codes=np.stack([c.codes for c in part]),
                             scales=np.stack([c.scales for c in part]),
                             dim=p), w[lo:lo + chunk])
        yield u[8:], w[8:]

    eng = _engine(mesh)
    got, rep = eng.fuse_stream(get_fusion(name),
                               blocks(compress_update, CompressedBlock),
                               chunk_rows=chunk, n_hint=n)
    want, jrep = _j_engine().fuse_stream(
        j_get_fusion(name), blocks(j_compress_update, JCompressedBlock),
        chunk_rows=chunk, n_hint=n)
    _close(got, want)
    assert rep.ingest_bytes == jrep.ingest_bytes and rep.n_rows == n
    assert eng.is_warm_stream(get_fusion(name), chunk, p, np.int8,
                              block=blk, n_hint=n)
    assert not eng.is_warm_stream(get_fusion(name), chunk, p, np.int8,
                                  block=128, n_hint=n)


# -- the planner's mesh plan -------------------------------------------------------
@pytest.mark.parametrize("n_pods", [1, 2])
@pytest.mark.parametrize("name", ["fedavg", "trimmedmean", "krum"])
def test_planner_mesh_plan_matches_reference(name, n_pods):
    """Both planners fed numerically equal hardware: the same mesh plan
    (engine, n_devices, est_seconds, breakdown), cold and warm, and the
    same choice. The reference's ICI link rate times its link count is
    set to the port's NVLink rate."""
    import dataclasses

    hw = dataclasses.replace(
        TPU_V5E, hbm_bytes=H100_SXM.hbm_bytes, hbm_bw=H100_SXM.hbm_bw,
        peak_flops_bf16=H100_SXM.peak_flops_bf16,
        ici_bw_per_link=H100_SXM.nvlink_bw / TPU_V5E.ici_links)
    ours = Planner(hw=H100_SXM, n_devices=8, n_pods=n_pods,
                   store_bw=819e9)
    theirs = JPlanner(hw=hw, n_devices=8, n_pods=n_pods, store_bw=819e9)
    for n, params in ((48, 1 << 20), (4096, 25 << 20)):
        load = Workload(update_bytes=4 * params, n_clients=n, dtype_bytes=4,
                        params=params)
        jload = JWorkload(update_bytes=4 * params, n_clients=n,
                          dtype_bytes=4, params=params)
        for warm in ((), ("distributed", "hierarchical")):
            got = ours.candidate_plans(load, get_fusion(name), warm)
            want = theirs.candidate_plans(jload, j_get_fusion(name), warm)
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                assert (a.engine, a.n_devices, a.feasible) == \
                    (b.engine, b.n_devices, b.feasible)
                assert a.est_seconds == pytest.approx(b.est_seconds,
                                                      rel=1e-9)
                assert a.breakdown.keys() == b.breakdown.keys()
                for k in a.breakdown:
                    assert a.breakdown[k] == pytest.approx(
                        b.breakdown[k], rel=1e-9, abs=1e-30), k
            assert ours.plan(load, get_fusion(name), warm).engine == \
                theirs.plan(jload, j_get_fusion(name), warm).engine
    assert Planner(n_devices=1).candidate_plans(
        load, get_fusion(name))[-1].engine == "local"


# -- the service and the mesh tooling ----------------------------------------------
def test_service_on_a_one_rank_mesh(mesh, tmp_path):
    """At one device the planner has no mesh plan (as in the reference),
    so rounds fold on the local engine; the first rank's decision still
    travels through the broadcast, and the report names the folded
    ids."""
    from repro_torch.core.store import UpdateStore

    store = UpdateStore(backend="disk", spool_dir=str(tmp_path))
    svc = AggregationService(mesh=mesh, device="cpu", store=store)
    assert svc.planner.n_devices == 1 and svc.hierarchical is None
    u, w = _mk(6, 70)
    for i in range(6):
        store.write(f"c{i}", u[i], weight=float(w[i]))
    fused, rep = svc.aggregate(from_store=True, expected_clients=6)
    assert rep.plan.engine == "local" and rep.streamed
    assert rep.client_ids == tuple(f"c{i}" for i in range(6))
    _close(fused, np.einsum("np,n->p", u, w) / (w.sum() + 1e-6))
    fused, rep = svc.aggregate(updates=list(u), weights=w)
    _close(fused, np.einsum("np,n->p", u, w) / (w.sum() + 1e-6))
    # the followers' read: the same rows straight from the spool
    assert np.array_equal(store.read_spooled("c3"), u[3])


def test_mesh_tooling(mesh):
    assert data_axis_names(mesh) == ("data",) and n_data_shards(mesh) == 1
    pod = make_local_mesh(1, 1, pod=1, device_type="cpu")
    assert data_axis_names(pod) == ("pod", "data")
    assert tuple(pod.mesh_dim_names) == ("pod", "data", "model")
    eng = DistributedEngine(mesh=pod, device="cpu")
    assert eng.client_axes == ("pod", "data") and eng.is_root
    assert eng.broadcast({"round": 3}) == {"round": 3}
    with pytest.raises(ValueError, match="device type"):
        DistributedEngine(mesh=mesh, device="cuda")
    with pytest.raises(ValueError, match="device_type"):
        make_local_mesh(1, 1, device_type="tpu")


def test_mesh_needs_a_process_group():
    """Rendezvous is the caller's: without a default group the mesh
    functions raise, saying so."""
    code = ("from repro_torch.launch.mesh import make_local_mesh\n"
            "try:\n"
            "    make_local_mesh(device_type='cpu')\n"
            "except RuntimeError as e:\n"
            "    print('RAISED', 'init_process_group' in str(e))\n")
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert "RAISED True" in res.stdout, res.stderr
