"""The slice as a whole: the port's AggregationService, UpdateStore and
CLI against the JAX package's, on the same seeded updates (CPU)."""
import os
import re
import subprocess
import sys
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.service import AggregationService as JService
from repro.core.store import UpdateStore as JStore
from repro_torch.configs.cnn_suite import CNN_SUITE
from repro_torch.core.compress import compressed_bytes
from repro_torch.core.secure import SecureMasking
from repro_torch.core.service import AggregationService
from repro_torch.core.store import UpdateStore
from repro_torch.core.workload import (
    Workload,
    WorkloadClass,
    classify,
    max_clients_single_node,
)
from repro_torch.utils.mem import H100_SXM
from repro_torch.utils.pytree import flat_vector_to_tree, tree_to_flat_vector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-5, 1e-6
N, P = 12, 3001
CHUNK_BYTES = 4 * P * 5          # 5-row blocks: 3 blocks, the last ragged


def _updates(seed=0, n=N, p=P):
    rng = np.random.default_rng(seed)
    return ([rng.normal(size=(p,)).astype(np.float32) for _ in range(n)],
            [float(rng.integers(1, 100)) for _ in range(n)])


def _report_fields(rep):
    return (rep.n_clients, rep.update_bytes, rep.streamed, rep.bytes_ingested,
            rep.empty, rep.monitor.ready if rep.monitor else None, rep.notes,
            rep.tenant)


def _pair(strategy=("kernel", "pallas"), **kw):
    ts, js = UpdateStore(), JStore()
    return (AggregationService(store=ts, local_strategy=strategy[0],
                               device="cpu", **kw),
            JService(store=js, local_strategy=strategy[1], **kw))


@pytest.mark.parametrize("strategy", [("kernel", "pallas"), ("torch", "jnp")],
                         ids=lambda s: s[0])
@pytest.mark.parametrize("fusion", ["fedavg", "iteravg", "fedadam"])
def test_store_round_matches(strategy, fusion):
    ours, theirs = _pair(strategy, fusion=fusion,
                         stream_chunk_bytes=CHUNK_BYTES)
    ups, ws = _updates(1)
    for svc in (ours, theirs):
        for i, (u, w) in enumerate(zip(ups, ws)):
            svc.store.write(f"client{i:05d}", u, weight=w)
    for _ in range(2):   # fedadam's state advances identically
        got, rep = ours.aggregate(from_store=True, expected_clients=N)
        want, jrep = theirs.aggregate(from_store=True, expected_clients=N)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
        assert _report_fields(rep) == _report_fields(jrep)
        assert rep.streamed and rep.plan.engine == "local"
        assert set(rep.phase_seconds) == {"ingest", "compile", "compute"}
    assert rep.phase_seconds["compile"] == 0.0   # warm second round


def test_compressed_store_round_matches():
    ours, theirs = _pair(compress=True, stream_chunk_bytes=3 * 4096)
    ups, ws = _updates(2, p=5003)
    for svc in (ours, theirs):
        for i, (u, w) in enumerate(zip(ups, ws)):
            svc.store.write(f"client{i:05d}",
                            svc.compress_update(f"client{i:05d}", u), weight=w)
    got, rep = ours.aggregate(from_store=True)
    want, jrep = theirs.aggregate(from_store=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert _report_fields(rep) == _report_fields(jrep)
    assert rep.bytes_ingested == N * compressed_bytes(5003)


def test_bf16_store_round_matches():
    ours, theirs = _pair(stream_chunk_bytes=2 * P * 4)
    ups, ws = _updates(3)
    for svc in (ours, theirs):
        for i, (u, w) in enumerate(zip(ups, ws)):
            svc.store.write(f"c{i}", u.astype(ml_dtypes.bfloat16), weight=w)
    got, rep = ours.aggregate(from_store=True)
    want, jrep = theirs.aggregate(from_store=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert _report_fields(rep) == _report_fields(jrep)


def test_empty_round_matches():
    ours, theirs = _pair(monitor_timeout=0.05)
    got, rep = ours.aggregate(from_store=True, expected_clients=4)
    want, jrep = theirs.aggregate(from_store=True, expected_clients=4)
    assert got is None and want is None
    assert rep.empty and jrep.empty
    assert (rep.n_clients, rep.monitor.ready, rep.monitor.count, rep.notes) \
        == (jrep.n_clients, jrep.monitor.ready, jrep.monitor.count,
            jrep.notes) == (0, False, 0, ())


def test_in_memory_round_with_template_matches():
    rng = np.random.default_rng(4)
    template = {"w": np.zeros((3, 5), np.float32),
                "b": np.zeros((5,), np.float32),
                "a": [np.zeros((2,), np.float32)]}
    ups = [{"w": rng.normal(size=(3, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "a": [rng.normal(size=(2,)).astype(np.float32)]}
           for _ in range(7)]
    ws = rng.uniform(1, 9, size=(7,)).astype(np.float32)
    ours, theirs = _pair()
    got, rep = ours.aggregate(updates=ups, weights=ws, template=template)
    want, jrep = theirs.aggregate(updates=ups, weights=ws, template=template)
    assert sorted(got) == sorted(want) == ["a", "b", "w"]
    for key in ("w", "b"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["a"][0].numpy(), np.asarray(want["a"][0]),
                               rtol=RTOL, atol=ATOL)
    assert _report_fields(rep) == _report_fields(jrep)
    assert not rep.streamed and rep.monitor is None
    # tensors in, tensors out: the same round from torch pytrees
    tups = [{k: (torch.from_numpy(v) if k != "a" else [torch.from_numpy(v[0])])
             for k, v in u.items()} for u in ups]
    again, _ = ours.aggregate(updates=tups, weights=ws, template=template)
    np.testing.assert_allclose(again["w"].numpy(), got["w"].numpy(),
                               rtol=RTOL, atol=ATOL)


HALF_RTOL = 2e-2    # tests/test_kernels.py's bf16 tolerance


def _bf16_trees(seed, n):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16),
             "b": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16)}
            for _ in range(n)]


def test_in_memory_bf16_round_with_template_matches():
    """bf16 pytrees and a bf16 template, as a JAX caller holds them
    (ml_dtypes arrays): the fused vector and the fused bf16 tree match
    the reference's."""
    ups = _bf16_trees(14, 6)
    template = {"w": np.zeros((3, 5), ml_dtypes.bfloat16),
                "b": np.zeros((5,), ml_dtypes.bfloat16)}
    ws = np.random.default_rng(15).uniform(1, 9, size=(6,)).astype(np.float32)
    ours, theirs = _pair()
    got, rep = ours.aggregate(updates=ups, weights=ws)
    want, jrep = theirs.aggregate(updates=ups, weights=ws)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)
    assert _report_fields(rep) == _report_fields(jrep)
    got, _ = ours.aggregate(updates=ups, weights=ws, template=template)
    want, _ = theirs.aggregate(updates=ups, weights=ws, template=template)
    for key in ("w", "b"):
        assert got[key].dtype == torch.bfloat16
        assert str(np.asarray(want[key]).dtype) == "bfloat16"
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(want[key], np.float32),
                                   rtol=HALF_RTOL, atol=ATOL)


def test_bf16_pytree_store_round_matches():
    """bf16 pytrees written to the store, plain and compressed through
    the service's error-feedback quantizer, fuse as the reference's."""
    ups = _bf16_trees(16, 5)
    ws = [float(i + 1) for i in range(5)]
    for kw in ({}, {"compress": True}):
        ours, theirs = _pair(**kw)
        for svc in (ours, theirs):
            for i, (u, w) in enumerate(zip(ups, ws)):
                if kw:
                    u = svc.compress_update(f"c{i}", u)
                svc.store.write(f"c{i}", u, weight=w)
        got, rep = ours.aggregate(from_store=True)
        want, jrep = theirs.aggregate(from_store=True)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=RTOL, atol=ATOL)
        assert _report_fields(rep) == _report_fields(jrep)


@pytest.mark.parametrize("grad", [False, True], ids=["plain", "requires_grad"])
def test_in_memory_round_takes_tensor_weights(grad):
    """``weights`` may be a tensor (on any device; a CPU one here, a
    CUDA one in chip_smoke.py): the round matches the reference's with
    the same weights as numpy."""
    ups, ws = _updates(17, n=5, p=257)
    tw = torch.tensor(ws, dtype=torch.float64, requires_grad=grad)
    ours, theirs = _pair()
    got, rep = ours.aggregate(updates=ups, weights=tw)
    want, jrep = theirs.aggregate(updates=ups, weights=np.asarray(ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert _report_fields(rep) == _report_fields(jrep)


def test_in_memory_round_times_the_copy_in_compute(monkeypatch):
    """As in the reference, a dense round's ingest ends with the rows
    stacked on the host: the host-to-device copy is timed in compute."""
    from repro_torch.core import service as service_mod

    real = service_mod.updates_to_device

    def slow_copy(x, device):
        time.sleep(0.3)
        return real(x, device)

    monkeypatch.setattr(service_mod, "updates_to_device", slow_copy)
    ups, ws = _updates(18, n=4, p=129)
    _, rep = AggregationService(device="cpu").aggregate(updates=ups,
                                                        weights=ws)
    assert rep.phase_seconds["compute"] >= 0.3
    assert rep.phase_seconds["ingest"] < 0.3


def _spool(store, seed):
    ups, ws = _updates(seed, n=7, p=1025)
    for i, (u, w) in enumerate(zip(ups, ws)):
        store.write(f"d{i}", u, weight=w)
        store.write(f"h{i}", u.astype(ml_dtypes.bfloat16), weight=w,
                    tenant="half")
    return ups, ws


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_disk_spool_cross_read(tmp_path, writer):
    """A disk spool written by either package's store is read by the
    other's, and a round over it gives the same fused vector."""
    spool = str(tmp_path / "spool")
    first = JStore(backend="disk", spool_dir=spool) if writer == "repro" \
        else UpdateStore(backend="disk", spool_dir=spool)
    _spool(first, 5)
    if writer == "repro":
        from repro.core.compress import compress_update
    else:
        from repro_torch.core.compress import compress_update
    rng = np.random.default_rng(6)
    for i in range(5):
        first.write(f"q{i}", compress_update(
            rng.normal(size=(1025,)).astype(np.float32), 256),
            weight=float(i + 1), tenant="q")
    ts = UpdateStore(backend="disk", spool_dir=spool)
    js = JStore(backend="disk", spool_dir=spool)
    assert ts.tenants() == js.tenants() == ["default", "half", "q"]
    for tenant in ("default", "half", "q"):
        n, p, dt = ts.meta(tenant)
        jn, jp, jdt = js.meta(tenant)
        assert (n, p, dt.itemsize) == (jn, jp, jdt.itemsize)
        ours = AggregationService(store=ts, device="cpu",
                                  stream_chunk_bytes=3 * 1025 * 4)
        theirs = JService(store=js, stream_chunk_bytes=3 * 1025 * 4)
        got, rep = ours.aggregate(from_store=True, tenant=tenant)
        want, jrep = theirs.aggregate(from_store=True, tenant=tenant)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
        assert _report_fields(rep) == _report_fields(jrep)


def _fused_head(out: str) -> np.ndarray:
    m = re.search(r"fused\[:5\]=\[([^\]]*)\]", out)
    assert m, out
    return np.array([float(x) for x in m.group(1).split()])


def test_cli_matches_reference_cli():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    common = ["--model", "CNN4.6", "--clients", "8"]
    ours = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.aggregate", "--device",
         "cpu", "--local-strategy", "kernel", *common],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert ours.returncode == 0, ours.stderr
    theirs = subprocess.run(
        [sys.executable, "-m", "repro.launch.aggregate", *common],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert theirs.returncode == 0, theirs.stderr
    np.testing.assert_allclose(_fused_head(ours.stdout),
                               _fused_head(theirs.stdout), rtol=RTOL)
    assert "streamed=True" in ours.stdout and "device=cpu" in ours.stdout


def test_async_adaptive_cli_matches_reference_cli():
    """``--async-rounds --adaptive``: a writer thread spreads the clients
    over 0.2 s while each round is open. Which rows a round folds depends
    on thread timing, so both CLIs are held to the same gates: the static
    one first, then the learned one, every round streamed."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    common = ["--model", "CNN4.6", "--clients", "8", "--async-rounds",
              "--adaptive", "--rounds", "3", "--spread", "0.2"]
    gates = {}
    for name, cmd in (("ours", ["repro_torch.launch.aggregate", "--device",
                                "cpu"]),
                      ("theirs", ["repro.launch.aggregate"])):
        res = subprocess.run([sys.executable, "-m", *cmd, *common], env=env,
                             capture_output=True, text=True, timeout=300,
                             cwd=REPO)
        assert res.returncode == 0, res.stderr
        lines = [ln for ln in res.stdout.splitlines() if "gate=" in ln]
        assert len(lines) == 3, res.stdout
        assert all("streamed=True" in ln for ln in lines)
        overlaps = [float(re.search(r"overlap=([0-9.]+)s", ln).group(1))
                    for ln in lines]
        assert overlaps[0] > 0   # the first round opens on an empty store
        heads = re.findall(r"fused\[:5\]=\[([^\]]*)\]", res.stdout)
        assert len(heads) == 3 and all(
            np.isfinite([float(x) for x in h.split()]).all() for h in heads)
        gates[name] = [re.search(r"gate=(\w+)", ln).group(1)
                       for ln in lines]
    assert gates["ours"] == gates["theirs"] == ["static", "learned",
                                                "learned"]
    assert "adaptive(cost_bias=0.5)" in res.stdout


def test_concurrent_tenants_cli_reports_every_tenant():
    """``--concurrent-tenants 3``: three tenants' rounds on one store and
    one service through the RoundScheduler, one labelled report line
    and fused head a tenant and round, each tenant's head equal to the
    reference CLI's (every round waits for all 8 clients)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    common = ["--model", "CNN4.6", "--clients", "8", "--concurrent-tenants",
              "3", "--device-concurrency", "2", "--rounds", "2",
              "--spread", "0.2", "--threshold-frac", "1.0"]
    heads = {}
    for name, cmd in (("ours", ["repro_torch.launch.aggregate", "--device",
                                "cpu"]),
                      ("theirs", ["repro.launch.aggregate"])):
        res = subprocess.run([sys.executable, "-m", *cmd, *common], env=env,
                             capture_output=True, text=True, timeout=300,
                             cwd=REPO)
        assert res.returncode == 0, res.stderr
        lines = [ln for ln in res.stdout.splitlines() if "engine=" in ln]
        assert sorted(re.search(r"tenant=(\w+)", ln).group(1)
                      for ln in lines) == ["app0", "app0", "app1", "app1",
                                           "app2", "app2"], res.stdout
        assert all("streamed=True" in ln for ln in lines)
        heads[name] = {
            (rnd, t): np.array([float(x) for x in h.split()])
            for rnd, chunk in enumerate(res.stdout.split("round=")[1:])
            for t, h in re.findall(
                r"tenant=(\w+) fused\[:5\]=\[([^\]]*)\]", chunk)}
    assert "tenants=['app0', 'app1', 'app2']" in res.stdout
    assert sorted(heads["ours"]) == sorted(heads["theirs"])
    assert len(heads["ours"]) == 6
    for key, head in heads["ours"].items():
        np.testing.assert_allclose(head, heads["theirs"][key], rtol=RTOL,
                                   err_msg=str(key))


def test_mesh_and_the_other_options_build_a_service(tmp_path):
    """``mesh=`` (ported since) builds a service whose planner counts the
    mesh's devices, with a hierarchical engine when the mesh has a "pod"
    dim; secure aggregation and the async and adaptive options build
    beside it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "rendezvous"), 1),
        rank=0, world_size=1)
    try:
        for pod in (0, 1):
            mesh = make_local_mesh(1, 1, pod=pod, device_type="cpu")
            svc = AggregationService(device="cpu", adaptive=True,
                                     staleness_discount=0.5, mesh=mesh)
            assert svc.planner.n_devices == mesh.size() == 1
            assert svc.distributed is not None
            assert (svc.hierarchical is not None) == bool(pod)
            if pod:
                assert svc.hierarchical.hierarchical
                assert svc.hierarchical.client_axes == ("pod", "data")
    finally:
        dist.destroy_process_group()
    masking = SecureMasking(n_clients=4)
    assert AggregationService(device="cpu", adaptive=True,
                              staleness_discount=0.5,
                              secure=masking).secure is masking
    svc = AggregationService(device="cpu", adaptive=True, cost_bias=0.3,
                             staleness_discount=0.5)
    assert svc.controller is not None and svc.controller.cost_bias == 0.3
    row = np.arange(7, dtype=np.float32)
    svc.store.write("c0", row, weight=2.0)
    fused, rep = svc.aggregate(from_store=True, async_round=True)
    assert rep.async_round and rep.close_policy.source == "static"
    # "auto" finds the row landed and 28 bytes to fold: it serializes
    svc.store.write("c0", row, weight=2.0)
    fused, rep = svc.aggregate(from_store=True, async_round="auto")
    assert not rep.async_round and rep.close_policy.source == "learned"
    for r in svc.history:
        assert r.n_clients == 1
    np.testing.assert_allclose(fused.numpy(), row * 2.0 / (2.0 + 1e-6),
                               rtol=RTOL, atol=ATOL)


def test_workload_classes_on_the_card():
    """The three classes against the H100's tiers (on-chip 50 MB, 80 GB
    device memory with 75% headroom)."""
    small = Workload.for_params(1_000_000, 10)               # 40 MB
    mid = Workload.for_params(CNN_SUITE["Resnet50"].num_params, 48)
    big = Workload.for_params(CNN_SUITE["CNN956"].num_params, 256)
    assert classify(small) is WorkloadClass.ONCHIP_RESIDENT
    assert classify(mid) is WorkloadClass.HBM_LOCAL
    assert classify(big) is WorkloadClass.DISTRIBUTED
    comp = Workload.for_params(CNN_SUITE["CNN956"].num_params, 200,
                               compressed=True)
    assert classify(comp) is WorkloadClass.HBM_LOCAL
    assert max_clients_single_node(91_000_000) == int(
        H100_SXM.hbm_bytes * 0.75 // 91_000_000)


def test_pytree_order_is_jax_order():
    from collections import OrderedDict

    from repro.utils.pytree import tree_to_flat_vector as j_flat

    rng = np.random.default_rng(8)
    tree = {"z": rng.normal(size=(2, 3)).astype(np.float32),
            "a": [rng.normal(size=(4,)).astype(np.float32), None,
                  (rng.normal(size=(1,)).astype(np.float32),)],
            "m": OrderedDict([("y", np.ones(2, np.float32)),
                              ("b", np.zeros(1, np.float32))])}
    flat = tree_to_flat_vector(tree)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(j_flat(tree)))
    back = flat_vector_to_tree(flat, tree)
    np.testing.assert_array_equal(back["z"].numpy(), tree["z"])
    assert list(back["m"]) == ["y", "b"] and back["a"][1] is None
