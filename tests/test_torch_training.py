"""Federated training in the port against the JAX package: the chunked
loss, the decoders' loss and every gradient leaf against
``jax.value_and_grad(decoder_loss)`` with the same weights (carried
across by ``convert.decoder_state_from_numpy``), the client's local
steps, 3-round ``FederatedServer`` trajectories from the same initial
params, and twins of tests/test_system.py's training tests and of
tests/test_fault_tolerance.py's engine-independent trajectory.

On the CPU the attention wrappers run their plain versions (forward and
backward) and the fusions theirs; an autouse fixture checks that no
kernel launched.
"""
import collections
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from repro.configs import get_config as jget_config
from repro.core import AggregationService as JService
from repro.data import FederatedLoader as JLoader
from repro.data import SyntheticLM as JSyntheticLM
from repro.fl import Client as JClient
from repro.fl import FederatedServer as JServer
from repro.models import build_model as jbuild_model
from repro.models.base import cross_entropy as jcross_entropy
from repro.models.base import next_token_loss as jnext_token_loss
from repro.optim import sgd as jsgd
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.service import AggregationService
from repro_torch.data import FederatedLoader, SyntheticLM
from repro_torch.fl import Client, FederatedServer
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.fused_fusion import kernel as fk
from repro_torch.kernels.robust_fusion import kernel as rk
from repro_torch.models import build_model
from repro_torch.models.base import cross_entropy, next_token_loss
from repro_torch.optim import sgd

REPO = Path(__file__).resolve().parents[1]
# fp32 throughout. The loss: sums over a 1024-wide vocabulary taken in
# another order; gradients: the same products through other kernels
# (XLA's CPU dots against PyTorch's), relative to each leaf's scale.
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# tests/test_fault_tolerance.py:103-106, the reference's own trajectory
# tolerance
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_launches():
    for mod in (fa, fk, rk):
        mod.reset_launches()
    yield
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert set(fk.LAUNCHES.values()) == {0}
    assert set(rk.LAUNCHES.values()) == {0}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state(jparams, cfg):
    return convert.decoder_state_from_numpy(_np(jparams), cfg, device="cpu")


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


# -- the losses ---------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    want = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask))
    _close(got, want, "cross_entropy", **LOSS_TOL)


@pytest.mark.parametrize("T,tied", [(512, True), (300, True), (256, False),
                                    (7, False)])
def test_next_token_loss_matches_reference(T, tied):
    """Two 256-position chunks (T = 512), the one-chunk fallback of a T
    that 256 does not divide, one exact chunk, and an untied head: the
    shift, the masked last position and the chunked sums, value and
    gradients of h, embed and head."""
    rng = np.random.default_rng(T)
    B, d, V = 2, 16, 97
    h = rng.normal(size=(B, T, d)).astype(np.float32)
    embed = rng.normal(size=(V, d)).astype(np.float32) * 0.3
    head = None if tied else rng.normal(size=(d, V)).astype(np.float32) * 0.3
    labels = rng.integers(0, V, size=(B, T)).astype(np.int32)

    def jloss(h_, e_, hd_):
        return jnext_token_loss(h_, e_, hd_, jnp.asarray(labels))

    args = [jnp.asarray(h), jnp.asarray(embed),
            None if head is None else jnp.asarray(head)]
    argnums = (0, 1) if head is None else (0, 1, 2)
    want, wgrads = jax.value_and_grad(jloss, argnums=argnums)(*args)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (h, embed, head)
              if x is not None]
    got = next_token_loss(leaves[0], leaves[1],
                          leaves[2] if head is not None else None,
                          torch.from_numpy(labels))
    got.backward()
    _close(got, want, "loss", **LOSS_TOL)
    for name, t, w in zip(("h", "embed", "head"), leaves, wgrads):
        # an untied head leaves embed out of the graph: jax.grad's zeros
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        _close(g, w, name, rtol=1e-5, atol=1e-7)


def _batch(vocab, B, T, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, T))
    return {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32)}


def _jax_loss_and_grads(arch, batch, seed=1):
    cfg = jget_config(arch).reduced()
    model = jbuild_model(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(params,
                                                                    jb)
    return params, loss, grads


def _port_loss_and_grads(arch, jparams, batch, remat=True):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    leaves = collections.OrderedDict(
        (k, v.requires_grad_()) for k, v in _state(jparams, cfg).items())
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, metrics = functional_call(model, leaves, (tb,), {"remat": remat})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return cfg, model, loss, metrics, collections.OrderedDict(
        zip(leaves, grads))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-1b"])
def test_decoder_loss_and_grads_match_reference(arch):
    """The reduced Qwen2 (qkv bias, GQA) and Gemma3 (MQA, window 16 at T
    = 40) in fp32: the loss and every gradient leaf, the tied embedding's
    being the sum of its gather and LM-head parts as under jax.grad."""
    batch = _batch(1024, 2, 40, seed=3)
    jparams, jloss, jgrads = _jax_loss_and_grads(arch, batch)
    cfg, model, loss, metrics, grads = _port_loss_and_grads(arch, jparams,
                                                            batch)
    assert cfg.tie_embeddings
    _close(loss, jloss, "loss", **LOSS_TOL)
    assert metrics["ce"] is loss and float(metrics["moe_aux"]) == 0.0
    want = _state(jgrads, cfg)
    assert list(want) == list(grads)
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        _close(g, want[name].numpy(), name, rtol=GRAD_TOL["rtol"],
               atol=max(GRAD_TOL["atol"], 1e-5 * scale))
    # the served module's parameters are untouched by the loss
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-1b"])
def test_remat_on_and_off_give_equal_gradients(arch):
    """Checkpointed layers recompute from the tensors bound at forward
    time (the caller's, under functional_call): bit for bit the
    gradients of the plain graph."""
    batch = _batch(1024, 2, 24, seed=5)
    jparams = jbuild_model(jget_config(arch).reduced()).init(
        jax.random.PRNGKey(2))
    _, _, l1, _, g1 = _port_loss_and_grads(arch, jparams, batch, remat=True)
    _, _, l2, _, g2 = _port_loss_and_grads(arch, jparams, batch, remat=False)
    assert torch.equal(l1, l2)
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


# -- the client and the server -----------------------------------------------


def _tiny_cfgs(**over):
    kw = dict(vocab=128, n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
              d_ff=128, head_dim=32)
    kw.update(over)
    return (dataclasses.replace(get_config("qwen2-0.5b").reduced(), **kw),
            dataclasses.replace(jget_config("qwen2-0.5b").reduced(), **kw))


@pytest.mark.parametrize("send_delta", [False, True])
def test_client_train_round_matches_reference(send_delta):
    cfg, jcfg = _tiny_cfgs()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(4))
    gen = SyntheticLM(vocab=128, seed=0, temperature=0.5)
    jgen = JSyntheticLM(vocab=128, seed=0, temperature=0.5)
    batch_fn = lambda s: gen.sample(4, 24, rng_seed=s)  # noqa: E731
    jc = JClient(client_id=0, model=jmodel, optimizer=jsgd(0.5),
                 local_steps=3, send_delta=send_delta)
    jupd, jloss = jc.train_round(
        jparams, lambda s: {"tokens": jnp.asarray(jgen.sample(4, 24, s)),
                            "labels": jnp.asarray(jgen.sample(4, 24, s))}, 0)
    model = build_model(cfg, device="cpu")
    c = Client(client_id=0, model=model, optimizer=sgd(0.5), local_steps=3,
               send_delta=send_delta)
    params = _state(jparams, cfg)
    upd, loss = c.train_round(
        params, lambda s: {"tokens": batch_fn(s), "labels": batch_fn(s)}, 0)
    np.testing.assert_allclose(loss, float(jloss), **LOSS_TOL)
    want = _state(jupd, cfg)
    assert list(upd) == list(want)
    for name in want:
        assert upd[name].dtype == (torch.float32 if send_delta
                                   else params[name].dtype)
        _close(upd[name], want[name].numpy(), name, **TRAJ_TOL)
    assert not any(p.requires_grad for p in model.parameters())


def _servers(fusion, send_delta, n_clients=4, rounds=3, lr=0.5):
    """The reference's FederatedServer and the port's, from the same
    initial params (the reference's ``model.init(PRNGKey(0))``), on the
    same synthetic data and client selection."""
    cfg, jcfg = _tiny_cfgs()
    jmodel = jbuild_model(jcfg)
    jloader = JLoader(gen=JSyntheticLM(vocab=128, seed=0, temperature=0.5),
                      n_clients=n_clients, batch=8, seq_len=32)
    jserver = JServer(
        model=jmodel,
        clients=[JClient(client_id=i, model=jmodel, optimizer=jsgd(lr),
                         local_steps=2, send_delta=send_delta)
                 for i in range(n_clients)],
        loader=jloader, service=JService(fusion=fusion,
                                         local_strategy="jnp"),
        rng_seed=0, clients_per_round=3)
    model = build_model(cfg, device="cpu")
    loader = FederatedLoader(gen=SyntheticLM(vocab=128, seed=0,
                                             temperature=0.5),
                             n_clients=n_clients, batch=8, seq_len=32)
    server = FederatedServer(
        model=model,
        clients=[Client(client_id=i, model=model, optimizer=sgd(lr),
                        local_steps=2, send_delta=send_delta)
                 for i in range(n_clients)],
        loader=loader, service=AggregationService(fusion=fusion,
                                                  device="cpu"),
        rng_seed=0, clients_per_round=3, params=_state(jserver.params, cfg))
    return cfg, jserver, server


@pytest.mark.parametrize("fusion,send_delta", [("fedavg", False),
                                               ("gradavg", True)])
def test_federated_trajectory_matches_reference(fusion, send_delta):
    cfg, jserver, server = _servers(fusion, send_delta)
    for r in range(3):
        jres, res = jserver.run_round(r), server.run_round(r)
        assert res.n_selected == jres.n_selected == 3
        np.testing.assert_allclose(res.mean_client_loss,
                                   jres.mean_client_loss, rtol=1e-4)
        assert res.report.plan.engine == jres.report.plan.engine
    want = _state(jserver.params, cfg)
    for name in want:
        assert server.params[name].dtype == want[name].dtype
        _close(server.params[name], want[name].numpy(), name, **TRAJ_TOL)


# -- twins of tests/test_system.py:19-100 -----------------------------------


def _tiny_setup(fusion="fedavg", n_clients=4, local_steps=2, lr=0.5,
                send_delta=False, vocab=128):
    cfg, _ = _tiny_cfgs(vocab=vocab)
    model = build_model(cfg, device="cpu")
    gen = SyntheticLM(vocab=cfg.vocab, seed=0, temperature=0.5)
    loader = FederatedLoader(gen=gen, n_clients=n_clients, batch=8,
                             seq_len=32)
    clients = [
        Client(client_id=i, model=model, optimizer=sgd(lr),
               local_steps=local_steps, send_delta=send_delta)
        for i in range(n_clients)
    ]
    service = AggregationService(fusion=fusion, local_strategy="torch",
                                 device="cpu")
    return FederatedServer(model=model, clients=clients, loader=loader,
                           service=service)


def test_federated_training_converges():
    server = _tiny_setup()
    results = server.run(12)
    first = np.mean([r.mean_client_loss for r in results[:2]])
    last = np.mean([r.mean_client_loss for r in results[-2:]])
    assert last < first - 0.3, (first, last)


def test_gradavg_delta_path_converges():
    server = _tiny_setup(fusion="gradavg", send_delta=True, lr=0.5)
    results = server.run(12)
    first = np.mean([r.mean_client_loss for r in results[:2]])
    last = np.mean([r.mean_client_loss for r in results[-2:]])
    assert last < first - 0.2, (first, last)


def test_robust_fusion_survives_byzantine_client():
    server = _tiny_setup(fusion="coordmedian", n_clients=5)
    bad = server.clients[0]
    orig_round = bad.train_round

    def poisoned(global_params, batch_fn, round_idx):
        upd, loss = orig_round(global_params, batch_fn, round_idx)
        upd = collections.OrderedDict(
            (k, u + 100.0 * torch.sign(u)) for k, u in upd.items())
        return upd, loss

    bad.train_round = poisoned
    results = server.run(8)
    assert np.isfinite(results[-1].mean_client_loss)
    assert results[-1].mean_client_loss < results[0].mean_client_loss + 1.0


def test_round_reports_expose_plan():
    server = _tiny_setup()
    res = server.run_round(0)
    assert res.report.plan.engine == "local"
    assert res.report.plan.feasible
    assert res.n_selected == 4


def test_train_cli_runs(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "qwen2-0.5b", "--rounds", "2", "--clients", "2",
         "--local-steps", "1", "--batch", "2", "--seq-len", "16",
         "--save", str(tmp_path / "final")],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[round   1]" in r.stdout
    assert "saved params" in r.stdout
    assert os.path.exists(tmp_path / "final.npz")


# -- twin of tests/test_fault_tolerance.py:52 --------------------------------


def _engine_run(strategy, cap):
    cfg, _ = _tiny_cfgs(vocab=64, n_layers=1, d_model=32, n_heads=2,
                        n_kv_heads=1, d_ff=64, head_dim=32)
    model = build_model(cfg, device="cpu")
    loader = FederatedLoader(gen=SyntheticLM(vocab=64, seed=0), n_clients=3,
                             batch=4, seq_len=16)
    clients = [Client(client_id=i, model=model, optimizer=sgd(0.3),
                      local_steps=1) for i in range(3)]
    svc = AggregationService(fusion="fedavg", local_strategy=strategy,
                             memory_cap_bytes=cap, device="cpu")
    server = FederatedServer(model=model, clients=clients, loader=loader,
                             service=svc)
    server.run(3)
    assert 4 * sum(p.numel() for p in server.params.values()) > 40_000
    return server.params, server.results


@pytest.mark.parametrize("strategy,cap", [("torch", 2 * 400_000),
                                          ("torch", 40_000),
                                          ("kernel", None),
                                          ("kernel", 40_000)])
def test_training_trajectory_engine_independent(strategy, cap):
    """§IV-C, strong form: the same global params whichever engine fuses
    each round (the torch baseline or the kernels' route, dense or
    memory-capped). The reference's cap (800 kB) holds this round whole;
    40 kB is under one 58 kB update, so each round folds one row at a
    time. head_dim 32, the attention kernels' smallest (the reference's
    test uses 16)."""
    p_full, _ = _engine_run("torch", None)
    p_other, _ = _engine_run(strategy, cap)
    for name in p_full:
        np.testing.assert_allclose(p_full[name].float().numpy(),
                                   p_other[name].float().numpy(), **TRAJ_TOL)
