"""Federated training of the Mamba2 / shared-attention hybrid in the port
against the JAX package: the reduced Zamba2's loss and every gradient
leaf (the fp32 SSM parameters dt_bias, a_log, d_skip and norm_scale
included) against ``jax.value_and_grad(zamba_loss)`` with the same
weights (carried across by ``convert.zamba_state_from_numpy``), remat on
and off, the kernels' wrappers against the plain versions, the client's
local steps against the reference's, and the train CLI.

On the CPU the scan's and the attention's wrappers run their plain
versions (forward and backward); an autouse fixture checks that no
kernel launched.
"""
import collections
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
from repro.data import SyntheticLM as JSyntheticLM
from repro.fl import Client as JClient
from repro.models import build_model as jbuild_model
from repro.optim import sgd as jsgd
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.fl import Client
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.fused_fusion import kernel as fk
from repro_torch.kernels.ssd_chunk import kernel as sk
from repro_torch.kernels.ssd_chunk.ops import ssd_scan_train_ref
from repro_torch.models import build_model
from repro_torch.models.layers.attention import attention_train_ref
from repro_torch.optim import sgd

REPO = Path(__file__).resolve().parents[1]
ARCH = "zamba2-1.2b"
# tests/test_torch_training.py's limits: fp32 throughout; the loss sums
# over a 1024-wide vocabulary in another order, the gradients are the
# same products through other kernels, relative to each leaf's scale
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
SSM_FP32 = ("dt_bias", "a_log", "d_skip")


@pytest.fixture(autouse=True)
def _no_launches():
    for mod in (fa, fk, sk):
        mod.reset_launches()
    yield
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert sk.LAUNCHES == {"ssd_chunk": 0, "ssd_chunk_bwd": 0}
    assert set(fk.LAUNCHES.values()) == {0}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(B, T, seed):
    toks = np.random.default_rng(seed).integers(0, 1024, size=(B, T))
    return {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32)}


def _jax_params(seed=1):
    cfg = jget_config(ARCH).reduced()
    model = jbuild_model(cfg)
    return model, model.init(jax.random.PRNGKey(seed))


def _port_loss_and_grads(jparams, batch, **kw):
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    state = convert.zamba_state_from_numpy(_np(jparams), cfg, device="cpu")
    leaves = collections.OrderedDict(
        (k, v.requires_grad_()) for k, v in state.items())
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, metrics = functional_call(model, leaves, (tb,), kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return cfg, model, loss, metrics, collections.OrderedDict(
        zip(leaves, grads))


@pytest.mark.parametrize("T", [48, 40])
def test_zamba_loss_and_grads_match_reference(T):
    """The reduced Zamba2 (2 Mamba layers, the shared block after each,
    N = P = 16, window 16) in fp32: three chunks of 16 (T = 48) or the
    one chunk of T = 40; the loss and every gradient leaf, the tied
    embedding's being the sum of its gather and LM-head parts."""
    jmodel, jparams = _jax_params()
    batch = _batch(2, T, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, jb)
    cfg, model, loss, metrics, grads = _port_loss_and_grads(jparams, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    assert set(metrics) == {"ce"} and metrics["ce"] is loss
    want = convert.zamba_state_from_numpy(_np(jgrads), cfg, device="cpu")
    assert list(want) == list(grads)
    for name, g in grads.items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(
            g.numpy(), w, err_msg=name, rtol=GRAD_TOL["rtol"],
            atol=max(GRAD_TOL["atol"], 1e-5 * scale))
    # every parameter gets a gradient, the fp32 SSM ones included
    for i in range(cfg.n_layers):
        for field in SSM_FP32 + ("norm_scale",):
            g = grads[f"mamba.{i}.cell.{field}"]
            assert torch.all(torch.isfinite(g)) and g.abs().max() > 0, field
            if field in SSM_FP32:
                assert g.dtype == torch.float32
    # the served module's parameters are untouched by the loss
    assert not any(p.requires_grad for p in model.parameters())


def test_remat_on_and_off_give_equal_gradients():
    """Checkpointed Mamba layers and shared-block call points recompute
    from the tensors bound at forward time: bit for bit the gradients of
    the plain graph."""
    _, jparams = _jax_params(seed=2)
    batch = _batch(2, 32, seed=5)
    _, _, l1, _, g1 = _port_loss_and_grads(jparams, batch, remat=True)
    _, _, l2, _, g2 = _port_loss_and_grads(jparams, batch, remat=False)
    assert torch.equal(l1, l2)
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


def test_kernel_wrappers_equal_the_plain_versions_on_cpu():
    """``Zamba.loss``'s defaults (``ssd_scan_train``,
    ``flash_attention_train``) run the plain versions on CPU tensors: the
    same bits as passing those explicitly."""
    _, jparams = _jax_params(seed=4)
    batch = _batch(2, 32, seed=7)
    _, _, l1, _, g1 = _port_loss_and_grads(jparams, batch)
    _, _, l2, _, g2 = _port_loss_and_grads(
        jparams, batch, ssd=ssd_scan_train_ref, attention=attention_train_ref)
    assert torch.equal(l1, l2)
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


@pytest.mark.parametrize("send_delta", [False, True])
def test_client_train_round_matches_reference(send_delta):
    """Two local SGD steps of the reduced Zamba2 on the same synthetic
    batches: the update (weights, or the fp32 delta) and the last loss."""
    jmodel, jparams = _jax_params(seed=4)
    gen = SyntheticLM(vocab=1024, seed=0, temperature=0.5)
    jgen = JSyntheticLM(vocab=1024, seed=0, temperature=0.5)
    jc = JClient(client_id=0, model=jmodel, optimizer=jsgd(0.5),
                 local_steps=2, send_delta=send_delta)
    jupd, jloss = jc.train_round(
        jparams, lambda s: {"tokens": jnp.asarray(jgen.sample(2, 32, s)),
                            "labels": jnp.asarray(jgen.sample(2, 32, s))}, 0)
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    c = Client(client_id=0, model=model, optimizer=sgd(0.5), local_steps=2,
               send_delta=send_delta)
    params = convert.zamba_state_from_numpy(_np(jparams), cfg, device="cpu")
    upd, loss = c.train_round(
        params, lambda s: {"tokens": gen.sample(2, 32, rng_seed=s),
                           "labels": gen.sample(2, 32, rng_seed=s)}, 0)
    np.testing.assert_allclose(loss, float(jloss), **LOSS_TOL)
    want = convert.zamba_state_from_numpy(_np(jupd), cfg, device="cpu")
    assert list(upd) == list(want)
    for name in want:
        assert upd[name].dtype == (torch.float32 if send_delta
                                   else params[name].dtype)
        np.testing.assert_allclose(upd[name].numpy(), want[name].numpy(),
                                   err_msg=name, **TRAJ_TOL)
    assert not any(p.requires_grad for p in model.parameters())


def test_train_cli_trains_reduced_zamba_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", ARCH, "--rounds", "1", "--clients", "2",
         "--local-steps", "1", "--batch", "2", "--seq-len", "32"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "arch=zamba2-1.2b-smoke" in res.stdout
    assert "[round   0] loss=" in res.stdout
    assert "engine=" in res.stdout
