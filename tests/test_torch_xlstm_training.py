"""Federated training of xLSTM in the port against the JAX package: the
sLSTM cell's gradient where its normalizer sits at its 1e-6 floor, the
loss and every gradient leaf of whole models (the fp32 gate leaves
``w_if``, ``b_if``, ``r`` and ``b`` included) against
``jax.value_and_grad`` of the reference's loss with the same weights
(carried across by ``convert.xlstm_state_from_numpy``), remat on and
off, bf16, the client's local steps against the reference's, and the
train CLI.

Tolerances: the cell at 1e-6; the models in fp32 with the loss at 1e-5
and each gradient leaf at rtol 1e-4 and an atol of a share of the
leaf's largest magnitude, each config's in ``CONFIGS``: 1e-5 for the
smoke model, 1e-4 for the eight-block and mLSTM-only models. That share
is fp32 rounding, amplified by the model's own sensitivity, which grows
as mLSTM blocks follow one another: at the smoke width and 2 x 48
tokens the exact (float64) gradient moves 3.7 times as far as the
weights with one mLSTM block, 101 times with two in a row and 2,674
with four, and 6.6 and 14.6 times with an sLSTM block after each
(``tools/xlstm_grad_conditioning.py --device cpu --arch
xlstm-350m-smoke 1:0:2x48 2:0:2x48 4:0:2x48 2:2:2x48 4:2:2x48``). The
worst share each config needs (printed by
``test_loss_and_grads_match_reference``; ``pytest -s`` shows it) read
3.6e-6 (smoke, T 48), 1.8e-6 (smoke, T 40), 1.5e-5 (eight blocks) and
1.3e-5 (mLSTM only) on an x86 host at one thread, and
``test_fp32_gradients_within_rounding_of_float64`` holds both packages'
fp32 gradients of the deep configs within 1e-4 of the same model
evaluated in float64 (the port reads 6.7e-5 at eight blocks). The
client's two steps move each leaf by the learning rate times the smoke
model's gradients, the second at weights the first moved, and are held
at ``CLIENT_SHARE`` = 5e-5 of how far they moved it (the worst share
read 1.7e-5 for the weights and 1.1e-5 for the delta; the test prints
it). bf16 at the
reference's bf16 bound 5e-2 for the loss and a cosine of 0.99 for the
whole gradient. The model reaches no kernel; an autouse fixture checks
that none launched.
"""
import collections
import math
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

from repro.data import SyntheticLM as JSyntheticLM
from repro.fl import Client as JClient
from repro.models import build_model as jbuild_model
from repro.models.layers import xlstm_layers as jx
from repro.optim import sgd as jsgd
from repro_torch import convert
from repro_torch.data import SyntheticLM
from repro_torch.fl import Client
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.kernels.fused_fusion import kernel as fk
from repro_torch.kernels.ssd_chunk import kernel as sk
from repro_torch.models import build_model
from repro_torch.models.layers import xlstm_layers as tx
from repro_torch.optim import sgd
from test_torch_xlstm import NARROW, SMOKE, _configs, _np, _slstm

REPO = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
SMOKE_SHARE = 1e-5    # of a leaf's largest magnitude: fp32 rounding
DEEP_SHARE = 1e-4
CLIENT_SHARE = 5e-5
CELL_TOL = 1e-6
GATES_FP32 = {"mlstm": ("w_if", "b_if"), "slstm": ("r", "b")}
# (config changes, T, gradient share): the smoke model (1 mLSTM + 1
# sLSTM block, chunk 16) in three chunks of 16 and in the one chunk of
# 40 that the chunk rule makes of T = 40; two segments of 3 mLSTM + 1
# sLSTM; mLSTM only
CONFIGS = {
    "smoke-3-chunks": ({}, 48, SMOKE_SHARE),
    "smoke-one-chunk-of-40": ({}, 40, SMOKE_SHARE),
    "8-layers-every-4": (dict(NARROW, slstm_every=4), 32, DEEP_SHARE),
    "every-0": (dict(n_layers=3, slstm_every=0), 20, DEEP_SHARE),
}


@pytest.fixture(autouse=True)
def _no_launches():
    for mod in (fa, fd, fk, sk):
        mod.reset_launches()
    yield
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert fd.LAUNCHES == {"flash_decode": 0}
    assert fk.LAUNCHES == {"weighted_sum": 0, "weighted_sum_dequant": 0}
    assert sk.LAUNCHES == {"ssd_chunk": 0, "ssd_chunk_bwd": 0}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small CPU tensors (many workers
    share the host under a parallel run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the sLSTM cell at its normalizer floor -----------------------------------


def test_slstm_cell_gradient_at_the_normalizer_floor():
    """A state whose normalizer sits at the 1e-6 floor and stays there:
    the forget gate saturates (f = 1 exactly, the forget term sets the
    stabilizer) and i_raw sits 60 below it, so n = f n + i rounds to
    1e-6 again. ``jnp.maximum(n, 1e-6)`` passes half the gradient to
    each side of that tie; the port must do the same. The gradients of
    the new h with respect to the pre-activation and to every state leaf
    against ``jax.grad`` of the reference's ``_slstm_cell``."""
    jd, p, td, _ = _slstm(12)
    rng = np.random.default_rng(13)
    B, d = 3, jd.d_model
    shape = (B, jd.n_heads, jd.h)
    c = (rng.choice([-1.0, 1.0], size=shape) * 1e-3).astype(np.float32)
    n = np.full(shape, 1e-6, np.float32)
    m = np.zeros(shape, np.float32)
    h = (rng.normal(size=shape) * 0.1).astype(np.float32)
    pre = rng.normal(size=(B, 4, d)).astype(np.float32)
    pre[:, 0], pre[:, 1] = -60.0, 40.0          # i_raw, f_raw
    pre = pre.reshape(B, 4 * d)
    wt = rng.normal(size=shape).astype(np.float32)
    args = (pre, c, n, m, h)

    def jloss(pre, c, n, m, h):
        new = jx._slstm_cell(p, jd, jx.SLSTMState(c, n, m, h), pre)
        return jnp.sum(new.h * wt), new.n

    jgrads, jn = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4),
                                  has_aux=True))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    new = tx._slstm_cell(tx._recurrent(torch.from_numpy(np.array(p.r))),
                         tx.SLSTMState(*leaves[1:]), leaves[0])
    # the normalizer is at the floor after the step, in both packages
    floor = np.float32(1e-6)
    assert np.all(np.asarray(jn) == floor)
    assert torch.all(new.n == floor)
    grads = torch.autograd.grad((new.h * torch.from_numpy(wt)).sum(), leaves)
    for name, g, w in zip(("pre", "c", "n", "m", "h"), grads, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, err_msg=name, rtol=CELL_TOL,
            atol=CELL_TOL * float(np.abs(w).max()))


# -- whole models ---------------------------------------------------------------


def _jax_pair(changes, seed=1):
    """(port config, reference model, reference params)."""
    jcfg, cfg = _configs(changes)
    jmodel = jbuild_model(jcfg)
    return cfg, jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(seed))


def _batch(B, T, seed, vocab=1024):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, T))
    return {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32)}


def _jax_loss_and_grads(jmodel, jparams, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, jb)
    return float(loss), grads


def _port_loss_and_grads(cfg, jparams, batch, dtype=None, **kw):
    """The port's loss and gradients at the reference's weights (cast to
    ``dtype`` if given), as a ``Client`` step takes them:
    ``functional_call`` on leaf tensors that require grad."""
    model = build_model(cfg, device="cpu")
    state = convert.xlstm_state_from_numpy(_np(jparams), cfg, device="cpu")
    leaves = collections.OrderedDict(
        (k, v.to(dtype or v.dtype).requires_grad_())
        for k, v in state.items())
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, metrics = functional_call(model, leaves, (tb,), kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return model, loss, metrics, collections.OrderedDict(zip(leaves, grads))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_reference(name):
    """The loss and every gradient leaf in fp32, the tied embedding's
    being the sum of its gather and LM-head parts, each leaf within its
    config's share; prints the least share that would hold."""
    changes, T, share = CONFIGS[name]
    cfg, jmodel, jparams = _jax_pair(changes)
    batch = _batch(2, T, seed=T)
    jloss, jgrads = _jax_loss_and_grads(jmodel, jparams, batch)
    model, loss, metrics, grads = _port_loss_and_grads(cfg, jparams, batch)
    np.testing.assert_allclose(loss.item(), jloss, **LOSS_TOL)
    assert set(metrics) == {"ce"} and metrics["ce"] is loss
    want = convert.xlstm_state_from_numpy(_np(jgrads), cfg, device="cpu")
    assert list(want) == list(grads)
    needed = {}
    for key, g in grads.items():
        w = want[key].numpy()
        scale = float(np.abs(w).max())
        over = (np.abs(g.numpy().astype(np.float64) - w)
                - GRAD_TOL["rtol"] * np.abs(w))
        needed[key] = max(float(over.max()), 0.0) / scale
        np.testing.assert_allclose(
            g.numpy(), w, err_msg=key, rtol=GRAD_TOL["rtol"],
            atol=max(GRAD_TOL["atol"], share * scale))
        assert torch.all(torch.isfinite(g)) and g.abs().max() > 0, key
    worst = max(needed, key=needed.get)
    print(f"{name}: worst share {needed[worst]:.3e} ({worst}), "
          f"limit {share:g}")
    # the fp32 gate leaves get fp32 gradients through functional_call
    for i, block in enumerate(model.blocks):
        for field in GATES_FP32[block.kind]:
            assert grads[f"blocks.{i}.cell.{field}"].dtype == torch.float32
    # the served module's parameters are untouched by the loss
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("name", ["8-layers-every-4", "every-0"])
def test_fp32_gradients_within_rounding_of_float64(name):
    """The ground under ``DEEP_SHARE``: at the deepest configs both
    packages' fp32 gradients lie within ``DEEP_SHARE`` of each leaf's
    largest magnitude of the port's gradients of a float64 tree (which
    the port computes in float64 throughout), and the loss within
    1e-6."""
    changes, T, share = CONFIGS[name]
    cfg, jmodel, jparams = _jax_pair(changes)
    batch = _batch(2, T, seed=T)
    jloss, jgrads = _jax_loss_and_grads(jmodel, jparams, batch)
    _, loss, _, grads = _port_loss_and_grads(cfg, jparams, batch)
    _, loss64, _, exact = _port_loss_and_grads(cfg, jparams, batch,
                                               dtype=torch.float64)
    assert loss64.dtype == torch.float64
    assert all(g.dtype == torch.float64 for g in exact.values())
    jgrads = convert.xlstm_state_from_numpy(_np(jgrads), cfg, device="cpu")
    for got in (loss.item(), jloss):
        np.testing.assert_allclose(got, loss64.item(), rtol=1e-6)
    for key, g in exact.items():
        scale = g.abs().max().item()
        for pkg, got in (("port", grads[key]), ("reference", jgrads[key])):
            err = (got.double() - g).abs().max().item()
            assert err <= share * scale, (pkg, key, err / scale)


def test_remat_on_and_off_give_equal_gradients():
    """Checkpointed mLSTM blocks recompute from the tensors bound at
    forward time: bit for bit the loss and gradients of the plain graph
    (two segments, so sLSTM blocks sit between checkpointed ones)."""
    changes, T, _ = CONFIGS["8-layers-every-4"]
    cfg, _, jparams = _jax_pair(changes, seed=2)
    batch = _batch(2, T, seed=5)
    _, l1, _, g1 = _port_loss_and_grads(cfg, jparams, batch, remat=True)
    _, l2, _, g2 = _port_loss_and_grads(cfg, jparams, batch, remat=False)
    assert torch.equal(l1, l2)
    assert list(g1) == list(g2)
    for key in g1:
        assert torch.equal(g1[key], g2[key]), key


def test_bf16_loss_and_gradient_match_reference():
    """The smoke model in bf16 (the gate leaves fp32): the loss at the
    reference's bf16 bound and the cosine of the whole gradient, in
    float64, against the reference's bf16 ``value_and_grad``."""
    cfg, jmodel, jparams = _jax_pair(dict(dtype="bfloat16"), seed=3)
    batch = _batch(2, 32, seed=9)
    jloss, jgrads = _jax_loss_and_grads(jmodel, jparams, batch)
    _, loss, _, grads = _port_loss_and_grads(cfg, jparams, batch)
    np.testing.assert_allclose(loss.item(), jloss, rtol=5e-2)
    want = convert.xlstm_state_from_numpy(_np(jgrads), cfg, device="cpu")
    dot = na = nb = 0.0
    for key, g in grads.items():
        assert g.dtype == want[key].dtype, key
        a, b = g.double().reshape(-1), want[key].double().reshape(-1)
        assert torch.all(torch.isfinite(a)), key
        dot += float(a @ b)
        na += float(a @ a)
        nb += float(b @ b)
    assert dot / math.sqrt(na * nb) >= 0.99


@pytest.mark.parametrize("send_delta", [False, True])
def test_client_train_round_matches_reference(send_delta):
    """Two local SGD steps of the smoke model on the same synthetic
    batches (two chunks of 16 each): the update (weights, or the fp32
    delta; each leaf within ``CLIENT_SHARE`` of how far the steps moved
    it) and the last loss; prints the least share that would hold."""
    cfg, jmodel, jparams = _jax_pair({}, seed=4)
    gen = SyntheticLM(vocab=cfg.vocab, seed=0, temperature=0.5)
    jgen = JSyntheticLM(vocab=cfg.vocab, seed=0, temperature=0.5)
    jc = JClient(client_id=0, model=jmodel, optimizer=jsgd(0.5),
                 local_steps=2, send_delta=send_delta)
    jupd, jloss = jc.train_round(
        jparams, lambda s: {"tokens": jnp.asarray(jgen.sample(2, 32, s)),
                            "labels": jnp.asarray(jgen.sample(2, 32, s))}, 0)
    model = build_model(cfg, device="cpu")
    c = Client(client_id=0, model=model, optimizer=sgd(0.5), local_steps=2,
               send_delta=send_delta)
    params = convert.xlstm_state_from_numpy(_np(jparams), cfg, device="cpu")
    upd, loss = c.train_round(
        params, lambda s: {"tokens": gen.sample(2, 32, rng_seed=s),
                           "labels": gen.sample(2, 32, rng_seed=s)}, 0)
    np.testing.assert_allclose(loss, float(jloss), **LOSS_TOL)
    want = convert.xlstm_state_from_numpy(_np(jupd), cfg, device="cpu")
    assert list(upd) == list(want)
    needed = {}
    for key in want:
        assert upd[key].dtype == (torch.float32 if send_delta
                                  else params[key].dtype)
        moved = (want[key] - (0 if send_delta else params[key])).abs().max()
        w = want[key].double()
        over = (upd[key].double() - w).abs() - TRAJ_TOL["rtol"] * w.abs()
        needed[key] = max(over.max().item(), 0.0) / moved.item()
        np.testing.assert_allclose(
            upd[key].numpy(), want[key].numpy(), err_msg=key,
            rtol=TRAJ_TOL["rtol"],
            atol=max(TRAJ_TOL["atol"], CLIENT_SHARE * moved.item()))
    worst = max(needed, key=needed.get)
    print(f"send_delta={send_delta}: worst share {needed[worst]:.3e} "
          f"({worst}), limit {CLIENT_SHARE:g}")
    assert not any(p.requires_grad for p in model.parameters())


def test_train_cli_trains_reduced_xlstm_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "xlstm-350m", "--rounds", "1", "--clients", "2",
         "--local-steps", "1", "--batch", "2", "--seq-len", "32"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"arch={SMOKE}" in res.stdout
    assert "[round   0] loss=" in res.stdout
    assert "engine=" in res.stdout
