"""The port's MoE layer against ``repro.models.layers.moe``, and the MoE
and head-dim-128 decoders against ``repro``'s on their smoke configs.

The layer at tests/test_moe.py's rtol 2e-4 / atol 2e-5 (fp32, the same
seeded numpy inputs and JAX-initialised parameters): the scatter path
where capacity drops assignments and where it drops none, the dense mix,
``moe``'s dispatch on T == 1, the load-balance loss, ranks in an expert,
the capacity, and routing ties (the lower expert index first, as
``jax.lax.top_k``). The decoders: the loss, its ``moe_aux`` and every
gradient leaf against ``jax.value_and_grad(decoder_loss)`` with the
parameters carried across by ``convert.decoder_state_from_numpy``.
Prefill and decode of the same models are cases of
tests/test_torch_decoder.py; their fusion and generation cases of
tests/test_torch_generate.py.

On the CPU the attention wrappers run their plain versions; an autouse
fixture checks that no kernel launched.
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
from hypothesis import given, settings, strategies as st
from torch.func import functional_call

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.layers import moe as jmoe
from repro.utils import tree_num_params
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.models import build_model
from repro_torch.models.decoder import Decoder
from repro_torch.models.layers import moe

REPO = Path(__file__).resolve().parents[1]
MOE_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_moe.py:35-36
# tests/test_torch_training.py's: the loss, and gradients relative to
# each leaf's scale
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _no_launches():
    fa.reset_launches()
    fd.reset_launches()
    yield
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert fd.LAUNCHES == {"flash_decode": 0}


def _setup(E=4, d=32, ff=64, shared=1, skew=False):
    """tests/test_moe.py's layer: JAX-initialised parameters and (4, 16,
    d) inputs. With ``skew`` every input leans towards expert 0, so that
    its buffer overflows at capacity factor 1.25."""
    jp = jmoe.init_moe(jax.random.PRNGKey(0), d, ff, E, shared, jnp.float32)
    x = np.random.default_rng(13).normal(size=(4, 16, d)) * 0.5
    if skew:
        router = np.asarray(jp.router).copy()
        router[:, 0] = np.abs(router[:, 0])
        jp = jp._replace(router=jnp.asarray(router))
        x = np.abs(x) + 0.5
    x = x.astype(np.float32)
    return jp, x, _port_moe(jp, d, ff, E, shared)


def _port_moe(jp, d, ff, E, shared) -> moe.MoE:
    p = moe.MoE(d, ff, E, shared, torch.float32, device="cpu")
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(p, name).copy_(torch.from_numpy(
                np.array(getattr(jp, name))))
        if shared:
            for name in ("w_gate", "w_up", "w_down"):
                getattr(p.shared, name).copy_(torch.from_numpy(
                    np.array(getattr(jp.shared, name))))
    return p


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or MOE_TOL))


# -- the layer ----------------------------------------------------------------


@pytest.mark.parametrize("skew,cf", [(True, 1.25), (False, 0.5)])
def test_scatter_path_with_drops_matches_reference(skew, cf):
    """Assignments ranked past an expert's capacity are dropped, the same
    ones in both packages: at the configs' 1.25 on inputs that crowd one
    expert, and at 0.5 on tests/test_moe.py's inputs."""
    jp, x, p = _setup(skew=skew)
    n = x.shape[0] * x.shape[1]
    _, idx, _ = moe.route(torch.from_numpy(x).reshape(n, -1), p.router, 2)
    pos = moe.positions_in_expert(idx.reshape(-1), 4)
    cap = moe.capacity(n, 2, 4, cf)
    assert int((pos >= cap).sum()) > 0      # drops happen
    want, waux = jmoe._moe_scatter(jp, jnp.asarray(x), 2, cf)
    got, aux = moe.moe_scatter(p, torch.from_numpy(x), 2, cf)
    _close(got, want)
    _close(aux, waux, rtol=1e-5, atol=0)
    # the dropped assignments are what sets it apart from the dense mix
    dense, _ = moe.moe_dense_mix(p, torch.from_numpy(x), 2)
    assert not torch.allclose(got, dense, rtol=2e-4, atol=2e-5)


def test_scatter_path_without_drops_matches_reference_and_dense_mix():
    """tests/test_moe.py:30-37 on the port: at capacity factor 8 nothing
    drops and the scatter path equals the dense mix."""
    jp, x, p = _setup()
    want, waux = jmoe._moe_scatter(jp, jnp.asarray(x), 2, 8.0)
    got, aux = moe.moe_scatter(p, torch.from_numpy(x), 2, 8.0)
    _close(got, want)
    _close(aux, waux, rtol=1e-5, atol=0)
    dense, daux = moe.moe_dense_mix(p, torch.from_numpy(x), 2)
    _close(got, dense.numpy())
    _close(aux, daux.numpy(), rtol=1e-5, atol=0)


@pytest.mark.parametrize("T", [1, 16])
def test_dense_mix_and_dispatch_match_reference(T):
    """The dense mix on a decode step's one token a sequence and on
    (4, 16); ``moe`` takes it for T == 1 and the scatter path else."""
    jp, x, p = _setup()
    x = np.ascontiguousarray(x[:, :T])
    want, waux = jmoe._moe_dense_mix(jp, jnp.asarray(x), 2)
    got, aux = moe.moe_dense_mix(p, torch.from_numpy(x), 2)
    _close(got, want)
    _close(aux, waux, rtol=1e-5, atol=0)
    want, waux = jmoe.moe(jp, jnp.asarray(x), 2, 1.25)
    got, aux = moe.moe(p, torch.from_numpy(x), 2, 1.25)
    _close(got, want)
    _close(aux, waux, rtol=1e-5, atol=0)


def test_no_shared_experts():
    jp, x, p = _setup(shared=0)
    assert p.shared is None and jp.shared is None
    for T in (1, 16):
        xt = np.ascontiguousarray(x[:, :T])
        want, _ = jmoe.moe(jp, jnp.asarray(xt), 2, 1.25)
        got, _ = moe.moe(p, torch.from_numpy(xt), 2, 1.25)
        _close(got, want)


@pytest.mark.parametrize("n,k,E", [(64, 2, 4), (300, 6, 64), (7, 1, 3)])
def test_aux_loss_matches_reference(n, k, E):
    rng = np.random.default_rng(n)
    logits = rng.normal(size=(n, E)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    want = jmoe._aux_loss(jnp.asarray(probs), jnp.asarray(idx, jnp.int32), E)
    got = moe.aux_loss(torch.from_numpy(probs), torch.from_numpy(idx), E)
    _close(got, want, rtol=1e-6, atol=0)


def test_routing_matches_reference():
    """Gate values, indices and probabilities of random tokens, top 6 of
    64 as DeepSeek-MoE routes."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(50, 32)).astype(np.float32)
    router = (rng.normal(size=(32, 64)) * 32 ** -0.5).astype(np.float32)
    wv, wi, wp = jmoe._route(jnp.asarray(x), jnp.asarray(router), 6)
    gv, gi, gp = moe.route(torch.from_numpy(x), torch.from_numpy(router), 6)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gv, wv, rtol=1e-5, atol=1e-7)
    _close(gp, wp, rtol=1e-5, atol=1e-7)


def test_routing_ties_go_to_the_lower_index():
    """Experts 2 and 3 copy the router columns of 0 and 1, and the logits
    are exact in fp32 (small integers times multiples of 1/8), so every
    probability ties with another; the top 2 and 3 are the tied pairs in
    ascending index order, as ``jax.lax.top_k`` returns them."""
    rng = np.random.default_rng(8)
    x = rng.integers(-3, 4, size=(40, 16)).astype(np.float32)
    cols = rng.integers(-4, 5, size=(16, 2)).astype(np.float32) / 8
    router = np.concatenate([cols, cols], axis=1)
    for k in (2, 3):
        wv, wi, _ = jmoe._route(jnp.asarray(x), jnp.asarray(router), k)
        gv, gi, _ = moe.route(torch.from_numpy(x), torch.from_numpy(router),
                              k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        _close(gv, wv, rtol=1e-6, atol=0)
        first = np.where(x @ cols[:, 0] >= x @ cols[:, 1], 0, 1)
        assert (gi[:, 0].numpy() == first).all()
        assert (gi[:, 1].numpy() == first + 2).all()


def test_positions_in_expert_are_dense_ranks():
    """tests/test_moe.py:55-59: per expert, ranks 0..count-1 in order of
    appearance."""
    idx = torch.tensor([2, 0, 2, 1, 0, 2])
    assert moe.positions_in_expert(idx, 3).tolist() == [0, 0, 1, 0, 1, 2]


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 300), k=st.integers(1, 4), E=st.integers(2, 16),
       seed=st.integers(0, 2 ** 16))
def test_positions_in_expert_match_reference(n, k, E, seed):
    """tests/test_moe.py's hypothesis bounds on n, k and E: ranks of n k
    assignments drawn at random, experts left empty included."""
    idx = np.random.default_rng(seed).integers(0, E, size=n * k)
    want = np.asarray(jmoe._positions_in_expert(
        jnp.asarray(idx, jnp.int32), E))
    got = moe.positions_in_expert(torch.from_numpy(idx), E)
    np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 300), k=st.integers(1, 4), E=st.integers(2, 16),
       cf=st.floats(0.5, 4.0))
def test_capacity_matches_reference(n, k, E, cf):
    """tests/test_moe.py:62-70's bounds and the reference's value."""
    c = moe.capacity(n, k, E, cf)
    assert c == jmoe._capacity(n, k, E, cf)
    assert c % 8 == 0
    assert c >= min(8, n * k)
    assert c <= -(-max(n * k, 8) // 8) * 8


@pytest.mark.parametrize("n", [2 * 512, 4 * 1024])
def test_no_drop_capacity_factor(n):
    """For DeepSeek-MoE's top 6 of 64, E / top_k gives every expert room
    for all n tokens of a prefill (n a multiple of 8; the capacity factor
    of the card's prefill-vs-decode check), and the config's 1.25 gives
    it far less."""
    m = get_config("deepseek-moe-16b").moe
    assert moe.capacity(n, m.top_k, m.n_experts, m.capacity_factor) < n / 3
    assert moe.capacity(n, m.top_k, m.n_experts,
                        m.n_experts / m.top_k) >= n


# -- the decoders -------------------------------------------------------------


def _batch(vocab, B, T, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, T))
    return {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32)}


@pytest.mark.parametrize("arch", ["deepseek-moe-16b-smoke",
                                  "minitron-8b-smoke", "dbrx-132b-smoke"])
def test_decoder_loss_and_grads_match_reference(arch):
    """fp32 smoke models at T = 40: the loss (for the MoE model with the
    weighted load-balance loss of the scatter path, capacity drops
    included), ``moe_aux`` and every gradient leaf, the router's through
    the gate values; Minitron's untied head gets its own gradient."""
    batch = _batch(1024, 2, 40, seed=3)
    jcfg = jget_config(arch)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        jmodel.loss, has_aux=True)(jparams, jb)

    cfg = get_config(arch)
    model = build_model(cfg, device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    leaves = collections.OrderedDict(
        (k, v.requires_grad_()) for k, v in
        convert.decoder_state_from_numpy(np_params, cfg, "cpu").items())
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, metrics = functional_call(model, leaves, (tb,))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    _close(loss, jloss, **LOSS_TOL)
    assert metrics["ce"] is loss
    _close(metrics["moe_aux"], jmetrics["moe_aux"], rtol=1e-5, atol=1e-6)
    if cfg.moe is not None:
        assert float(metrics["moe_aux"].detach()) > 0
        assert cfg.tie_embeddings is False
    want = convert.decoder_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jgrads), cfg, "cpu")
    assert list(want) == list(leaves)
    for (name, g), w in zip(zip(leaves, grads), want.values()):
        scale = float(w.abs().max())
        _close(g, w.numpy(), rtol=GRAD_TOL["rtol"],
               atol=max(GRAD_TOL["atol"], 1e-5 * scale))
    if cfg.moe is not None:
        router = dict(zip(leaves, grads))["layers.0.moe.router"]
        assert float(router.abs().sum()) > 0


def test_remat_on_and_off_give_equal_moe_gradients():
    """The checkpointed MoE layer recomputes from the tensors bound at
    forward time (``decoder.layer_tensors`` binds the router, the expert
    stacks and the shared experts): bit for bit the plain graph's."""
    cfg = get_config("deepseek-moe-16b-smoke")
    model = build_model(cfg, device="cpu", seed=2)
    tb = {k: torch.from_numpy(v).long()
          for k, v in _batch(cfg.vocab, 2, 24, seed=5).items()}
    out = []
    for remat in (True, False):
        leaves = collections.OrderedDict(
            (k, v.clone().requires_grad_())
            for k, v in model.state_dict().items())
        loss, _ = functional_call(model, leaves, (tb,), {"remat": remat})
        out.append((loss, torch.autograd.grad(loss, list(leaves.values()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minitron-8b",
                                  "qwen2.5-3b", "dbrx-132b"])
def test_full_size_tree_matches_the_reference(arch):
    """The full configs on the meta device: ``repro``'s tree, leaf for
    leaf (names, shapes, the router in fp32), and its parameter count;
    DBRX-132B's MoE layers hold no shared experts."""
    cfg = get_config(arch)
    net = Decoder(cfg, device="meta")
    ref = jax.eval_shape(jbuild_model(jget_config(arch)).init,
                         jax.random.PRNGKey(0))
    assert sum(p.numel() for p in net.parameters()) == cfg.num_params() \
        == tree_num_params(ref)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    dtypes = {k: v.dtype for k, v in net.state_dict().items()}
    L = cfg.n_layers
    layer = ref["layers"]
    want = {"embed": ref["embed"].shape}
    if not cfg.tie_embeddings:
        want["head"] = ref["head"].shape
    if cfg.moe is not None:
        m = layer["moe"]
        for name in ("router", "w_gate", "w_up", "w_down"):
            want[f"layers.{L - 1}.moe.{name}"] = getattr(m, name).shape[1:]
        if m.shared is None:
            assert not any(".moe.shared." in k for k in shapes)
            assert net.layers[0].moe.shared is None
        else:
            for name in ("w_gate", "w_up", "w_down"):
                want[f"layers.{L - 1}.moe.shared.{name}"] = \
                    getattr(m.shared, name).shape[1:]
        assert dtypes["layers.0.moe.router"] == torch.float32
        assert dtypes["layers.0.moe.w_gate"] == torch.bfloat16
    else:
        for name in ("w_gate", "w_up", "w_down"):
            want[f"layers.{L - 1}.mlp.{name}"] = \
                getattr(layer["mlp"], name).shape[1:]
    for key, shape in want.items():
        assert shapes[key] == tuple(shape), key
    assert net.layers[0].attn.wq.shape[-1] == 128


def test_importing_moe_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.models.layers.moe\n"
            "import repro_torch.models.decoder\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro')\n"
            "       or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n"
            "print('OK')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "OK", res.stderr


def _cli_serves_unfused(arch):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.generate", "--arch",
         arch, "--device", "cpu", "--clients", "0",
         "--batch", "2", "--prompt-len", "6", "--new-tokens", "4",
         "--seed", "3"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == (f"[serve] {arch}: {get_config(arch).num_params()}"
                        " params, no fusion round (--clients 0)")
    assert "capacity factor 1.25, a decode step none" in lines[1]
    assert lines[-1].startswith("[serve] tokens:")


def test_cli_serves_the_moe_model_without_a_fusion_round():
    """``--clients 0`` serves the seeded model as it is (a full-size
    DeepSeek-MoE-16B client does not fit beside the model on one card);
    the MoE run says how prefill and decode differ."""
    _cli_serves_unfused("deepseek-moe-16b-smoke")


def test_cli_serves_dbrx_smoke():
    """The generate CLI serves DBRX-132B at its -smoke size (the full
    model, 264 GB in bf16, fits no single 80 GB card)."""
    _cli_serves_unfused("dbrx-132b-smoke")

