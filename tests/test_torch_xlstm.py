"""The port's xLSTM against the JAX package's: the mLSTM and sLSTM blocks
on the same seeded numpy data (forward and recurrent steps, every state
leaf), and whole models with JAX-initialised parameters carried across
by ``convert.xlstm_from_numpy`` — prefill logits, teacher-forced decode
steps and the loss value at ``xlstm-350m-smoke``, at a narrow 8-layer
config with ``slstm_every = 4`` (two segments of 3 mLSTM + 1 sLSTM) and
with ``slstm_every = 0``; a bf16 prefill; the full configuration's
shapes and its O(1) cache; the generate CLI.

Tolerances: the blocks in fp32 at 1e-5 (the cell states, whose
normalizer ``n`` sums input gates over the steps, relative to their
size); the models at tests/test_models.py's 2e-3; bf16 at the
reference's bf16 bound 5e-2 (tests/test_kernels_extra.py:77). The model
reaches no kernel; an autouse fixture checks that none launched.
"""
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

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.layers import xlstm_layers as jx
from repro.utils import tree_num_params
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.kernels.fused_fusion import kernel as fk
from repro_torch.kernels.ssd_chunk import kernel as sk
from repro_torch.models import build_model
from repro_torch.models.layers import xlstm_layers as tx
from repro_torch.models.xlstm import XLSTM, block_kinds

REPO = Path(__file__).resolve().parents[1]
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)   # tests/test_models.py:137-140
BF16_TOL = dict(rtol=5e-2, atol=5e-2)    # tests/test_kernels_extra.py:77
SMOKE = "xlstm-350m-smoke"
MDIMS = dict(d_model=32, d_inner=64, d_qk=32, d_v=64, n_heads=4, chunk=16)
SDIMS = dict(d_model=32, n_heads=4, up=42)
MLSTM_FIELDS = ("w_up", "w_z", "conv_w", "w_q", "w_k", "w_v", "w_if",
                "b_if", "gn_scale", "w_out")
SLSTM_FIELDS = ("w_in", "r", "b", "gn_scale", "w_gate", "w_upp", "w_down")
# the reference's block functions, each jitted once (dims static)
jit = lambda f: jax.jit(f, static_argnums=1)   # noqa: E731
J_MLSTM_FORWARD, J_MLSTM_STEP, J_QKVIF = map(jit, (
    jx.mlstm_forward, jx.mlstm_decode_step, jx._mlstm_qkvif))
J_SLSTM_FORWARD, J_SLSTM_STEP, J_SLSTM_CELL = map(jit, (
    jx.slstm_forward, jx.slstm_decode_step, jx._slstm_cell))


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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _copy_into(module, params, fields):
    for name in fields:
        getattr(module, name).copy_(
            torch.from_numpy(np.array(getattr(params, name), np.float32)))


def _mlstm(seed):
    """JAX-initialised mLSTM parameters with the zero / constant ones
    (gn_scale, b_if) drawn at random too, and the port's module holding
    the same values."""
    jd = jx.MLSTMDims(**MDIMS)
    p = jx.init_mlstm(jax.random.PRNGKey(seed), jd, jnp.float32)
    rng = np.random.default_rng(seed)
    p = p._replace(
        b_if=jnp.asarray(rng.normal(size=(2 * jd.n_heads,)) + 1.0,
                         jnp.float32),
        gn_scale=jnp.asarray(rng.normal(size=(jd.d_v,)) * 0.1, jnp.float32))
    td = tx.MLSTMDims(*jd)
    cell = tx.MLSTM(td, torch.float32, device="cpu")
    _copy_into(cell, p, MLSTM_FIELDS)
    return jd, p, td, cell


def _slstm(seed):
    jd = jx.SLSTMDims(**SDIMS)
    p = jx.init_slstm(jax.random.PRNGKey(seed), jd, jnp.float32)
    rng = np.random.default_rng(seed)
    p = p._replace(
        b=jnp.asarray(rng.normal(size=(4 * jd.d_model,)), jnp.float32),
        gn_scale=jnp.asarray(rng.normal(size=(jd.d_model,)) * 0.1,
                             jnp.float32))
    td = tx.SLSTMDims(*jd)
    cell = tx.SLSTM(td, torch.float32, device="cpu")
    _copy_into(cell, p, SLSTM_FIELDS)
    return jd, p, td, cell


def _x(seed, B, T, d):
    return np.random.default_rng(seed).normal(size=(B, T, d)) \
        .astype(np.float32)


def _assert_state(got, want, tol=LAYER_TOL):
    assert type(got).__name__ == type(want).__name__
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), err_msg=name,
                                   **tol)


# -- mLSTM --------------------------------------------------------------------


@pytest.mark.parametrize("T", [8, 48, 20],
                         ids=["under-chunk", "3-chunks", "one-chunk-of-T"])
def test_mlstm_forward_matches_reference(T):
    """T under the chunk of 16, three chunks of 16, and T = 20, which
    the chunk rule makes one chunk of 20."""
    jd, p, td, cell = _mlstm(T)
    x = _x(T + 1, 2, T, MDIMS["d_model"])
    want = np.asarray(J_MLSTM_FORWARD(p, jd, jnp.asarray(x)))
    got = tx.mlstm_forward(cell, td, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


def test_mlstm_qkvif_matches_reference():
    jd, p, td, cell = _mlstm(3)
    x = _x(4, 2, 9, MDIMS["d_model"])
    want = J_QKVIF(p, jd, jnp.asarray(x))
    got = tx._mlstm_qkvif(cell, td, torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LAYER_TOL)


def test_mlstm_decode_steps_match_reference_and_forward():
    """Each step's output and every state leaf (C, n, m, the conv tail)
    equal the reference's; the state is updated in place; the steps
    reproduce the chunked forward (fp32 at 1e-4: the stabilizer's m
    differs between one step at a time and a chunk)."""
    jd, p, td, cell = _mlstm(5)
    B, T = 2, 12
    x = _x(6, B, T, MDIMS["d_model"])
    js = jx.init_mlstm_state(B, jd, jnp.float32)
    state = tx.init_mlstm_state(B, td, torch.float32)
    held = list(state)
    ys = []
    for t in range(T):
        js, jy = J_MLSTM_STEP(p, jd, js, jnp.asarray(x[:, t:t + 1]))
        state, y = tx.mlstm_decode_step(cell, td, state,
                                        torch.from_numpy(x[:, t:t + 1]))
        assert all(a is b for a, b in zip(state, held))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER_TOL)
        _assert_state(state, js)
        ys.append(y)
    full = tx.mlstm_forward(cell, td, torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_mlstm_module_shapes_and_dtypes():
    """The reference's shapes; w_if and b_if stay fp32 in a bf16 block
    (repro/models/layers/xlstm_layers.py:82-84), b_if's forget half
    starts at 3.0."""
    jd = jx.MLSTMDims(**MDIMS)
    ref = jx.init_mlstm(jax.random.PRNGKey(0), jd, jnp.bfloat16)
    cell = tx.MLSTM(tx.MLSTMDims(*jd), torch.bfloat16, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    for name in MLSTM_FIELDS:
        got, want = getattr(cell, name), getattr(ref, name)
        assert tuple(got.shape) == want.shape, name
        assert (got.dtype == torch.float32) == (want.dtype == jnp.float32)
    np.testing.assert_array_equal(cell.b_if.numpy(), np.asarray(ref.b_if))


# -- sLSTM --------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 13])
def test_slstm_forward_matches_reference(T):
    jd, p, td, cell = _slstm(T)
    x = _x(T + 2, 2, T, SDIMS["d_model"])
    want = np.asarray(J_SLSTM_FORWARD(p, jd, jnp.asarray(x)))
    got = tx.slstm_forward(cell, td, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


def test_slstm_cell_matches_reference():
    """One cell step from a random state (n well above its 1e-6 floor
    and below it): the new c, n, m, h."""
    jd, p, td, _ = _slstm(7)
    rng = np.random.default_rng(8)
    shape = (3, jd.n_heads, jd.h)
    st = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    st[1] = np.abs(st[1]) * np.where(rng.random(shape) < 0.2, 1e-8, 1.0)
    st[1] = st[1].astype(np.float32)
    pre = rng.normal(size=(3, 4 * jd.d_model)).astype(np.float32) * 2
    want = J_SLSTM_CELL(p, jd, jx.SLSTMState(*map(jnp.asarray, st)),
                          jnp.asarray(pre))
    got = tx._slstm_cell(tx._recurrent(torch.from_numpy(np.array(p.r))),
                         tx.SLSTMState(*map(torch.from_numpy, st)),
                         torch.from_numpy(pre))
    _assert_state(got, want)


def test_slstm_decode_steps_match_reference_and_forward():
    """Each step's output and every state leaf (c, n, m, h) equal the
    reference's, in place; the steps reproduce the forward."""
    jd, p, td, cell = _slstm(9)
    B, T = 2, 10
    x = _x(10, B, T, SDIMS["d_model"])
    js = jx.init_slstm_state(B, jd)
    state = tx.init_slstm_state(B, td)
    _assert_state(state, js)
    held = list(state)
    ys = []
    for t in range(T):
        js, jy = J_SLSTM_STEP(p, jd, js, jnp.asarray(x[:, t:t + 1]))
        state, y = tx.slstm_decode_step(cell, td, state,
                                        torch.from_numpy(x[:, t:t + 1]))
        assert all(a is b for a, b in zip(state, held))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER_TOL)
        _assert_state(state, js)
        ys.append(y)
    full = tx.slstm_forward(cell, td, torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                               **LAYER_TOL)


def test_slstm_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the exact erf
    form would miss the reference's FFN by more than the layer bound."""
    x = torch.linspace(-4, 4, 101)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(
        torch.nn.functional.gelu(x, approximate="tanh").numpy(), want,
        **LAYER_TOL)
    assert np.abs(torch.nn.functional.gelu(x).numpy() - want).max() > 1e-4


# -- the model ----------------------------------------------------------------

NARROW = dict(n_layers=8, d_model=64)     # narrow widths, 8 blocks
CONFIGS = {
    "smoke": ({}, 32),                                   # 2 chunks of 16
    "8-layers-every-4": (dict(NARROW, slstm_every=4), 20),
    "every-0": (dict(n_layers=3, slstm_every=0), 20),
}


def _configs(changes):
    xl = {k: changes[k] for k in ("slstm_every",) if k in changes}
    base = {k: v for k, v in changes.items() if k not in xl}
    out = []
    for cfg in (jget_config(SMOKE), get_config(SMOKE)):
        if xl:
            base["xlstm"] = dataclasses.replace(cfg.xlstm, **xl)
        out.append(dataclasses.replace(cfg, **base))
    return out


def _pair(changes, seed=1):
    jcfg, cfg = _configs(changes)
    jmodel = jbuild_model(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    model = convert.xlstm_from_numpy(_np(params), cfg, device="cpu")
    return jcfg, jmodel, params, cfg, model


@pytest.mark.parametrize("name", list(CONFIGS))
def test_model_matches_reference(name):
    """JAX-initialised parameters carried across: the block order, the
    prefill logits, each of T teacher-forced decode steps, every state
    leaf after them, and the loss value."""
    changes, T = CONFIGS[name]
    jcfg, jmodel, params, cfg, model = _pair(changes)
    k = cfg.xlstm.slstm_every
    assert ("slstm" in params) == bool(k)
    kinds = block_kinds(cfg)
    assert len(kinds) == cfg.n_layers
    assert kinds == [("slstm" if k and (i + 1) % k == 0 else "mlstm")
                     for i in range(cfg.n_layers)]
    B = 2
    toks = np.random.default_rng(T).integers(0, cfg.vocab, size=(B, T))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    np.testing.assert_allclose(
        model.prefill({"tokens": tt}).numpy(),
        np.asarray(jax.jit(jmodel.prefill)(params, {"tokens": jt})),
        **MODEL_TOL)
    jloss, _ = jax.jit(jmodel.loss)(params, {"tokens": jt, "labels": jt})
    loss, metrics = model.loss({"tokens": tt, "labels": tt})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert metrics["ce"] is loss
    jcache = jmodel.init_cache(B, 64)
    cache = model.init_cache(B, 64)
    assert len(cache) == len(jcache) == cfg.n_layers
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos))
    for t in range(T):
        jcache, jl = step(params, jcache, jt[:, t:t + 1], jnp.int32(t))
        cache, tl = model.decode_step(cache, tt[:, t:t + 1], t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for c, jc in zip(cache, jcache):
        _assert_state(c, jc, MODEL_TOL)


def test_bf16_prefill_and_decode_match_reference():
    """The smoke model in bf16 (w_if, b_if, r and b stay fp32): prefill
    logits and 20 teacher-forced steps at the reference's bf16 bound.
    The chunked conv rounds after each tap and the decode step's once,
    in both packages alike."""
    jcfg, jmodel, params, cfg, model = _pair(dict(dtype="bfloat16"))
    fp32 = {k for k, v in model.state_dict().items()
            if v.dtype == torch.float32}
    assert fp32 == {"blocks.0.cell.w_if", "blocks.0.cell.b_if",
                    "blocks.1.cell.r", "blocks.1.cell.b"}
    B, T = 2, 20
    toks = np.random.default_rng(11).integers(0, cfg.vocab, size=(B, T))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    np.testing.assert_allclose(
        model.prefill({"tokens": tt}).numpy(),
        np.asarray(jax.jit(jmodel.prefill)(params, {"tokens": jt})),
        **BF16_TOL)
    jcache, cache = jmodel.init_cache(B, 64), model.init_cache(B, 64)
    assert cache[0].conv.dtype == torch.bfloat16
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos))
    for t in range(T):
        jcache, jl = step(params, jcache, jt[:, t:t + 1], jnp.int32(t))
        cache, tl = model.decode_step(cache, tt[:, t:t + 1], t)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16_TOL)


@pytest.mark.parametrize("T", [40, 37])
def test_prefill_matches_stepwise_decode(T):
    """tests/test_models.py:120-140 on the port: teacher-forced decode
    reproduces prefill's last-position logits, chunked (40: two chunks
    of 16 and a partial one, so one chunk of 40) and not."""
    cfg = get_config(SMOKE)
    model = build_model(cfg, device="cpu", seed=1)
    toks = torch.from_numpy(
        np.random.default_rng(T).integers(0, cfg.vocab, size=(2, T)))
    want = model.prefill({"tokens": toks})
    cache = model.init_cache(2, 0)
    for t in range(T):
        cache, logits = model.decode_step(cache, toks[:, t:t + 1], t)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), **MODEL_TOL)


def test_decode_replays_from_a_copied_state():
    """The caches are updated in place: a replay from a copy of an
    earlier state gives the same logits as the first pass."""
    model = build_model(get_config(SMOKE), device="cpu", seed=2)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 1024,
                                                              size=(1, 6)))
    cache = model.init_cache(1, 8)
    for t in range(3):
        cache, _ = model.decode_step(cache, toks[:, t:t + 1], t)
    saved = [type(s)(*(x.clone() for x in s)) for s in cache]
    first = [model.decode_step(cache, toks[:, t:t + 1], t)[1]
             for t in range(3, 6)]
    again = [model.decode_step(saved, toks[:, t:t + 1], t)[1]
             for t in range(3, 6)]
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_state_dict_order_and_param_count():
    """convert emits the model's state_dict keys in order, and the
    counts agree: module, analytic, reference."""
    jcfg, _, params, cfg, model = _pair({})
    state = convert.xlstm_state_from_numpy(_np(params), cfg, device="cpu")
    built = build_model(cfg, device="cpu")
    assert isinstance(built, XLSTM)
    assert list(state) == list(built.state_dict())
    assert list(state)[:4] == ["embed", "final_norm", "blocks.0.norm",
                               "blocks.0.cell.w_up"]
    assert sum(p.numel() for p in built.parameters()) == cfg.num_params() \
        == jcfg.num_params() == tree_num_params(params)


def test_full_size_shapes_and_o1_cache():
    """xLSTM-350M on the meta device (shapes, no memory): 388,701,352
    parameters, bf16 but the fp32 gates' weights and biases; 21 mLSTM and
    3 sLSTM blocks, every 8th an sLSTM; a cache whose size does not
    depend on the length (tests/test_models.py:161-168's 2 GiB bound at
    524,288 tokens)."""
    cfg = get_config("xlstm-350m")
    jcfg = jget_config("xlstm-350m")
    net = XLSTM(cfg, device="meta")
    n = sum(p.numel() for p in net.parameters())
    assert n == cfg.num_params() == jcfg.num_params() == 388_701_352
    kinds = block_kinds(cfg)
    assert kinds.count("slstm") == 3
    assert [i for i, k in enumerate(kinds) if k == "slstm"] == [7, 15, 23]
    fp32 = {name for name, p in net.named_parameters()
            if p.dtype == torch.float32}
    assert fp32 == ({f"blocks.{i}.cell.{f}" for i, k in enumerate(kinds)
                     for f in (("w_if", "b_if") if k == "mlstm"
                               else ("r", "b"))})
    cell = net.blocks[0].cell
    assert cell.w_q.shape == (2048, 1024) and cell.w_v.shape == (2048, 2048)
    assert net.blocks[7].cell.r.shape == (4, 4, 256, 256)
    assert net.blocks[7].cell.w_gate.shape == (1024, 1365)

    def nbytes(cache):
        return sum(x.numel() * x.element_size() for s in cache for x in s)

    short, long = net.init_cache(1, 1024), net.init_cache(1, 524_288)
    assert nbytes(short) == nbytes(long) < 2 * 2 ** 30
    assert short[0].C.shape == (1, 4, 256, 512)
    assert short[0].conv.dtype == torch.bfloat16
    assert short[7].c.shape == (1, 4, 256)


def test_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.generate", "--arch",
         SMOKE, "--device", "cpu", "--clients", "2", "--batch", "2",
         "--prompt-len", "20", "--new-tokens", "4", "--seed", "3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert f"[serve] {SMOKE}: fused 2 clients" in lines[0]
    diff = float(lines[1].rsplit("max_abs_diff=", 1)[1])
    assert diff < 2e-3
    assert lines[-1].startswith("[serve] tokens:")
