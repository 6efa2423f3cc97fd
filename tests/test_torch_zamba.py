"""The port's Zamba2 hybrid against the JAX package's: the smoke model with
JAX-initialised parameters carried across by ``convert`` (prefill logits
and 24 teacher-forced decode steps at tests/test_models.py's 2e-3, the
reduced window of 16 wrapping each call point's ring), the full-size
configuration's shapes, and the generate CLI at ``--arch
zamba2-1.2b-smoke`` (the FedAvg fusion of smoke clients against the JAX
service is a case of tests/test_torch_generate.py).

On the CPU the SSD and attention wrappers run their plain versions; an
autouse fixture checks that no kernel launched.
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
from repro.models.zamba import _segments as jsegments
from repro.utils import tree_num_params
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.kernels.fused_fusion import kernel as fk
from repro_torch.kernels.ssd_chunk import kernel as sk
from repro_torch.kernels.ssd_chunk.ref import ssd_scan_ref
from repro_torch.models import build_model
from repro_torch.models.cache import AttnCache
from repro_torch.models.layers.mamba2 import Mamba2Cache
from repro_torch.models.xlstm import XLSTM
from repro_torch.models.zamba import Zamba, segments

REPO = Path(__file__).resolve().parents[1]
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)   # tests/test_models.py:137-140
SMOKE = "zamba2-1.2b-smoke"


@pytest.fixture(autouse=True)
def _no_launches():
    for mod in (fa, fd, fk, sk):
        mod.reset_launches()
    yield
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert fd.LAUNCHES == {"flash_decode": 0}
    assert fk.LAUNCHES == {"weighted_sum": 0, "weighted_sum_dequant": 0}
    assert sk.LAUNCHES == {"ssd_chunk": 0, "ssd_chunk_bwd": 0}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(arch=SMOKE, seed=1, **changes):
    cfg = jget_config(arch)
    if changes:
        cfg = dataclasses.replace(cfg, **changes)
    model = jbuild_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("T,layers", [(24, 2), (21, 2), (24, 3)])
def test_prefill_and_decode_match_reference(T, layers):
    """JAX-initialised parameters carried across: prefill logits (chunked
    at 16, or one chunk of T = 21) and each of T teacher-forced decode
    steps equal the reference's; the rings (16 slots of a 64-token
    cache) wrap, and every cache holds the reference's values. With 3
    layers and a shared block every 2, the last segment is partial."""
    changes = {} if layers == 2 else dict(n_layers=3, hybrid_shared_every=2)
    jcfg, jmodel, params = _jax_model(**changes)
    cfg = dataclasses.replace(get_config(SMOKE), **changes)
    model = convert.zamba_from_numpy(_np(params), cfg, device="cpu")
    B = 2
    toks = np.random.default_rng(T + layers).integers(0, cfg.vocab,
                                                      size=(B, T))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    np.testing.assert_allclose(
        model.prefill({"tokens": tt}).numpy(),
        np.asarray(jax.jit(jmodel.prefill)(params, {"tokens": jt})),
        **MODEL_TOL)
    jcache = jmodel.init_cache(B, 64)
    cache = model.init_cache(B, 64)
    assert len(cache) == len(jcache)
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos))
    for t in range(T):
        jcache, jl = step(params, jcache, jt[:, t:t + 1], jnp.int32(t))
        cache, tl = model.decode_step(cache, tt[:, t:t + 1], t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for c, jc in zip(cache, jcache):
        for got, want in zip(c, jc):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **MODEL_TOL)


def test_prefill_matches_stepwise_decode_and_the_plain_path():
    """tests/test_models.py:120-140 on the port: teacher-forced decode
    reproduces prefill's last-position logits, and so does prefill with
    the plain SSD and plain attention passed in."""
    cfg = get_config(SMOKE)
    model = build_model(cfg, device="cpu", seed=1)
    toks = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 40)))
    want = model.prefill({"tokens": toks})
    plain = model.prefill({"tokens": toks}, ssd=ssd_scan_ref,
                          attention=attention_ref)
    np.testing.assert_allclose(plain.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    cache = model.init_cache(2, 64)
    positions = torch.arange(40, dtype=torch.int32)
    for t in range(40):
        cache, logits = model.decode_step(cache, toks[:, t:t + 1],
                                          positions[t])
    np.testing.assert_allclose(logits.numpy(), want.numpy(), **MODEL_TOL)


def test_state_dict_order_and_param_count():
    """convert emits the model's state_dict keys in order, and the
    counts agree: module, analytic, reference."""
    jcfg, _, params = _jax_model()
    cfg = get_config(SMOKE)
    state = convert.zamba_state_from_numpy(_np(params), cfg, device="cpu")
    model = build_model(cfg, device="cpu")
    assert isinstance(model, Zamba)
    assert list(state) == list(model.state_dict())
    assert list(state)[:4] == ["embed", "final_norm", "mamba.0.norm",
                               "mamba.0.cell.w_in"]
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params() \
        == jcfg.num_params() == tree_num_params(params)


def test_full_size_shapes_segments_and_caches():
    """Zamba2-1.2B on the meta device (shapes, no memory): 1,104,777,344
    parameters, bf16 except the fp32 dt_bias / a_log / d_skip; 38 layers
    in segments [6]*6 + [2], so the shared block runs 6 times; one ring
    of min(length, 2048) slots per call point."""
    cfg = get_config("zamba2-1.2b")
    jcfg = jget_config("zamba2-1.2b")
    assert segments(cfg) == jsegments(jcfg) == [6] * 6 + [2]
    net = Zamba(cfg, device="meta")
    assert sum(p.numel() for p in net.parameters()) == cfg.num_params() \
        == jcfg.num_params() == 1_104_777_344
    fp32 = {n for n, p in net.named_parameters() if p.dtype == torch.float32}
    assert fp32 == {f"mamba.{i}.cell.{f}" for i in range(38)
                    for f in ("dt_bias", "a_log", "d_skip")}
    cell = net.mamba[0].cell
    assert cell.w_in.shape == (2048, 2 * 4096 + 2 * 64 + 64)
    assert cell.conv_w.shape == (4, 4096 + 2 * 64)
    for length, slots in [(1024, 1024), (4096, 2048)]:
        cache = net.init_cache(1, length)
        rings = [c for c in cache if isinstance(c, AttnCache)]
        assert len(cache) == 44 and len(rings) == 6
        assert all(c.k.shape == (1, slots, 32, 64) for c in rings)
        assert all(isinstance(c, Mamba2Cache) for c in cache[:6])
        assert isinstance(cache[6], AttnCache)
        assert cache[0].state.shape == (1, 64, 64, 64)
        assert cache[0].state.dtype == torch.float32


def test_registry_routes_the_hybrid_and_refuses_xlstm():
    """``hybrid`` and ``ssm`` with a Mamba2 ``SSMConfig`` build the
    hybrid; ``ssm`` with an ``XLSTMConfig`` builds the xLSTM since its
    slice (no longer refused), routed first as in ``repro``; what the
    registry refuses now is the ``ssm`` family with neither config."""
    assert isinstance(build_model(get_config(SMOKE), device="cpu"), Zamba)
    ssm = dataclasses.replace(get_config(SMOKE), family="ssm",
                              hybrid_shared_every=0)
    model = build_model(ssm, device="cpu")
    assert isinstance(model, Zamba) and model.shared is None
    cfg = dataclasses.replace(get_config(SMOKE), family="ssm", ssm=None,
                              xlstm=jget_config("xlstm-350m-smoke").xlstm)
    assert isinstance(build_model(cfg, device="cpu"), XLSTM)
    both = dataclasses.replace(ssm, xlstm=cfg.xlstm)
    assert isinstance(build_model(both, device="cpu"), XLSTM)
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(cfg, xlstm=None), device="cpu")


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
