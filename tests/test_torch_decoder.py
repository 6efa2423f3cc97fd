"""The port's decoder against the JAX package's: its layers on the same
seeded numpy data, and the Qwen2 / Gemma3 / Qwen2.5 / Minitron /
DeepSeek-MoE / LLaVA-NeXT smoke models with JAX-initialised parameters
carried across by ``convert`` — prefill logits and teacher-forced decode
steps at tests/test_models.py's 2e-3; LLaVA-NeXT's patch prefix through
hidden states, prefill, the loss and its gradients.

On the CPU the attention wrappers run their plain versions; an autouse
fixture checks that no kernel launched.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import decoder as jdecoder
from repro.models.base import lm_logits as jlm_logits
from repro.models.layers.attention import AttnParams
from repro.models.layers.attention import project_qkv as jproject_qkv
from repro.models.layers.mlp import MLPParams
from repro.models.layers.mlp import mlp as jmlp
from repro.models.layers.norms import rms_norm as jrms_norm
from repro.models.layers.rope import apply_rope as japply_rope
from repro.utils import tree_num_params
from repro_torch import convert
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.models import build_model
from repro_torch.models.base import lm_logits
from repro_torch.models.cache import init_attn_cache
from repro_torch.models.decoder import Decoder, layer_windows
from repro_torch.models.encdec import EncDec
from repro_torch.models.xlstm import XLSTM
from repro_torch.models.layers.attention import Attention, project_qkv
from repro_torch.models.layers.mlp import MLP, mlp
from repro_torch.models.layers.norms import rms_norm
from repro_torch.models.layers.rope import apply_rope

MODEL_TOL = dict(rtol=2e-3, atol=2e-3)   # tests/test_models.py:137-140
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
SMOKE = ["qwen2-0.5b-smoke", "gemma3-1b-smoke", "qwen2.5-3b-smoke",
         "minitron-8b-smoke", "deepseek-moe-16b-smoke", "dbrx-132b-smoke"]


@pytest.fixture(autouse=True)
def _no_launches():
    fa.reset_launches()
    fd.reset_launches()
    yield
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert fd.LAUNCHES == {"flash_decode": 0}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(arch, seed=1):
    cfg = jget_config(arch)
    model = jbuild_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(seed))


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jrms_norm(jx, jnp.asarray(scale), 1e-6), np.float32)
    tdt = getattr(torch, dtype)
    got = rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale), 1e-6)
    assert got.dtype == tdt
    tol = LAYER_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("hd,theta", [(32, 1e4), (64, 1e6), (256, 1e6)])
def test_apply_rope_matches_reference(hd, theta):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 1300, size=(2, 7)).astype(np.int32)
    want = np.asarray(japply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_mlp_matches_reference():
    rng = np.random.default_rng(1)
    d, ff = 48, 96
    w = [rng.normal(size=s).astype(np.float32) * 0.2
         for s in ((d, ff), (d, ff), (ff, d))]
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    want = np.asarray(jmlp(MLPParams(*(jnp.asarray(a) for a in w)),
                           jnp.asarray(x)))
    p = MLP(d, ff, torch.float32, device="cpu")
    for param, a in zip((p.w_gate, p.w_up, p.w_down), w):
        param.copy_(torch.from_numpy(a))
    np.testing.assert_allclose(mlp(p, torch.from_numpy(x)).numpy(), want,
                               **LAYER_TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_project_qkv_matches_reference(bias):
    rng = np.random.default_rng(2)
    d, nq, nkv, hd = 64, 6, 2, 32
    shapes = dict(wq=(d, nq, hd), wk=(d, nkv, hd), wv=(d, nkv, hd),
                  wo=(nq, hd, d), bq=(nq, hd), bk=(nkv, hd), bv=(nkv, hd))
    arrays = {k: rng.normal(size=s).astype(np.float32) * 0.2
              for k, s in shapes.items()}
    if not bias:
        for k in ("bq", "bk", "bv"):
            arrays[k] = None
    jp = AttnParams(**{k: None if a is None else jnp.asarray(a)
                       for k, a in arrays.items()})
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    want = jproject_qkv(jp, jnp.asarray(x), jnp.asarray(pos), 1e6)
    p = Attention(d, nq, nkv, hd, bias, torch.float32, device="cpu")
    for k, a in arrays.items():
        if a is not None:
            getattr(p, k).copy_(torch.from_numpy(a))
    got = project_qkv(p, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                      1e6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LAYER_TOL)


@pytest.mark.parametrize("tied", [True, False])
def test_lm_logits_matches_reference(tied):
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 3, 32)).astype(np.float32)
    embed = rng.normal(size=(100, 32)).astype(np.float32)
    head = None if tied else rng.normal(size=(32, 100)).astype(np.float32)
    want = np.asarray(jlm_logits(jnp.asarray(h), jnp.asarray(embed),
                                 None if tied else jnp.asarray(head)))
    got = lm_logits(torch.from_numpy(h), torch.from_numpy(embed),
                    None if tied else torch.from_numpy(head))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


# -- whole models -------------------------------------------------------------


@pytest.mark.parametrize("arch", SMOKE)
def test_prefill_and_decode_match_reference(arch):
    """JAX-initialised parameters carried across: prefill logits and each
    of 24 teacher-forced decode steps equal the reference's."""
    jcfg, jmodel, params = _jax_model(arch)
    cfg = get_config(arch)
    model = convert.decoder_from_numpy(_np(params), cfg, device="cpu")
    B, T = 2, 24
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(B, T))
    jt = jnp.asarray(toks, jnp.int32)
    tt = torch.from_numpy(toks)
    np.testing.assert_allclose(
        model.prefill({"tokens": tt}).numpy(),
        np.asarray(jax.jit(jmodel.prefill)(params, {"tokens": jt})),
        **MODEL_TOL)
    jcache = jmodel.init_cache(B, 64)
    cache = model.init_cache(B, 64)
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos))
    for t in range(T):
        jcache, jl = step(params, jcache, jt[:, t:t + 1], jnp.int32(t))
        cache, tl = model.decode_step(cache, tt[:, t:t + 1], t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    # the ring caches hold the reference's keys and values
    for c, jc in zip(cache, jcache):
        np.testing.assert_allclose(c.k.numpy(), np.asarray(jc.k), **MODEL_TOL)
        np.testing.assert_allclose(c.v.numpy(), np.asarray(jc.v), **MODEL_TOL)


@pytest.mark.parametrize("arch", SMOKE)
def test_prefill_matches_stepwise_decode(arch):
    """tests/test_models.py:120-140 on the port: teacher-forced decode
    reproduces prefill's last-position logits (ring caches wrap for
    gemma3's window 16). An MoE prefill runs at the capacity factor E /
    top_k, where no assignment drops: a decode step's dense mix drops
    none."""
    cfg = get_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    model = build_model(cfg, device="cpu", seed=1)
    toks = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 24)))
    want = model.prefill({"tokens": toks})
    cache = model.init_cache(2, 64)
    positions = torch.arange(24, dtype=torch.int32)
    for t in range(24):
        cache, logits = model.decode_step(cache, toks[:, t:t + 1],
                                          positions[t])
    np.testing.assert_allclose(logits.numpy(), want.numpy(), **MODEL_TOL)


def test_ring_cache_windowed_equals_full_for_short_seq():
    """tests/test_models.py:142-158: while the context is shorter than
    the window, the window-length rings agree with full-length caches
    (and with the reference's decode)."""
    jcfg, jmodel, params = _jax_model("gemma3-1b-smoke", seed=2)
    cfg = get_config("gemma3-1b-smoke")
    model = convert.decoder_from_numpy(_np(params), cfg, device="cpu")
    ring = model.init_cache(1, 64)
    assert [c.k.shape[1] for c in ring] == [
        16 if w else 64 for w in layer_windows(cfg)]
    full = [init_attn_cache(1, 64, cfg.n_kv_heads, cfg.resolved_head_dim,
                            torch.float32) for _ in range(cfg.n_layers)]
    jcache = jmodel.init_cache(1, 64)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(1, 10))
    tt, jt = torch.from_numpy(toks), jnp.asarray(toks, jnp.int32)
    for t in range(10):
        ring, la = model.decode_step(ring, tt[:, t:t + 1], t)
        full, lb = model.decode_step(full, tt[:, t:t + 1], t)
        jcache, lj = jmodel.decode_step(params, jcache, jt[:, t:t + 1],
                                        jnp.int32(t))
        np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(la.numpy(), np.asarray(lj), **MODEL_TOL)


@pytest.mark.parametrize("arch", SMOKE)
def test_num_params_matches_model_and_reference(arch):
    jcfg, _, params = _jax_model(arch)
    cfg = get_config(arch)
    model = build_model(cfg, device="cpu")
    counted = sum(p.numel() for p in model.parameters())
    assert counted == cfg.num_params() == jcfg.num_params() \
        == tree_num_params(params)


@pytest.mark.parametrize("arch", sorted(a for a, c in ARCHITECTURES.items()
                                         if c.family in ("dense", "moe",
                                                         "vlm")))
def test_full_size_param_count_and_shapes(arch):
    """The full configs, built on the meta device (shapes, no memory):
    the parameter count equals the analytic one and the reference's; every
    parameter is bf16 but an MoE router, which stays fp32."""
    cfg = get_config(arch)
    assert cfg.num_params() == jget_config(arch).num_params()
    net = Decoder(cfg, device="meta")
    assert sum(p.numel() for p in net.parameters()) == cfg.num_params()
    assert all(p.dtype == (torch.float32 if name.endswith(".moe.router")
                           else torch.bfloat16)
               for name, p in net.named_parameters())
    assert net.layers[0].attn.wq.shape == (
        cfg.d_model, cfg.n_heads, cfg.resolved_head_dim)


def test_configs_mirror_the_reference():
    for arch in list(ARCHITECTURES) + [a + "-smoke" for a in ARCHITECTURES]:
        mine, ref = get_config(arch), jget_config(arch)
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (arch, f.name)
    # every architecture of the reference, xLSTM-350M the last to arrive
    assert "xlstm-350m" in ARCHITECTURES
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_families_not_yet_ported_raise():
    """``vlm`` builds the decoder and ``audio`` the encoder-decoder since
    their slice, ``ssm`` with ``cfg.xlstm`` the xLSTM since its own: no
    family of ``repro`` is left unported. What still raises is a config
    with neither an ``SSMConfig`` nor an ``XLSTMConfig`` in the ``ssm``
    family, as in ``repro``."""
    assert type(build_model(get_config("llava-next-34b-smoke"),
                            device="cpu")) is Decoder
    assert type(build_model(get_config("whisper-small-smoke"),
                            device="cpu")) is EncDec
    xlstm = jget_config("xlstm-350m-smoke")
    cfg = dataclasses.replace(get_config("zamba2-1.2b-smoke"), family="ssm",
                              xlstm=xlstm.xlstm)
    assert type(build_model(cfg, device="cpu")) is XLSTM
    assert type(build_model(get_config("xlstm-350m-smoke"),
                            device="cpu")) is XLSTM
    neither = dataclasses.replace(cfg, ssm=None, xlstm=None)
    with pytest.raises(ValueError, match="unknown family 'ssm'"):
        build_model(neither, device="cpu")
    # the decoders train since the training slice, Zamba2 since its own;
    # an MoE block builds and trains since the MoE slice
    toks = torch.zeros((1, 8), dtype=torch.int64)
    moe = dataclasses.replace(get_config("qwen2-0.5b-smoke"),
                              moe=MoEConfig(n_experts=4, top_k=2))
    for cfg in (get_config("qwen2-0.5b-smoke"), moe,
                get_config("deepseek-moe-16b-smoke")):
        model = build_model(cfg, device="cpu")
        loss, metrics = model.loss({"tokens": toks, "labels": toks})
        assert torch.isfinite(loss)
        assert (float(metrics["moe_aux"]) > 0) == (cfg.moe is not None)
    zamba = build_model(get_config("zamba2-1.2b-smoke"), device="cpu")
    loss, _ = zamba.loss({"tokens": toks, "labels": toks})
    assert torch.isfinite(loss)


# -- the vision-language prefix (LLaVA-NeXT) ------------------------------------


def _vlm_batch(cfg, B=2, T=16, seed=8):
    """Seeded patches (B, n_patch_tokens, d) and tokens, as numpy."""
    rng = np.random.default_rng(seed)
    patches = rng.normal(size=(B, cfg.n_patch_tokens, cfg.d_model)
                         ).astype(np.float32)
    return patches, rng.integers(0, cfg.vocab, size=(B, T))


def test_vlm_prefix_hidden_and_prefill_match_reference():
    """The patches go before the embedded tokens with positions running
    across both: hidden states and prefill logits against
    ``decoder_hidden`` / ``decoder_prefill``; the prefix changes the
    text's logits."""
    arch = "llava-next-34b-smoke"
    jcfg, _, params = _jax_model(arch)
    cfg = get_config(arch)
    model = convert.decoder_from_numpy(_np(params), cfg, device="cpu")
    patches, toks = _vlm_batch(cfg)
    jp, jt = jnp.asarray(patches), jnp.asarray(toks, jnp.int32)
    tp, tt = torch.from_numpy(patches), torch.from_numpy(toks)
    jh, _, offset = jdecoder.decoder_hidden(params, jcfg, jt, jp, remat=False)
    h, _ = model.hidden(tt, patch_embeds=tp)
    assert offset == cfg.n_patch_tokens == 8
    assert tuple(h.shape) == (2, offset + toks.shape[1], cfg.d_model)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **MODEL_TOL)
    got = model.prefill({"tokens": tt, "patch_embeds": tp})
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jdecoder.decoder_prefill(
            params, jcfg, {"tokens": jt, "patch_embeds": jp})), **MODEL_TOL)
    assert not np.allclose(got.numpy(), model.prefill({"tokens": tt}).numpy(),
                           **MODEL_TOL)
    # patches in another float dtype are cast to the hidden dtype
    h64, _ = model.hidden(tt, patch_embeds=tp.double())
    assert h64.dtype == torch.float32 and torch.equal(h64, h)


def test_vlm_loss_and_grads_match_reference():
    """The loss drops the patch positions before the CE: its value and
    every gradient leaf against ``jax.value_and_grad(decoder_loss)``
    (tests/test_torch_moe.py's limits; the untied head included)."""
    arch = "llava-next-34b-smoke"
    jcfg, jmodel, params = _jax_model(arch)
    cfg = get_config(arch)
    patches, toks = _vlm_batch(cfg, seed=9)
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(toks, jnp.int32),
          "patch_embeds": jnp.asarray(patches)}
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        params, jb)
    model = build_model(cfg, device="cpu")
    leaves = collections.OrderedDict(
        (k, v.requires_grad_()) for k, v in
        convert.decoder_state_from_numpy(_np(params), cfg, "cpu").items())
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks),
          "patch_embeds": torch.from_numpy(patches)}
    loss, metrics = functional_call(model, leaves, (tb,))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-6)
    assert metrics["ce"] is loss
    want = convert.decoder_state_from_numpy(_np(jgrads), cfg, "cpu")
    assert list(want) == list(leaves) and "head" in want
    for g, w in zip(grads, want.values()):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=max(1e-6, 1e-5 * scale))
