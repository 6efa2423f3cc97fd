"""The port's encoder-decoder (Whisper-small, reduced) against the JAX
package's ``repro.models.encdec``: JAX-initialised parameters carried
across by ``convert.encdec_from_numpy``, the same seeded numpy frames
and tokens through both. Encode, prefill and the loss value at 1e-4
(fp32, the same arithmetic in another order), decode steps at
tests/test_models.py's 2e-3, on zero cross caches (as the reference's
``init_cache`` leaves them) and on caches filled from the encoder, and
the port's prefill against its own teacher-forced decode at 2e-3.

On the CPU the attention wrappers run their plain versions; an autouse
fixture checks that no kernel launched.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.utils import tree_num_params
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.launch.generate import generate
from repro_torch.models import build_model
from repro_torch.models.encdec import EncDec

ARCH = "whisper-small-smoke"
TIGHT = dict(rtol=1e-4, atol=1e-4)       # encode / prefill / loss, fp32
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)   # tests/test_models.py:137-140
B, T = 2, 12


@pytest.fixture(autouse=True)
def _no_launches():
    fa.reset_launches()
    fd.reset_launches()
    yield
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert fd.LAUNCHES == {"flash_decode": 0}


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, the port's model holding them, frames,
    tokens) of the reduced Whisper-small."""
    jcfg = jget_config(ARCH)
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(3))
    cfg = get_config(ARCH)
    model = convert.encdec_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    rng = np.random.default_rng(7)
    frames = rng.normal(size=(B, cfg.n_audio_frames, cfg.d_model)
                        ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, size=(B, T))
    return jcfg, params, model, frames, toks


def test_builds_and_carries_the_reference_tree(pair):
    jcfg, params, model, _, _ = pair
    cfg = get_config(ARCH)
    assert isinstance(build_model(cfg, device="cpu"), EncDec)
    state = convert.encdec_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    assert list(state) == list(model.state_dict())
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params() \
        == jcfg.num_params() == tree_num_params(params)


def test_full_size_shapes():
    """Whisper-small at full size on the meta device: 294.7 M parameters,
    every one bf16, the cross attention MHA."""
    cfg = get_config("whisper-small")
    net = EncDec(cfg, device="meta")
    assert sum(p.numel() for p in net.parameters()) == cfg.num_params() \
        == jget_config("whisper-small").num_params() == 294_683_904
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    assert len(net.enc_layers) == len(net.dec_layers) == 12
    assert net.dec_layers[0].xattn.wk.shape == (768, 12, 64)


def test_encode_prefill_and_loss_match_reference(pair):
    jcfg, params, model, frames, toks = pair
    jf, jt = jnp.asarray(frames), jnp.asarray(toks, jnp.int32)
    tf, tt = torch.from_numpy(frames), torch.from_numpy(toks)
    encode = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f, remat=False))
    prefill = jax.jit(lambda p, b: jencdec.encdec_prefill(p, jcfg, b))
    loss = jax.jit(lambda p, b: jencdec.encdec_loss(p, jcfg, b))
    np.testing.assert_allclose(model.encode(tf).numpy(),
                               np.asarray(encode(params, jf)), **TIGHT)
    np.testing.assert_allclose(
        model.prefill({"audio_frames": tf, "tokens": tt}).numpy(),
        np.asarray(prefill(params, {"audio_frames": jf, "tokens": jt})),
        **TIGHT)
    want, _ = loss(params, {"audio_frames": jf, "tokens": jt, "labels": jt})
    with torch.no_grad():
        got, metrics = model.loss({"audio_frames": tf, "tokens": tt,
                                   "labels": tt})
    np.testing.assert_allclose(float(got), float(want), **TIGHT)
    assert float(metrics["ce"]) == float(got)


def _reference_steps(params, jcfg, jcache, toks):
    step = jax.jit(lambda c, t, pos: jencdec.encdec_decode_step(
        params, jcfg, c, t, pos))
    out = []
    for t in range(toks.shape[1]):
        jcache, logits = step(jcache, jnp.asarray(toks[:, t:t + 1],
                                                  jnp.int32), jnp.int32(t))
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("filled", [False, True])
def test_decode_steps_match_reference(pair, filled):
    """Teacher-forced decode steps against ``encdec_decode_step``: on zero
    cross caches (the reference's ``init_cache``), and on caches the
    port's ``fill_cross_cache`` writes from its encoder output, against
    the reference's caches built from its ``encode`` and ``_enc_kv``."""
    jcfg, params, model, frames, toks = pair
    jcache = jencdec.encdec_init_cache(jcfg, B, 32)
    cache = model.init_cache(B, 32)
    if filled:
        enc = jencdec.encode(params, jcfg, jnp.asarray(frames), remat=False)
        for li, c in enumerate(jcache):
            layer = jax.tree_util.tree_map(lambda a: a[li],
                                           params["dec_layers"])
            k, v = jencdec._enc_kv(layer, enc, jcfg)
            jcache[li] = c._replace(cross_k=k, cross_v=v)
        model.fill_cross_cache(cache, model.encode(torch.from_numpy(frames)))
        for c, jc in zip(cache, jcache):
            np.testing.assert_allclose(c.cross_k.numpy(),
                                       np.asarray(jc.cross_k), **TIGHT)
    want = _reference_steps(params, jcfg, jcache, toks)
    tt = torch.from_numpy(toks)
    for t in range(T):
        cache, logits = model.decode_step(cache, tt[:, t:t + 1], t)
        np.testing.assert_allclose(logits.numpy(), want[t], **MODEL_TOL)


def test_prefill_matches_teacher_forced_decode(pair):
    """tests/test_models.py:120-140 on the port: the cross caches filled
    from the encoder, teacher-forced decode reproduces prefill's
    last-position logits, through the kernels' wrappers and through the
    plain versions passed explicitly."""
    _, _, model, frames, toks = pair
    tf, tt = torch.from_numpy(frames), torch.from_numpy(toks)
    want = model.prefill({"audio_frames": tf, "tokens": tt})
    plain = model.prefill({"audio_frames": tf, "tokens": tt},
                          attention=attention_ref)
    np.testing.assert_allclose(plain.numpy(), want.numpy(), **TIGHT)
    cache = model.fill_cross_cache(model.init_cache(B, T), model.encode(tf))
    _, logits = generate(model, tt, 1, cache_len=T, cache=cache,
                         return_logits=True)
    np.testing.assert_allclose(logits[:, 0].numpy(), want.numpy(),
                               **MODEL_TOL)
    cache = model.fill_cross_cache(model.init_cache(B, T), model.encode(tf))
    for t in range(T):
        cache, last = model.decode_step(cache, tt[:, t:t + 1], t,
                                        attention=flash_decode_ref)
    np.testing.assert_allclose(last.numpy(), logits[:, 0].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_training_and_other_frame_counts_raise(pair):
    """The loss with grad mode on raises, naming the queued Whisper
    training; frames of another count than the cross caches' raise."""
    cfg, _, model, frames, toks = pair
    batch = {"audio_frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)}
    with pytest.raises(NotImplementedError, match="Whisper training"):
        model.loss(batch)
    with pytest.raises(ValueError, match="frames"):
        model.encode(torch.from_numpy(frames[:, :8].copy()))
    short = dataclasses.replace(get_config(ARCH), n_audio_frames=8)
    other = build_model(short, device="cpu")
    with pytest.raises(ValueError, match="cross cache"):
        other.fill_cross_cache(other.init_cache(B, 4),
                               model.encode(torch.from_numpy(frames)))
