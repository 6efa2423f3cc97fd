"""The port's encoder-decoder (Whisper-small, reduced) against the JAX
package's ``repro.models.encdec``: JAX-initialised parameters carried
across by ``convert.encdec_from_numpy``, the same seeded numpy frames
and tokens through both. Encode, prefill and the loss value at 1e-4
(fp32, the same arithmetic in another order), decode steps at
tests/test_models.py's 2e-3, on zero cross caches (as the reference's
``init_cache`` leaves them) and on caches filled from the encoder, and
the port's prefill against its own teacher-forced decode at 2e-3.
Training: the loss and every gradient leaf against
``jax.value_and_grad`` of the reference's loss at
tests/test_torch_training.py's limits, remat on and off bitwise equal,
and a client's local steps (``Client.train_round`` with frames in its
batches) against the reference's ``Client``.

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
from repro.fl import Client as JClient
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.optim import sgd as jsgd
from repro.utils import tree_num_params
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.fl import Client
from repro_torch.fl.client import batch_to_device
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.launch.generate import generate
from repro_torch.models import build_model
from repro_torch.models.encdec import EncDec
from repro_torch.models.layers.attention import attention_train_ref
from repro_torch.optim import sgd

ARCH = "whisper-small-smoke"
TIGHT = dict(rtol=1e-4, atol=1e-4)       # encode / prefill / loss, fp32
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)   # tests/test_models.py:137-140
# tests/test_torch_training.py's: the loss, and each gradient leaf
# relative to its scale; a client's updates at the reference's own
# trajectory tolerance (tests/test_fault_tolerance.py:103-106)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
B, T = 2, 12


@pytest.fixture(autouse=True)
def _no_launches():
    fa.reset_launches()
    fd.reset_launches()
    yield
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert fd.LAUNCHES == {"flash_decode": 0}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small CPU tensors: under a parallel
    test run, torch's default of a thread a core in every worker made a
    float64 ``gradcheck`` here take minutes instead of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_other_frame_counts_raise(pair):
    """Frames of another count than the cross caches' raise, in encode
    and in a cache fill (the loss with grad mode on trains: see
    ``test_loss_and_grads_match_reference``)."""
    cfg, _, model, frames, toks = pair
    with pytest.raises(ValueError, match="frames"):
        model.encode(torch.from_numpy(frames[:, :8].copy()))
    short = dataclasses.replace(get_config(ARCH), n_audio_frames=8)
    other = build_model(short, device="cpu")
    with pytest.raises(ValueError, match="cross cache"):
        other.fill_cross_cache(other.init_cache(B, 4),
                               model.encode(torch.from_numpy(frames)))


def _batch(frames, toks):
    return {"audio_frames": torch.from_numpy(frames),
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(toks)}


def _loss_and_grads(model, batch, **kw):
    leaves = collections.OrderedDict(
        (k, v.clone().requires_grad_()) for k, v in model.state_dict().items())
    loss, metrics = functional_call(model, leaves, (batch,), kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, metrics, collections.OrderedDict(zip(leaves, grads))


def test_loss_and_grads_match_reference(pair):
    """``EncDec.loss`` trains: its value and every gradient leaf (the
    encoder's through each decoder layer's cross keys and values, the
    tied embedding's from its gather and its LM head) against
    ``jax.value_and_grad`` of the reference's loss, with the attention
    backward's non-causal, cross-length route in the encoder and the
    cross attention; through ``attention_train_ref`` the same values."""
    jcfg, params, model, frames, toks = pair
    jb = {"audio_frames": jnp.asarray(frames),
          "tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(toks, jnp.int32)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jencdec.encdec_loss(p, jcfg, jb), has_aux=True)(params)
    loss, metrics, grads = _loss_and_grads(model, _batch(frames, toks))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    assert metrics["ce"] is loss
    cfg = get_config(ARCH)
    want = convert.encdec_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jgrads), cfg, device="cpu")
    assert list(want) == list(grads)
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(
            g.numpy(), want[name].numpy(), err_msg=name,
            rtol=GRAD_TOL["rtol"], atol=max(GRAD_TOL["atol"], 1e-5 * scale))
    plain_loss, _, plain = _loss_and_grads(model, _batch(frames, toks),
                                           attention=attention_train_ref)
    assert torch.equal(plain_loss, loss)
    for name in grads:
        assert torch.equal(plain[name], grads[name]), name
    # the served module's parameters are untouched by the loss
    assert not any(p.requires_grad for p in model.parameters())


def test_remat_on_and_off_give_equal_gradients(pair):
    """Checkpointed encoder and decoder layers recompute from the tensors
    bound at forward time (the caller's, under functional_call; the
    decoder layer's ``cross_kv`` inside its body): bit for bit the
    gradients of the plain graph."""
    _, _, model, frames, toks = pair
    l1, _, g1 = _loss_and_grads(model, _batch(frames, toks), remat=True)
    l2, _, g2 = _loss_and_grads(model, _batch(frames, toks), remat=False)
    assert torch.equal(l1, l2)
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


def test_batch_to_device_keeps_float_entries():
    """A client's batch reaches the loss as it was drawn: frame
    embeddings unrounded in their float dtype (fp64 as fp32, as JAX
    without x64 takes them), tokens and labels as int64."""
    rng = np.random.default_rng(11)
    frames = rng.normal(size=(2, 16, 8)).astype(np.float32) * 3.7
    toks = rng.integers(0, 50, size=(2, 5)).astype(np.int32)
    got = batch_to_device({"audio_frames": frames, "tokens": toks,
                           "labels": toks, "f64": frames.astype(np.float64),
                           "mask": toks > 9}, torch.device("cpu"))
    assert got["audio_frames"].dtype == torch.float32
    assert torch.equal(got["audio_frames"], torch.from_numpy(frames))
    assert got["f64"].dtype == torch.float32
    assert torch.equal(got["f64"], torch.from_numpy(frames))
    for name in ("tokens", "labels", "mask"):
        assert got[name].dtype == torch.int64
    assert torch.equal(got["tokens"], torch.from_numpy(toks).long())
    half = batch_to_device({"x": torch.from_numpy(frames).bfloat16()},
                           torch.device("cpu"))
    assert half["x"].dtype == torch.bfloat16


@pytest.mark.parametrize("send_delta", [False, True])
def test_client_train_round_matches_reference(pair, send_delta):
    """``Client.train_round`` of the reduced Whisper: two local SGD steps
    on seeded batches of frames and tokens (numpy, as a loader draws
    them), against the reference's ``Client``: the last loss and every
    leaf of the update (the weights, or their fp32 delta)."""
    jcfg, params, model, _, _ = pair
    cfg = get_config(ARCH)
    rng = np.random.default_rng(21)
    batches = [{"audio_frames": rng.normal(size=(B, cfg.n_audio_frames,
                                                 cfg.d_model)
                                           ).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, size=(B, T))}
               for _ in range(2)]
    for b in batches:
        b["labels"] = b["tokens"]
    jc = JClient(client_id=0, model=jbuild_model(jcfg), optimizer=jsgd(0.5),
                 local_steps=2, send_delta=send_delta)
    jupd, jloss = jc.train_round(
        params, lambda s: {"audio_frames": jnp.asarray(
            batches[s]["audio_frames"]),
                           "tokens": jnp.asarray(batches[s]["tokens"],
                                                 jnp.int32),
                           "labels": jnp.asarray(batches[s]["labels"],
                                                 jnp.int32)}, 0)
    c = Client(client_id=0, model=model, optimizer=sgd(0.5), local_steps=2,
               send_delta=send_delta)
    start = model.state_dict()
    upd, loss = c.train_round(start, lambda s: batches[s], 0)
    np.testing.assert_allclose(loss, float(jloss), **LOSS_TOL)
    want = convert.encdec_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jupd), cfg, device="cpu")
    assert list(upd) == list(want)
    for name in want:
        assert upd[name].dtype == (torch.float32 if send_delta
                                   else start[name].dtype)
        np.testing.assert_allclose(upd[name].numpy(), want[name].numpy(),
                                   err_msg=name, **TRAJ_TOL)
    assert not any(p.requires_grad for p in model.parameters())
