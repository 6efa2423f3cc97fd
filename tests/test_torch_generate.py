"""The port's serving entry point against the JAX package: the FedAvg
fusion of client models (``repro``'s AggregationService over the same
trees, applied as ``FederatedServer.run_round`` applies it) and greedy
decoding (a loop over the reference model's ``decode_step``, as
examples/serve_federated_model.py writes it), on the CPU."""
import ast
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
from repro.core import AggregationService as JService
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.kernels.fused_fusion import kernel as fk
from repro_torch.kernels.ssd_chunk import kernel as sk
from repro_torch.launch import generate as gen

REPO = Path(__file__).resolve().parents[1]
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)   # tests/test_models.py:137-140


@pytest.fixture(autouse=True)
def _no_launches():
    for mod in (fa, fd, fk, sk):
        mod.reset_launches()
    yield
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert fd.LAUNCHES == {"flash_decode": 0}
    assert fk.LAUNCHES == {"weighted_sum": 0, "weighted_sum_dequant": 0}
    assert sk.LAUNCHES == {"ssd_chunk": 0}


def _jax_generate(model, params, prompt, n_new, cache_len):
    """examples/serve_federated_model.py:22-53, greedy, also returning
    the logits each new token was picked from."""
    B, T0 = prompt.shape
    cache = model.init_cache(B, cache_len)
    step = jax.jit(lambda p, c, t, pos: model.decode_step(p, c, t, pos))
    logits = None
    for t in range(T0):
        cache, logits = step(params, cache, prompt[:, t:t + 1], jnp.int32(t))
    cur = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    out, seen = [cur], [logits]
    for i in range(n_new - 1):
        cache, logits = step(params, cache, cur, jnp.int32(T0 + i))
        cur = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(cur)
        seen.append(logits)
    return (np.asarray(jnp.concatenate([prompt] + out, axis=1)),
            np.stack([np.asarray(s) for s in seen], axis=1))


def _clients(params, n, seed):
    """n client trees: the global JAX tree plus seeded numpy noise."""
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.01 * rng.normal(size=p.shape).astype(
            np.float32), params) for _ in range(n)]


@pytest.mark.parametrize("arch", ["qwen2-0.5b-smoke", "gemma3-1b-smoke",
                                  "zamba2-1.2b-smoke"])
def test_fused_model_generates_as_the_reference(arch):
    jcfg = jget_config(arch)
    jmodel = jbuild_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    clients = _clients(params, 3, seed=1)
    weights = np.array([3.0, 1.0, 5.0], np.float32)

    # the reference: FedAvg of the trees, applied as run_round does
    fused, _ = JService(fusion="fedavg", local_strategy="jnp").aggregate(
        updates=[jax.tree_util.tree_map(jnp.asarray, c) for c in clients],
        weights=weights, template=params)
    jparams = jax.tree_util.tree_map(lambda p, f: f.astype(p.dtype),
                                     params, fused)

    cfg = get_config(arch)
    state_from_numpy = (convert.zamba_state_from_numpy if cfg.ssm
                        else convert.decoder_state_from_numpy)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = (convert.zamba_from_numpy if cfg.ssm
             else convert.decoder_from_numpy)(np_params, cfg, device="cpu")
    states = [state_from_numpy(c, cfg, device="cpu") for c in clients]
    vec, report = gen.fuse_clients(model, states, weights)
    assert report.n_clients == 3 and vec.numel() == cfg.num_params()
    want = state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    got = model.state_dict()
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=2e-5, atol=1e-6, err_msg=name)

    prompt = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 8))
    jtokens, jlogits = _jax_generate(jmodel, jparams,
                                     jnp.asarray(prompt, jnp.int32), 6, 32)
    tokens, logits = gen.generate(model, torch.from_numpy(prompt), 6,
                                  cache_len=32, return_logits=True)
    np.testing.assert_array_equal(tokens.numpy(), jtokens)
    np.testing.assert_allclose(logits.numpy(), jlogits, **MODEL_TOL)
    # prefill's last-position logits agree with the teacher-forced ones
    last = model.prefill({"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(last.numpy(), logits[:, 0].numpy(),
                               **MODEL_TOL)


def test_fuse_clients_keeps_dtypes_and_key_order():
    """The fused value replaces each parameter, cast to its dtype (bf16
    here); clients given as mappings in another key order are taken in
    the template's order."""
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("qwen2-0.5b-smoke"),
                              dtype="bfloat16")
    model = build_model(cfg, device="cpu", seed=3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(4)
    clients = []
    for _ in range(2):
        c = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
             for k, v in before.items()}
        clients.append(dict(reversed(list(c.items()))))   # another key order
    weights = np.array([1.0, 3.0], np.float32)
    vec, _ = gen.fuse_clients(model, clients, weights)
    offset = 0
    for k, v in model.state_dict().items():
        mean = (clients[0][k] * 1.0 + clients[1][k] * 3.0) / (4.0 + 1e-6)
        assert v.dtype == before[k].dtype == torch.bfloat16
        fused = vec[offset:offset + v.numel()].view(v.shape)
        offset += v.numel()
        np.testing.assert_allclose(fused.numpy(), mean.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        assert torch.equal(v, fused.to(torch.bfloat16)), k


def test_sampling_is_seeded():
    from repro_torch.models import build_model

    model = build_model(get_config("gemma3-1b-smoke"), device="cpu", seed=5)
    prompt = torch.from_numpy(np.random.default_rng(6).integers(
        0, 1024, size=(2, 4)))
    runs = [gen.generate(model, prompt, 5, cache_len=16, temperature=0.8,
                         generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert runs[0].shape == (2, 9)
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0][:, :4], prompt)


def test_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.generate", "--arch",
         "qwen2-0.5b-smoke", "--device", "cpu", "--clients", "2",
         "--batch", "2", "--prompt-len", "6", "--new-tokens", "4",
         "--seed", "3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert "fused 2 clients" in lines[0]
    diff = float(lines[1].rsplit("max_abs_diff=", 1)[1])
    assert diff < 2e-3
    assert lines[-1].startswith("[serve] tokens:")
    assert len(ast.literal_eval(lines[-1].split(":", 1)[1].strip())) == 10
