"""The port's training substrate against the JAX package's: optimizers
and schedules fed the same seeded gradients, the synthetic data and the
partitions array for array, and ``save_pytree`` / ``load_pytree`` across
the two packages. Twins of tests/test_substrate.py:37-131 first."""
import collections

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload_pytree
from repro.checkpoint import save_pytree as jsave_pytree
from repro.data import FederatedLoader as JFederatedLoader
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import dirichlet_partition as jdirichlet
from repro.data import make_batch as jmake_batch
from repro.data import shard_partition as jshard
from repro.optim import adamw as jadamw
from repro.optim import apply_updates as japply
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_decay as jcosine
from repro.optim import global_norm as jglobal_norm
from repro.optim import sgd as jsgd
from repro.optim import warmup_cosine as jwarmup
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.data import (
    FederatedLoader,
    SyntheticLM,
    dirichlet_partition,
    make_batch,
    shard_partition,
)
from repro_torch.optim import (
    adamw,
    apply_updates,
    clip_by_global_norm,
    constant,
    cosine_decay,
    global_norm,
    sgd,
    warmup_cosine,
)
from repro_torch.utils.pytree import tree_leaves

RNG = np.random.default_rng(11)
OPT_TOL = dict(rtol=1e-6, atol=0.0)   # fp32 update arithmetic, step for step


def _quad_grad(params):
    """Gradient of 0.5 * x**2."""
    return {"x": params["x"].clone()}


# -- twins of tests/test_substrate.py ---------------------------------------


def test_sgd_descends_quadratic():
    opt = sgd(0.1)
    params = {"x": torch.tensor(5.0)}
    state = opt.init(params)
    for step in range(100):
        ups, state = opt.update(_quad_grad(params), state, step)
        params = apply_updates(params, ups)
    assert abs(float(params["x"])) < 1e-3


def test_adamw_descends_and_decays():
    opt = adamw(0.1, weight_decay=0.01)
    params = {"x": torch.tensor(5.0)}
    state = opt.init(params)
    for step in range(200):
        ups, state = opt.update(_quad_grad(params), state, step, params)
        params = apply_updates(params, ups)
    assert abs(float(params["x"])) < 1e-2


def test_clip_by_global_norm():
    tree = {"a": torch.full((10,), 10.0)}
    clipped = clip_by_global_norm(tree, 1.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_schedules():
    s = warmup_cosine(1.0, warmup_steps=10, total_steps=110)
    assert float(s(0)) == 0.0
    assert float(s(10)) == pytest.approx(1.0, rel=1e-5)
    assert float(s(110)) <= 0.2
    c = cosine_decay(1.0, 100)
    assert float(c(0)) == pytest.approx(1.0)


def test_synthetic_deterministic_and_learnable_structure():
    g = SyntheticLM(vocab=64, seed=0)
    a = g.sample(2, 16, rng_seed=1)
    b = g.sample(2, 16, rng_seed=1)
    np.testing.assert_array_equal(a, b)
    c = g.sample(2, 16, rng_seed=2)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 64


def test_dirichlet_partition_covers_all():
    parts = dirichlet_partition(1000, 10, alpha=0.5, seed=0)
    allidx = np.sort(np.concatenate(parts))
    np.testing.assert_array_equal(allidx, np.arange(1000))
    assert all(len(p) >= 1 for p in parts)
    sizes = [len(p) for p in parts]
    assert max(sizes) > 2 * min(sizes)


def test_shard_partition_balanced():
    parts = shard_partition(100, 7)
    sizes = [len(p) for p in parts]
    assert max(sizes) - min(sizes) <= 1


def test_checkpoint_roundtrip(tmp_path):
    tree = {"w": torch.from_numpy(RNG.normal(size=(8, 4)).astype(np.float32)),
            "opt": {"m": torch.zeros((3,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    path = str(tmp_path / "ckpt")
    save_pytree(path, tree)
    back = load_pytree(path, tree)
    torch.testing.assert_close(back["w"], tree["w"], rtol=0, atol=0)
    assert back["opt"]["m"].dtype == torch.bfloat16
    assert int(back["step"]) == 7


# -- the same inputs through both packages ----------------------------------


def _grad_trees(n_steps, shapes):
    """Seeded gradients, one tree a step, as numpy."""
    rng = np.random.default_rng(5)
    return [{k: rng.normal(size=s).astype(np.float32) * 0.3
             for k, s in shapes.items()} for _ in range(n_steps)]


OPTIMIZERS = {
    "sgd": (lambda: sgd(0.05), lambda: jsgd(0.05)),
    "sgd_momentum": (lambda: sgd(0.05, momentum=0.9),
                     lambda: jsgd(0.05, momentum=0.9)),
    "sgd_cosine": (lambda: sgd(cosine_decay(0.1, 4)),
                   lambda: jsgd(jcosine(0.1, 4))),
    "adamw_decay_bf16_moments": (
        lambda: adamw(0.01, weight_decay=0.1, moment_dtype=torch.bfloat16),
        lambda: jadamw(0.01, weight_decay=0.1, moment_dtype=jnp.bfloat16)),
    "adamw_warmup": (
        lambda: adamw(warmup_cosine(0.02, 2, 5), weight_decay=0.01),
        lambda: jadamw(jwarmup(0.02, 2, 5), weight_decay=0.01)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_optimizer_matches_reference(name, param_dtype):
    """Five steps of each optimizer on the same gradients: every updated
    parameter and every state leaf equal the reference's at rtol 1e-6."""
    shapes = {"w": (6, 5), "b": (5,), "emb": (7, 3)}
    rng = np.random.default_rng(3)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    make, jmake = OPTIMIZERS[name]
    opt, jopt = make(), jmake()
    tdt, jdt = getattr(torch, param_dtype), getattr(jnp, param_dtype)
    params = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    state, jstate = opt.init(params), jopt.init(jparams)
    for step, g in enumerate(_grad_trees(5, shapes)):
        grads = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
        jgrads = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        ups, state = opt.update(grads, state, step, params)
        jups, jstate = jopt.update(jgrads, jstate, jnp.int32(step), jparams)
        params, jparams = apply_updates(params, ups), japply(jparams, jups)
    for k in shapes:
        assert params[k].dtype == tdt
        np.testing.assert_allclose(params[k].float().numpy(),
                                   np.asarray(jparams[k], np.float32),
                                   **OPT_TOL)
    # both packages flatten plain dicts in sorted-key order
    got = [t.float().numpy() for t in tree_leaves(state)]
    want = [np.asarray(x, np.float32)
            for x in jax.tree_util.tree_leaves(jstate)]
    assert len(got) == len(want) == (0 if name.startswith("sgd") and
                                     "momentum" not in name else
                                     len(shapes) * (1 if name.startswith(
                                         "sgd") else 2))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **OPT_TOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_and_global_norm_match_reference(max_norm):
    g = _grad_trees(1, {"a": (9, 4), "b": (13,)})[0]
    tree = {k: torch.from_numpy(v) for k, v in g.items()}
    jtree = {k: jnp.asarray(v) for k, v in g.items()}
    np.testing.assert_allclose(float(global_norm(tree)),
                               float(jglobal_norm(jtree)), rtol=1e-6)
    got, want = clip_by_global_norm(tree, max_norm), jclip(jtree, max_norm)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("step", [0, 1, 3, 9, 10, 57, 110, 200])
def test_schedules_match_reference(step):
    for got, want in ((warmup_cosine(0.3, 10, 110), jwarmup(0.3, 10, 110)),
                      (cosine_decay(0.3, 100, 0.2), jcosine(0.3, 100, 0.2))):
        np.testing.assert_allclose(float(got(step)),
                                   float(want(jnp.int32(step))), rtol=1e-6)
    assert float(constant(0.25)(step)) == 0.25


@pytest.mark.parametrize("skew,vocab", [(0.0, 64), (0.5, 96), (0.3, 600)])
def test_synthetic_and_loader_arrays_equal_reference(skew, vocab):
    """Equal seeds give equal arrays: samples, client batches (skewed
    bigram tables included) and client weights."""
    gen = SyntheticLM(vocab=vocab, seed=3, skew=skew, temperature=0.7)
    jgen = JSyntheticLM(vocab=vocab, seed=3, skew=skew, temperature=0.7)
    for seed, cid in ((1, None), (2, 0), (7, 3)):
        assert np.array_equal(gen.sample(3, 12, rng_seed=seed, client_id=cid),
                              jgen.sample(3, 12, rng_seed=seed,
                                          client_id=cid))
    loader = FederatedLoader(gen=gen, n_clients=5, batch=2, seq_len=10)
    jloader = JFederatedLoader(gen=jgen, n_clients=5, batch=2, seq_len=10)
    for cid in range(5):
        assert loader.client_weight(cid) == jloader.client_weight(cid)
        for r in (0, 1000, 2001):
            a, b = loader.client_batch(cid, r), jloader.client_batch(cid, r)
            assert sorted(a) == sorted(b)
            assert all(np.array_equal(a[k], b[k]) for k in a)
    a = make_batch(vocab, 2, 9, seed=4)
    b = jmake_batch(vocab, 2, 9, seed=4)
    assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))


@pytest.mark.parametrize("alpha,seed", [(0.5, 0), (0.1, 3), (5.0, 9)])
def test_partitions_equal_reference(alpha, seed):
    for a, b in zip(dirichlet_partition(997, 11, alpha, seed=seed),
                    jdirichlet(997, 11, alpha, seed=seed)):
        assert np.array_equal(a, b)
    for a, b in zip(shard_partition(103, 7), jshard(103, 7)):
        assert np.array_equal(a, b)


def _trees():
    w = RNG.normal(size=(5, 3)).astype(np.float32)
    m = RNG.normal(size=(4,)).astype(np.float32)
    bf = RNG.normal(size=(2, 3)).astype(np.float32)
    ttree = {"w": torch.from_numpy(w),
             "opt": {"m": torch.from_numpy(m).to(torch.bfloat16),
                     "count": torch.tensor(3, dtype=torch.int32)},
             "layers": [torch.from_numpy(bf), torch.from_numpy(bf * 2)]}
    jtree = {"w": jnp.asarray(w),
             "opt": {"m": jnp.asarray(m, jnp.bfloat16),
                     "count": jnp.int32(3)},
             "layers": [jnp.asarray(bf), jnp.asarray(bf * 2)]}
    return ttree, jtree


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_npz_loads_in_the_other_package(writer, tmp_path):
    """A tree saved by either package loads in the other with equal
    arrays and the template's dtypes (bf16 stored widened to fp32 by
    both), and both write the same keys and manifest."""
    ttree, jtree = _trees()
    path = str(tmp_path / "ckpt")
    (save_pytree if writer == "port" else jsave_pytree)(
        path, ttree if writer == "port" else jtree)
    keys = set(np.load(path + ".npz").files)
    assert keys == {"w", "opt/m", "opt/count", "layers/0", "layers/1"}
    back = load_pytree(path, ttree)
    jback = jload_pytree(path, jtree)
    assert back["opt"]["m"].dtype == torch.bfloat16
    assert jback["opt"]["m"].dtype == jnp.bfloat16
    assert int(back["opt"]["count"]) == int(jback["opt"]["count"]) == 3
    for a, b in ((back["w"], jback["w"]), (back["opt"]["m"], jback["opt"]["m"]),
                 (back["layers"][1], jback["layers"][1])):
        assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))
    other = str(tmp_path / "other")
    (jsave_pytree if writer == "port" else save_pytree)(
        other, jtree if writer == "port" else ttree)
    with open(path + ".json") as f1, open(other + ".json") as f2:
        assert f1.read() == f2.read()


def test_state_dict_keys_and_bf16_words(tmp_path):
    """A ``state_dict``'s dotted names are one key each; BF16 host words
    and ml_dtypes bf16 arrays are saved widened to fp32, bit for bit."""
    sd = collections.OrderedDict(
        [("layers.0.attn.wq", torch.randn(3, 2).to(torch.bfloat16)),
         ("embed", torch.randn(4, 2))])
    path = str(tmp_path / "sd")
    save_pytree(path, sd)
    npz = np.load(path + ".npz")
    assert list(npz.files) == ["layers.0.attn.wq", "embed"]
    np.testing.assert_array_equal(npz["layers.0.attn.wq"],
                                  sd["layers.0.attn.wq"].float().numpy())
    arr = RNG.normal(size=(5,)).astype(ml_dtypes.bfloat16)
    save_pytree(path, {"x": arr})
    np.testing.assert_array_equal(np.load(path + ".npz")["x"],
                                  arr.astype(np.float32))
