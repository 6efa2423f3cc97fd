"""State carried from the JAX package into the port: a streamed round's
carry, a server optimizer's state and a numpy pytree (CPU)."""
import collections

import numpy as np
import pytest
import torch

from repro.core.fusion import get_fusion as j_get_fusion
from repro.core.local import LocalEngine as JLocalEngine
from repro.utils.pytree import tree_to_flat_vector as j_flat
from repro_torch.convert import carry_from_numpy, load_server_state, tree_from_numpy
from repro_torch.core.fusion import get_fusion
from repro_torch.core.local import LocalEngine
from repro_torch.utils.pytree import tree_leaves, tree_to_flat_vector

RTOL, ATOL = 2e-5, 1e-6


def _blocks(u, w, chunk):
    return [(u[lo:lo + chunk], w[lo:lo + chunk])
            for lo in range(0, u.shape[0], chunk)]


@pytest.mark.parametrize("strategy,jstrategy", [("kernel", "pallas"),
                                                ("torch", "jnp")])
@pytest.mark.parametrize("name", ["fedavg", "iteravg", "clippedavg"])
def test_stream_carry_continues_a_jax_round(name, strategy, jstrategy):
    rng = np.random.default_rng(1)
    u = rng.normal(size=(14, 403)).astype(np.float32)
    w = rng.uniform(1, 5, size=(14,)).astype(np.float32)
    blocks = _blocks(u, w, 4)
    jeng = JLocalEngine(strategy=jstrategy)
    want, _ = jeng.fuse_stream(j_get_fusion(name), iter(blocks), chunk_rows=4)
    _, half = jeng.fuse_stream(j_get_fusion(name), iter(blocks[:2]),
                               chunk_rows=4)
    init = carry_from_numpy(half.acc_state, device="cpu")
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.float32
               for t in init)
    got, rep = LocalEngine(strategy=strategy, device="cpu").fuse_stream(
        get_fusion(name), iter(blocks[2:]), init=init, chunk_rows=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert rep.n_rows == 6 and rep.acc_tot == pytest.approx(
        float(w.sum()) if name != "iteravg" else 14.0, rel=1e-6)


def test_carry_only_round_finalizes_the_carry():
    rng = np.random.default_rng(2)
    u = rng.normal(size=(5, 64)).astype(np.float32)
    w = np.ones(5, np.float32)
    _, rep = JLocalEngine(strategy="jnp").fuse_stream(
        j_get_fusion("fedavg"), iter(_blocks(u, w, 5)))
    got, _ = LocalEngine(strategy="kernel", device="cpu").fuse_stream(
        get_fusion("fedavg"), iter(()),
        init=carry_from_numpy(rep.acc_state, "cpu"))
    np.testing.assert_allclose(got.numpy(), u.mean(0), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["fedavgm", "fedadam"])
def test_server_state_carries_across(name):
    """Two JAX rounds, the optimizer state carried across, and the third
    round is equal in both packages."""
    rng = np.random.default_rng(3)
    rounds = [(rng.normal(size=(9, 211)).astype(np.float32),
               rng.uniform(1, 4, size=(9,)).astype(np.float32))
              for _ in range(3)]
    jeng = JLocalEngine(strategy="pallas")
    jf = j_get_fusion(name)
    for u, w in rounds[:2]:
        jeng.fuse(jf, u, w)
    if name == "fedavgm":
        arrays = {"velocity": np.asarray(jf._velocity)}
    else:
        arrays = {"m": np.asarray(jf._m), "v": np.asarray(jf._v), "t": jf._t}
    tf = get_fusion(name)
    load_server_state(tf, arrays, device="cpu")
    u, w = rounds[2]
    want = np.asarray(jeng.fuse(jf, u, w))
    got = LocalEngine(strategy="kernel", device="cpu").fuse(tf, u, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if name == "fedadam":
        assert tf._t == jf._t == 3


def test_load_server_state_rejects_stateless_fusion():
    with pytest.raises(TypeError, match="keeps no server state"):
        load_server_state(get_fusion("fedavg"), {}, device="cpu")


def test_tree_from_numpy_keeps_jax_leaf_order():
    rng = np.random.default_rng(4)
    tree = {"conv1": {"w": rng.normal(size=(3, 3)).astype(np.float32),
                      "b": rng.normal(size=(3,)).astype(np.float32)},
            "dense": [rng.normal(size=(2, 2)).astype(np.float32)],
            "bn": collections.OrderedDict(
                [("scale", np.ones(2, np.float32)),
                 ("bias", np.zeros(2, np.float32))])}
    got = tree_from_numpy(tree, device="cpu")
    assert list(got) == ["bn", "conv1", "dense"]
    assert list(got["conv1"]) == ["b", "w"]
    assert list(got["bn"]) == ["scale", "bias"]   # an OrderedDict keeps order
    assert all(isinstance(x, torch.Tensor) for x in tree_leaves(got))
    np.testing.assert_array_equal(tree_to_flat_vector(got).numpy(),
                                  np.asarray(j_flat(tree)))
