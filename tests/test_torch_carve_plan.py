"""The arithmetic of the register carve (``carve_reg_kernel`` in
``csrc/robust_fusion.cu``), checked without a card: a numpy model of its
two routes against the JAX package's Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and the port's plain version, bit for bit.

A column's top and bottom windows hold KM >= K slots. On the fast route
they hold 32-bit order keys, and a value enters with integer min / max
(t[j] = max(t[j], min(x, t[j + 1])), the mirror for the bottom). The key
is one-to-one except on -0 (it shares +0's) and NaN (every payload one
key), which a stable sort keeps apart by input order; so a warp of 32
columns takes the exact route of fp32 compares in jnp.sort's order from
its carry on, or from the first group of CARVE_GROUP rows in which a
valid value of one of its columns is -0 or NaN. The model follows the
kernel step for step: the windows, the route chosen per warp and row
group, the keys turned back into bits at the switch, ssum added in row
order; the kernel itself is held against the plain version on the card
by chip_smoke.py.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

from repro.kernels.robust_fusion import kernel as jkernel
from repro_torch.kernels import _build
from repro_torch.kernels.robust_fusion import kernel, ref

F32, U32 = np.float32, np.uint32
SIGN = U32(0x80000000)
NAN_A, NAN_B, NAN_NEG = U32(0x7FC00002), U32(0x7FC00001), U32(0xFFC00003)


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"topk_carve": 0, "trimmed_mean": 0,
                               "coord_median": 0}


# -- the model ----------------------------------------------------------------


def bits(x):
    return np.ascontiguousarray(x, F32).view(U32)


def floats(b):
    return np.ascontiguousarray(b, U32).view(F32)


def plain_key(b):
    """order_key on values other than -0 and NaN: unsigned order = fp32
    order."""
    return b ^ ((b.view(np.int32) >> 31).view(U32) | SIGN)


def plain_bits(k):
    return k ^ (((~k).view(np.int32) >> 31).view(U32) | SIGN)


def keyless(x):
    x = np.asarray(x, F32)
    return np.isnan(x) | ((x == 0) & np.signbit(x))


def before(a, b):
    """a sorts strictly before b in jnp.sort's order."""
    with np.errstate(invalid="ignore"):
        return (a < b) | (np.isnan(b) & ~np.isnan(a))


def top_exact(t, x):
    """top_insert on fp32 bits t (KM, P) of each column, value x (P,)."""
    tf, xb, new = floats(t), bits(x), t.copy()
    for j in range(len(t) - 1):
        new[j] = np.where(~before(x, tf[j + 1]), t[j + 1],
                          np.where(~before(x, tf[j]), xb, t[j]))
    new[-1] = np.where(~before(x, tf[-1]), xb, t[-1])
    return new


def bot_exact(b, x):
    bf, xb, new = floats(b), bits(x), b.copy()
    for j in range(len(b) - 1, 0, -1):
        new[j] = np.where(before(x, bf[j - 1]), b[j - 1],
                          np.where(before(x, bf[j]), xb, b[j]))
    new[0] = np.where(before(x, bf[0]), xb, b[0])
    return new


def top_key(t, k):
    new = t.copy()
    new[:-1] = np.maximum(t[:-1], np.minimum(k, t[1:]))
    new[-1] = np.maximum(t[-1], k)
    return new


def bot_key(b, k):
    new = b.copy()
    new[1:] = np.minimum(b[1:], np.maximum(k, b[:-1]))
    new[0] = np.minimum(b[0], k)
    return new


def by_warp(cols):
    """(P,) bool -> (P,) bool: any column of each warp of 32."""
    P = cols.shape[0]
    w = np.pad(cols, (0, -P % 32)).reshape(-1, 32).any(1)
    return np.repeat(w, 32)[:P]


@np.errstate(invalid="ignore")   # inf + -inf is NaN in ssum, as on the card
def carve_model(block, valid, ssum, topk, botk, route="auto"):
    """carve_reg_kernel on one (c, P) block -> (ssum, topk, botk, fast):
    ``fast`` (groups, P) marks the (row group, column) steps taken on the
    fast route. ``route`` "fast" or "exact" forces one route on every
    warp."""
    c, P = block.shape
    K = topk.shape[0]
    km = kernel.carve_window(K)
    assert km, "the model covers the register route (K <= 32)"
    pad = km - K
    t = np.full((km, P), -np.inf, F32)
    t[pad:] = topk
    b = np.full((km, P), np.inf, F32)
    b[:K] = botk
    t, b = bits(t), bits(b)
    if route == "auto":
        exact = by_warp(keyless(topk).any(0) | keyless(botk).any(0))
    else:
        exact = np.full(P, route == "exact")
    t = np.where(exact, t, plain_key(t))
    b = np.where(exact, b, plain_key(b))
    acc = np.zeros(P, F32)
    x = np.asarray(block, F32)
    fast = []
    for i0 in range(0, c, kernel.CARVE_GROUP):
        rows = [i for i in range(i0, min(c, i0 + kernel.CARVE_GROUP))
                if valid[i] > 0]
        if route == "auto":
            odd = by_warp(keyless(x[rows]).any(0)) & ~exact
            t = np.where(odd, plain_bits(t), t)
            b = np.where(odd, plain_bits(b), b)
            exact = exact | odd
        fast.append(~exact)
        for i in rows:
            acc = (acc + x[i]).astype(F32)
            k = plain_key(bits(x[i]))
            t = np.where(exact, top_exact(t, x[i]), top_key(t, k))
            b = np.where(exact, bot_exact(b, x[i]), bot_key(b, k))
    t = np.where(exact, t, plain_bits(t))
    b = np.where(exact, b, plain_bits(b))
    # the masked rows enter botk as +inf after the valid rows, at most KM
    # of them; a +inf displaces only a NaN, which the fast route never holds
    for _ in range(min(c - int((np.asarray(valid) > 0).sum()), km)):
        b = np.where(exact, bot_exact(b, np.full(P, np.inf, F32)), b)
    fast = np.array(fast).reshape(-1, P)
    return (ssum + acc).astype(F32), floats(t[pad:]), floats(b[:K]), fast


# -- data ----------------------------------------------------------------------


def _values(rng, shape, specials):
    """Normals and ties from a small grid; ``specials`` mixes in +-inf,
    NaNs of three payloads and signed zeros."""
    v = rng.normal(size=shape).astype(F32)
    grid = np.array([-2, -1, -0.5, 0.5, 1, 2], F32)
    ties = rng.random(shape) < 0.3
    v[ties] = rng.choice(grid, size=int(ties.sum()))
    if specials:
        pool = np.concatenate([
            floats(np.array([NAN_A, NAN_B, NAN_NEG], U32)),
            np.array([np.inf, -np.inf, 0.0, -0.0, 0.0, -0.0], F32)])
        hit = rng.random(shape) < 0.08
        v[hit] = rng.choice(pool, size=int(hit.sum()))
    return v


def _case(seed, c, P, K, fill, specials, ragged):
    rng = np.random.default_rng(seed)
    block = _values(rng, (c, P), specials)
    valid = (rng.random(c) < 0.7).astype(F32) if ragged \
        else np.ones(c, F32)
    # a carry in jnp.sort's order: the 2K values sorted stably
    both = torch.from_numpy(_values(rng, (2 * K, P), specials))
    both = torch.sort(both, dim=0, stable=True).values.numpy()
    topk, botk = both[K:].copy(), both[:K].copy()
    fill = min(fill, K)
    topk[: K - fill] = -np.inf
    botk[fill:] = np.inf
    ssum = rng.normal(size=(P,)).astype(F32)
    return block, valid, ssum, topk, botk


def _assert_same(got, want, what):
    np.testing.assert_array_equal(bits(got[1]), bits(want[1]),
                                  err_msg=f"{what}: topk")
    np.testing.assert_array_equal(bits(got[2]), bits(want[2]),
                                  err_msg=f"{what}: botk")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5,
                               err_msg=f"{what}: ssum")


def _reference(args):
    return tuple(t.numpy() for t in ref.topk_carve_ref(
        *map(torch.from_numpy, args)))


# -- tests ----------------------------------------------------------------------


@settings(max_examples=120, deadline=None)
@given(K=st.sampled_from([1, 4, 23, 24, 32]), c=st.sampled_from([1, 7, 14, 33]),
       P=st.sampled_from([1, 31, 33, 70]), fill=st.integers(0, 32),
       specials=st.booleans(), ragged=st.booleans(),
       seed=st.integers(0, 2 ** 32 - 1))
# two NaNs in a column's carry fill botk (K = 1), and the one row is masked
@example(K=1, c=1, P=70, fill=1, specials=True, ragged=True, seed=115)
def test_model_matches_the_reference_bit_for_bit(K, c, P, fill, specials,
                                                  ragged, seed):
    args = _case(seed, c, P, K, fill, specials, ragged)
    got = carve_model(*args)
    _assert_same(got, _reference(args), "model vs topk_carve_ref")
    # the route shares the wrapper reports are the model's
    shares = kernel.carve_routes(*map(torch.from_numpy,
                                      (args[0], args[1], args[3], args[4])))
    fast = got[3]
    assert shares["fast_groups"] == pytest.approx(fast[:, ::32].mean())
    assert shares["fast_warps"] == pytest.approx(fast[-1, ::32].mean())
    if not specials:
        # no -0 and no NaN: every warp stays on the fast route, and the
        # fast route alone is exact
        assert fast.all()
        _assert_same(carve_model(*args, route="fast"), got, "fast route")


@pytest.mark.parametrize("K", [1, 4, 23, 24, 32])
@pytest.mark.parametrize("c", [1, 7, 14, 33])
def test_model_matches_pallas(K, c):
    """Specials, a half-filled carry, ragged validity, two warps and a
    ragged third: the model against the Pallas kernel bit for bit."""
    args = _case(K * 100 + c, c, 70, K, K // 2, True, True)
    want = jkernel.topk_carve_pallas(*map(jnp.asarray, args))
    want = tuple(np.asarray(w) for w in want)
    _assert_same(carve_model(*args), want, "model vs Pallas")
    _assert_same(_reference(args), want, "topk_carve_ref vs Pallas")


@pytest.mark.parametrize("K", [1, 4, 23, 32, 40])
def test_a_masked_row_displaces_a_nan_from_botk(K):
    """The reference masks a row with valid == 0 to +inf for botk, and
    +inf sorts before NaN, so each masked row pushes botk's last NaN out.
    The Pallas kernel, the plain version (the wrapper on the CPU) and,
    for K <= 32, the model agree bit for bit."""
    args = _case(K, 7, 70, K, K, False, False)
    args[1][1:] = 0.0                     # one valid row, six masked
    args[4][-1, ::3] = floats(np.array([NAN_A], U32))[0]
    args[4][-3:, ::7] = floats(np.array([NAN_B], U32))[0]
    want = jkernel.topk_carve_pallas(*map(jnp.asarray, args))
    want = tuple(np.asarray(w) for w in want)
    got = kernel.topk_carve(*map(torch.from_numpy, args))
    _assert_same(tuple(t.numpy() for t in got), want, "wrapper vs Pallas")
    if kernel.carve_window(K):
        _assert_same(carve_model(*args), want, "model vs Pallas")
        assert not carve_model(*args)[3][:, :32].any()   # the exact route
    # one to three NaNs a column: the valid row displaces one, the masked
    # rows the rest; without them a NaN stays where the column has two
    assert not np.isnan(want[2]).any()
    alone = _reference((args[0][:1], args[1][:1]) + args[2:])
    assert np.isnan(alone[2][:, ::7]).any() == (K > 1)


def test_warps_switch_route_at_the_first_keyless_group():
    """A -0 in row 20 of column 40 (warp 1): warp 1 leaves the fast route
    at the row group of row 20, warps 0 and 2 never do, and the result is
    the reference's."""
    args = _case(7, 33, 70, 4, 4, False, False)
    args[0][20, 40] = -0.0
    _, _, _, fast = got = carve_model(*args)
    groups, switch = -(-33 // kernel.CARVE_GROUP), 20 // kernel.CARVE_GROUP
    assert fast[:, 0].all() and fast[:, 64].all()
    np.testing.assert_array_equal(fast[:, 32], np.arange(groups) < switch)
    _assert_same(got, _reference(args), "switch")
    shares = kernel.carve_routes(*map(torch.from_numpy,
                                      (args[0], args[1], args[3], args[4])))
    assert shares == {
        "fast_warps": pytest.approx(2 / 3),
        "fast_groups": pytest.approx((2 * groups + switch) / (3 * groups))}


def test_a_keyless_carry_takes_the_exact_route_from_the_start():
    args = _case(8, 7, 64, 23, 23, False, False)
    args[3][-1, 3] = floats(np.array([NAN_A], U32))[0]   # NaN in topk
    fast = carve_model(*args)[3]
    assert not fast[:, :32].any() and fast[:, 32:].all()
    _assert_same(carve_model(*args), _reference(args), "keyless carry")


def test_fast_route_alone_fails_on_negative_zero_after_positive_zero():
    """Top window {+0, 1} and a -0 arrives: a stable sort keeps the later
    -0 ({-0, 1}); the keys rank -0 below +0 and keep {+0, 1}. The bottom
    window {-1, +0} keeps its earlier +0."""
    block = np.array([[-0.0]], F32)
    args = (block, np.ones(1, F32), np.zeros(1, F32),
            np.array([[0.0], [1.0]], F32), np.array([[-1.0], [0.0]], F32))
    want = _reference(args)
    assert bits(want[1])[0, 0] == SIGN                 # -0 kept in topk
    assert bits(want[2])[1, 0] == 0                    # +0 kept in botk
    fast = carve_model(*args, route="fast")
    assert bits(fast[1])[0, 0] == 0                    # +0: wrong
    assert not np.array_equal(bits(fast[1]), bits(want[1]))
    _assert_same(carve_model(*args), want, "auto route")
    _assert_same(carve_model(*args, route="exact"), want, "exact route")


def test_fast_route_alone_fails_on_two_nan_payloads():
    """Top window {1, NaN_a} and NaN_b arrives: a stable sort keeps both
    NaNs in input order ({NaN_a, NaN_b}); the keys order them by payload
    and NaN_b's is the smaller."""
    nan_a, nan_b = floats(np.array([NAN_A, NAN_B], U32))
    args = (np.array([[nan_b]], F32), np.ones(1, F32), np.zeros(1, F32),
            np.array([[1.0], [nan_a]], F32), np.array([[0.0], [1.0]], F32))
    want = _reference(args)
    np.testing.assert_array_equal(bits(want[1])[:, 0], [NAN_A, NAN_B])
    fast = carve_model(*args, route="fast")
    np.testing.assert_array_equal(bits(fast[1])[:, 0], [NAN_B, NAN_A])
    _assert_same(carve_model(*args), want, "auto route")


def test_windows_and_group_match_the_cuda_source():
    """Review guard on the kernel source, which only the card compiles:
    the buckets and the row group the model and ``carve_routes`` use are
    the kernel's."""
    src = _build.sources("robust_fusion")[0].read_text()
    assert f"constexpr int kCarveGroup = {kernel.CARVE_GROUP};" in src
    launch = src[src.index("void launch_carve("):]
    launch = launch[:launch.index("carve_mem_kernel")]
    buckets = [int(k) for k in re.findall(r"launch_carve_reg<T, (\d+)>",
                                          launch)]
    assert tuple(buckets) == kernel.CARVE_WINDOWS
    assert [kernel.carve_window(K) for K in (1, 3, 5, 23, 24, 25, 32, 33)] \
        == [1, 4, 8, 24, 24, 32, 32, 0]
    for op in ("max(t[j], min(x, t[j + 1]))", "min(b[j], max(x, b[j - 1]))",
               "__any_sync(lanes, odd)"):
        assert op in src
