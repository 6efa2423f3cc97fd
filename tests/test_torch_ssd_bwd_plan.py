"""A CPU model of the SSD-scan backward kernels' schedule, held against
``jax.vjp`` of the JAX package's per-lane oracle ``ssd_chunk_ref`` and
against the port's plain backward ``ssd_scan_bwd_ref``, at rtol 1e-4 with
an absolute part of 1e-4 times each gradient's largest magnitude (the
limit chip_smoke.py holds the kernel to on the card).

The CUDA kernels (``src/repro_torch/csrc/ssd_chunk.cu``, ``ssd_bwd_*``)
run on the card only. What this file models in plain PyTorch and numpy
is their order of work and their arithmetic:

* the forward's saved scores C B^T and chunk-start states (three TF32
  passes with ``split``: hi and lo both rounded to nearest, ties away);
* the state gradient's increments sum_t (exp(cum_t) C_t)^T dy_t over
  64-step tiles and their reverse hand-off G_{c-1} = fma(G_c,
  exp(cum_last), increment);
* the row kernel, per 64-row tile, its column tiles in order: D = dy x^T,
  E = 2^((cum_t - cum_s) log2 e) with the mask applied to the exponent,
  W = CB E, Q = D E, dC += Q B, each lane's running fma of D W over its
  columns (s < t) summed over its quad at the end; then dC += exp(cum_t)
  h dy and iota;
* the column kernel, per 64-column tile, its row tiles from the last to
  the diagonal one, with the row kernel's D, W and Q (the kernel takes
  D^T's passes in the order that gives the same bits): dx += W^T dy,
  dB += Q^T C, the lanes' running fma of D W over their rows (t > s);
  then the state terms G^T B_s, G x_s and sigma;
* dlam's float64 scans in the kernel's thread, warp and block order, and
  the head sums of dB and dC in head order;
* every product as ``mma.sync`` m16n8k8 takes fp32 operands in the
  backward: k in steps of 8, each step's three TF32 passes (lo.hi, hi.lo,
  hi.hi) added to the fp32 accumulator in turn, operands split by
  ``split_rz`` (hi rounded to nearest, ties away; lo = v - hi, which the
  tensor core reads truncated to TF32). One pass (hi.hi) alone leaves the
  tolerance, which a test asserts.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels._build import CSRC
from repro_torch.kernels.ssd_chunk import kernel, ref
from test_torch_ssd_bwd import _jax_vjp_lanes

R = 64                                # steps a row / column tile (kR)
THREADS = 256                         # a dlam block (kBT)
LOG2E = np.float32(1.4426950408889634)
RTOL = 1e-4                           # chip_smoke.py SSD_BWD_RTOL


def tile_plan(L):
    """A model of the loop bounds of the row and column kernels in
    ``csrc/ssd_chunk.cu`` (``ssd_bwd_row_kernel`` / ``ssd_bwd_col_kernel``):
    the causal 64 x 64 tile pairs they walk in a chunk of L steps, in
    their order. ``"row"`` lists (row tile t, [column tiles s]) a block in
    launch order (``tile_index(..., true)``: the last row tile, with the
    most work, first; ``for (int kt = 0; kt <= rt; ++kt)``), ``"col"``
    (column tile s, [row tiles t]) with each block from the last row tile
    to the diagonal one (``row_of(i) = RT - 1 - i`` for i < ``RT - st``).
    On a diagonal tile warp w (rows or steps 16w .. 16w + 15) forms the
    8-wide n-tiles ``"row_diag"[w]`` (``nj = 2 * warp + 2``: at or left of
    its rows) and ``"col_diag"[w]`` (``j0 = 2 * warp``: at or below its
    steps). ``test_tile_plan_mirrors_the_kernels_loops`` holds these
    expressions to the source."""
    rt_n = -(-L // R)
    return {
        "row": [(rt, list(range(rt + 1))) for rt in reversed(range(rt_n))],
        "col": [(st, list(range(rt_n - 1, st - 1, -1))) for st in range(rt_n)],
        "row_diag": [list(range(2 * w + 2)) for w in range(4)],
        "col_diag": [list(range(2 * w, 8)) for w in range(4)],
    }


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"ssd_chunk": 0, "ssd_chunk_bwd": 0}


def _bits(a):
    return a.contiguous().view(torch.int32)


def split(a, fast=True):
    """(hi, lo) of fp32 ``a`` as the tensor cores read them: hi rounded to
    TF32 (the low 13 mantissa bits dropped, to nearest, ties away); lo the
    remainder, truncated to TF32 (``split_rz``, ``fast``) or rounded like
    hi (``split``, the forward's)."""
    hi = ((_bits(a) + 0x1000) & -0x2000).view(torch.float32)
    lo = a - hi
    lo = (_bits(lo) & -0x2000) if fast else ((_bits(lo) + 0x1000) & -0x2000)
    return hi, lo.view(torch.float32)


def mma3(acc, a, b, passes=3, fast=True):
    """acc + a @ b (k the last axis of a) as mma.sync.m16n8k8 takes it: k
    in steps of 8, each step's passes lo.hi, hi.lo, hi.hi added to the
    fp32 accumulator in turn (hi.hi alone with ``passes`` 1)."""
    ah, al = split(a, fast)
    bh, bl = split(b, fast)
    for k in range(0, a.shape[-1], 8):
        ks = slice(k, k + 8)
        if passes == 3:
            acc = acc + al[..., ks] @ bh[..., ks, :]
            acc = acc + ah[..., ks] @ bl[..., ks, :]
        acc = acc + ah[..., ks] @ bh[..., ks, :]
    return acc


def fma(a, b, c):
    """fmaf(a, b, c), rounded once (float64 holds the fp32 product)."""
    return (a.double() * b.double() + c.double()).float()


def quad_sum(v):
    """quad_sum over the last axis (the 4 lanes of a quad): (l0 + l1) +
    (l2 + l3), the xor-1 then xor-2 shuffles."""
    return (v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3])


def lane_fma(acc, d, w, mask):
    """Each lane's running fma of d * w over its columns of a 64-wide tile
    (acc (..., 64, 4): lane t4 holds columns 8j + 2 t4 + q, taken j by j,
    q by q), where ``mask``."""
    for j in range(8):
        for q in range(2):
            idx = 8 * j + 2 * torch.arange(4) + q
            acc = torch.where(mask[..., idx], fma(d[..., idx], w[..., idx], acc), acc)
    return acc


def _hillis_steele(v):
    """Inclusive scan over the last axis (32 lanes), as the shuffles add."""
    incl = v.copy()
    for off in (1, 2, 4, 8, 16):
        shifted = np.zeros_like(incl)
        shifted[..., off:] = incl[..., :-off]
        incl = np.where(np.arange(32) >= off, incl + shifted, incl)
    return incl


def _block_sum(v):
    """block_sum over (..., 8 warps, 32 lanes): a warp's xor butterfly,
    then the warps in order from 0."""
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., np.arange(32) ^ off]
    s = np.zeros(v.shape[:-2])
    for w in range(v.shape[-2]):
        s = s + v[..., w, 0]
    return s


def dlam_model(rowz, iota, colz, sig, gh, L):
    """ssd_bwd_dlam_kernel on planes (..., L) fp32 and gh (...) float64:
    each of 256 threads takes a run of ceil(L / 256) steps, a warp scans
    its runs, the warps' totals are added in order; returns fp32."""
    seg = -(-L // THREADS)
    shape = rowz.shape[:-1]

    def runs(a):
        out = np.zeros(shape + (THREADS * seg,))
        out[..., :L] = a.astype(np.float64)
        return out.reshape(shape + (THREADS // 32, 32, seg))

    rz, io, cz, sg_ = (runs(a) for a in (rowz, iota, colz, sig))
    bt = rz - cz
    ab = np.zeros(rz.shape[:-1])
    sg = np.zeros_like(ab)
    bb = np.zeros_like(ab)
    for k in range(seg):
        ab = ab + (io[..., k] + bt[..., k])
        sg = sg + sg_[..., k]
        bb = bb + bt[..., k]
    iab, isg = _hillis_steele(ab), _hillis_steele(sg)
    run_ab = np.zeros_like(iab)
    run_sg = np.zeros_like(isg)
    run_ab[..., 1:], run_sg[..., 1:] = iab[..., :-1], isg[..., :-1]
    wab, wsg = iab[..., 31], isg[..., 31]
    tot_b = _block_sum(bb)
    tot_ab = np.zeros(shape)
    for w in range(THREADS // 32):
        later = (np.arange(THREADS // 32) > w)[:, None]
        run_ab = np.where(later, run_ab + wab[..., w, None, None], run_ab)
        run_sg = np.where(later, run_sg + wsg[..., w, None, None], run_sg)
        tot_ab = tot_ab + wab[..., w]
    out = np.zeros(shape + (THREADS // 32, 32, seg), np.float32)
    first = np.zeros((THREADS // 32, 32, seg), bool)
    first[0, 0, 0] = True
    for k in range(seg):
        v = np.where(first[..., k], (tot_ab - tot_b)[..., None, None],
                     tot_ab[..., None, None] - run_ab) + run_sg + gh[..., None, None]
        out[..., k] = v.astype(np.float32)
        run_ab = run_ab + (io[..., k] + (rz[..., k] - cz[..., k]))
        run_sg = run_sg + sg_[..., k]
    return out.reshape(shape + (THREADS * seg,))[..., :L]


def model_bwd(lam, Bm, Cm, xdt, dy, chunk=256, passes=3):
    """The backward kernels' schedule on fp32 tensors; returns (dlam, dBm,
    dCm, dxdt) and the tile pairs each kernel visited."""
    B, T, H = lam.shape
    N, P = Bm.shape[-1], xdt.shape[-1]
    L = ref.chunk_len(T, chunk)
    nc, RT = T // L, -(-L // R)
    Lpad, NP = RT * R, kernel.state_pad(N)
    plan = tile_plan(L)
    mm = lambda acc, a, b: mma3(acc, a, b, passes)  # noqa: E731
    padc = lambda a, n: torch.nn.functional.pad(a.float(), (0, n - a.shape[-1]))  # noqa: E731
    Bp, Cp, xp, dyp = padc(Bm, NP), padc(Cm, NP), padc(xdt, 64), padc(dy, 64)
    cum = ref.cumulative_decay(lam.float().reshape(B, nc, L, H), 2).permute(0, 3, 1, 2)
    last = cum[..., -1]                                          # (B, H, nc)
    cum = torch.cat([cum, last[..., None].expand(B, H, nc, Lpad - L)], -1)
    valid = torch.arange(Lpad) < L

    def rows(a, c, t0):      # (B, 64, ...): steps t0 .. of chunk c, 0 past L
        out = torch.zeros((B, R) + a.shape[2:])
        k = min(R, L - t0)
        out[:, :k] = a[:, c * L + t0:c * L + t0 + k]
        return out

    def lane(a, c, t0):      # (B, H, 64, 64) rows of a (B, T, H, 64)
        return rows(a, c, t0).permute(0, 2, 1, 3)

    # the forward's saved states and scores (three passes of split: lo rounded)
    hs = [torch.zeros(B, H, NP, 64)]
    for c in range(nc - 1):
        S = torch.zeros(B, H, NP, 64)
        for st in range(RT):
            s0 = st * R
            dec = torch.exp(last[:, :, c, None] - cum[:, :, c, s0:s0 + R])
            dec = torch.where(valid[s0:s0 + R], dec, torch.zeros(()))
            S = mma3(S, rows(Bp, c, s0).transpose(1, 2)[:, None],
                     lane(xp, c, s0) * dec[..., None], fast=False)
        hs.append(fma(hs[-1], torch.exp(last[:, :, c])[..., None, None], S))
    scores = {(c, rt, kt): mma3(torch.zeros(B, R, R), rows(Cp, c, rt * R),
                                rows(Bp, c, kt * R).transpose(1, 2), fast=False)
              for c in range(nc) for rt in range(RT) for kt in range(rt + 1)}

    # the state gradient: increments, then the reverse hand-off
    G = [None] * nc
    G[nc - 1] = torch.zeros(B, H, NP, 64)
    inc = {}
    for c in range(1, nc):
        acc = torch.zeros(B, H, NP, 64)
        for st in range(RT):
            t0 = st * R
            e = torch.where(valid[t0:t0 + R], torch.exp(cum[:, :, c, t0:t0 + R]),
                            torch.zeros(()))
            A = (rows(Cp, c, t0)[:, None] * e[..., None]).transpose(-1, -2)
            acc = mm(acc, A, lane(dyp, c, t0))
        inc[c] = acc
    for c in range(nc - 2, -1, -1):
        G[c] = fma(G[c + 1], torch.exp(last[:, :, c + 1])[..., None, None], inc[c + 1])

    tri = torch.ones(R, R, dtype=torch.bool).tril()      # s <= t
    strict = torch.ones(R, R, dtype=torch.bool).tril(-1)  # s < t
    visits = {"row": [], "col": []}
    D, E = {}, {}

    def pair_terms(c, rt, kt):   # D, E (t, s) of a tile pair: one set of bits for both kernels
        if (c, rt, kt) not in D:
            t0, s0 = rt * R, kt * R
            D[c, rt, kt] = mm(torch.zeros(B, H, R, R), lane(dyp, c, t0),
                              lane(xp, c, s0).transpose(-1, -2))
            live = valid[t0:t0 + R, None] & valid[None, s0:s0 + R] & (tri if kt == rt else True)
            d2 = (cum[:, :, c, t0:t0 + R, None] - cum[:, :, c, None, s0:s0 + R]) * LOG2E
            E[c, rt, kt] = torch.exp2(torch.where(live, d2, torch.full((), -np.inf)))
        return D[c, rt, kt], E[c, rt, kt]

    dC_part = torch.zeros(B, T, H, N)
    dB_part = torch.zeros(B, T, H, N)
    dx = torch.zeros(B, T, H, P)
    planes = torch.zeros(4, B, H, nc, Lpad)      # sum_s Z, iota, sum_t Z, sigma
    for c in range(nc):
        for rt, kts in plan["row"]:
            t0 = rt * R
            dc = torch.zeros(B, H, R, NP)
            rz = torch.zeros(B, H, R, 4)
            for kt in kts:
                visits["row"].append((c, rt, kt))
                d, e = pair_terms(c, rt, kt)
                w = scores[c, rt, kt][:, None] * e
                rz = lane_fma(rz, d, w, (strict if kt == rt else tri | ~tri).expand_as(d))
                dc = mm(dc, d * e, rows(Bp, c, kt * R)[:, None])
            io = torch.zeros(B, H, R)
            if c > 0:
                v = mm(torch.zeros(B, H, R, NP), lane(dyp, c, t0), hs[c].transpose(-1, -2))
                ec = torch.where(valid[t0:t0 + R], torch.exp(cum[:, :, c, t0:t0 + R]),
                                 torch.zeros(()))
                dc = fma(ec[..., None], v, dc)
                part = torch.zeros(B, H, R, 4)
                Cr = rows(Cp, c, t0)[:, None].expand(B, H, R, NP)
                for jj in range(NP // 8):
                    for q in range(2):
                        idx = 8 * jj + 2 * torch.arange(4) + q
                        part = fma(Cr[..., idx], v[..., idx], part)
                io = quad_sum(part) * ec
            k = min(R, L - t0)
            planes[0, :, :, c, t0:t0 + k] = quad_sum(rz)[..., :k]
            planes[1, :, :, c, t0:t0 + k] = io[..., :k]
            dC_part[:, c * L + t0:c * L + t0 + k] = dc[..., :k, :N].permute(0, 2, 1, 3)
        for st, rts in plan["col"]:
            s0 = st * R
            dxa = torch.zeros(B, H, R, 64)
            dba = torch.zeros(B, H, R, NP)
            cz = torch.zeros(B, H, R, 4)
            for rt in rts:
                visits["col"].append((c, rt, st))
                d, e = pair_terms(c, rt, st)
                dT, eT = d.transpose(-1, -2), e.transpose(-1, -2)
                wT = scores[c, rt, st].transpose(-1, -2)[:, None] * eT
                cz = lane_fma(cz, dT, wT, (strict.t() if rt == st else tri | ~tri).expand_as(dT))
                dxa = mm(dxa, wT, lane(dyp, c, rt * R))
                dba = mm(dba, dT * eT, rows(Cp, c, rt * R)[:, None])
            sg = torch.zeros(B, H, R)
            if c < nc - 1:
                Bs = rows(Bp, c, s0)[:, None].expand(B, H, R, NP)
                bg = mm(torch.zeros(B, H, R, 64), Bs, G[c])
                u = mm(torch.zeros(B, H, R, NP), lane(xp, c, s0), G[c].transpose(-1, -2))
                es = torch.where(valid[s0:s0 + R],
                                 torch.exp(last[:, :, c, None] - cum[:, :, c, s0:s0 + R]),
                                 torch.zeros(()))
                dxa = fma(es[..., None], bg, dxa)
                dba = fma(es[..., None], u, dba)
                part = torch.zeros(B, H, R, 4)
                for jj in range(NP // 8):
                    for q in range(2):
                        idx = 8 * jj + 2 * torch.arange(4) + q
                        part = fma(Bs[..., idx], u[..., idx], part)
                sg = quad_sum(part) * es
            k = min(R, L - s0)
            planes[2, :, :, c, s0:s0 + k] = quad_sum(cz)[..., :k]
            planes[3, :, :, c, s0:s0 + k] = sg[..., :k]
            dx[:, c * L + s0:c * L + s0 + k] = dxa[..., :k, :P].permute(0, 2, 1, 3)
            dB_part[:, c * L + s0:c * L + s0 + k] = dba[..., :k, :N].permute(0, 2, 1, 3)

    # dlam: exp(cum_last) <G_c, h_c> in the kernel's float64 order, the scans
    gh = np.zeros((B, H, nc))
    for c in range(1, nc - 1):   # h_0 = 0 and G_{nc-1} = 0
        prod = (G[c].double() * hs[c].double()).reshape(B, H, -1, THREADS).numpy()
        s = np.zeros((B, H, THREADS))
        for k in range(prod.shape[2]):      # thread tid takes i = tid + 256 k in k order
            s = s + prod[:, :, k]
        gh[..., c] = torch.exp(last[:, :, c]).double().numpy() \
            * _block_sum(s.reshape(B, H, THREADS // 32, 32))
    pl = planes[..., :L].numpy()
    dlam = dlam_model(pl[0], pl[1], pl[2], pl[3], gh, L)         # (B, H, nc, L)
    dlam = torch.from_numpy(dlam).permute(0, 2, 3, 1).reshape(B, T, H)

    def head_sum(part):      # in head order
        s = torch.zeros(B, T, N)
        for h in range(H):
            s = s + part[:, :, h]
        return s

    return (dlam, head_sum(dB_part), head_sum(dC_part), dx), visits


def _inputs(seed, B, T, H, N, P):
    """Seeded inputs; lam on multiples of 2^-8, so that every prefix sum is
    exact in any order (the JAX reference sums lam in fp32, the port in
    float64)."""
    rng = np.random.default_rng(seed)
    lam = -np.abs(rng.normal(size=(B, T, H))).astype(np.float32) * 0.1
    lam = np.round(lam * 256.0).astype(np.float32) / 256.0
    Bm = rng.normal(size=(B, T, N)).astype(np.float32)
    Cm = rng.normal(size=(B, T, N)).astype(np.float32)
    xdt = rng.normal(size=(B, T, H, P)).astype(np.float32)
    dy = rng.normal(size=(B, T, H, P)).astype(np.float32)
    return lam, Bm, Cm, xdt, dy


def _violation(got, want):
    """The largest |got - want| / (rtol |want| + rtol max |want|): under 1
    within the limit."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = RTOL * np.abs(want).max()
    return float(np.max(np.abs(got - want) / (atol + RTOL * np.abs(want))))


NAMES = ("dlam", "dBm", "dCm", "dxdt")


@pytest.mark.parametrize("B,T,H,N,P,chunk", [
    (1, 512, 2, 32, 32, 128),    # four chunks of two row tiles
    (1, 150, 2, 16, 24, 256),    # L = T = 150: one ragged chunk of 3 tiles
    (1, 384, 1, 16, 16, 64),     # B = H = 1: six one-tile chunks
    (1, 75, 3, 10, 7, 256),      # odd N, P and H: N_pad 16, P padded to 64
])
def test_schedule_matches_jax_vjp(B, T, H, N, P, chunk):
    arrays = _inputs(T + 7 * N + P, B, T, H, N, P)
    args = [torch.from_numpy(a) for a in arrays]
    got, _ = model_bwd(*args, chunk=chunk)
    want_jax = _jax_vjp_lanes(*arrays, ref.chunk_len(T, chunk))
    want_plain = ref.ssd_scan_bwd_ref(*args, chunk=chunk)
    for name, g, wj, wp in zip(NAMES, got, want_jax, want_plain):
        assert torch.isfinite(g).all() and g.shape == wp.shape, name
        assert _violation(g.numpy(), wj) < 1.0, name
        assert _violation(g.numpy(), wp.numpy()) < 1.0, name


def test_one_tf32_pass_breaks_the_tolerance():
    """One TF32 pass per product (operands rounded to 10-bit mantissas)
    moves the gradients far past the limit at the Zamba2 widths; three
    passes stay inside it."""
    arrays = _inputs(5, 1, 256, 2, 64, 64)
    args = [torch.from_numpy(a) for a in arrays]
    plain = ref.ssd_scan_bwd_ref(*args, chunk=128)
    three, _ = model_bwd(*args, chunk=128)
    one, _ = model_bwd(*args, chunk=128, passes=1)
    assert max(_violation(g.numpy(), w.numpy()) for g, w in zip(three, plain)) < 0.2
    assert max(_violation(g.numpy(), w.numpy()) for g, w in zip(one, plain)) > 2.0


def test_dlam_of_one_chunk_starts_from_an_exact_zero():
    """With one chunk there is no state before or after it: dlam_0 is the
    float64 difference of two sums of the same per-step terms, an exact
    0, as the plain version's."""
    arrays = _inputs(9, 2, 150, 3, 16, 16)
    args = [torch.from_numpy(a) for a in arrays]
    dlam = model_bwd(*args, chunk=256)[0][0]
    assert torch.equal(dlam[:, 0], torch.zeros_like(dlam[:, 0]))
    assert torch.all(dlam[:, 1:].abs() > 0)


@pytest.mark.parametrize("L", [64, 75, 150, 256, 600, 1000])
def test_schedule_visits_every_causal_tile_pair_once(L):
    """Each kernel takes every (row tile, column tile <= row tile) pair of
    a chunk once; on a diagonal tile each warp's n-tiles cover exactly the
    causal part of its 16 rows (row kernel) or steps (column kernel)."""
    plan = tile_plan(L)
    rt_n = -(-L // R)
    want = sorted((rt, kt) for rt in range(rt_n) for kt in range(rt + 1))
    assert sorted((rt, kt) for rt, kts in plan["row"] for kt in kts) == want
    assert sorted((rt, st) for st, rts in plan["col"] for rt in rts) == want
    # the row blocks with the most column tiles first; a column block ends on its diagonal
    assert [len(k) for _, k in plan["row"]] == sorted((len(k) for _, k in plan["row"]), reverse=True)
    assert all(rts[-1] == st and rts == sorted(rts, reverse=True) for st, rts in plan["col"])
    for w in range(4):
        rows = range(16 * w, 16 * w + 16)
        need = {s // 8 for t in rows for s in range(t + 1)}
        assert set(plan["row_diag"][w]) == need
        need = {t // 8 for s in rows for t in range(s, R)}
        assert set(plan["col_diag"][w]) == need


def test_model_visits_what_the_plan_lists():
    arrays = _inputs(3, 1, 320, 1, 16, 8)
    _, visits = model_bwd(*(torch.from_numpy(a) for a in arrays), chunk=160)
    plan = tile_plan(160)
    for key in ("row", "col"):
        for c in range(2):
            got = [v[1:] for v in visits[key] if v[0] == c]
            if key == "row":
                want = [(rt, kt) for rt, kts in plan["row"] for kt in kts]
            else:
                want = [(rt, st) for st, rts in plan["col"] for rt in rts]
            assert got == want


def test_tile_plan_mirrors_the_kernels_loops():
    """The loop bounds that ``tile_plan`` models, as the CUDA source states
    them: an edit to the kernels' walk must be made in the model too."""
    src = (Path(CSRC) / "ssd_chunk.cu").read_text()
    for line in ("r.tile = last_first ? RT - 1 - k : k;",
                 "const TileIdx ix = tile_index(RT, H, B, true);",
                 "const TileIdx ix = tile_index(RT, H, B, false);",
                 "for (int kt = 0; kt <= rt; ++kt) {",
                 "const int n_rt = RT - st;",
                 "auto row_of = [&](int i) { return RT - 1 - i; };",
                 "const int nj = kDiag ? 2 * warp + 2 : 8;",
                 "const int j0 = kDiag ? 2 * warp : 0;"):
        assert line in src, line


@pytest.mark.parametrize("T,chunk,kernels", [
    (1024, 256, 6),    # Zamba2-1.2B layer: increments and hand-off, row, column, dlam, head sums
    (600, 256, 4),     # L = T: one chunk, no state gradient
    (4096, 256, 6),
    (300, 256, 4),
    (48, 16, 6),
])
def test_bwd_device_kernels(T, chunk, kernels):
    assert kernel.bwd_device_kernels(T, chunk) == kernels
