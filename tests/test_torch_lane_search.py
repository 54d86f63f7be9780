"""The λ searches' lane core (csrc/lane_search.cuh, K3 and K7) on the
CPU: the wrapper-side arithmetic of its launch, a numpy emulation of its
summation order, and the lane independence of the plain versions.

  * lane grouping: a launch's blocks hold one team for each of its lanes
    [s0, s0 + count), once, in order, L a block, the last block partial;
    above 32 covariates (the GT_DYN form) each team's working set is its
    own slice of the scratch, and a scratch budget of three lanes splits
    the block into launches that still cover every lane once;
  * the shared-memory layout of every form (K3 float32 shared, K3
    per-lane with float64 sums, K7 shared and per-lane; n_cvt from 0 to
    64): its parts follow one another without gaps or overlaps, the block
    fits an H100's 227 KB, and the working sets leave shared memory past
    32 covariates.  chip_smoke.py holds this arithmetic against the
    kernels' own size functions on the card;
  * the kernel's summation order (tiles of rows, each thread's rows of a
    tile added in order, then the thread slices in order; the scalars per
    tile slot, then the slots in order; Σ h r² per thread, warp and warp
    order) emulated in numpy: the base rows of dev12, Σ h, Σ h², Σ log v,
    the Gram and Σ h r² of logf_stable within 1e-12 relative of the
    port's float64 sums, and the logf_stable built from them within
    1e-12 of the reference's (gemma_tpu);
  * lambda_solve_plain and lambda_solve_f64_plain on a seeded block that
    mixes lanes with two sign-change intervals, flat lanes (none), lanes
    that NaN-poison and lanes whose Newton converges in one step equal
    the same functions lane by lane, bit for bit in float64 (λ of both,
    K7's logf; K3's logf_stable within 4 ulp, its W-only Gram being one
    BLAS product over the lanes): the lane independence the kernels'
    lock-step must keep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.models.lmm import likelihood as tlk
from gemma_torch import kernels
from gemma_torch.models.lmm import likelihood as lk
from gemma_torch.models.lmm import optimize as opt

F64 = torch.float64
# (K3 or K7, float64 sums, per-lane operands)
FORMS = {"k3_shared": (False, False, False), "k3_lane": (False, True, True),
         "k3_lane_f32": (False, False, True), "k7_shared": (True, False, False),
         "k7_lane": (True, False, True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=F64)


@pytest.mark.parametrize("count", [1, 3, 7, 8, 9, 13, 64, 100])
@pytest.mark.parametrize("L", [1, 4, 8])
def test_search_blocks_cover_the_lanes(count, L):
    for s0 in (0, 5):
        blocks = opt.search_blocks(s0, count, L)
        lanes = [f + j for f, nl, _ in blocks for j in range(nl)]
        assert lanes == list(range(s0, s0 + count))
        assert all(nl == L for _, nl, _ in blocks[:-1])
        assert blocks[-1][1] == (count % L or L)
        # the lane-indexed scratch: lane s's slice is s - s0 of the launch
        for f, nl, slot in blocks:
            assert slot == f - s0


@pytest.mark.parametrize("S", [1, 2, 3, 4, 7, 9, 17])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_scratch_splits_cover_the_lanes(S, form):
    f64, wide, per_lane = FORMS[form]
    geo = opt.search_geometry(40, 1940, f64, wide, per_lane)
    lane_bytes = geo["ws_bytes"]
    budget = 3 * lane_bytes
    seen, offsets = [], []
    for a, b in kernels.lane_ranges(S, lane_bytes, budget):
        assert 1 <= b - a <= 3
        for f, nl, slot in opt.search_blocks(a, b - a, geo["L"]):
            for j in range(nl):
                seen.append(f + j)
                offsets.append((slot + j) * lane_bytes)
        # every lane's slice inside the launch's scratch
        assert max(offsets[-(b - a):]) + lane_bytes <= budget
    assert seen == list(range(S))


@pytest.mark.parametrize("n_cvt", [0, 1, 2, 3, 16, 17, 19, 20, 24, 32, 33,
                                   40, 64])
@pytest.mark.parametrize("n", [60, 1940, 20000])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_search_layout_fits_the_card(n_cvt, n, form):
    f64, wide, per_lane = FORMS[form]
    y = opt.search_geometry(n_cvt, n, f64, wide, per_lane)
    L, TR, ni, C1 = y["L"], y["TR"], y["ni"], n_cvt + 1
    M = C1 * (C1 + 1) // 2
    t = 8 if f64 or wide else 4
    tin = 8 if f64 else 4
    assert L == (1 if per_lane or wide and not f64 else 4 if f64 else 8)
    assert 8 <= TR <= opt.LS_TR and TR & (TR - 1) == 0
    assert y["bytes"] <= (opt.LS_RESIDENT_MAX if y["resident"]
                          else opt.LS_SMEM_MAX)
    # the sums' threads: items of two columns (the pairs, then x with a
    # UtWy column) cover every flat position but x·x, in slices of whole
    # vectors of a tile's rows below 256 items, in passes of 256 above
    assert y["items"] == (M + 1) // 2 + (C1 + 1) // 2 and M + C1 + 1 == ni
    vw = 16 // t
    if y["items"] <= opt.LS_THREADS:
        sl = y["slices"]
        assert y["passes"] == 1 and sl & (sl - 1) == 0
        assert sl * y["items"] <= opt.LS_THREADS and (TR // sl) % vw == 0
        assert 2 * sl * y["items"] > opt.LS_THREADS or 2 * sl > TR // vw
    else:
        assert y["slices"] == 1
        assert (y["passes"] - 1) * 256 < y["items"] <= y["passes"] * 256
    sizes = {"kind": 4 * 8, "lane": 4 * 8, "lam": t * 8, "aux": t * 8, "res": 2 * t * 8,
             "lsc": 6 * t * 8, "wred": t * 8 * 8,
             "u": n * C1 * tin if y["resident"] else 0 if y["rows"]
             else 2 * TR * C1 * tin}
    # the row-split sums (c <= 1) keep each thread's 24 partial sums for
    # the team's reduction; the column sums their weights and slices
    assert y["rows"] == (n_cvt <= 1)
    if y["rows"]:
        sizes["part"] = 256 * (3 * 6 + 6) * t
    else:
        sizes.update(h=L * 3 * TR * t, hx=L * 3 * TR * t,
                     sl=y["slices"] * ni * L * 3 * t if y["slices"] > 1
                     else 0)
    sizes["ws"] = L * y["ws_bytes"] if n_cvt <= 32 else 0
    at = 0
    for name, b in sizes.items():
        assert y[name] == at, name
        at += (b + 15) // 16 * 16
    assert y["bytes"] == at
    ws = (6 * ni * t + 15) // 16 * 16
    if not f64:
        ws += (C1 * C1 * t + 15) // 16 * 16 + 3 * ((C1 * t + 15) // 16 * 16)
    assert y["ws_bytes"] == ws
    # the mouse block's shapes keep UtWy in shared memory
    if n == 1940 and n_cvt <= 1:
        assert y["resident"]


def _block(n, S, n_cvt, seed):
    """A seeded block in rotated form: eigenvalues (a few zero), an
    intercept and normal covariates, a response, S genotype rows."""
    rng = np.random.default_rng(seed)
    Xk = rng.binomial(2, 0.3, size=(300, n)).astype(np.float64)
    Xkc = Xk - Xk.mean(axis=1, keepdims=True)
    K = Xkc.T @ Xkc / 300
    Kc = K - K.mean(0) - K.mean(1)[:, None] + K.mean()
    w, U = np.linalg.eigh(Kc)
    w = np.where(w < 1e-10, 0.0, w)
    y = np.linalg.cholesky(K + 1e-6 * np.eye(n)) @ rng.normal(size=n) \
        + rng.normal(size=n)
    W = np.column_stack([np.ones(n), rng.normal(size=(n, n_cvt - 1))])
    X = rng.binomial(2, 0.3, size=(S, n)).astype(np.float64)
    return w, U.T @ W, U.T @ y, X @ U


def _columns(n_cvt):
    """Each flat position's column: ('p', a, b) a pair of UtWy columns,
    ('x', j) x with UtWy column j, ('xx',) (ls_item's items cover the
    first two kinds, the lane scalars x·x)."""
    cols = n_cvt + 2
    out = []
    for a in range(1, cols + 1):
        for b in range(a, cols + 1):
            def u(lab):
                return n_cvt if lab == n_cvt + 2 else lab - 1
            if a == b == n_cvt + 1:
                out.append(("xx",))
            elif n_cvt + 1 in (a, b):
                out.append(("x", u(b if a == n_cvt + 1 else a)))
            else:
                out.append(("p", u(a), u(b)))
    return out


def _emulate_sums(ev, UtWy, X, lam, n_cvt, geo):
    """ls_sums in numpy: the base rows (L, 3, ni) and the lane scalars
    Σ h, Σ h², Σ log v, Σ h^p x² (L, 6) of lanes with rows X (L, n) at
    lam (L,), in the kernel's order: a column's slice of a tile adds its
    rows in order, the slices are added in order; a scalar's tile slot
    adds the tiles in order, the slots are added in order.  A column's
    slice adds the partial of every LS_FOLD_ROWS of its rows to its
    running sum; in the row-split
    form a thread adds its rows in blocks of LS_ROWS_BLOCK, then the team
    adds its threads in order."""
    n, L = len(ev), len(lam)
    TR, slices, ni = geo["TR"], geo["slices"], geo["ni"]
    rs = TR // slices
    v = lam[:, None] * ev[None, :] + 1.0
    h = 1.0 / v
    hx = h * X
    H = np.stack([h, h * h, h * h * h], axis=1)                 # (L, 3, n)
    HX = np.stack([hx, hx * h, hx * h * h], axis=1)
    B = np.zeros((n, ni))
    kinds = _columns(n_cvt)
    for k, c in enumerate(kinds):
        if c[0] == "p":
            B[:, k] = UtWy[:, c[1]] * UtWy[:, c[2]]
        elif c[0] == "x":
            B[:, k] = UtWy[:, c[1]]
    is_p = np.array([c[0] == "p" for c in kinds])
    if geo["rows"]:
        # each team thread tt adds rows tt, tt + TS, ... ; the team adds
        # its threads in order
        TS = opt.LS_THREADS // geo["L"]
        A = np.where(is_p[None, None, None, :], H[..., None],
                     HX[..., None]) * B[None, None]         # (L, 3, n, ni)
        val = np.stack([h, h * h, np.log(np.abs(v)), hx * X, hx * h * X,
                        hx * h * h * X], axis=1)            # (L, 6, n)
        rows, scal = 0.0, 0.0
        for tt in range(TS):
            part, spart = 0.0, 0.0
            mine = list(range(tt, n, TS))
            for b0 in range(0, len(mine), opt.LS_ROWS_BLOCK):
                bp, bs = 0.0, 0.0
                for i in mine[b0:b0 + opt.LS_ROWS_BLOCK]:
                    bp = bp + A[:, :, i]
                    bs = bs + val[:, :, i]
                part, spart = part + bp, spart + bs
            rows, scal = rows + part, scal + spart
        rows = np.array(rows, dtype=np.float64)
        kxx = kinds.index(("xx",))
        rows[:, :, kxx] = scal[:, 3:]
        return rows, scal
    ntiles = -(-n // TR)
    fold = max(1, opt.LS_FOLD_ROWS // rs)
    acc = np.zeros((slices, L, 3, ni))
    for t0 in range(0, ntiles, fold):
        for s in range(slices):
            part = 0.0
            for tile in range(t0, min(t0 + fold, ntiles)):
                rv = min(TR, n - tile * TR)
                for r in range(s * rs, min(s * rs + rs, rv)):
                    i = tile * TR + r
                    A = np.where(is_p[None, None, :], H[:, :, i, None],
                                 HX[:, :, i, None])
                    part = part + A * B[i][None, None, :]
            acc[s] = acc[s] + part
    rows = acc[0]
    for s in range(1, slices):
        rows = rows + acc[s]
    slot = np.zeros((6, L, TR))
    for tile in range(ntiles):
        rv = min(TR, n - tile * TR)
        i = tile * TR + np.arange(rv)
        for q, val in enumerate((h, h * h, np.log(np.abs(v)), hx * X,
                                 hx * h * X, hx * h * h * X)):
            slot[q, :, :rv] += val[:, i]
    scal = np.zeros((L, 6))
    for r in range(TR):
        scal += slot[:, :, r].T
    kxx = kinds.index(("xx",))
    rows[:, :, kxx] = scal[:, 3:]
    return rows, scal


def _warp_order_sum(per_thread):
    """Σ over 256 thread partials: xor-shuffle tree in each warp, then the
    warps in order (ls_residual)."""
    tot = 0.0
    for w in range(8):
        v = per_thread[w * 32:(w + 1) * 32].copy()
        for o in (16, 8, 4, 2, 1):
            v = v + v[np.arange(32) ^ o]
        tot += v[0]
    return tot


@pytest.mark.parametrize("n_cvt", [1, 3, 24])
def test_summation_order_matches_dev12_and_logf_stable(n_cvt):
    n, L = 150, 4
    ev, UtW, Uty, Utx = _block(n, L, n_cvt, seed=7 + n_cvt)
    data = lk.build_batch_data(_t(ev), _t(UtW), _t(Uty), _t(Utx), n_cvt)
    UtWy = data.UtWy.numpy()
    lam = np.array([3e-4, 0.07, 2.5, 900.0])
    for f64, wide, per_lane in FORMS.values():
        geo = opt.search_geometry(n_cvt, n, f64, wide, per_lane)
        rows, scal = _emulate_sums(ev, UtWy, Utx, lam, n_cvt, geo)
        # the present dev12 sums: base rows at orders 1-3, Σ h, Σ h²
        ref = lk._base_rows_multi(*lk._weights(_t(lam), data.eval)[1:], data,
                                  n_cvt, 3)
        for p in range(3):
            want = ref[p].numpy()
            assert np.max(np.abs(rows[:, p] - want)) <= \
                1e-12 * np.max(np.abs(want))
        h = 1.0 / (lam[:, None] * ev + 1.0)
        for q, want in enumerate((h.sum(1), (h * h).sum(1),
                                  np.log(lam[:, None] * ev + 1.0).sum(1))):
            np.testing.assert_allclose(scal[:, q], want, rtol=1e-12)
    # K3's logf_stable from its emulated sums: the Gram and right-hand
    # side of [W, x] from the order-1 row, Σ h r² in the residual's order
    rows, scal = _emulate_sums(ev, UtWy, Utx, lam, n_cvt, opt.search_geometry(
        n_cvt, n, *FORMS["k3_shared"]))
    cols = n_cvt + 2

    def ab(a, b):
        a, b = min(a, b), max(a, b)
        return (2 * cols - a + 2) * (a - 1) // 2 + (b - a)
    CZ = n_cvt + 1
    got = []
    for li in range(L):
        row = rows[li, 0]
        G = np.array([[row[ab(i + 1, j + 1)] for j in range(CZ)]
                      for i in range(CZ)])
        rhs = np.array([row[ab(i + 1, cols)] for i in range(CZ)])
        W, y = UtWy[:, :n_cvt], UtWy[:, n_cvt]
        x = Utx[li]
        Z = np.column_stack([W, x])
        hl = 1.0 / (lam[li] * ev + 1.0)
        np.testing.assert_allclose(G, (Z * hl[:, None]).T @ Z, rtol=1e-12,
                                   atol=1e-12 * np.abs(G).max())
        np.testing.assert_allclose(rhs, (Z * hl[:, None]).T @ y,
                                   rtol=1e-12, atol=1e-12 * np.abs(rhs).max())
        Lc = np.linalg.cholesky(G)
        beta = np.linalg.solve(Lc.T, np.linalg.solve(Lc, rhs))
        r = y - W @ beta[:n_cvt] - x * beta[n_cvt]
        per = np.zeros(256)
        for i in range(n):
            per[i % 256] += hl[i] * r[i] * r[i]
        p_yy = _warp_order_sum(per)
        np.testing.assert_allclose(p_yy, np.sum(hl * r * r), rtol=1e-12)
        Z0 = Z.T @ Z
        logdet0 = np.linalg.slogdet(Z0)[1]
        df = n - n_cvt - 1
        got.append(lk.logf_const(n, n_cvt, False, True)
                   - 0.5 * scal[li, 2] - 0.5 * (2 * np.log(np.diag(Lc)).sum()
                                                - logdet0)
                   - 0.5 * df * np.log(p_yy))
    want = lk.logf_stable(_t(lam), data, n_cvt, False, True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    jdata = tlk.build_batch_data(*(jnp.asarray(a, jnp.float64) for a in
                                   (ev, UtW, Uty, Utx)), n_cvt)
    jwant = np.asarray(tlk.logf_stable(jnp.asarray(lam), jdata, n_cvt, False,
                                       True))
    np.testing.assert_allclose(got, jwant, rtol=1e-12)


def mixed_block(seed=135, n=60, S=48):
    """A seeded shared-operand block whose lanes mix the searches' exits
    (chip_smoke.py builds its mixed blocks the same way at the mouse n):
    eigenvalues log-uniform (three zero), a response whose variance along
    the eigenvectors follows one of two random λ on random halves (so the
    likelihood of some lanes has two sign-change intervals), genotype
    rows of random scales, and three rows that repeat the intercept
    (collinear: the REML search NaN-poisons).  Returns the rotated
    operands eval, W (n, 1), y, X (S, n)."""
    rng = np.random.default_rng(seed)
    ev = np.sort(np.exp(rng.uniform(np.log(1e-3), np.log(1e3), n)))
    ev[:3] = 0.0
    l1, l2 = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), 2))
    grp = rng.random(n) < 0.5
    y = rng.normal(size=n) * np.sqrt(np.where(grp, l1 * ev + 1,
                                              l2 * ev + 1))
    w = rng.normal(size=n)
    X = rng.normal(size=(S, n)) * np.exp(rng.uniform(-3, 3, (S, 1)))
    X[[5, 17, 30]] = np.stack([w, 2.0 * w, -w])
    return ev, w[:, None], y, X


def _plain_both(ev, W, y, X, n_cvt, reml, d1f=None):
    """Both plain searches on rows X; K3's from the fine grid's dev1 d1f
    (K2's output, computed on these rows where not given)."""
    d64 = lk.build_batch_data(_t(ev), _t(W), _t(y), _t(X), n_cvt)
    fine = opt.fine_grid(1e-5, 1e5, 10, opt._F32_GRID_REFINE)
    if d1f is None:
        d1f = lk.dev1_grid(fine, d64, n_cvt, False, reml)
    st3, st7 = {}, {}
    r3 = opt.lambda_solve_plain(d1f, fine, d64, n_cvt, False, reml, 1e-5,
                                1e5, 10, stats=st3)
    r7 = opt.lambda_solve_f64_plain(d64, n_cvt, False, reml, 1e-5, 1e5, 10,
                                    stats=st7)
    return r3, r7, st3, st7


def _same(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        a.nan_to_num(0.0), b.nan_to_num(0.0))


@pytest.mark.parametrize("reml", [True, False], ids=["reml", "ml"])
def test_plain_searches_are_lane_independent(reml):
    ev, W, y, X = mixed_block()
    fine = opt.fine_grid(1e-5, 1e5, 10, opt._F32_GRID_REFINE)
    d1f = lk.dev1_grid(fine, lk.build_batch_data(_t(ev), _t(W), _t(y), _t(X),
                                                 1), 1, False, reml)
    r3, r7, st3, st7 = _plain_both(ev, W, y, X, 1, reml, d1f)
    # the block mixes what it is meant to: K7's exits on its lanes
    iv, steps = st7["intervals"], st7["newton_steps"]
    nan = torch.isnan(r7.lam)
    assert int(((iv >= 2) & ~nan).sum()) >= 1
    assert int((iv == 0).sum()) >= 1
    assert int(((steps == iv) & (iv > 0)).sum()) >= 1
    assert int(nan.sum()) == (3 if reml else 0)
    for s in range(X.shape[0]):
        q3, q7, _, _ = _plain_both(ev, W, y, X[s:s + 1], 1, reml,
                                   d1f[:, s:s + 1].contiguous())
        assert _same(q3.lam, r3.lam[s:s + 1])
        assert _same(q7.lam, r7.lam[s:s + 1]) and _same(q7.logf,
                                                         r7.logf[s:s + 1])
        # logf_stable's W-only Gram is one matrix product over the lanes,
        # which BLAS blocks by the lane count: its last bit may move
        assert _same(q3.logf.isnan(), r3.logf[s:s + 1].isnan())
        assert float((q3.logf - r3.logf[s:s + 1]).abs().nan_to_num(0.0)) \
            <= 4 * torch.finfo(F64).eps * float(r3.logf[s].abs()
                                                 .nan_to_num(0.0))
