"""The schedule of K4/K5 (csrc/test_tail.cuh) and K6's speed mode
(csrc/lrt_tail.cu) in numpy, against their plain versions, and the plain
versions against the reference.

The mirror follows the kernels' order of work (csrc/test_sums.cuh): each
lane's weights made once an individual (rounded to T for K4/K5, float64
for K6); the sums in the launch form's order: a warp a lane (c <= 3: 32
threads over the individuals, then a butterfly), a tile of lanes on DMMA
(shared operands: each column's sum in individual order, k-steps of 4
within chunks of up to 32; Σ h x² and Σ log over a warp a lane) or a block a
lane (per-lane operands: each column in individual order, the row sums
over the block's last 16 threads and its warps in order; K6's Σ log in
the register form the log of each round's product of eight v); the
single-lane null in
parts of TS_PART individuals summed in order; the rows rounded once to T
and the recurrence over the live entries only; K6's Gram factored column
by column, the forward solve in k order and the back solve from the
last column, and the residual pass in each form's order.  The chunk
sizes and shared memory come from chip_smoke.py's tail_layout, which
chip_smoke holds equal to the kernels' own size functions on the card.

Tolerances: the mirror against the plain versions at chip_smoke.py's
holds: K4/K5 |p - p_plain| <= 1e-5 (3e-5 for the per-lane and c >= 24
forms, TOL_LANE) and |beta - beta_plain| <= 1e-3 se in float32, 1e-10
and 1e-8 se in float64; K6 |logl - logl_plain| <= 1e-12 |logl_plain| and
|p - p_plain| <= 1e-6.  The plain versions against the reference, float64,
as tests/test_torch_assoc.py: p-values abs 1e-8, the other statistics
rel 1e-9.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import (TAIL_LANE, TAIL_LRT, TAIL_LRT_NULL, TAIL_MMA,
                        TAIL_REG, TAIL_TEST, tail_form, tail_layout)
from gemma_tpu.models.lmm import likelihood as tlk
from gemma_tpu.ops import stats as tstats
from gemma_torch.models.lmm import likelihood as lk
from gemma_torch.models.lmm.engine import gene_batch_data, gxe_batch_data
from gemma_torch.models.lmm.indices import pab_indices
from gemma_torch.ops.stats import chisq_sf, f_sf

N = 160           # individuals
S_SHARED = 20     # lanes of a shared block: two tiles of 8 and one of 4
S_LANE = 5        # lanes of a per-lane block
PART = 128        # TS_PART: individuals a block of a single-lane null
f32, f64 = np.float32, np.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(seed=3):
    """Seeded eigen-rotated operands of a kinship of binomial genotypes."""
    rng = np.random.default_rng(seed)
    G = rng.binomial(2, 0.3, size=(300, N)).astype(f64)
    Gc = G - G.mean(1, keepdims=True)
    K = Gc.T @ Gc / G.shape[0]
    ev, U = np.linalg.eigh(K - K.mean(0) - K.mean(1)[:, None] + K.mean())
    ev = np.where(ev < 1e-10, 0.0, ev)
    y = np.linalg.cholesky(K + 1e-6 * np.eye(N)) @ rng.normal(size=N) \
        + rng.normal(size=N)
    X = rng.binomial(2, 0.3, size=(S_SHARED, N)).astype(f64)
    X[:3] += (y > np.median(y)) * 0.5
    W = np.column_stack([np.ones(N), rng.normal(size=(N, 47))])
    env = rng.normal(size=N)
    E = rng.normal(size=(S_LANE, N))
    # columns 48-119, drawn last: c = 120, past the staging of whole rows
    W = np.column_stack([W, rng.normal(size=(N, 72))])
    return dict(ev=ev, U=U, y=y, X=X, W=W, env=env, E=E)


OPS = _operands()


def _block(mode, nc, dt):
    """(data, n_cvt of the kernels) of a shared, GxE or gene block."""
    o = OPS
    t = lambda a: torch.as_tensor(a, dtype=dt)  # noqa: E731
    U = o["U"]
    Uty = U.T @ o["y"]
    if mode == "shared":
        return lk.build_batch_data(t(o["ev"]), t(U.T @ o["W"][:, :nc]),
                                   t(Uty), t(o["X"] @ U), nc), nc
    if mode == "gxe":                       # [W, env, x]: nc - 2 columns
        x = o["X"][:S_LANE]
        return gxe_batch_data(t(o["ev"]), t(U.T @ o["W"][:, :nc - 2]),
                              t(U.T @ o["env"]), t(Uty), t(x @ U),
                              t((x * o["env"]) @ U), nc - 2), nc
    return gene_batch_data(t(o["ev"]), t(U.T @ o["W"][:, :nc]),
                           t(o["X"][0] @ U), t(o["E"] @ U), nc), nc


def _lams(S, dt, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(10.0 ** rng.uniform(-1.5, 1.5, S), dtype=dt)


# --- the mirror --------------------------------------------------------

def _lane_ops(data):
    """Per-lane numpy operands: eval (n,), [W, y] (S, n, C1), wy (S, n,
    M), x (S, n), whatever the lane strides."""
    S = lk.n_lanes(data)
    n = data.eval.shape[0]
    np_ = lambda a: a.numpy()  # noqa: E731
    UtWy = np_(data.UtWy)
    wy = np_(data.wy_prod)
    if UtWy.ndim == 2:
        UtWy = np.broadcast_to(UtWy, (S,) + UtWy.shape)
        wy = np.broadcast_to(wy, (S,) + wy.shape)
    x = np.broadcast_to(np_(data.Utx), (S, n))
    return np_(data.eval), UtWy, wy, x


def _threads(v, T):
    """(S, T, R): thread t's sum of v[:, i] over i ≡ t (mod T), in order."""
    S, n, R = v.shape
    acc = np.zeros((S, T, R))
    for i0 in range(0, n, T):
        blk = v[:, i0:i0 + T]
        acc[:, :blk.shape[1]] += blk
    return acc


def _butterfly(acc):
    """A shuffle butterfly over axis 1 (a power of two wide)."""
    w = acc.shape[1]
    o = w // 2
    while o:
        acc = acc + acc[:, np.arange(w) ^ o]
        o //= 2
    return acc[:, 0]


def _block_sum(acc):
    """ts_block_sum of 256 threads' partials (S, 256, R): each warp's
    butterfly, then the warps in order."""
    tot = 0.0
    for w in range(8):
        tot = tot + _butterfly(acc[:, 32 * w:32 * w + 32])
    return tot


def _lane_rowsum(v, kc):
    """The lane form's row sums: the block's last kc threads over the
    individuals, then the block sum (the other threads hold zeros)."""
    acc = np.zeros((v.shape[0], 256, v.shape[2]))
    acc[:, 256 - kc:] = _threads(v, kc)
    return _block_sum(acc)


def _sums(terms, rowsum, form, S, n, kc=16):
    """The lanes' sums in the form's order: terms (S, n, Q) of the
    columns, rowsum (S, n, R) of the row sums (Σ h x², Σ log); kc the
    chunk's individuals (tail_layout)."""
    if form == TAIL_REG:
        tot = _butterfly(_threads(np.concatenate([terms, rowsum], axis=2),
                                  32))
        return tot[:, :terms.shape[2]], tot[:, terms.shape[2]:]
    cols = np.zeros((S, terms.shape[2]))
    for i in range(n):                       # each column in i order
        cols = cols + terms[:, i]
    if form == TAIL_MMA:                  # a warp a lane
        acc = np.zeros((S, 32, rowsum.shape[2]))
        acc[:, :kc] = _threads(rowsum, kc)
        return cols, _butterfly(acc)
    return cols, _lane_rowsum(rowsum, kc)


def _pair_cols(C1):
    return [(a, b) for a in range(C1) for b in range(a, C1)]


def _test_rows(lam, data, nc, shared):
    """K4/K5's rows: the sums rounded once to T at their flat positions."""
    T = lam.numpy().dtype.type
    ev, UtWy, wy, x = _lane_ops(data)
    l = lam.numpy().astype(T)
    h = (T(1) / (l[:, None] * ev[None, :].astype(T) + T(1))).astype(T)
    hx = (h * x.astype(T)).astype(T)
    a1, a2 = h.astype(f64), hx.astype(f64)
    terms = np.concatenate([a1[..., None] * wy.astype(f64),
                            a2[..., None] * UtWy.astype(f64)], axis=2)
    rowsum = (a2 * x.astype(f64))[..., None]
    S, n = a1.shape
    form = tail_form(nc, shared)
    kc = tail_layout(nc, form, TAIL_TEST, T(0).itemsize)["kc"]
    cols, rs = _sums(terms, rowsum, form, S, n, kc)
    q = np.concatenate([cols, rs], axis=1)          # (S, Q)
    idx = pab_indices(nc)
    C1, M = nc + 1, wy.shape[2]
    # the sum at each flat position
    at = np.empty(idx.n_index, dtype=np.int64)
    at[np.asarray(idx.wy_positions)] = np.arange(M)
    at[int(idx.xx)] = M + C1
    at[np.asarray(idx.xw_positions)] = M + np.asarray(idx.xw_partners)
    return q[:, at].astype(T), form


def _recur(row, nc):
    """ts_recur: steps 1..c over the live entries in place, then the (y, y)
    entry of step c + 1."""
    idx = pab_indices(nc)
    T = row.dtype.type
    row = row.copy()
    ni = idx.n_index
    for p in range(1, nc + 1):
        ww = row[:, idx.ww[p - 1]]
        nz = ww != 0
        safe = np.where(nz, ww, T(1))
        live = np.arange(idx.ww[p], ni)
        a = row[:, idx.aw[p - 1][live]]
        b = row[:, idx.bw[p - 1][live]]
        v = row[:, live]
        row[:, live] = np.where(nz[:, None],
                                v - a * b / safe[:, None], v)
    p_yy, p_xx, p_xy = row[:, ni - 1], row[:, idx.xx], row[:, idx.xy]
    nz = p_xx != 0
    px_yy = np.where(nz, p_yy - p_xy * p_xy / np.where(nz, p_xx, T(1)), p_yy)
    return p_yy, p_xx, p_xy, px_yy


def _mirror_test(lam, data, nc, shared, score):
    row, form = _test_rows(lam, data, nc, shared)
    T = row.dtype.type
    n = data.eval.shape[0]
    p_yy, p_xx, p_xy, px_yy = _recur(row, nc)
    with np.errstate(all="ignore"):
        df = T(n - nc - 1)
        tau = df / px_yy
        beta = p_xy / p_xx
        se = np.sqrt(T(1) / (tau * p_xx))
        f = (T(n) * p_xy * p_xy / (p_yy * p_xx) if score
             else (p_xy * p_xy / p_xx) * tau)
    p = f_sf(torch.as_tensor(f.astype(f64)), 1.0, float(n - nc - 1)).numpy()
    return beta, se, p.astype(T), form


def _factor(q, nc, M, null):
    """ts_factor on each lane: packed Gram, Cholesky column by column,
    forward solve in k order, back solve from the last column (each
    lane's operations in the kernel's order, the lanes side by side)."""
    C1 = nc + 1
    CZ = nc if null else nc + 1
    pair = {ab: i for i, ab in enumerate(_pair_cols(C1))}
    S = q.shape[0]
    G = np.zeros((S, CZ, CZ))
    r = np.zeros((S, CZ))
    for i in range(CZ):
        for j in range(i + 1):
            G[:, i, j] = (q[:, pair[(j, i)]] if i < nc else
                          q[:, M + j] if j < nc else q[:, M + C1])
        r[:, i] = q[:, pair[(i, nc)]] if i < nc else q[:, M + nc]
    ok = np.ones(S, dtype=bool)
    with np.errstate(all="ignore"):
        for j in range(CZ):
            d = G[:, j, j].copy()
            for k in range(j):
                d -= G[:, j, k] * G[:, j, k]
            ok &= d > 0
            G[:, j, j] = np.sqrt(np.where(ok, d, 1.0))
            v = G[:, j + 1:, j].copy()
            for k in range(j):
                v -= G[:, j + 1:, k] * G[:, j, k][:, None]
            G[:, j + 1:, j] = v / G[:, j, j][:, None]
        for k in range(CZ):
            r[:, k] = r[:, k] / G[:, k, k]
            r[:, k + 1:] -= G[:, k + 1:, k] * r[:, k:k + 1]
        for k in range(CZ - 1, -1, -1):
            r[:, k] = r[:, k] / G[:, k, k]
            r[:, :k] -= G[:, k, :k] * r[:, k:k + 1]
    r[~ok] = np.nan
    return r


def _mirror_logl(lam, data, nc, shared, null, parts=False):
    """K6's float64 logl of each lane (the null model where `null`; in
    parts of PART individuals where `parts`, the single-lane null)."""
    ev, UtWy, _, x = _lane_ops(data)
    S = lam.numel()
    UtWy, x = UtWy[:S], x[:S]
    n = ev.shape[0]
    C1 = nc + 1
    M = C1 * (C1 + 1) // 2
    v = lam.numpy().astype(f64)[:, None] * ev.astype(f32).astype(f64) + 1.0
    h = 1.0 / v
    z = UtWy.astype(f64)
    xd = np.zeros_like(h) if null else x.astype(f64)
    hx = h * xd
    prs = _pair_cols(C1)
    pairs = np.stack([z[..., a] * z[..., b] for a, b in prs], axis=2)
    terms = h[..., None] * pairs
    if not null:
        terms = np.concatenate([terms, hx[..., None] * z], axis=2)
    rowsum = np.stack([hx * xd, np.log(np.abs(v))], axis=2)
    kind = TAIL_LRT_NULL if null else TAIL_LRT
    if parts:
        q = np.zeros((S, terms.shape[2]))
        rs = np.zeros((S, 2))
        kc = tail_layout(nc, TAIL_LANE, kind, 8)["kc"]
        for i0 in range(0, n, PART):
            sl = slice(i0, min(n, i0 + PART))
            cq, crs = _sums(terms[:, sl], rowsum[:, sl], TAIL_LANE, S,
                            sl.stop - i0, kc)
            q, rs = q + cq, rs + crs
    else:
        form = tail_form(nc, shared)
        q, rs = _sums(terms, rowsum, form, S, n,
                      tail_layout(nc, form, kind, 8)["kc"])
        if form == TAIL_REG:
            # thread j: the log of each round's product of v (individuals
            # j + 256 m + 32 u, u < 8), the rounds in order
            ld = np.zeros((S, 32, 1))
            for r0 in range(0, n, 256):
                for j in range(32):
                    idx = np.arange(r0 + j, min(n, r0 + 256), 32)
                    if idx.size:
                        ld[:, j, 0] += np.log(np.abs(np.prod(v[:, idx],
                                                             axis=1)))
            rs[:, 1] = _butterfly(ld)[:, 0]
    full = np.zeros((S, M + C1 + 1))
    full[:, :q.shape[1]] = q
    full[:, M + C1] = rs[:, 0]
    beta = _factor(full, nc, M, null)
    wb = np.zeros((S, n))
    for a in range(nc):
        wb = wb + z[..., a] * beta[:, a:a + 1]
    t = z[..., nc] - wb
    if not null:
        t = t - xd * beta[:, nc:nc + 1]
    res = h * (t * t)
    form = tail_form(nc, shared)
    if parts:        # a block a part, a thread an individual
        p_yy = np.zeros(S)
        for i0 in range(0, n, PART):
            p_yy = p_yy + _block_sum(_threads(res[:, i0:i0 + PART, None],
                                              256))[:, 0]
    elif form == TAIL_REG:
        p_yy = _butterfly(_threads(res[..., None], 32))[:, 0]
    elif form == TAIL_MMA:
        p_yy = _butterfly(_threads(res[..., None], 32))[:, 0]
    else:
        p_yy = _block_sum(_threads(res[..., None], 256))[:, 0]
    p_yy = np.where((p_yy >= 0) & (p_yy < 1e-8), 1e-8, p_yy)
    c = lk.logf_const(n, nc, False, False)
    return c - 0.5 * rs[:, 1] - 0.5 * n * np.log(p_yy)


# --- the mirror against the plain versions -----------------------------

CASES = [("shared", 1), ("shared", 3), ("shared", 24), ("shared", 40),
         ("shared", 120), ("gxe", 3), ("gxe", 24), ("gxe", 40), ("gxe", 120),
         ("gene", 1), ("gene", 3), ("gene", 24)]


@pytest.mark.parametrize("dt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("mode,nc", CASES,
                         ids=[f"{m}_c{c}" for m, c in CASES])
def test_test_tail_mirror_matches_plain(mode, nc, dt):
    data, nc = _block(mode, nc, dt)
    S = lk.n_lanes(data)
    shared = mode == "shared"
    lam = _lams(S, dt, nc)
    l_score = lam[:1] if mode != "gene" else lam
    wide = not shared or nc >= 24
    for score, lm, plain in ((False, lam, lk.wald_pvalues_plain),
                             (True, l_score, lk.score_pvalues_plain)):
        b, se, p, form = _mirror_test(lm.expand(S), data, nc, shared, score)
        assert form == tail_form(nc, shared)
        bp, sp, pp = (t.numpy() for t in plain(lm, data, nc))
        ok = np.isfinite(pp)
        assert ok.mean() > 0.9
        assert np.array_equal(np.isnan(p), np.isnan(pp))
        tol_p, tol_b = ((3e-5 if wide else 1e-5), 1e-3) \
            if dt == torch.float32 else (1e-10, 1e-8)
        assert np.max(np.abs(p[ok] - pp[ok])) <= tol_p, (score, form)
        assert np.max(np.abs(b[ok] - bp[ok]) / sp[ok]) <= tol_b, (score, form)


LRT_CASES = [("shared", 1), ("shared", 3), ("shared", 24), ("shared", 40),
             ("shared", 120), ("gxe", 3), ("gxe", 24), ("gxe", 120),
             ("gene", 1), ("gene", 24)]


@pytest.mark.parametrize("mode,nc", LRT_CASES,
                         ids=[f"{m}_c{c}" for m, c in LRT_CASES])
def test_lrt_mirror_matches_plain(mode, nc):
    """K6's speed mode: the null launch (one shared lane in parts, or a
    null per lane) and the SNP launch."""
    data, nc = _block(mode, nc, torch.float32)
    S = lk.n_lanes(data)
    shared = mode == "shared"
    lam = _lams(S, torch.float32, nc + 1)
    l0 = lam[:1] * 1.1 if shared else lam * 1.1
    l0_m = _mirror_logl(l0, data, nc, shared, True, parts=shared)
    d64 = data._replace(eval=data.eval.double(), UtWy=data.UtWy.double(),
                        Utx=data.Utx.double())
    l0_p = lk.logf_stable(l0.double().reshape(-1), d64, nc, True,
                          False).numpy()
    np.testing.assert_allclose(l0_m, l0_p, rtol=1e-12, atol=0)
    l1_m = _mirror_logl(lam, data, nc, shared, False)
    l1_p, p_p = lk.lrt_pvalues_plain(lam, None, data, nc, l0, None)
    l1_p64 = lk.logf_stable(lam.double(), d64, nc, False, False).numpy()
    np.testing.assert_allclose(l1_m, l1_p64, rtol=1e-12, atol=0)
    p_m = chisq_sf(torch.as_tensor(2.0 * (l1_m - l0_m)), 1.0).numpy()
    np.testing.assert_allclose(p_m.astype(f32), p_p.numpy(), rtol=0,
                               atol=1e-6)
    assert np.array_equal(l1_m.astype(f32), l1_p.numpy()) or np.allclose(
        l1_m.astype(f32), l1_p.numpy(), rtol=1e-7, atol=0)


# --- the layout mirror ---------------------------------------------------

@pytest.mark.parametrize("kind", [TAIL_TEST, TAIL_LRT,
                                  TAIL_LRT_NULL])
def test_tail_layout_fits_the_card(kind):
    """The forms' shared memory fits a block of the H100 (227 KB) and at
    most 32 covariates keeps every lane's set there in one pass; above it
    the sets go to scratch and more passes take the columns, at any c up
    to K6's 5,119 (whole rows of [W, y] staged, four at least)."""
    for c in list(range(0, 41)) + [64, 100, 120, 200, 500, 1000, 3000, 5119]:
        for shared in (True, False):
            form = tail_form(c, shared)
            for tsize in (4, 8):
                L = tail_layout(c, form, kind, tsize)
                assert L["bytes"] <= 227 * 1024, (c, shared, tsize)
                assert (L["lane_bytes"] > 0) == (c > 32)
                if c <= 32:
                    assert L["passes"] == 1
                if form == TAIL_MMA:
                    assert L["Mp"] % 8 == 0
                if form != TAIL_REG:
                    # whole rows in chunks of 16, 8 or 4 individuals up
                    # to about 75 covariates (K6: always), else the pass's
                    # columns at a stride free of bank conflicts
                    assert L["raw"] or (kind == TAIL_TEST and c > 60)
                    if L["raw"]:
                        assert L["kc"] in (32, 16, 8, 4)
                        assert L["kc"] >= 8 or c > 40
                    else:
                        assert (L["bst"] % 16 in (4, 12) if tsize == 8
                                else L["bst"] % 32 in (8, 24))
                if kind != TAIL_TEST:
                    # K6's residual chunks of 64 rows, none (rows read
                    # from device memory) past 319 covariates
                    assert L["rc"] == (64 if c < 320 else 0)
            assert (form == TAIL_REG) == (c <= 3)
    if kind != TAIL_TEST:       # where lrt_tail_launch refuses
        assert not tail_layout(5120, TAIL_MMA, kind, 8)["raw"]


# --- the plain versions against the reference -------------------------

@pytest.mark.parametrize("nc", [1, 40])
def test_plain_tests_match_reference_shared(nc):
    data, nc = _block("shared", nc, torch.float64)
    S = lk.n_lanes(data)
    lam = _lams(S, torch.float64, nc)
    o = OPS
    U = o["U"]
    jd = tlk.build_batch_data(jnp.asarray(o["ev"]),
                              jnp.asarray(U.T @ o["W"][:, :nc]),
                              jnp.asarray(U.T @ o["y"]),
                              jnp.asarray(o["X"] @ U), nc)
    _check_against_reference(lam, data, jd, nc, slice(None))


@pytest.mark.parametrize("mode,nc", [("gxe", 24), ("gene", 3)])
def test_plain_tests_match_reference_per_lane(mode, nc):
    """A lane of the per-lane blocks: the reference takes its covariates
    and response as a shared block."""
    data, nc = _block(mode, nc, torch.float64)
    lam = _lams(lk.n_lanes(data), torch.float64, nc)
    for s in (3,):
        UtWy = data.UtWy[s].numpy()
        x = data.Utx[s if data.Utx.shape[0] > 1 else 0].numpy()
        jd = tlk.build_batch_data(jnp.asarray(data.eval.numpy()),
                                  jnp.asarray(UtWy[:, :nc]),
                                  jnp.asarray(UtWy[:, nc]),
                                  jnp.asarray(x[None]), nc)
        _check_against_reference(lam, data, jd, nc, slice(s, s + 1))


def _check_against_reference(lam, data, jd, nc, lanes):
    n = data.eval.shape[0]
    df = float(n - nc - 1)
    lj = jnp.asarray(lam[lanes].numpy())
    for plain, ref, stat in ((lk.wald_pvalues_plain, tlk.wald_stats, "wald"),
                             (lk.score_pvalues_plain, tlk.score_stats,
                              "score")):
        b, se, p = (t[lanes].numpy() for t in plain(lam, data, nc))
        rb, rse, rf, rdf = ref(lj, jd, nc)
        assert float(rdf) == df
        rp = np.asarray(tstats.f_sf(rf, 1.0, rdf))
        np.testing.assert_allclose(b, np.asarray(rb), rtol=1e-9, atol=1e-12,
                                   err_msg=stat)
        np.testing.assert_allclose(se, np.asarray(rse), rtol=1e-9,
                                   err_msg=stat)
        np.testing.assert_allclose(p, rp, rtol=0, atol=1e-8, err_msg=stat)
    # K6: the ML log-likelihoods of both models and the chi-square tail
    l0 = lam[lanes] * 1.1
    for null, lm in ((True, l0), (False, lam[lanes])):
        sub = data if lanes == slice(None) else _lane_block(data, lanes)
        mine = lk.logf_stable(lm, sub, nc, null, False).numpy()
        ref = np.asarray(tlk.logf_stable(jnp.asarray(lm.numpy()), jd, nc,
                                         null, False))
        np.testing.assert_allclose(mine, ref, rtol=1e-9, err_msg=str(null))
    d = np.linspace(0.0, 30.0, 61)
    np.testing.assert_allclose(
        chisq_sf(torch.as_tensor(d), 1.0).numpy(),
        np.asarray(tstats.chisq_sf(jnp.asarray(d), 1.0)), rtol=0, atol=1e-8)


def _lane_block(data, lanes):
    """One lane of a per-lane block."""
    return data._replace(UtWy=data.UtWy[lanes], wy_prod=data.wy_prod[lanes],
                         Utx=data.Utx[lanes] if data.Utx.shape[0] > 1
                         else data.Utx)
