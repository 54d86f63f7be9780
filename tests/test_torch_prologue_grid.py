"""K1 (csrc/geno_prologue.cu) and K2's per-thread forms (csrc/
lambda_grid.cu): their plain versions against the reference, and Python
mirrors of the kernels' own arithmetic.

K1: prologue_plain against the reference's unpack_bed, impute_rows and
center_genotype_block on every wire (packed, int8, float32, float64),
every mode (IMPUTE, CENTRE, CENTRE with scale over n and over n_total !=
n), n = 1, 2, 3, 4 and 1,939 (n mod 4 = 0..3) with an all-missing row, a
0x55 pad row (packed) and monomorphic rows; hard calls in float32 equal
the reference bit for bit (their float sums are exact).  The kernel's
moments of the hard-call wires are 32-bit integers, a packed byte's four
codes at once by popcounts of the code classes: mirrored in numpy, they
equal the decoded dosages' float32 sums exactly up to n = 100,000
(dosages 0..2, sums below 2^24), so mean = sum / cnt is prologue_plain's
IEEE quotient (chip_smoke.py holds the IMPUTE operand bit-equal on the
card).  chip_smoke's k1_geometry / k1_stage_pieces mirror the kernel's
rows a block and its staging: every byte of an (S, nb) block is copied
once (odd nb, S not a multiple of the rows a block, row starts at every
alignment), and the cp.async chunks lie 16-byte aligned inside the
block's shared memory.

K2: grid_epilogue_plain against the reference's dev1_grid at c = 2, 3,
4, 8 and 16, REML and ML, the alternative and the null fit (calc_null),
with shared operands and per-lane ones (each lane its own covariates,
as -gxe: the reference's single-lane dev1_grid a lane, as its engine
vmaps it), at chip_smoke.py's K2 tolerance |d - d_ref| <= 1e-5
max|d_ref| + 8 n eps / λ_g (float32; float64 1e-9 and 64 n eps, as
tests/test_torch_lmm.py).  The
register form's compile-time index arithmetic (lg_ab, lg_kind, lg_col
and the in-place step's pivots), mirrored here, equals pab_indices and
kernels.pab_tables at every instantiated c (0..LG_REG_MAX).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from gemma_tpu.models.lmm import likelihood as tlk
from gemma_tpu.ops import kinship as tpu_kinship
from gemma_tpu.ops import pack2 as tpu_pack2
from gemma_tpu.parallel.shard import impute_rows as tpu_impute_rows
from gemma_torch import kernels
from gemma_torch.models.lmm import likelihood as lk
from gemma_torch.models.lmm import optimize as opt
from gemma_torch.models.lmm.indices import pab_indices
from gemma_torch.ops import pack2

F32, F64 = torch.float32, torch.float64
WIRES = ("packed", "int8", "float32", "float64")
MODES = ("impute", "centre", "scale", "scale_n_total")
with open(os.path.join(kernels.CSRC_DIR, "lambda_grid.cu")) as _fh:
    LG_REG_MAX = int(re.search(r"#define LG_REG_MAX (\d+)",
                               _fh.read()).group(1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers torch's default
    pool oversubscribes the cores (tests/test_torch_mvlmm.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dosages(S, n, seed):
    """(S + 3, n) int8 hard calls, -1 missing, chip_smoke's generator:
    an all-missing row, a monomorphic one (all 2 with some missing) and
    an all-0 one, then S random rows, 10% missing."""
    return cs.k1_genotypes(S + 3, n, seed, missing=0.1)


def _as_nan(X, dtype=np.float64):
    return np.where(X < 0, np.nan, X).astype(dtype)


# ---------------------------------------------------------------- K1


@pytest.mark.parametrize("n", [1, 2, 3, 4, 1939])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wire", WIRES)
def test_prologue_matches_reference(wire, mode, n):
    X = _dosages(6, n, seed=n)
    f32 = wire == "float32"
    dt, jdt = (F32, jnp.float32) if f32 else (F64, jnp.float64)
    if wire == "packed":
        raw = pack2.pack_bed_codes(X)
        raw = np.vstack([raw, np.full((1, raw.shape[1]), pack2.PAD_BYTE,
                                      np.uint8)])
        dec = np.asarray(tpu_pack2.unpack_bed(raw, n))
        np.testing.assert_array_equal(dec[:-1], X)
    else:
        raw = {"int8": X, "float32": _as_nan(X, np.float32),
               "float64": _as_nan(X)}[wire]
        dec = X
    if mode == "impute":
        ref = np.asarray(tpu_impute_rows(jnp.asarray(
            dec if wire in ("packed", "int8") else raw), jdt))
    else:
        nan = _as_nan(dec, np.float32 if f32 else np.float64)
        ref = np.asarray(tpu_kinship.center_genotype_block(
            jnp.asarray(nan), mode != "centre",
            n_total=n + 5 if mode == "scale_n_total" else None))
    got = pack2.prologue(torch.from_numpy(raw), n,
                         pack2.IMPUTE if mode == "impute" else pack2.CENTRE,
                         mode != "centre" and mode != "impute",
                         n + 5 if mode == "scale_n_total" else None, dt)
    assert got.dtype == dt and got.shape == ref.shape
    if f32 and mode != "scale_n_total" and mode != "scale":
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-6 if f32 else 1e-12)
    # the all-missing row: zeros in every mode (IMPUTE's mean is 0)
    assert (got[0] == 0).all()
    if wire == "packed":
        assert (got[-1] == 0).all()          # the 0x55 pad row


def _popc(a):
    return np.unpackbits(a.astype(np.uint8)[..., None], axis=-1).sum(-1)


def _packed_moments(packed, n):
    """The kernel's integer moments of a packed block: per byte, the
    slots past n set to code 1 (missing), then the code classes counted
    by popcounts of the low and high bits of each slot."""
    b = packed.astype(np.int64).copy()
    tail = n & 3
    if tail:
        keep = (1 << (2 * tail)) - 1
        b[:, -1] = (b[:, -1] & keep) | (0x55 & ~keep)
    lo, hi = b & 0x55, (b >> 1) & 0x55
    c0 = _popc(~(lo | hi) & 0x55)           # code 0: dosage 2
    c2 = _popc(hi & ~lo & 0xFF)             # code 2: dosage 1
    c3 = _popc(hi & lo)                     # code 3: dosage 0
    return ((c0 + c2 + c3).sum(1), (2 * c0 + c2).sum(1),
            (4 * c0 + c2).sum(1))


@pytest.mark.parametrize("n", [1, 6, 1939, 100_000])
def test_integer_moments_equal_float_sums(n):
    X = _dosages(5, n, seed=7 + n)
    packed = pack2.pack_bed_codes(X)
    cnt, s, sq = _packed_moments(packed, n)
    # the int8 wire's moments, one element at a time
    obs = X >= 0
    v = np.where(obs, X, 0).astype(np.int64)
    np.testing.assert_array_equal(cnt, obs.sum(1))
    np.testing.assert_array_equal(s, v.sum(1))
    np.testing.assert_array_equal(sq, (v * v).sum(1))
    # slack slots that a writer filled with code 0 (PLINK pads with zero
    # bits) are masked too
    if n % 4:
        z = packed.copy()
        z[:, -1] &= (1 << (2 * (n % 4))) - 1
        np.testing.assert_array_equal(_packed_moments(z, n)[0], cnt)
    # prologue_plain's float32 sums are exact: equal to the integers, so
    # its mean is the kernel's sum / cnt
    xt = pack2.unpack_bed(torch.from_numpy(packed), n)
    miss = xt < 0
    g0 = torch.where(miss, torch.zeros((), dtype=F32), xt.to(F32))
    assert np.array_equal(g0.sum(1).numpy(), s.astype(np.float32))
    assert np.array_equal((g0 * g0).sum(1).numpy(), sq.astype(np.float32))
    assert (s < 2 ** 24).all() and (sq < 2 ** 24).all()
    mean = (torch.from_numpy(s.astype(np.float32))
            / torch.from_numpy(np.maximum(cnt, 1).astype(np.float32)))
    got = pack2.prologue(torch.from_numpy(packed), n, pack2.IMPUTE,
                         dtype=F32)
    want = torch.where(miss, mean[:, None], xt.to(F32))
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,S", [(1939, 37), (1, 9), (6, 17), (8200, 3),
                                 (60_001, 3), (100_000, 2)])
@pytest.mark.parametrize("wire", [0, 1, 2, 3])
def test_staging_mirror_covers_each_byte_once(wire, n, S):
    nb = pack2.packed_width(n) if wire == 0 else n
    esz = cs.K1_WIRE_BYTES[wire]
    rowbytes = nb * esz
    form, rows, smem = cs.k1_geometry(wire, n, nb)
    assert smem <= 227 * 1024
    if n <= cs.K1["warp_n"]:
        assert form == 0 and 1 <= rows <= cs.K1["warps"]
        assert rows == cs.K1["warps"] or rows * rowbytes * 2 > \
            cs.K1["rows_smem"]
    else:
        assert rows == 1 and form == (1 if rowbytes <= cs.K1["smem_max"]
                                      else 2)
    for base in (0, esz, 3 * esz, 256 + 8 * esz):
        seen = np.zeros(S * rowbytes, np.int32)
        for b in range(-(-S // rows)):
            r0 = b * rows
            nrow = min(rows, S - r0)
            a = base + r0 * rowbytes
            (h0, h1), chunks, (t0, t1) = cs.k1_stage_pieces(
                a, nrow * rowbytes)
            for lo, hi in ((h0, h1), (t0, t1)):
                seen[lo - base:hi - base] += 1
            for c in chunks:
                assert c % 16 == 0 and c >= a and c + 16 <= a + nrow * rowbytes
                seen[c - base:c + 16 - base] += 1
            if form != 2:
                top = max([h1, t1] + [c + 16 for c in chunks])
                assert top - (a & ~15) <= smem
        assert (seen == 1).all()


# ---------------------------------------------------------------- K2


def _lg_ab(a, b, cols):
    return (2 * cols - a + 2) * (a - 1) // 2 + (b - a)


def _lg_kind(a, b, c):
    if a == c + 1 and b == c + 1:
        return 1
    return 2 if c + 1 in (a, b) else 0


def _lg_col(a, b, c):
    if a == c + 1 and b == c + 1:
        return 0
    if b == c + 1:
        return a - 1
    if a == c + 1:
        return c
    if a == c + 2:
        return (c + 1) * (c + 2) // 2 - 1
    return (a - 1) * (c + 2) - (a - 1) * a // 2 + (b - a if b <= c
                                                   else b - a - 1)


@pytest.mark.parametrize("c", range(0, LG_REG_MAX + 1))
def test_register_form_indices_match_tables(c):
    """lambda_grid_reg<C>'s compile-time layout against pab_indices and
    the tables the warp form reads."""
    idx = pab_indices(c)
    cols, ni = c + 2, idx.n_index
    tab = kernels.pab_tables(c, "cpu").numpy()
    steps = c + 1
    aw = tab[:steps * ni].reshape(steps, ni)
    bw = tab[steps * ni:2 * steps * ni].reshape(steps, ni)
    ww = tab[2 * steps * ni:2 * steps * ni + steps]
    diag = tab[2 * steps * ni + steps:2 * steps * ni + 2 * steps]
    kind = tab[2 * steps * ni + 2 * steps:2 * steps * ni + 2 * steps + ni]
    col = tab[2 * steps * ni + 2 * steps + ni:]
    seen = []
    for a in range(1, cols + 1):
        for b in range(a, cols + 1):
            k = _lg_ab(a, b, cols)
            seen.append(k)
            assert idx.pairs[k] == (a, b)
            assert (_lg_kind(a, b, c), _lg_col(a, b, c)) == (kind[k], col[k])
    assert seen == list(range(ni))
    assert _lg_ab(cols, cols, cols) == ni - 1 == idx.yy
    for p in range(1, steps + 1):
        assert _lg_ab(p, p, cols) == ww[p - 1] == diag[p - 1]
        written = set()
        for a in range(p + 1, cols + 1):
            for b in range(a, cols + 1):
                k = _lg_ab(a, b, cols)
                assert _lg_ab(p, a, cols) == aw[p - 1][k]
                assert _lg_ab(p, b, cols) == bw[p - 1][k]
                written.add(k)
        # the pivots (row p) are not written at step p, and every entry a
        # later step or dev1 reads is
        pivots = {_lg_ab(p, b, cols) for b in range(p, cols + 1)}
        assert not (written & pivots)
        later = {_lg_ab(a, b, cols) for a in range(p + 1, cols + 1)
                 for b in range(a, cols + 1)}
        assert later == written


N_G, S_G = 180, 3


def _grid_problem(c, seed):
    rng = np.random.default_rng(seed)
    Xk = rng.binomial(2, 0.3, size=(300, N_G)).astype(np.float64)
    Xkc = Xk - Xk.mean(axis=1, keepdims=True)
    K = Xkc.T @ Xkc / 300
    Kc = K - K.mean(0) - K.mean(1)[:, None] + K.mean()
    w, U = np.linalg.eigh(Kc)
    w = np.where(w < 1e-10, 0.0, w)
    y = np.linalg.cholesky(K + 1e-6 * np.eye(N_G)) @ rng.normal(size=N_G) \
        + rng.normal(size=N_G)
    X = rng.binomial(2, 0.3, size=(S_G, N_G)).astype(np.float64)
    # per-lane covariates: the intercept and c - 1 normal columns a lane
    W = np.concatenate([np.ones((S_G, N_G, 1)),
                        rng.normal(size=(S_G, N_G, c - 1))], axis=2)
    return w, U.T @ W, U.T @ y, X @ U


@pytest.fixture(scope="module")
def _ref_grid():
    """The reference's dev1_grid on one lane, compiled once per (c,
    calc_null, reml) and reused by every lane and operand kind."""
    cache = {}

    def get(c, calc_null, reml):
        key = (c, calc_null, reml)
        if key not in cache:
            fine = opt.fine_grid(1e-5, 1e5, 10, opt._F32_GRID_REFINE)
            cache[key] = jax.jit(lambda e, W, y, x: tlk.dev1_grid(
                fine, tlk.build_batch_data(e, W, y, x, c), c, calc_null,
                reml))
        return cache[key]
    return get


@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "lane"])
@pytest.mark.parametrize("calc_null", [False, True], ids=["alt", "null"])
@pytest.mark.parametrize("reml", [True, False], ids=["reml", "ml"])
@pytest.mark.parametrize("c", [2, 3, 4, 8, 16])
def test_grid_epilogue_matches_reference(c, reml, calc_null, per_lane,
                                         _ref_grid):
    w, UtW, Uty, Utx = _grid_problem(c, seed=c)
    if not per_lane:
        UtW = np.broadcast_to(UtW[:1], UtW.shape)
    ref_fn = _ref_grid(c, calc_null, reml)
    fine = opt.fine_grid(1e-5, 1e5, 10, opt._F32_GRID_REFINE)
    lam = np.asarray(fine)[:, None]
    for dt, jdt in ((F32, jnp.float32), (F64, jnp.float64)):
        ref = np.stack([np.asarray(ref_fn(
            jnp.asarray(w, jdt), jnp.asarray(UtW[s], jdt),
            jnp.asarray(Uty, jdt), jnp.asarray(Utx[s:s + 1], jdt)))[:, 0]
            for s in range(S_G)], axis=1)
        t = (lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dt))
        data = lk.build_batch_data(t(w), t(UtW) if per_lane else t(UtW[0]),
                                   t(Uty), t(Utx), c)
        gp = lk.grid_products(fine, data, c)
        assert (gp.shared.dim() == 4) == per_lane
        got = lk.grid_epilogue_plain(gp, N_G, c, calc_null, reml).numpy()
        assert got.shape == ref.shape == (len(fine), S_G)
        ok = np.isfinite(ref)
        assert (np.isfinite(got) == ok).all()
        # dev1 cancels O(n / λ) terms: a normwise bound plus the
        # rounding floor k n eps / λ (chip_smoke's K2 hold in float32,
        # tests/test_torch_lmm.py's in float64)
        rtol, k = (1e-5, 8) if dt == F32 else (1e-9, 64)
        eps = np.finfo(np.float32 if dt == F32 else np.float64).eps
        bound = rtol * np.abs(ref[ok]).max() + k * N_G * eps / \
            np.broadcast_to(lam, ref.shape)[ok]
        assert (np.abs(got[ok] - ref[ok]) <= bound).all()
