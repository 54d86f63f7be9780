"""gemma_torch.ops against gemma_tpu.ops on the same numpy inputs.

The port runs on the CPU here, where each kernel wrapper takes its
plain PyTorch version (the kernels themselves are held against those
on the card by chip_smoke.py).  Tolerances:
  * genotype operands: exact up to float64 rounding of the row mean
    (atol 1e-12);
  * kinship: rel 1e-10 (one product, summed in another order);
  * eigenvalues: 1e-9 relative to the spectral radius (two LAPACK
    drivers);
  * f_sf: abs 1e-10 against the reference and against scipy;
  * chisq_sf: abs 1e-9 against the reference, rel 1e-10 against scipy
    over x in [1e-8, 1400] (down to p ~ 1e-306: the continued fraction
    gives Q itself, not 1 − P).
"""

import numpy as np
import pytest
import scipy.special
import torch

import jax.numpy as jnp

from gemma_tpu.ops import kinship as tpu_kinship
from gemma_tpu.ops import pack2 as tpu_pack2
from gemma_tpu.ops import stats as tpu_stats
from gemma_tpu.ops.eigh import eigh_zeroed as tpu_eigh_zeroed
from gemma_tpu.ops.eigh import zero_eigenvalues as tpu_zero_eigenvalues
from gemma_tpu.parallel.shard import impute_rows as tpu_impute_rows
from gemma_torch.ops import pack2
from gemma_torch.ops.center import center_matrix
from gemma_torch.ops.eigh import eigh_zeroed, zero_eigenvalues
from gemma_torch.ops.kinship import KinshipAccumulator, center_genotype_block
from gemma_torch.ops.stats import betainc, chisq_sf, f_sf

F64 = torch.float64


def _dosages(S, n, seed, pad_rows=0):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 3, size=(S, n)).astype(np.int8)
    X[rng.random((S, n)) < 0.1] = -1
    X[1, :] = 1                       # constant row: var == 0
    X[2, :] = -1                      # all-missing row
    if pad_rows:
        X = np.vstack([X, np.full((pad_rows, n), -1, np.int8)])
    return X


def _as_nan(Xi8):
    return np.where(Xi8 < 0, np.nan, Xi8.astype(np.float64))


@pytest.mark.parametrize("n", [1, 7, 64, 101])
def test_unpack_bed_matches_reference(n):
    X = _dosages(9, n, seed=n) if n > 1 else np.array(
        [[-1], [0], [1], [2]], np.int8)
    packed = pack2.pack_bed_codes(X)
    np.testing.assert_array_equal(packed, tpu_pack2.pack_bed_codes(X))
    ours = pack2.unpack_bed(torch.from_numpy(packed), n).numpy()
    np.testing.assert_array_equal(ours,
                                  np.asarray(tpu_pack2.unpack_bed(packed, n)))


def test_pad_byte_rows_decode_to_zeros():
    packed = np.full((3, 5), pack2.PAD_BYTE, np.uint8)
    for mode in (pack2.IMPUTE, pack2.CENTRE):
        out = pack2.prologue(torch.from_numpy(packed), 18, mode, True,
                             dtype=F64)
        assert out.shape == (3, 18)
        assert (out == 0).all()


@pytest.mark.parametrize("wire", ["packed", "int8", "float"])
@pytest.mark.parametrize("n", [37, 120])
def test_impute_matches_reference(wire, n):
    X = _dosages(12, n, seed=3, pad_rows=2)
    ref = np.asarray(tpu_impute_rows(
        jnp.asarray(tpu_pack2.unpack_bed(tpu_pack2.pack_bed_codes(X), n)),
        jnp.float64))
    raw = {"packed": pack2.pack_bed_codes(X), "int8": X,
           "float": _as_nan(X)}[wire]
    ours = pack2.prologue(torch.from_numpy(raw), n, pack2.IMPUTE, dtype=F64)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("wire", ["packed", "int8", "float"])
@pytest.mark.parametrize("n_total", [None, 150])
def test_centre_matches_reference(scale, wire, n_total):
    n = 101                                  # 3 slack slots in the last byte
    X = _dosages(10, n, seed=5, pad_rows=3)
    ref = np.asarray(tpu_kinship.center_genotype_block(
        jnp.asarray(_as_nan(X)), scale, n_total=n_total))
    raw = {"packed": pack2.pack_bed_codes(X), "int8": X,
           "float": _as_nan(X)}[wire]
    ours = pack2.prologue(torch.from_numpy(raw), n, pack2.CENTRE, scale,
                          n_total, F64)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-12)
    if wire == "float":
        direct = center_genotype_block(torch.from_numpy(raw), scale, n_total)
        np.testing.assert_allclose(direct.numpy(), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("scale", [False, True])
def test_kinship_accumulator_matches_reference(scale):
    n = 90
    blocks = [_dosages(40, n, seed=s) for s in range(3)]
    ref = tpu_kinship.KinshipAccumulator(n, scale=scale, dtype=jnp.float64)
    acc = KinshipAccumulator(n, scale=scale, dtype=F64)
    for i, X in enumerate(blocks):
        ref.update(_as_nan(X), n_valid=40)
        raw = pack2.pack_bed_codes(X) if i % 2 else X
        acc.update(torch.from_numpy(raw), n_valid=40)
    a = np.asarray(ref.finalize())
    b = acc.finalize().numpy()
    np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-13)


def test_kinship_accumulator_empty_raises():
    with pytest.raises(ValueError):
        KinshipAccumulator(4, dtype=F64).finalize()


def test_eigh_zeroed_matches_reference():
    rng = np.random.default_rng(11)
    n = 80
    X = rng.normal(size=(30, n))
    K = X.T @ X / 30                           # rank 30: a zero cluster
    K[0, 0] -= 1e-3                            # and a small negative
    Kc = center_matrix(torch.from_numpy(K))
    ev, U, tr = eigh_zeroed(Kc)
    from gemma_tpu.ops.center import center_matrix as tpu_center
    rev, rU, rtr = tpu_eigh_zeroed(tpu_center(jnp.asarray(K)))
    rev = np.asarray(rev)
    scale = np.abs(rev).max()
    np.testing.assert_allclose(ev.numpy(), rev, rtol=0, atol=1e-9 * scale)
    assert (ev.numpy()[:n - 30] == 0).all()
    assert abs(float(tr) - float(rtr)) <= 1e-9 * scale
    assert float(tr) == pytest.approx(float(ev.mean()), abs=0)
    # U diagonalises the centred matrix
    np.testing.assert_allclose((U.T @ Kc @ U).diagonal().numpy(),
                               torch.linalg.eigvalsh(Kc).numpy(),
                               atol=1e-10 * scale)


@pytest.mark.parametrize("df", [3.0, 117.0, 1938.0])
def test_f_sf_matches_reference_and_scipy(df):
    x = np.concatenate([[-1.0, 0.0, 1e-12, 1e-8], np.logspace(-4, 2.5, 60),
                        [np.inf, np.nan]])
    ours = f_sf(torch.from_numpy(x), 1.0, df).numpy()
    ref = np.asarray(tpu_stats.f_sf(jnp.asarray(x), 1.0, df))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours[fin], ref[fin], rtol=0, atol=1e-10)
    sp = scipy.special.fdtrc(1.0, df, np.maximum(x[:-1], 0.0))
    np.testing.assert_allclose(ours[:-1], sp, rtol=0, atol=1e-10)


def test_betainc_saturating_tail():
    """The case the reference measured saturating in float32:
    betainc(383, 0.5, 1 − 1.6e-8) = 0.99721."""
    x = torch.tensor([1 - 1.6e-8, 0.25, 0.999], dtype=F64)
    ours = betainc(383.0, 0.5, x).numpy()
    np.testing.assert_allclose(ours, scipy.special.betainc(383.0, 0.5,
                                                           x.numpy()),
                               rtol=1e-10, atol=1e-300)
    assert ours[0] == pytest.approx(0.99721, abs=1e-5)
    # f_sf in float32 takes the small-argument side: no saturation
    f = torch.tensor([2.0 * 383 * 1.6e-8], dtype=torch.float32)
    q = f_sf(f, 1.0, 766.0)
    assert q.dtype == torch.float32
    assert float(q) == pytest.approx(
        scipy.special.fdtrc(1.0, 766.0, float(f)), abs=1e-6)


def test_chisq_sf_matches_reference_and_scipy():
    import scipy.stats
    x = np.concatenate([np.logspace(-8, np.log10(1400.0), 400),
                        [1.5, 3.0, 1399.999]])
    ours = chisq_sf(torch.from_numpy(x), 1.0).numpy()
    np.testing.assert_allclose(ours, scipy.stats.chi2.sf(x, 1), rtol=1e-10,
                               atol=0)
    ref = np.asarray(tpu_stats.chisq_sf(jnp.asarray(x), 1.0))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-9)
    edge = torch.tensor([-1.0, 0.0, np.inf, np.nan], dtype=F64)
    out = chisq_sf(edge, 1.0).numpy()
    np.testing.assert_array_equal(out[:3], [1.0, 1.0, 0.0])
    assert np.isnan(out[3])
    f = chisq_sf(torch.tensor([2.5], dtype=torch.float32), 1.0)
    assert f.dtype == torch.float32


def test_zero_eigenvalues_matches_reference():
    ev = np.array([-1e-3, -1e-12, 0.0, 5e-11, 1e-10, 0.3, 2.5])
    a, ta = tpu_zero_eigenvalues(jnp.asarray(ev))
    b, tb = zero_eigenvalues(torch.from_numpy(ev))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert float(tb) == pytest.approx(float(ta), rel=1e-15)
