"""The wrapper-side arithmetic of K15 (pair_colsum) and K12 (bslmm_chain)
that their Hopper redesigns added, and their plain versions against the
reference, on the CPU.

  * K15's launches: the chunks of PC_MAX_M matrices tile every pair
    once, the row slices cover 0..n with none empty, the columns a thread
    reads divide n, and the partials' scratch holds every launch's; a
    numpy emulation of the sliced sums (each slice's partial, then the
    slices added in order) equals the einsum within 1e-12 relative;
  * K12's scratch layout: its parts follow one another without gaps or
    overlaps and the total holds a cluster of 16; the cluster's slices of
    the individuals cover 0..n exactly, in rank order;
  * pair_colsum_plain at chunked stack sizes against numpy (1e-12), and
    the plain calc_posterior just past 32 active ranks (the shape at
    which K12 leaves its one-warp factor for the blocked one) fed the
    reference's own draws, rel 1e-10 as tests/test_torch_bslmm.py.  The
    kernel's panel code itself runs only on the card, where chip_smoke.py
    holds it against this plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.models import bslmm as rb
from gemma_tpu.ops.eigh import eigh_zeroed
from gemma_torch.models import bslmm as pb
from gemma_torch.models import vc

F64 = torch.float64
SMS = 132


def _stacks(rng, ma, mb, n):
    return rng.normal(size=(ma, n, n)), rng.normal(size=(mb, n, n))


@pytest.mark.parametrize("n", [1, 31, 1939, 1940])
@pytest.mark.parametrize("ma,mb", [(1, 1), (2, 3), (8, 8), (9, 9), (9, 2)])
@pytest.mark.parametrize("isz", [4, 8])
def test_pair_colsum_launch_geometry(n, ma, mb, isz):
    for aligned in (True, False):
        plan = vc.pc_launches(ma, mb, n, isz, SMS, aligned)
        seen = np.zeros((ma, mb), dtype=int)
        for i0, j0, ka, kb, cols, rows, ns in plan:
            assert 1 <= ka <= vc.PC_MAX_M and 1 <= kb <= vc.PC_MAX_M
            seen[i0:i0 + ka, j0:j0 + kb] += 1
            # 16 bytes at most, one value where n or the address is not a
            # multiple of the vector, and never where the products of 8
            # matrices would not fit the registers
            assert cols in (1, 2, 4) and cols * isz <= 16 and n % cols == 0
            if not aligned or max(ka, kb) > 4:
                assert cols == 1
            # the slices cover 0..n, none empty, at least PC_ROWS_MIN
            # rows where n has them
            assert rows * ns >= n and rows * (ns - 1) < n
            assert rows >= min(n, vc.PC_ROWS_MIN)
            assert ns <= max(1, n // vc.PC_ROWS_MIN)
            # at the paths' width every SM gets at least two blocks
            tiles = -(-n // (vc.PC_LANES * cols))
            if n >= 1939:
                assert tiles * ns >= 2 * SMS
        assert (seen == 1).all()
        words = vc.pc_scratch_words(plan, n)
        assert words == max(ns * ka * kb * n
                            for _, _, ka, kb, _, _, ns in plan)


@pytest.mark.parametrize("n,ma,mb", [(31, 2, 3), (67, 9, 2), (96, 4, 4)])
def test_pair_colsum_slices_sum_to_einsum(n, ma, mb):
    """The kernel's decomposition in numpy: per launch, each row slice's
    partial column sums of every pair, then the slices added in order."""
    rng = np.random.default_rng(n + ma)
    A, B = _stacks(rng, ma, mb, n)
    out = np.zeros((ma, mb, n))
    for i0, j0, ka, kb, cols, rows, ns in vc.pc_launches(ma, mb, n, 8, SMS,
                                                         True):
        part = np.zeros((ns, ka, kb, n))
        for k in range(ns):
            s = slice(k * rows, min(n, (k + 1) * rows))
            part[k] = np.einsum("ist,jst->ijt", A[i0:i0 + ka, s],
                                B[j0:j0 + kb, s])
        acc = np.zeros((ka, kb, n))
        for k in range(ns):
            acc += part[k]
        out[i0:i0 + ka, j0:j0 + kb] = acc
    want = np.einsum("ist,jst->ijt", A, B)
    assert np.abs(out - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("ma,mb,n", [(9, 9, 31), (9, 3, 12)])
def test_pair_colsum_plain_chunked_sizes(ma, mb, n):
    rng = np.random.default_rng(ma * mb)
    A, B = _stacks(rng, ma, mb, n)
    got = vc.pair_colsum(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    want = np.einsum("ist,jst->ijt", A, B)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,s_max", [(1746, 300), (1, 1), (7, 1536),
                                     (40, 2000)])
def test_chain_scratch_layout(n, s_max):
    lay = pb.chain_scratch_layout(n, s_max)
    sizes = {"slot0": 3 * n + s_max, "slot1": 3 * n + s_max, "w_hi": n,
             "zv": n, "vv": n, "omega": s_max * (s_max + 1) // 2,
             "vectors": 3 * s_max, "p_gamma": 16 * 3 * s_max,
             "ranks": (16 * 3 * s_max + 1) // 2}
    at = 0
    for name, words in sizes.items():
        assert lay[name] == at, name
        at += words
    assert lay["total"] == at == pb.chain_scratch(n, s_max)
    # a cluster of 8 needs no more than the 16 the wrapper sizes for
    assert pb.chain_scratch_layout(n, s_max, 8)["total"] <= at


@pytest.mark.parametrize("n", [1, 7, 16, 1746, 1940])
@pytest.mark.parametrize("cs", [8, 16])
def test_chain_slices_cover_the_individuals(n, cs):
    sl = pb.chain_slices(n, cs)
    assert len(sl) == cs and sl[0][0] == 0 and sl[-1][1] == n
    for (a, b), (c, _) in zip(sl, sl[1:]):
        assert a <= b == c
    lens = [b - a for a, b in sl]
    assert sum(lens) == n and max(lens) - min(lens) <= 1


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=F64)


@pytest.fixture(scope="module")
def panel_setup():
    """tests/test_torch_bslmm.py's simulation (n = 150, p = 120)."""
    rng = np.random.default_rng(1)
    n, p = 150, 120
    X = rng.binomial(2, 0.3, size=(p, n)).astype(np.float64)
    Xc = X - X.mean(axis=1, keepdims=True)
    causal = rng.choice(p, 3, replace=False)
    g = rng.normal(0, 1, 3) @ Xc[causal]
    g *= np.sqrt(0.6) / g.std()
    y = g + rng.normal(0, np.sqrt(0.4), n)
    y -= y.mean()
    ev, U, tr = eigh_zeroed(jnp.asarray(Xc.T @ Xc / p))
    UtX = np.asarray((jnp.asarray(Xc) @ U).T)
    return (np.asarray(ev), float(tr), UtX,
            np.asarray(U.T @ jnp.asarray(y)))


@pytest.mark.parametrize("a_mode,n_gamma", [(11, 33), (13, 48)])
def test_calc_posterior_past_one_panel(panel_setup, a_mode, n_gamma):
    ev, tr, UtX, Uty = panel_setup
    n, p = UtX.shape
    s_max = 48
    st_r = rb.BslmmSettings(ns_test=p, ni_test=n, s_max=s_max, w_step=1,
                            s_step=1, a_mode=a_mode)
    calc_posterior, _ = rb.make_mcmc_step(
        jnp.asarray(UtX), jnp.asarray(Uty), jnp.asarray(ev), tr,
        rb.calc_p_gamma(p, st_r.geo_mean), st_r)
    ranks = (np.arange(s_max) * 7) % p
    h, rho, logp = 0.45, 0.6, float(np.log(5.0 / p))
    key = jax.random.PRNGKey(11)
    want = calc_posterior(
        key, jnp.asarray(Uty),
        jnp.asarray(np.where(np.arange(s_max) < n_gamma, ranks, p),
                    jnp.int32), jnp.int32(n_gamma), jnp.float64(h),
        jnp.float64(rho), jnp.float64(logp))
    k1, k2, k3, _ = jax.random.split(key, 4)
    draws = (_t(jax.random.normal(k1, (n,), jnp.float64)),
             float(jax.random.gamma(k2, n / 2.0, dtype=jnp.float64)),
             _t(jax.random.normal(k3, (s_max,), jnp.float64)))
    st = pb.BslmmSettings(ns_test=p, ni_test=n, s_max=s_max, w_step=1,
                          s_step=1, a_mode=a_mode)
    ops = pb.chain_operands(_t(UtX.T), _t(Uty), _t(ev), tr, st.geo_mean)
    got = pb.calc_posterior(ops, st, _t(Uty), list(ranks[:n_gamma]),
                            n_gamma, h, rho, logp, draws)
    for name, a, b in zip(pb.Posterior._fields, got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-10 * max(np.abs(b).max(),
                                                   1e-300), name
