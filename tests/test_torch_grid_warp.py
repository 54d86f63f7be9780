"""K2's warp form (csrc/lambda_grid.cu, above 16 covariates) emulated in
numpy, against the plain recurrences and the reference's dev1_grid.

The emulation runs the kernel's schedule: one warp a (grid point, SNP),
its two rows updated in place, step p over the flat range [base(p + 1),
ni) of the pairs a, b > p (the entries the later steps and dev1 read),
entry k on lane (k - base(p + 1)) mod 32, every lane reading the pivot
row p's segment, which no lane writes at step p.  Each entry's
expression is the kernel's (and _pab_rows'/_ppab_rows') in float32, so
every live entry must equal the plain rows exactly, step by step; dev1
from those rows is held against the reference's float32 dev1_grid at
chip_smoke.py's K2 tolerance, |d1 - d1_ref| <= 1e-5 max|d1_ref| + 8 n
eps32 / λ_g.  Above 338 covariates the labels leave shared memory and
the lanes take the pivots' flat indices from the tables' aw/bw: the two
must name the same entries.  Also: Kernel.launch_lanes' split into
launches of at most kernels.split_lanes lanes, which chip_smoke uses to
hold split launches against one launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.models.lmm import likelihood as tlk
from gemma_torch import kernels
from gemma_torch.models.lmm import likelihood as lk
from gemma_torch.models.lmm import optimize as opt
from gemma_torch.models.lmm.indices import pab_indices

# 400 individuals: with 40 covariates at n = 80 the two packages' float32
# grid products alone (both float32, summed in other orders) move dev1 by
# up to 1.5 times the bound; from n = 200 on they stay within 0.75 of it
N, S = 400, 3


def _base(p, cols):
    """Flat position of the pair (p, p) in GetabIndex's layout."""
    return (2 * cols - p + 2) * (p - 1) // 2


def _problem(n_cvt, seed):
    rng = np.random.default_rng(seed)
    Xk = rng.binomial(2, 0.3, size=(500, N)).astype(np.float64)
    Xkc = Xk - Xk.mean(axis=1, keepdims=True)
    K = Xkc.T @ Xkc / 500
    y = np.linalg.cholesky(K + 1e-6 * np.eye(N)) @ rng.normal(size=N) \
        + rng.normal(size=N)
    X = rng.binomial(2, 0.3, size=(S, N)).astype(np.float64)
    W = np.column_stack([np.ones(N), rng.normal(size=(N, n_cvt - 1))])
    Kc = K - K.mean(0) - K.mean(1)[:, None] + K.mean()
    w, U = np.linalg.eigh(Kc)
    w = np.where(w < 1e-10, 0.0, w)
    return tuple(a.astype(np.float32) for a in (w, U.T @ W, U.T @ y, X @ U))


def _warp_rows(row0, row0pp, trace_hi, n_cvt, calc_null):
    """The warp form's rows and trace on float32 copies of row 0 (G, S,
    ni): a list, one (pab, ppab, live) a step, and the trace."""
    idx = pab_indices(n_cvt)
    cols, ni = n_cvt + 2, idx.n_index
    la = np.array([a for a, _ in idx.pairs])
    lb = np.array([b for _, b in idx.pairs])
    P, PP = row0.copy(), row0pp.copy()
    trace = trace_hi[:, None].repeat(P.shape[1], 1).astype(np.float32)
    steps = []
    for p in range(1, (n_cvt if calc_null else n_cvt + 1) + 1):
        bp, start = _base(p, cols), _base(p + 1, cols)
        k = np.arange(start, ni)
        lane = (k - start) % 32
        # each live entry on one lane, every lane a share of the step
        assert np.array_equal(np.bincount(lane, minlength=32)[:len(k)] > 0,
                              np.ones(min(32, len(k)), bool))
        piv = np.arange(bp, bp + cols - p + 1)        # row p: (p, p..cols)
        aw, bw = bp + la[k] - p, bp + lb[k] - p
        assert np.isin(aw, piv).all() and np.isin(bw, piv).all()
        assert not np.isin(k, piv).any()              # no lane writes them
        ps_ww, ps2_ww = P[..., bp:bp + 1], PP[..., bp:bp + 1]
        trace = trace - ps2_ww[..., 0] / ps_ww[..., 0]
        nz = ps_ww != 0
        safe = np.where(nz, ps_ww, np.float32(1))
        ps_aw, ps_bw = P[..., aw], P[..., bw]
        ps2_aw, ps2_bw, ps2_ab = PP[..., aw], PP[..., bw], PP[..., k]
        P[..., k] = np.where(nz, P[..., k] - ps_aw * ps_bw / safe, P[..., k])
        v = (ps2_ab + ps_aw * ps_bw * ps2_ww / (safe * safe)
             - (ps_aw * ps2_bw + ps_bw * ps2_aw) / safe)
        PP[..., k] = np.where(nz, v, ps2_ab)
        steps.append((P.copy(), PP.copy(), k))
    return steps, trace


def _dev1(P, PP, trace, lam, trace_hi, n, n_cvt, reml):
    """dev1 from the warp's last rows (G, S, ni), as its lane 0 computes
    it (calc_null false)."""
    f = np.float32
    lam, trace_hi = lam[:, None].astype(f), trace_hi[:, None].astype(f)
    p_yy, pp_yy = P[..., -1], PP[..., -1]
    ypkpy = (p_yy - pp_yy) / lam
    if reml:
        df = f(n - n_cvt - 1)
        return f(-0.5) * ((df - trace) / lam) + f(0.5) * df * ypkpy / p_yy
    return (f(-0.5) * ((f(n) - trace_hi) / lam)
            + f(0.5) * f(n) * ypkpy / p_yy)


@pytest.mark.parametrize("n_cvt", [17, 40, 200, 340])
def test_tables_name_the_labels_pivots(n_cvt):
    """The step tables aw/bw that the warp form reads above 338
    covariates give, on every live entry of every step, the flat indices
    bp + a - p and bp + b - p that it forms from the labels below."""
    idx = pab_indices(n_cvt)
    cols, ni = n_cvt + 2, idx.n_index
    la = np.array([a for a, _ in idx.pairs])
    lb = np.array([b for _, b in idx.pairs])
    for p in range(1, n_cvt + 2):
        bp, k = _base(p, cols), np.arange(_base(p + 1, cols), ni)
        assert idx.ww[p - 1] == bp
        np.testing.assert_array_equal(idx.aw[p - 1, k], bp + la[k] - p)
        np.testing.assert_array_equal(idx.bw[p - 1, k], bp + lb[k] - p)


@pytest.mark.parametrize("n_cvt", [17, 24, 32, 40])
@pytest.mark.parametrize("reml", [True, False], ids=["reml", "ml"])
def test_warp_form_matches_plain_rows_and_reference(n_cvt, reml):
    ev, UtW, Uty, Utx = _problem(n_cvt, seed=n_cvt)
    t = torch.as_tensor
    data = lk.build_batch_data(t(ev), t(UtW), t(Uty), t(Utx), n_cvt)
    grid = opt.fine_grid(1e-5, 1e5, 10, opt._F32_GRID_REFINE)
    gp = lk.grid_products(grid, data, n_cvt)
    G = len(grid)
    rows = [lk._assemble(n_cvt, gp.shared[p][:, None, :].expand(G, S, -1),
                         gp.xx[p], gp.xcross[p].permute(0, 2, 1))
            for p in range(2)]
    pab = lk._pab_rows(rows[0], n_cvt)
    ppab = lk._ppab_rows(rows[1], pab, n_cvt)
    steps, trace = _warp_rows(rows[0].numpy(), rows[1].numpy(),
                              gp.trace_hi.numpy(), n_cvt, False)
    for p, (P, PP, live) in enumerate(steps, start=1):
        np.testing.assert_array_equal(P[..., live], pab[p][..., live].numpy())
        np.testing.assert_array_equal(PP[..., live],
                                      ppab[p][..., live].numpy())
    P, PP, _ = steps[-1]
    got = _dev1(P, PP, trace, gp.lam.numpy(), gp.trace_hi.numpy(), N, n_cvt,
                reml)
    plain = lk.grid_epilogue_plain(gp, N, n_cvt, False, reml).numpy()
    np.testing.assert_array_equal(got, plain)
    jdata = tlk.build_batch_data(*(jnp.asarray(a) for a in
                                   (ev, UtW, Uty, Utx)), n_cvt)
    ref = np.asarray(tlk.dev1_grid(grid, jdata, n_cvt, False, reml))
    bound = (1e-5 * np.abs(ref).max()
             + 8 * N * np.finfo(np.float32).eps / grid[:, None])
    assert np.all(np.abs(got - ref) <= bound)


class _Fake(kernels.Kernel):
    """A kernel whose launches are recorded, not run."""

    def __init__(self):
        super().__init__("fake", (), "")
        self.calls = []

    def launch(self, device, *args):
        self.calls.append(args)
        self.launches += 1


@pytest.mark.parametrize("lane_bytes", [0, 64])
def test_split_lanes_covers_each_lane_once(lane_bytes, monkeypatch):
    """kernels.split_lanes splits a launch over S lanes into launches of
    at most that many lanes, with or without scratch, in order; unset, a
    scratch that fits its share of free memory takes one launch."""
    k = _Fake()
    monkeypatch.setattr(kernels, "split_lanes", 3)
    free = int(10 * lane_bytes / kernels.SCRATCH_SHARE)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (free, free))
    k.launch_lanes(torch.device("cpu"), 10, lane_bytes,
                   lambda s0, n, w: (s0, n, w is None))
    assert [c[:2] for c in k.calls] == [(0, 3), (3, 3), (6, 3), (9, 1)]
    assert all(c[2] == (lane_bytes == 0) for c in k.calls)
    assert k.splits == 3
    monkeypatch.setattr(kernels, "split_lanes", None)
    k.calls.clear()
    k.launch_lanes(torch.device("cpu"), 10, lane_bytes,
                   lambda s0, n, w: (s0, n))
    assert k.calls == [(0, 10)]
