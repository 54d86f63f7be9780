"""The port's BSLMM, BSLMM-DAP and prediction cores against gemma_tpu on
the same numpy inputs, float64 on the CPU (the kernel wrappers take
their plain versions), and the port's random stream.

Tolerances:
  * calc_posterior fed the reference's own draws (its key split as at
    gemma_tpu/models/bslmm.py:148): logpost, beta, UtXb, alpha, Utu, pve
    and pge rel 1e-10 (the same float64 formulas; the reference factors
    the s_max-padded Omega, the port its n_gamma block);
  * dap_calc_bf rel 1e-10; dap_estimate_hyper and ridge_gblup rel 1e-12;
    predict_effects, add_breeding_values and mvnorm_predict rel 1e-10;
  * chains: the port's stream is its own (Philox, ops/philox.py), so the
    two packages' chains agree in distribution only (ROADMAP §C6): on the
    reference's test data both record 1,000 states, both put the two
    causal SNPs on top by inclusion, their mean pve within 0.1 and both
    acceptance ratios in (0.01, 0.9);
  * Philox: Random123's known answers exactly; sample moments within
    five standard errors;
  * a checkpointed chain, and one killed after a save and resumed, equal
    the uninterrupted chain bit for bit.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.models import bslmm as rb
from gemma_tpu.models import bslmmdap as rdap
from gemma_tpu.models import predict as rpred
from gemma_tpu.ops.eigh import eigh_zeroed
from gemma_torch import kernels
from gemma_torch.carry import bslmm_inputs_from_numpy
from gemma_torch.models import bslmm as pb
from gemma_torch.models import bslmmdap as pdap
from gemma_torch.models import predict as ppred
from gemma_torch.ops import philox

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain chain loops over small tensors (see
    tests/test_torch_mvlmm.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(n=150, p=120, n_causal=3, seed=0, h2=0.6):
    """tests/test_bslmm.py's simulation."""
    rng = np.random.default_rng(seed)
    X = rng.binomial(2, 0.3, size=(p, n)).astype(np.float64)
    Xc = X - X.mean(axis=1, keepdims=True)
    causal = rng.choice(p, n_causal, replace=False)
    beta = rng.normal(0, 1, n_causal)
    g = beta @ Xc[causal]
    g *= np.sqrt(h2) / g.std()
    y = g + rng.normal(0, np.sqrt(1 - h2), n)
    y -= y.mean()
    return Xc, y, Xc.T @ Xc / p, causal


def _eigen(Xc, y, K):
    """The reference's factors as numpy: eval, U, trace_G, UtX (n, p),
    Uty."""
    ev, U, tr = eigh_zeroed(jnp.asarray(K))
    UtX = np.asarray((jnp.asarray(Xc) @ U).T)
    return (np.asarray(ev), np.asarray(U), float(tr), UtX,
            np.asarray(U.T @ jnp.asarray(y)))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=F64)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def post_setup():
    Xc, y, K, _ = _sim(seed=1)
    ev, U, tr, UtX, Uty = _eigen(Xc, y, K)
    return ev, U, tr, UtX, Uty


@pytest.mark.parametrize("a_mode", [11, 13])
@pytest.mark.parametrize("n_gamma, rho", [(4, 0.8), (0, 0.5), (7, 0.0),
                                          (20, 0.3)],
                         ids=["ng4", "ng0", "rho0", "ng20"])
def test_calc_posterior_with_the_references_draws(post_setup, a_mode,
                                                  n_gamma, rho):
    ev, U, tr, UtX, Uty = post_setup
    n, p = UtX.shape
    s_max = 20
    st_r = rb.BslmmSettings(ns_test=p, ni_test=n, s_max=s_max, w_step=1,
                            s_step=1, a_mode=a_mode)
    calc_posterior, _ = rb.make_mcmc_step(
        jnp.asarray(UtX), jnp.asarray(Uty), jnp.asarray(ev), tr,
        rb.calc_p_gamma(p, st_r.geo_mean), st_r)
    ranks = (np.arange(s_max) * 7) % p
    h, logp = 0.45, float(np.log(5.0 / p))
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
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        assert _rel(a, b) <= 1e-10 or np.abs(np.asarray(b)).max() == 0 \
            and np.abs(a).max() == 0, name


def test_ridge_gblup_matches_reference(post_setup):
    ev, U, tr, UtX, Uty = post_setup
    a_r, u_r = rb.ridge_gblup(jnp.asarray(UtX), jnp.asarray(Uty),
                              jnp.asarray(ev), 1.7)
    a_p, u_p = pb.ridge_gblup(_t(UtX.T), _t(Uty), _t(ev), 1.7)
    assert _rel(a_p.numpy(), a_r) <= 1e-12
    assert _rel(u_p.numpy(), u_r) <= 1e-12


@pytest.fixture(scope="module")
def dap_setup():
    """tests/test_bslmmdap.py's data: two causal SNPs of 40."""
    rng = np.random.default_rng(2)
    n, p = 120, 40
    X = rng.binomial(2, 0.3, size=(p, n)).astype(np.float64)
    Xc = X - X.mean(axis=1, keepdims=True)
    g = Xc[[3, 17]].sum(axis=0)
    g *= np.sqrt(0.7) / g.std()
    y = g + rng.normal(0, np.sqrt(0.3), n)
    y -= y.mean()
    ev, U, tr, UtX, Uty = _eigen(Xc, y, Xc.T @ Xc / p)
    grid = rdap.hyper_grid(0.05, 0.95, 4, 0.1, 0.9, 3, tr)
    return ev, tr, UtX, Uty, grid


def test_dap_calc_bf_matches_reference(dap_setup):
    ev, tr, UtX, Uty, grid = dap_setup
    want = rdap.dap_calc_bf(jnp.asarray(UtX), jnp.asarray(Uty),
                            jnp.asarray(ev), grid)
    kernels.reset_launches()
    got = pdap.dap_calc_bf(_t(UtX.T), _t(Uty), _t(ev), grid)
    assert all(k.launches == 0 for k in kernels.ALL)
    assert got.shape == want.shape == (UtX.shape[1], len(grid))
    assert float(np.max(np.abs(got - want) / np.abs(want))) <= 1e-10


def test_bf_epilogue_float32_products_in_float64(dap_setup):
    """Float32 products, float64 epilogue: the BF is float64 and finite
    where the log-difference passes float32's exp range."""
    ev, tr, UtX, Uty, grid = dap_setup
    f32 = torch.float32
    xHx, xHy, ldH, hyy = pdap.bf_products(
        torch.as_tensor(UtX.T.copy(), dtype=f32),
        torch.as_tensor(Uty, dtype=f32), torch.as_tensor(ev, dtype=f32),
        grid[:, 3])
    assert xHx.dtype == f32 and ldH.dtype == F64
    sa2 = _t(grid[:, 2])
    bf = pdap.bf_epilogue(xHx, xHy, ldH, hyy, sa2, 1.0, len(Uty))
    ref = pdap.bf_epilogue(xHx.double(), xHy.double(), ldH, hyy, sa2, 1.0,
                           len(Uty))
    assert bf.dtype == F64 and torch.isfinite(bf).all()
    assert float((bf.log() - ref.log()).abs().max()) <= 1e-3
    big = pdap.bf_epilogue(xHx * 0 + 1e4, xHy * 0 + 2e3, ldH, hyy,
                           sa2 * 0 + 1.0, 1.0, len(Uty))
    assert torch.isfinite(big).all() and float(big.log().min()) > 88


def test_dap_estimate_hyper_matches_reference(dap_setup):
    ev, tr, UtX, Uty, grid = dap_setup
    BF = rdap.dap_calc_bf(jnp.asarray(UtX), jnp.asarray(Uty),
                          jnp.asarray(ev), grid)
    blocks = [BF[i:i + 10] for i in range(0, len(BF), 10)]
    rs = [f"rs{i}" for i in range(len(BF))]
    wab = np.full(len(grid), 1.0 / len(grid))
    rng = np.random.default_rng(4)
    Ac = rng.normal(size=(len(BF), 1))
    Ad = rng.integers(0, 3, size=(len(BF), 1))
    for kw in ({}, dict(Ad=Ad, n_levels=[3]), dict(Ac=Ac),
               dict(Ac=Ac, Ad=Ad, n_levels=[3])):
        want = rdap.dap_estimate_hyper(grid[:, 2], grid[:, 3], wab, blocks,
                                       rs, **kw)
        got = pdap.dap_estimate_hyper(grid[:, 2], grid[:, 3], wab, blocks,
                                      rs, **kw)
        for a, b in zip(got, want):
            assert _rel(a, b) <= 1e-12, kw


def test_predict_effects_matches_reference():
    rng = np.random.default_rng(0)
    p, n = 30, 60
    X = rng.binomial(2, 0.4, size=(p, n)).astype(np.float64)
    X[rng.random((p, n)) < 0.05] = np.nan
    train = rng.random(n) < 0.7
    rs = [f"rs{i}" for i in range(p)]
    effects = {f"rs{i}": rng.normal() for i in range(0, p, 2)}
    a_r, k_r = rpred.predict_effects(X, rs, train, effects)
    a_p, k_p = ppred.predict_effects(X, rs, train, effects, device="cpu")
    assert k_p == k_r and _rel(a_p, a_r) <= 1e-10


def test_add_breeding_values_matches_reference():
    rng = np.random.default_rng(1)
    n = 40
    A = rng.normal(size=(n, 25))
    G = A @ A.T / 25             # rank 25: a zero eigenvalue cluster
    train = np.zeros(n, dtype=bool)
    train[rng.choice(n, 30, replace=False)] = True
    u_hat = rng.normal(size=30)
    want = rpred.add_breeding_values(G, u_hat, train)
    got = ppred.add_breeding_values(G, u_hat, train, device="cpu")
    assert _rel(got, want) <= 1e-10


@pytest.mark.parametrize("d", [1, 2])
def test_mvnorm_predict_matches_reference(d):
    rng = np.random.default_rng(5 + d)
    m = 25
    A = rng.normal(size=(m, 40))
    G = A @ A.T / 40
    Y = rng.normal(size=(m, d))
    Y[rng.random((m, d)) < 0.15] = np.nan
    Y_hat = rng.normal(size=(m, d)) * 0.1
    if d == 1:
        Vg, Ve = np.asarray(1.3), np.asarray(0.7)
    else:
        Vg = np.array([[1.0, 0.3], [0.3, 0.8]])
        Ve = np.array([[0.5, 0.1], [0.1, 0.6]])
    want = rpred.mvnorm_predict(Y, Y_hat, G, Vg, Ve)
    got = ppred.mvnorm_predict(Y, Y_hat, G, Vg, Ve, device="cpu")
    assert _rel(got, want) <= 1e-10
    np.testing.assert_array_equal(got[~np.isnan(Y)], Y[~np.isnan(Y)])


def test_probit_transform_matches_reference():
    y = np.linspace(-4, 4, 17)
    assert _rel(ppred.probit_transform(y), rpred.probit_transform(y)) <= 1e-12


# ---------------------------------------------------------------------------
# the random stream

def test_philox_known_answers():
    """Random123's philox4x32_10 known-answer vectors, on ints and on
    int64 tensors."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        assert philox.philox4x32(*ctr, key) == want
        got = philox.philox4x32(*(torch.tensor([c]) for c in ctr), key)
        assert tuple(int(g) for g in got) == want


def _within(sample, mean, var, k=5.0):
    se = math.sqrt(var / len(sample))
    return abs(float(sample.mean()) - mean) <= k * se


def test_philox_uniform_and_normal_moments():
    key = philox.key_of(2024)
    idx = torch.arange(200_000)
    u1, u2 = philox.unit2_t(key, 3, 7, idx)
    for u in (u1, u2):
        assert float(u.min()) > 0 and float(u.max()) < 1
        assert _within(u, 0.5, 1 / 12) and _within(u * u, 1 / 3, 4 / 45)
    z = philox.normal_t(key, 3, 8, idx)
    assert _within(z, 0.0, 1.0) and _within(z * z, 1.0, 2.0)
    assert abs(float((z ** 3).mean())) < 5 * math.sqrt(15 / len(z))
    # scalars and tensors give the same draws
    assert philox.unit2(key, 3, 7, 5) == (float(u1[5]), float(u2[5]))
    assert philox.normal(key, 3, 8, 9) == float(z[9])


@pytest.mark.parametrize("a", [0.4, 1.0, 3.5, 97.5])
def test_philox_gamma_moments(a):
    key = philox.key_of(7)
    g = np.array([philox.gamma(key, 1, 7, a, i) for i in range(20_000)])
    assert g.min() > 0
    assert _within(g, a, a)                   # mean a, variance a
    assert _within((g - a) ** 2, a, 2 * a * a + 6 * a)


@pytest.mark.parametrize("bound", [0.0, 3.0, -3.0, 8.0, -8.0])
def test_philox_truncated_normal_moments(bound):
    """X > bound: the mean and second moment of the truncated normal
    (Mills ratio), exact also at 8 standard deviations."""
    key = philox.key_of(5)
    N = 100_000
    x = philox.truncnorm_above_t(key, 2, 10, torch.full((N,), bound,
                                                       dtype=F64))
    assert float(x.min()) > bound
    phi = math.exp(-0.5 * bound * bound) / math.sqrt(2 * math.pi)
    tail = 0.5 * math.erfc(bound / math.sqrt(2))
    lam = phi / tail
    mean = lam
    var = 1 + bound * lam - lam * lam
    assert _within(x, mean, var)
    assert _within(x * x, var + mean * mean, 2 + 4 * bound * bound + 10)


# ---------------------------------------------------------------------------
# chains

_REF_CHAIN = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
sys.path.insert(0, {repo!r})
from gemma_tpu.models.bslmm import BslmmSettings, run_mcmc
d = np.load({path!r})
st = BslmmSettings(ns_test=100, ni_test=200, s_max=20, w_step=500,
                   s_step=2000, r_pace=2, n_mh=1)
f = run_mcmc(jnp.asarray(d["UtX_sorted"]), jnp.asarray(d["Uty"]),
             jnp.asarray(d["ev"]), float(d["tr"]), st, h0=0.5, rho0=0.9,
             logp0=float(np.log(5.0 / 100)), n_gamma0=5, seed=3)
w = int(f.w)
print(json.dumps(dict(w=w, pve=np.asarray(f.rec_hyp)[:w, 1].tolist(),
                      cnt=np.asarray(f.acc_betacnt).tolist(),
                      n_accept=int(f.n_accept))))
"""


def test_chain_statistics_match_reference(tmp_path):
    """tests/test_bslmm.py's chain (n = 200, p = 100, two causal SNPs, w
    500, s 2,000, r_pace 2) through both packages."""
    Xc, y, K, causal = _sim(n=200, p=100, n_causal=2, seed=2, h2=0.7)
    ev, U, tr, UtX, Uty = _eigen(Xc, y, K)
    order = np.argsort(-np.abs(UtX.T @ Uty), kind="stable")
    path = str(tmp_path / "ops.npz")
    np.savez(path, UtX_sorted=UtX[:, order], Uty=Uty, ev=ev, tr=tr)
    r = subprocess.run([sys.executable, "-c",
                        _REF_CHAIN.format(repo=REPO, path=path)],
                       capture_output=True, text=True, timeout=900,
                       env=dict(os.environ))
    assert r.returncode == 0, r.stderr[-2000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])

    st = rb.BslmmSettings(ns_test=100, ni_test=200, s_max=20, w_step=500,
                          s_step=2000, r_pace=2, n_mh=1)
    inp = bslmm_inputs_from_numpy(UtX[:, order], Uty, ev, tr, st, h0=0.5,
                                  rho0=0.9, logp0=float(np.log(5.0 / 100)),
                                  n_gamma0=5)
    kernels.reset_launches()
    f = pb.run_mcmc(*inp, seed=3)
    assert all(k.launches == 0 for k in kernels.ALL)
    assert f.w == ref["w"] == 1000
    pves = {"port": f.rec_hyp[:f.w, 1].numpy(), "ref": np.array(ref["pve"])}
    for cnt, name in ((f.acc_betacnt.numpy(), "port"),
                      (np.array(ref["cnt"]), "ref")):
        pip = np.zeros(100)
        pip[order] = cnt / 1000
        assert set(np.argsort(-pip)[:2]) == set(causal), name
        assert np.isfinite(pves[name]).all()
    assert abs(pves["port"].mean() - pves["ref"].mean()) <= 0.1
    for acc in (f.n_accept, ref["n_accept"]):
        assert 0.01 < acc / 2500 < 0.9


def test_probit_chain_runs():
    """-bslmm 3: the latent liabilities resampled each iteration (the
    reference's test_probit_chain_runs, on the port)."""
    Xc, y_cont, K, _ = _sim(n=120, p=60, n_causal=2, seed=7, h2=0.7)
    y01 = (y_cont > 0).astype(np.float64)
    y_lab = y01 - y01.mean()
    ev, U, tr, UtX, Uty = _eigen(Xc, y_lab, K)
    st = rb.BslmmSettings(ns_test=60, ni_test=120, s_max=10, w_step=100,
                          s_step=400, r_pace=2, n_mh=2, a_mode=13)
    inp = bslmm_inputs_from_numpy(UtX, Uty, ev, tr, st, h0=0.4, rho0=0.8,
                                  logp0=float(np.log(4.0 / 60)), n_gamma0=4,
                                  U=U, y_labels=y_lab)
    f = pb.run_mcmc(*inp, seed=8)
    assert f.w == 200
    hyp = f.rec_hyp[:f.w].numpy()
    assert np.isfinite(hyp).all()
    assert ((hyp[:, 1] >= 0) & (hyp[:, 1] <= 1)).all()
    assert f.n_accept > 0 and np.isfinite(f.mean_z)


def _assert_same_state(a, b):
    for f in pb.ChainState._fields:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), f
        else:
            assert va == vb, f


def _ckpt_chain(w_step=200, s_step=400, r_pace=10):
    rng = np.random.default_rng(0)
    n, p = 60, 40
    X = rng.binomial(2, 0.3, size=(p, n)).astype(np.float64)
    Xc = X - X.mean(axis=1, keepdims=True)
    y = Xc[2] * 0.9 + rng.normal(size=n)
    y -= y.mean()
    ev, U, tr, UtX, Uty = _eigen(Xc, y, Xc.T @ Xc / p)
    st = pb.BslmmSettings(ns_test=p, ni_test=n, w_step=w_step, s_step=s_step,
                          r_pace=r_pace, s_max=20, a_mode=11)
    ops = pb.chain_operands(_t(UtX.T), _t(Uty), _t(ev), tr, st.geo_mean)
    return ops, st, 0.4, 0.8, float(np.log(3 / p)), 3


def test_checkpoint_and_resume_are_bit_identical(tmp_path, monkeypatch):
    """A chain checkpointed every 137 iterations equals the uninterrupted
    one; a run killed inside its second save resumes from the first and
    ends in the same state."""
    args = _ckpt_chain()
    ref = pb.run_mcmc(*args, seed=7)

    ck = str(tmp_path / "chain.ckpt.npz")
    flushed = []
    seg = pb.run_mcmc(*args, seed=7, checkpoint_path=ck,
                      checkpoint_every=137,
                      on_segment=lambda s: flushed.append((s.t, s.w)))
    _assert_same_state(ref, seg)
    assert [t for t, _ in flushed] == [137, 274, 411, 548, 600]

    ck2 = str(tmp_path / "crash.ckpt.npz")
    saves = {"n": 0}
    real_savez = np.savez

    def crashing_savez(*a, **kw):
        real_savez(*a, **kw)
        saves["n"] += 1
        if saves["n"] == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(np, "savez", crashing_savez)
    with pytest.raises(KeyboardInterrupt):
        pb.run_mcmc(*args, seed=7, checkpoint_path=ck2, checkpoint_every=137)
    monkeypatch.setattr(np, "savez", real_savez)
    # the crash hits inside the second save, before its atomic replace
    assert int(np.load(ck2)["t"]) == 137
    resumed = pb.run_mcmc(*args, seed=7, checkpoint_path=ck2,
                          checkpoint_every=137)
    _assert_same_state(ref, resumed)


@pytest.mark.parametrize("split", [(300, 300, 10), (200, 400, 5)])
def test_checkpoint_of_another_split_is_not_resumed(tmp_path, split):
    """A checkpoint of the same length and seed but another burn-in split
    or r_pace (record buffers of another size) is not resumed: the chain
    starts afresh and equals an uninterrupted run of the new settings."""
    # an unfinished checkpoint of -w 200 -s 400 -rpace 10 (40 rows), t = 274
    ck = str(tmp_path / "chain.ckpt.npz")
    ops, st, *init = _ckpt_chain()
    part = pb.bslmm_chain(ops, st, pb.init_state(ops, st, *init, 7), 274, 7)
    pb.save_checkpoint(ck, part, pb.chain_id(ops, st), 7)
    new = _ckpt_chain(*split)
    want = pb.run_mcmc(*new, seed=7)
    got = pb.run_mcmc(*new, seed=7, checkpoint_path=ck, checkpoint_every=137)
    _assert_same_state(want, got)
    assert got.w == new[1].n_records() == got.rec_hyp.shape[0]


def test_chain_refuses_a_state_whose_records_do_not_fit():
    """K12's wrapper and its plain version refuse a state whose record
    rows or count are not the ones the settings give."""
    ops, st, *init = _ckpt_chain()
    s0 = pb.init_state(ops, st, *init, 7)
    other = dataclasses.replace(st, w_step=100, s_step=500)
    with pytest.raises(ValueError, match="record rows"):
        pb.bslmm_chain(ops, other, s0, 600, 7)
    part = pb.bslmm_chain(ops, st, s0, 300, 7)
    with pytest.raises(ValueError, match="record rows"):
        pb.bslmm_chain(ops, st, part._replace(w=part.w + 1), 400, 7)
    with pytest.raises(ValueError, match="outside"):
        pb.bslmm_chain(ops, st, part, 700, 7)
