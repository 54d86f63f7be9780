"""K14's stages (csrc/calc_crt.cu) mirrored in numpy, against the plain
version (_crt_lanes) and the reference's calc_crt.

The mirror takes a lane through the kernel's order: the prologue
(EigenProc, the whitened Gram blocks and their inverses, Qi, its SNP
rows Qs, Z), each individual's Hi_k, P_k and F_k built once, the three
products over n, each family's rows (δ^p folded in) against its
columns, taken tile by tile over crt_layout's tiles, which must cover
each family's sums exactly once, then SS_p[v] from G_p, C = SS Z, the hoisted LZ = L_p[v]'
Z with Y = Qi LZ, the pair traces and the factors summed over the pairs
in the reference's order.  It must match _crt_lanes within 1e-12 of each
factor's largest magnitude at d = 2, 5 and 10, and the reference's
calc_crt within tests/test_torch_crt.py's rel 1e-9 at d = 2 and 3 (the
reference takes 39 s alone at d = 5 and 344 s at d = 10 on an 8-core
host; _crt_lanes is held against it at d = 5 in tests/test_torch_crt.py).
crt_layout is the Python mirror of calc_crt_lane_bytes (chip_smoke.py
holds the two equal on the card); the lane split is kernels.lane_ranges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.models import mvlmm_core as ref_core
from gemma_torch import kernels
from gemma_torch.models import mvlmm_core as core

TILE = 32


def _lanes(d, c, n, seed, S=2):
    """Random lanes as tests/test_torch_crt.py makes them: eigenvalues
    (one zero), an intercept and c - 2 covariates, S SNP rows, positive
    definite Vg, Ve and a negative definite Hvar."""
    rng = np.random.default_rng(seed)
    ev = np.abs(rng.gamma(2.0, 1.0, n))
    ev[0] = 0.0
    X0 = np.vstack([np.ones((1, n)), rng.normal(size=(c - 2, n))])
    R = rng.normal(size=(S, 1, n))
    Vg, Ve, H = [], [], []
    for _ in range(S):
        for out in (Vg, Ve):
            A = rng.normal(size=(d, d))
            out.append(A @ A.T / d + 0.3 * np.eye(d))
        Hr = rng.normal(size=(d * (d + 1),) * 2)
        H.append(-(Hr @ Hr.T + 0.5 * np.eye(d * (d + 1))))
    return ev, X0, R, np.array(Vg), np.array(Ve), np.array(H)


def _vech(d):
    """GEMMA's parameter order: (i, j), i <= j, row-major."""
    return [(i, j) for i in range(d) for j in range(i, d)]


def _ti(i, j, d):
    i, j = min(i, j), max(i, j)
    return i * d - i * (i - 1) // 2 + (j - i)


def _mirror(ev, X, Vg, Ve, Hv):
    """(crt_a, crt_b, crt_c) of one lane, X (c, n), in the kernel's
    stages."""
    c, n = X.shape
    d = Vg.shape[0]
    vs, dd, cd = d * (d + 1) // 2, d * d, c * d
    pairs = _vech(d)
    # 1 prologue
    D, Uh, A, _ = (t[0].numpy() for t in core.eigen_proc(
        torch.as_tensor(Vg)[None], torch.as_tensor(Ve)[None]))
    w = 1.0 / (D[:, None] * ev + 1.0)                          # (d, n)
    Qw = np.linalg.inv(np.einsum("lk,ik,jk->lij", w, X, X))
    Qi = np.einsum("li,lab,lj->aibj", Uh, Qw, Uh).reshape(cd, cd)
    s0 = (c - 1) * d
    Qs = Qi[s0:, :].reshape(d, c, d)
    Z = np.linalg.inv(Qi[s0:, s0:])
    # 2 build, once an individual
    Hi = np.einsum("li,lk,lj->kij", A, w, A)                   # (n, d, d)
    P = np.einsum("bk,ibj->kij", X, Qs) @ Hi
    F = np.einsum("kmi,mq,kqj->kij", P, Z, P)
    # 3 products: each family's rows against its columns, tile by tile
    lay = core.crt_layout(n, d, c)
    e = [np.ones(n), ev, ev * ev]
    A = [np.concatenate([e[p][:, None] * X.T for p in range(2)], 1),
         np.concatenate([e[p][:, None] * P.reshape(n, dd)
                         for p in range(2)], 1),
         np.stack([e[p] * Hi[:, b, cc] for p in range(3)
                   for b, cc in pairs], 1)]
    W = np.zeros((n, vs, d, d))
    for v, (i, j) in enumerate(pairs):
        W[:, v] = P[:, :, i, None] * Hi[:, None, j, :]          # (n, a, e)
        if i != j:
            W[:, v] += P[:, :, j, None] * Hi[:, None, i, :]
    B = [W.reshape(n, vs * dd), P.reshape(n, dd),
         np.stack([F[:, ee, a] for ee, a in pairs], 1)]
    M = [np.zeros((a.shape[1], b.shape[1])) for a, b in zip(A, B)]
    cover = [np.zeros(m.shape, int) for m in M]
    for f, ti, tj in lay["tiles"]:
        rs = slice(ti * TILE, (ti + 1) * TILE)
        cs = slice(tj * TILE, (tj + 1) * TILE)
        M[f][rs, cs] = A[f][:, rs].T @ B[f][:, cs]
        cover[f][rs, cs] += 1
    assert all((cv == 1).all() for cv in cover)
    assert [m.shape for m in M] == list(zip(lay["fr"], lay["fc"]))
    G = M[1].reshape(2, dd, dd)
    T = M[2].reshape(3, vs, vs)
    L = (M[0].reshape(2, c, vs, d, d).transpose(0, 2, 3, 1, 4)
         .reshape(2, vs, d, cd))
    # 4 C and Y
    C = np.zeros((2, vs, d, d))
    Y = np.zeros((2, vs, cd, d))
    for p in range(2):
        for v, (i, j) in enumerate(pairs):
            Gp = G[p].reshape(d, d, d, d)                      # [a, i, b, j]
            SS = Gp[:, i, :, j] + (Gp[:, j, :, i] if i != j else 0.0)
            C[p, v] = SS @ Z
            Y[p, v] = Qi @ (L[p, v].T @ Z)
    # 5 pair traces and 6 the factors, the pairs in order
    trCg = -np.einsum("vaa->v", C[1])
    trCe = -np.einsum("vaa->v", C[0])
    B = Cs = Ds = 0.0
    for v1 in range(vs):
        for v2 in range(v1, vs):
            tt = [[np.trace(L[p1, v1] @ Y[p2, v2]) for p2 in range(2)]
                  for p1 in range(2)]
            cc = [[np.trace(C[p1, v1] @ C[p2, v2]) for p2 in range(2)]
                  for p1 in range(2)]
            (i1, j1), (i2, j2) = pairs[v1], pairs[v2]
            mm = []
            for p in range(3):
                m = 0.0
                for a, b in ((i1, j1), (j1, i1))[:1 + (i1 != j1)]:
                    for c2, e2 in ((i2, j2), (j2, i2))[:1 + (i2 != j2)]:
                        m += T[p, _ti(b, c2, d), _ti(e2, a, d)]
                mm.append(m)
            trB_gg = -tt[1][1] + mm[2]
            trB_ge = -(tt[1][0] + tt[0][1]) + 2.0 * mm[1]
            trB_ee = -tt[0][0] + mm[0]
            trCC_gg, trCC_ge, trCC_ee = (cc[1][1], cc[1][0] + cc[0][1],
                                         cc[0][0])
            mult = 1.0 if v1 == v2 else 2.0
            hg, he, hx = Hv[v1, v2], Hv[v1, vs + v2], Hv[vs + v1, vs + v2]
            B += mult * (hg * trB_gg + he * trB_ge + hx * trB_ee)
            Cs += mult * (hg * (trCC_gg + 0.5 * trCg[v1] * trCg[v2])
                          + he * (trCC_ge + 0.5 * trCg[v1] * trCe[v2]
                                  + 0.5 * trCe[v1] * trCg[v2])
                          + hx * (trCC_ee + 0.5 * trCe[v1] * trCe[v2]))
            Ds += mult * (hg * (trCC_gg + trB_gg) + he * (trCC_ge + trB_ge)
                          + hx * (trCC_ee + trB_ee))
    return 2.0 * Ds - Cs, 2.0 * B, Cs


def _mirror_lanes(ev, X0, R, Vg, Ve, H):
    out = [_mirror(ev, np.vstack([X0, R[s]]), Vg[s], Ve[s], H[s])
           for s in range(R.shape[0])]
    return [np.array(col) for col in zip(*out)]


@pytest.mark.parametrize("d,c,n,seed", [(2, 2, 40, 0), (2, 13, 30, 1),
                                        (5, 2, 40, 2), (10, 3, 24, 3)])
def test_stages_match_plain(d, c, n, seed):
    ev, X0, R, Vg, Ve, H = _lanes(d, c, n, seed)
    got = _mirror_lanes(ev, X0, R, Vg, Ve, H)
    t = torch.as_tensor
    want = core.calc_crt_plain(t(ev), t(X0), t(R), t(Vg), t(Ve), t(H))
    for g, w in zip(got, want):
        w = w.numpy()
        assert np.max(np.abs(g - w)) <= 1e-12 * np.max(np.abs(w))


@pytest.mark.parametrize("d,c,n,seed", [(2, 3, 10, 4), (3, 2, 8, 5)])
def test_stages_match_reference(d, c, n, seed):
    ev, X0, R, Vg, Ve, H = _lanes(d, c, n, seed)
    S = R.shape[0]
    X = np.concatenate([np.broadcast_to(X0, (S,) + X0.shape), R], axis=1)
    want = ref_core.calc_crt(jnp.asarray(ev), jnp.asarray(X),
                             jnp.zeros((d, n)), jnp.asarray(Vg),
                             jnp.asarray(Ve), jnp.asarray(H))
    for g, w in zip(_mirror_lanes(ev, X0, R, Vg, Ve, H), want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-9)


@pytest.mark.parametrize("n,d,c", [(757, 2, 2), (757, 5, 2), (757, 10, 13),
                                   (100, 90, 2)])
def test_layout_and_lane_split(n, d, c):
    """The layout's regions follow one another, a lane's scratch grows
    with n by its Gram weights and three per-individual d×d arrays, each
    family's tiles cover its rows and columns, the build's staged arrays
    leave shared memory past 85 traits, and a block split at three lanes
    covers each lane once."""
    lay = core.crt_layout(n, d, c)
    off = lay["offsets"]
    names = list(off)
    assert [off[k] for k in names] == sorted(off[k] for k in names)
    assert lay["len"] >= off["tmp"] > off["pair"]
    grow = core.crt_layout(n + 1, d, c)["len"] - lay["len"]
    assert grow >= 3 * d * d + d
    assert lay["build_smem"] == (d <= 85)
    vs = d * (d + 1) // 2
    assert lay["fr"] == [2 * c, 2 * d * d, 3 * vs]
    assert lay["fc"] == [vs * d * d, d * d, vs]
    for f in range(3):
        mine = [(ti, tj) for g, ti, tj in lay["tiles"] if g == f]
        assert len(set(mine)) == len(mine)
        assert {ti for ti, _ in mine} == set(range(-(-lay["fr"][f] // TILE)))
        assert {tj for _, tj in mine} == set(range(-(-lay["fc"][f] // TILE)))
    lane_bytes = 8 * lay["len"]
    S = 10
    seen = [s for a, b in kernels.lane_ranges(S, lane_bytes, 3 * lane_bytes)
            for s in range(a, b)]
    assert seen == list(range(S))
