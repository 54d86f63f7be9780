"""Phenotype prediction (-predict 1/2/3; reference src/prdt.cpp), through
the reference package's `gemma_tpu/models/predict.py`.

Mode 41: for individuals with missing phenotypes, accumulate
y_hat = mu + sum_s beta_s (x_s - mean_train(x_s)) over SNPs present in
the estimated-parameter file (PRDT::AnalyzeBimbam/Plink,
prdt.cpp:207-446), optionally adding kinship-propagated breeding
values u_f = K_fo K_oo^+ u_hat (AddBV, prdt.cpp:133-205).
Mode 42: probit scale, y → Phi(y) (gemma.cpp:1715-1722).
Mode 43: conditional-MVN imputation (MvnormPrdt, prdt.cpp:448-553).

The per-SNP accumulation is one product, test genotypes (f, p_used) @
effects (p_used,); AddBV an eigendecomposition and three products; mode
43 a solve.  All run in float64 with `torch.linalg` (cuSOLVER on the
card, LAPACK on the CPU) on the device the caller names.
"""

from __future__ import annotations

import numpy as np
import torch

from gemma_torch.ops.eigh import EIGEN_MINVALUE
from gemma_torch.ops.stats import normal_cdf

F64 = torch.float64


def read_est(path: str, est_column=(2, 5, 6, 7)) -> dict:
    """BSLMM .param.txt-style estimates → {rs: alpha + beta*gamma}
    (ReadFile_est, gemma_io.cpp; column 0 means 'absent', value
    defaults alpha=0, beta=0, gamma=1)."""
    out = {}
    rs_c, a_c, b_c, g_c = est_column
    with open(path) as fh:
        next(fh)  # header
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            rs = parts[rs_c - 1]
            alpha = float(parts[a_c - 1]) if a_c > 0 else 0.0
            beta = float(parts[b_c - 1]) if b_c > 0 else 0.0
            gamma = float(parts[g_c - 1]) if g_c > 0 else 1.0
            if rs in out:
                raise ValueError(f"duplicate SNP {rs} in {path}")
            out[rs] = alpha + beta * gamma
    return out


def predict_effects(X_raw: np.ndarray, rs_names, indicator_idv: np.ndarray,
                    effects: dict, device="cuda") -> tuple:
    """Sum of genotype-effect products for test individuals.

    X_raw: (p, ni_total) raw dosages (NaN missing); indicator_idv True
    for training rows.  Test genotypes are centered by the TRAINING
    mean; test-missing values are imputed at the test mean before
    centering (prdt.cpp:253-295).  Returns (y_add (n_test,), ns_used).
    """
    train = indicator_idv
    test = ~indicator_idv
    used = [i for i, rs in enumerate(rs_names) if rs in effects]
    if not used:
        return np.zeros(int(test.sum())), 0

    Xu = X_raw[used]
    bvec = np.array([effects[rs_names[i]] for i in used])

    Xtr = Xu[:, train]
    Xte = Xu[:, test]
    with np.errstate(invalid="ignore"):
        train_mean = np.nanmean(Xtr, axis=1)
        test_mean = np.nanmean(Xte, axis=1)
    # SNPs missing for ALL test individuals are skipped (prdt.cpp:279)
    ok = ~np.isnan(test_mean)
    Xte = np.where(np.isnan(Xte), test_mean[:, None], Xte)
    Xc = Xte - train_mean[:, None]
    Xc = np.where(ok[:, None], Xc, 0.0)
    bvec = np.where(ok, bvec, 0.0)

    y_add = torch.as_tensor(bvec, dtype=F64, device=device) @ torch.as_tensor(
        Xc, dtype=F64, device=device)
    return y_add.cpu().numpy(), int(ok.sum())


def predict_effects_fetch(fetch, rs_names, indicator_idv: np.ndarray,
                          effects: dict, block: int = 4096,
                          device="cuda") -> tuple:
    """Streaming predict_effects: `fetch(sel)` returns the raw dosage
    rows for (sorted) indices sel, so the (p, n) matrix never
    materialises — the reference streams the genotype file the same
    way (PRDT::AnalyzeBimbam, prdt.cpp:207-310)."""
    test = ~indicator_idv
    used = np.array([i for i, rs in enumerate(rs_names) if rs in effects],
                    dtype=np.int64)
    if used.size == 0:
        return np.zeros(int(test.sum())), 0
    y_add = np.zeros(int(test.sum()))
    ns_used = 0
    rs_arr = list(rs_names)
    for s in range(0, len(used), block):
        sel = used[s:s + block]
        ya, k = predict_effects(fetch(sel), [rs_arr[i] for i in sel],
                                indicator_idv, effects, device)
        y_add += ya
        ns_used += k
    return y_add, ns_used


def add_breeding_values(G_full: np.ndarray, u_hat: np.ndarray,
                        indicator_idv: np.ndarray,
                        device="cuda") -> np.ndarray:
    """u_test = K_fo K_oo^+ u_hat with K centered by the training
    indicator (AddBV, prdt.cpp:133-205)."""
    G_full = torch.as_tensor(G_full, dtype=F64, device=device)
    w = torch.as_tensor(indicator_idv, dtype=F64, device=device)
    Gw = G_full @ w
    wtw = w @ w
    d = w @ Gw
    G = (G_full - torch.outer(Gw, w) / wtw - torch.outer(w, Gw) / wtw
         + d / (wtw * wtw) * torch.outer(w, w))

    train = torch.as_tensor(indicator_idv, device=device)
    Goo = G[train][:, train]
    Gfo = G[~train][:, train]

    eval_, U = torch.linalg.eigh(Goo)
    eval_ = torch.where(eval_ < EIGEN_MINVALUE, torch.zeros_like(eval_),
                        eval_)
    Utu = U.T @ torch.as_tensor(u_hat, dtype=F64, device=device)
    Utu = torch.where(eval_ != 0, Utu / torch.where(eval_ != 0, eval_, 1.0),
                      Utu)
    return (Gfo @ (U @ Utu)).cpu().numpy()


def probit_transform(y: np.ndarray) -> np.ndarray:
    return normal_cdf(torch.as_tensor(y, dtype=F64), 1.0).numpy()


def mvnorm_predict(Y_full: np.ndarray, Y_hat: np.ndarray,
                   G_full: np.ndarray, Vg: np.ndarray,
                   Ve: np.ndarray, device="cuda") -> np.ndarray:
    """Conditional-MVN imputation of missing phenotypes (mode 43).

    Y_full: (m, d) phenotypes over covariate-valid individuals, NaN
    missing; Y_hat: fixed-effect predictions; H = Vg ⊗_sym G + I ⊗ Ve
    in (individual, phenotype) flattening.  y_miss = yhat_miss +
    H_mo H_oo^{-1} (y_obs - yhat_obs)  (MvnormPrdt, prdt.cpp:448-553).
    """
    m, d = Y_full.shape
    obs_np = ~np.isnan(Y_full).reshape(-1)            # flat (m*d,)
    obs = torch.as_tensor(obs_np, device=device)
    G = torch.as_tensor(G_full, dtype=F64, device=device)
    I = torch.eye(m, dtype=F64, device=device)
    if d == 1:
        H = float(Vg) * G + float(Ve) * I
    else:
        H = (torch.kron(G, torch.as_tensor(Vg, dtype=F64, device=device))
             + torch.kron(I, torch.as_tensor(Ve, dtype=F64, device=device)))

    yh = torch.as_tensor(Y_hat.reshape(-1), dtype=F64, device=device)
    yf = torch.as_tensor(Y_full.reshape(-1), dtype=F64, device=device)
    resid = yf[obs] - yh[obs]
    H_oo = H[obs][:, obs]
    H_mo = H[~obs][:, obs]
    y_miss = yh[~obs] + H_mo @ torch.linalg.solve(H_oo, resid)

    out = Y_full.copy().reshape(-1)
    out[~obs_np] = y_miss.cpu().numpy()
    return out.reshape(m, d)
