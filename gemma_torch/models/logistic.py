"""Penalized logistic regression (reference src/logistic.cpp): a copy of
the reference package's gemma_tpu/models/logistic.py (host numpy).

Used by BSLMM-DAP's hyper-parameter EM to regress posterior inclusion
probabilities on SNP annotations (bslmmdap.cpp:789-801).  The
reference implements IRLS Newton with optional L1/L2 penalties and
three interfaces (categorical / continuous / mixed designs); DAP calls
them unpenalized.

Here: one weighted IRLS core on a dense design matrix; categorical
columns are one-hot encoded (a coefficient per level, matching the
reference's per-level parameterization); lambda_l2 gives the ridge
penalty (L1 is approximated by none — DAP never uses it).
"""

from __future__ import annotations

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def irls_fit(X: np.ndarray, y: np.ndarray, lambda_l2: float = 0.0,
             max_iter: int = 100, tol: float = 1e-8) -> np.ndarray:
    """Weighted-response logistic fit: y in [0,1] are probabilities
    (posterior inclusion), X includes no intercept column (added here
    as the LAST coefficient, matching logistic.cpp's layout)."""
    n, k = X.shape
    Xd = np.column_stack([X, np.ones(n)])
    beta = np.zeros(k + 1)
    for _ in range(max_iter):
        eta = Xd @ beta
        mu = _sigmoid(eta)
        w = np.maximum(mu * (1 - mu), 1e-10)
        z = eta + (y - mu) / w
        A = Xd.T @ (w[:, None] * Xd)
        if lambda_l2 > 0:
            A += lambda_l2 * np.eye(k + 1)
        b = Xd.T @ (w * z)
        beta_new = np.linalg.solve(A + 1e-10 * np.eye(k + 1), b)
        if np.max(np.abs(beta_new - beta)) < tol:
            beta = beta_new
            break
        beta = beta_new
    return beta


def _onehot(Ad: np.ndarray, n_levels: list) -> np.ndarray:
    cols = []
    for j, L in enumerate(n_levels):
        oh = np.zeros((Ad.shape[0], L))
        oh[np.arange(Ad.shape[0]), Ad[:, j]] = 1.0
        # drop the last level to avoid collinearity with the intercept
        cols.append(oh[:, :-1])
    return np.hstack(cols) if cols else np.zeros((Ad.shape[0], 0))


def logistic_cat_fit(Ad: np.ndarray, n_levels: list, pip: np.ndarray,
                     lambda_l1: float = 0.0, lambda_l2: float = 0.0):
    X = _onehot(Ad, n_levels)
    return irls_fit(X, pip, lambda_l2)


def logistic_cat_pred(coef: np.ndarray, Ad: np.ndarray,
                      n_levels: list) -> np.ndarray:
    X = _onehot(Ad, n_levels)
    return _sigmoid(np.column_stack([X, np.ones(len(X))]) @ coef)


def logistic_cont_fit(Ac: np.ndarray, pip: np.ndarray,
                      lambda_l1: float = 0.0, lambda_l2: float = 0.0):
    return irls_fit(Ac, pip, lambda_l2)


def logistic_cont_pred(coef: np.ndarray, Ac: np.ndarray) -> np.ndarray:
    return _sigmoid(np.column_stack([Ac, np.ones(len(Ac))]) @ coef)


def logistic_mixed_fit(Ad: np.ndarray, n_levels: list, Ac: np.ndarray,
                       pip: np.ndarray, lambda_l1: float = 0.0,
                       lambda_l2: float = 0.0):
    X = np.hstack([_onehot(Ad, n_levels), Ac])
    return irls_fit(X, pip, lambda_l2)


def logistic_mixed_pred(coef: np.ndarray, Ad: np.ndarray, n_levels: list,
                        Ac: np.ndarray) -> np.ndarray:
    X = np.hstack([_onehot(Ad, n_levels), Ac])
    return _sigmoid(np.column_stack([X, np.ones(len(X))]) @ coef)
