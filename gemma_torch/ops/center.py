"""Matrix and vector centring and scaling (GEMMA mathfunc.cpp analogues):
torch products and elementwise work on the device, no kernel of their own.

  * center_matrix    — G := P G P with P = I - 11'/n (`CenterMatrix(G)`)
  * center_matrix_w  — project a covariate matrix W out of G
                       (`CenterMatrix(G, W)`)
  * center_vector_w  — residualise y against W (`CenterVector(y, W)`)
  * scale_matrix     — divide by the mean diagonal (`ScaleMatrix`)
"""

from __future__ import annotations

import torch


def center_matrix(G: torch.Tensor) -> torch.Tensor:
    """Double-center a symmetric matrix: G - rowmean - colmean + grandmean."""
    n = G.shape[0]
    Gw = G.sum(dim=1)                             # G @ 1
    d = Gw.sum()                                  # 1' G 1
    return G - (Gw[:, None] + Gw[None, :]) / n + d / (n * n)


def center_matrix_w(G: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Project covariates out of G: (I-Pw) G (I-Pw)' with Pw = W(W'W)^-1 W'."""
    WtWiWt = torch.linalg.solve(W.T @ W, W.T)     # (c, n)
    GW = G @ W                                    # (n, c)
    Gtmp = GW @ WtWiWt                            # G Pw
    G = G - Gtmp - Gtmp.T
    WtGW = W.T @ GW                               # (c, c)
    return G + WtWiWt.T @ (WtGW @ WtWiWt)         # + Pw G Pw


def center_vector_w(y: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Residualise y against W: y - W (W'W)^-1 W'y."""
    return y - W @ torch.linalg.solve(W.T @ W, W.T @ y)


def scale_matrix(G: torch.Tensor) -> torch.Tensor:
    """Divide by the mean of the diagonal (mathfunc `ScaleMatrix`)."""
    return G / torch.diagonal(G).mean()
