"""Symmetric eigendecomposition with GEMMA's zeroing rule.

GEMMA eigendecomposes the centered n×n relatedness matrix once per run
and zeroes eigenvalues below 1e-10 — including negatives — before
everything downstream (lapack.cpp `EigenDecomp_Zeroed`:260-291).  The
returned trace is the mean of the *zeroed* eigenvalues.

`torch.linalg.eigh` is the library solver: cuSOLVER on the card, LAPACK
on the CPU, as the reference leaves it to `jnp.linalg.eigh`.  Its
eigenvectors may differ from another solver's in sign and inside
degenerate eigenspaces; every statistic downstream is invariant to
both.
"""

from __future__ import annotations

import torch

EIGEN_MINVALUE = 1e-10


def eigh_zeroed(G: torch.Tensor, with_raw: bool = False):
    """Eigendecompose symmetric G; zero eigenvalues < 1e-10.

    Returns (eigenvalues ascending, U, trace_G) with trace_G the mean
    of the zeroed eigenvalues; with_raw=True appends the pre-zeroing
    eigenvalues (the -check validator reads those)."""
    raw, U = torch.linalg.eigh(G)
    eval_ = torch.where(raw < EIGEN_MINVALUE, torch.zeros_like(raw), raw)
    out = (eval_, U, eval_.mean())
    return out + (raw,) if with_raw else out


def zero_eigenvalues(eval_: torch.Tensor):
    """Apply the <1e-10 → 0 rule to externally loaded eigenvalues (the
    -u/-d path, gemma.cpp:2661-2668); the trace is the mean of the
    zeroed values."""
    eval_ = torch.where(eval_ < EIGEN_MINVALUE, torch.zeros_like(eval_),
                        eval_)
    return eval_, eval_.mean()
