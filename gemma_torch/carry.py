"""Carry a run's intermediates across into the port's tensors.

This system has no weights; what one run hands the next stage is the
eigendecomposition (eval, U), the rotated covariates and phenotype
(UtW, Uty), the null-model fit and the per-block batch data.
`state_from_numpy` turns those — as numpy arrays, from whatever
produced them — into device tensors in the port's layout, so two
implementations can be fed identical eigenfactors and null fits;
`mvlmm_state_from_numpy` does the same for the multivariate LMM's
rotated operands and null (Vg, Ve, B), and `bslmm_inputs_from_numpy` for
the BSLMM chain's operands, settings and starting values.
cuSOLVER's and LAPACK's eigenvectors differ in sign and inside
degenerate eigenspaces; comparing the association downstream of shared
factors takes that out of the comparison.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gemma_torch.models import bslmm
from gemma_torch.models.lmm.engine import NullFit
from gemma_torch.models.lmm.likelihood import LmmBatchData, build_batch_data


class CarriedState(NamedTuple):
    eval: torch.Tensor            # (n,)
    U: torch.Tensor | None        # (n, n)
    UtW: torch.Tensor             # (n, c)
    Uty: torch.Tensor             # (n,)
    null: NullFit | None
    data: LmmBatchData | None     # batch data of the Utx block, if given


def state_from_numpy(eval_, UtW, Uty, *, n_cvt: int, U=None, null=None,
                     Utx=None, device: str | torch.device = "cpu",
                     dtype: torch.dtype = torch.float64) -> CarriedState:
    """Numpy intermediates → the port's tensors on `device` in `dtype`.

    `null` is any object with the NullFit field names (the reference
    package's NullFit, or a dict); `Utx` (S, n) builds the block's
    LmmBatchData with `build_batch_data`."""

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(a)),
                               dtype=dtype, device=device)

    ev, utw, uty = t(eval_), t(UtW), t(Uty)
    nf = None
    if null is not None:
        get = null.get if isinstance(null, dict) else (
            lambda k: getattr(null, k))
        nf = NullFit(**{f: t(get(f)) for f in NullFit._fields})
    data = None
    if Utx is not None:
        data = build_batch_data(ev, utw, uty, t(Utx), n_cvt)
    return CarriedState(eval=ev, U=None if U is None else t(U), UtW=utw,
                        Uty=uty, null=nf, data=data)


class MvlmmState(NamedTuple):
    eval: torch.Tensor            # (n,)
    X0: torch.Tensor              # (c0, n) shared rotated covariates
    Y: torch.Tensor               # (d, n) rotated phenotypes
    R: torch.Tensor | None        # (S, r, n) the lanes' own rotated rows
    Vg: torch.Tensor              # (1 or S, d, d) float64
    Ve: torch.Tensor
    B: torch.Tensor | None        # (1 or S, d, c) float64


def mvlmm_state_from_numpy(eval_, X0, Y, *, Vg, Ve, B=None, R=None,
                           device: str | torch.device = "cpu",
                           dtype: torch.dtype = torch.float64) -> MvlmmState:
    """An mvLMM run's intermediates — the rotated operands in the
    reference's layout (X0 (c0, n), Y (d, n), per-lane rows (S, r, n))
    and a null fit's (Vg, Ve, B), shared (d, d) or per lane — as the
    tensors mvlmm_core's kernels take: operands in `dtype`, the starting
    values float64 with a leading lane axis."""

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(a)),
                               dtype=dt, device=device)

    def lanes(a):
        a = t(a, torch.float64)
        return a[None] if a.ndim == 2 else a

    return MvlmmState(eval=t(eval_), X0=t(X0), Y=t(Y),
                      R=None if R is None else t(R), Vg=lanes(Vg),
                      Ve=lanes(Ve), B=None if B is None else lanes(B))


class BslmmInputs(NamedTuple):
    ops: bslmm.ChainOperands
    settings: bslmm.BslmmSettings
    h0: float
    rho0: float
    logp0: float
    n_gamma0: int


def bslmm_inputs_from_numpy(UtX_sorted, Uty, eval_, trace_G, settings, *,
                            h0, rho0, logp0, n_gamma0, U=None,
                            y_labels=None, device: str | torch.device = "cpu",
                            dtype: torch.dtype = torch.float64
                            ) -> BslmmInputs:
    """A BSLMM run's chain inputs in the reference's layout — UtX_sorted
    (n, p) with columns in rank order, Uty and eval (n,), trace_G, a
    settings object with BslmmSettings' fields (the reference's, or a
    dict), the initial (h, rho, log pi, |gamma|) and, for the probit
    model, U (n, n) and the centred labels — as the port's ChainOperands
    (UtXT (p, n) rows in rank order) and BslmmSettings."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(a)),
                               dtype=dtype, device=device)

    get = settings.get if isinstance(settings, dict) else (
        lambda k: getattr(settings, k))
    fields = [f.name for f in dataclasses.fields(bslmm.BslmmSettings)]
    st = bslmm.BslmmSettings(**{f: get(f) for f in fields})
    ops = bslmm.chain_operands(
        t(np.asarray(UtX_sorted).T), t(Uty), t(eval_), float(trace_G),
        st.geo_mean, U=None if U is None else t(U),
        y_labels=None if y_labels is None else t(y_labels))
    return BslmmInputs(ops, st, float(h0), float(rho0), float(logp0),
                       int(n_gamma0))
