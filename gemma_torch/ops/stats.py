"""Survival functions of the F and chi-square distributions
(gsl_cdf_fdist_Q, gsl_cdf_chisq_Q) and the normal CDF
(gsl_cdf_gaussian_P).

torch has no regularised incomplete beta, so `betainc` here is the
Lentz continued fraction (Numerical Recipes `betacf`), written as masked
vectorised PyTorch and evaluated in float64 whatever the input dtype.
`gammaincc` is the regularised upper incomplete gamma Q(a, x) the same
way: the series for x < a + 1 and the Lentz continued fraction, which
gives Q itself (not 1 − P), otherwise.  The kernels run the same
functions as device code (csrc/tails.cuh: K4, K5 and K6); these are
their plain versions.

Domain conventions follow GSL: f_sf(x <= 0) == 1, chisq_sf(x <= 0) == 1
(gamma_Q returns 1 for x <= 0).
"""

from __future__ import annotations

import torch

_BETACF_MAXIT = 1000
_BETACF_EPS = 1e-15
_GAMMA_MAXIT = 1000
_GAMMA_EPS = 1e-15
_FPMIN = 1e-300


def _betacf(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor):
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    fpmin = torch.full_like(x, _FPMIN)

    def fix(v):
        return torch.where(v.abs() < _FPMIN, fpmin, v)

    c = torch.ones_like(x)
    d = 1.0 / fix(1.0 - qab * x / qap)
    h = d.clone()
    live = torch.ones_like(x, dtype=torch.bool)
    for m in range(1, _BETACF_MAXIT + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d1 = 1.0 / fix(1.0 + aa * d)
        c1 = fix(1.0 + aa / c)
        h1 = h * d1 * c1
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d2 = 1.0 / fix(1.0 + aa * d1)
        c2 = fix(1.0 + aa / c1)
        delta = d2 * c2
        h = torch.where(live, h1 * delta, h)
        d = torch.where(live, d2, d)
        c = torch.where(live, c2, c)
        live = live & ~((delta - 1.0).abs() < _BETACF_EPS)
        if not bool(live.any()):
            break
    return h


def betainc(a, b, x: torch.Tensor) -> torch.Tensor:
    """Regularised incomplete beta I_x(a, b), float64."""
    x = x.to(torch.float64)
    a = torch.as_tensor(a, dtype=torch.float64, device=x.device).expand_as(x)
    b = torch.as_tensor(b, dtype=torch.float64, device=x.device).expand_as(x)
    xc = x.clamp(min=1e-300, max=1.0 - 1e-16)
    direct = xc < (a + 1.0) / (a + b + 2.0)
    aa = torch.where(direct, a, b)
    bb = torch.where(direct, b, a)
    xx = torch.where(direct, xc, 1.0 - xc)
    lbt = (torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
           + a * torch.log(xc) + b * torch.log1p(-xc))
    frac = torch.exp(lbt) * _betacf(aa, bb, xx) / aa
    out = torch.where(direct, frac, 1.0 - frac)
    out = torch.where(x <= 0.0, torch.zeros_like(out), out)
    out = torch.where(x >= 1.0, torch.ones_like(out), out)
    return torch.where(torch.isnan(x), x, out)


def f_sf(x: torch.Tensor, d1: float, d2: float) -> torch.Tensor:
    """Q(x) of F(d1, d2) in x's dtype (computed in float64).

    Each lane takes whichever incomplete-beta argument is smaller
    (I_z(a,b) = 1 − I_{1−z}(b,a)): the direct one saturates as z → 1
    (the reference measured betainc(383, 0.5, 1−1.6e-8) = 1.0 in
    float32 where the true value is 0.99721)."""
    xd = x.to(torch.float64)
    xt = d2 / (d2 + d1 * xd)
    wt = d1 * xd / (d2 + d1 * xd)
    q_direct = betainc(d2 / 2.0, d1 / 2.0, xt.clamp(max=1.0))
    q_comp = 1.0 - betainc(d1 / 2.0, d2 / 2.0, wt.clamp(max=1.0))
    q = torch.where(xt <= 0.5, q_direct, q_comp)
    q = torch.where(xd <= 0.0, torch.ones_like(q), q)
    return q.to(x.dtype)


def gammaincc(a, x: torch.Tensor) -> torch.Tensor:
    """Regularised upper incomplete gamma Q(a, x), float64; Q(a, x <= 0)
    = 1, Q(a, inf) = 0, NaN stays NaN.  Each lane stops where its
    sequential loop would (GSL/Numerical Recipes gser and gcf)."""
    x = x.to(torch.float64)
    a = torch.as_tensor(a, dtype=torch.float64, device=x.device).expand_as(x)
    ok = (x > 0.0) & torch.isfinite(x)
    series = ok & (x < a + 1.0)
    frac = ok & ~series
    xs = torch.where(ok, x, torch.ones_like(x))
    lpre = -xs + a * torch.log(xs) - torch.lgamma(a)

    # series for P(a, x), then Q = 1 - P
    ap = a.clone()
    dl = 1.0 / a
    total = dl.clone()
    live = series.clone()
    for _ in range(_GAMMA_MAXIT):
        if not bool(live.any()):
            break
        ap = torch.where(live, ap + 1.0, ap)
        dl = torch.where(live, dl * (xs / ap), dl)
        total = torch.where(live, total + dl, total)
        live = live & ~(dl.abs() < total.abs() * _GAMMA_EPS)
    q_series = 1.0 - total * torch.exp(lpre)

    # Lentz continued fraction for Q(a, x)
    fpmin = torch.full_like(x, _FPMIN)

    def fix(v):
        return torch.where(v.abs() < _FPMIN, fpmin, v)

    b = xs + 1.0 - a
    c = torch.full_like(x, 1.0 / _FPMIN)
    d = 1.0 / b
    h = d.clone()
    live = frac.clone()
    for i in range(1, _GAMMA_MAXIT + 1):
        if not bool(live.any()):
            break
        an = -i * (i - a)
        b = torch.where(live, b + 2.0, b)
        d1 = 1.0 / fix(an * d + b)
        c1 = fix(b + an / c)
        delta = d1 * c1
        h = torch.where(live, h * delta, h)
        d = torch.where(live, d1, d)
        c = torch.where(live, c1, c)
        live = live & ~((delta - 1.0).abs() < _GAMMA_EPS)
    q_frac = torch.exp(lpre) * h

    out = torch.where(series, q_series, q_frac)
    out = torch.where(x <= 0.0, torch.ones_like(out), out)
    out = torch.where(torch.isinf(x) & (x > 0), torch.zeros_like(out), out)
    return torch.where(torch.isnan(x), x, out)


def chisq_sf(x: torch.Tensor, df: float) -> torch.Tensor:
    """Q(x) of chi-square(df) = Q(df/2, x/2), matching gsl_cdf_chisq_Q,
    in x's dtype (computed in float64)."""
    return gammaincc(0.5 * df, 0.5 * x.to(torch.float64)).to(x.dtype)


def normal_cdf(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """P(N(0, sigma²) <= x), matching `gsl_cdf_gaussian_P`, in x's dtype."""
    x = torch.as_tensor(x)
    z = x / (sigma * torch.sqrt(torch.tensor(2.0, dtype=x.dtype)))
    return 0.5 * (1.0 + torch.special.erf(z))
