// Distribution tails in float64 for the test kernels (K4, K5, K6): the
// F(d1, d2) survival function through the regularised incomplete beta,
// and the chi-square survival function through the regularised upper
// incomplete gamma.  torch has neither as a device function; the plain
// versions are gemma_torch/ops/stats.py (betainc, f_sf, gammaincc,
// chisq_sf), the same loops as masked vectorised torch.
#pragma once

#include "common.cuh"

#define GT_BETACF_MAXIT 1000
#define GT_GAMMA_MAXIT 1000
#define GT_TAIL_EPS 1e-15
#define GT_FPMIN 1e-300

// Lentz continued fraction of the incomplete beta (Numerical Recipes
// betacf).
__device__ inline double gt_betacf(double a, double b, double x) {
  const double qab = a + b, qap = a + 1.0, qam = a - 1.0;
  double c = 1.0, d = 1.0 - qab * x / qap;
  if (fabs(d) < GT_FPMIN) d = GT_FPMIN;
  d = 1.0 / d;
  double h = d;
  for (int m = 1; m <= GT_BETACF_MAXIT; ++m) {
    const double m2 = 2.0 * m;
    double aa = m * (b - m) * x / ((qam + m2) * (a + m2));
    d = 1.0 + aa * d;
    if (fabs(d) < GT_FPMIN) d = GT_FPMIN;
    c = 1.0 + aa / c;
    if (fabs(c) < GT_FPMIN) c = GT_FPMIN;
    d = 1.0 / d;
    h *= d * c;
    aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2));
    d = 1.0 + aa * d;
    if (fabs(d) < GT_FPMIN) d = GT_FPMIN;
    c = 1.0 + aa / c;
    if (fabs(c) < GT_FPMIN) c = GT_FPMIN;
    d = 1.0 / d;
    const double del = d * c;
    h *= del;
    if (fabs(del - 1.0) < GT_TAIL_EPS) break;
  }
  return h;
}

// Regularised incomplete beta I_x(a, b).
__device__ inline double gt_betainc(double a, double b, double x) {
  if (isnan(x)) return x;
  if (x <= 0.0) return 0.0;
  if (x >= 1.0) return 1.0;
  const double lbt = lgamma(a + b) - lgamma(a) - lgamma(b) + a * log(x) +
                     b * log1p(-x);
  const double bt = exp(lbt);
  if (x < (a + 1.0) / (a + b + 2.0)) return bt * gt_betacf(a, b, x) / a;
  return 1.0 - bt * gt_betacf(b, a, 1.0 - x) / b;
}

// Survival function of F(d1, d2), as gsl_cdf_fdist_Q.
__device__ inline double gt_f_sf(double x, double d1, double d2) {
  if (isnan(x)) return x;
  if (x <= 0.0) return 1.0;
  const double xt = d2 / (d2 + d1 * x);
  if (xt <= 0.5) return gt_betainc(0.5 * d2, 0.5 * d1, fmin(xt, 1.0));
  const double wt = d1 * x / (d2 + d1 * x);
  return 1.0 - gt_betainc(0.5 * d1, 0.5 * d2, fmin(wt, 1.0));
}

// Regularised upper incomplete gamma Q(a, x), GSL gamma_Q semantics:
// Q(a, x <= 0) = 1.  For x < a + 1 the series gives P and Q = 1 - P
// (Q >= Q(a, a + 1), not small); otherwise the Lentz continued fraction
// gives Q itself, so small p-values keep their relative accuracy.
__device__ inline double gt_gamma_q(double a, double x) {
  if (isnan(x)) return x;
  if (x <= 0.0) return 1.0;
  if (isinf(x)) return 0.0;
  const double lpre = -x + a * log(x) - lgamma(a);
  if (x < a + 1.0) {
    double ap = a, del = 1.0 / a, sum = del;
    for (int k = 0; k < GT_GAMMA_MAXIT; ++k) {
      ap += 1.0;
      del *= x / ap;
      sum += del;
      if (fabs(del) < fabs(sum) * GT_TAIL_EPS) break;
    }
    return 1.0 - sum * exp(lpre);
  }
  double b = x + 1.0 - a, c = 1.0 / GT_FPMIN, d = 1.0 / b, h = d;
  for (int i = 1; i <= GT_GAMMA_MAXIT; ++i) {
    const double an = -i * (i - a);
    b += 2.0;
    d = an * d + b;
    if (fabs(d) < GT_FPMIN) d = GT_FPMIN;
    c = b + an / c;
    if (fabs(c) < GT_FPMIN) c = GT_FPMIN;
    d = 1.0 / d;
    const double del = d * c;
    h *= del;
    if (fabs(del - 1.0) < GT_TAIL_EPS) break;
  }
  return exp(lpre) * h;
}

// Survival function of chi-square(df), as gsl_cdf_chisq_Q.
__device__ inline double gt_chisq_sf(double x, double df) {
  return gt_gamma_q(0.5 * df, 0.5 * x);
}
