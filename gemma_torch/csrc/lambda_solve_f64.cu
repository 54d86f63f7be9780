// K7 — per-SNP λ search in float64 with GEMMA's GSL semantics (the
// parity mode).
//
// Replaces the float64 branch of the reference package's
//   gemma_tpu/models/lmm/optimize.py:247 calc_lambda
// whole: the per-point dev1 scan of the n_region + 1 point coarse grid
// (:300-302), and per sign-change interval in order GSL Brent-Dekker to
// 1e-1 relative width (_brent_batched :66-183), Newton to 1e-5
// (_newton_batched :186-235), and the Pab-form logf
// (gemma_tpu/models/lmm/likelihood.py:237) at each candidate and at
// l_min/l_max.  GEMMA's quirks are kept: the second-to-last Newton
// iterate is the root (lmm.cpp:2096); a zero derivative, a non-finite
// value, a step out of (l_min, l_max) or the 100-iteration cap poisons
// the lane with NaN (lmm.cpp:2078-2094); a Brent that hits its cap ends
// the interval walk.
//
// One thread block per SNP lane; every thread runs the scalar search with
// the same values, which the block reductions of lmm_lane.cuh (dev1,
// dev12, shared with K3) hand to all of them.  The Pab logf is one block
// reduction of the order-1 base row plus Σ log|λ d + 1| and the CalcPab
// recurrence; its λ-independent REML piece, the identity-weighted
// recurrence diagonals, comes in as iab_logdiag (build_batch_data).
// Each lane's UtWy, wy and Utx rows sit at its lane stride (0 where the
// lanes share them), as in K3.
//
// Bound: operations — float64 evaluations of O(n·(c+1)²) each, at least
// the n_region + 1 scan points, one per Brent step, one per Newton step
// and the logf at each candidate and both ends, per lane; the lane's Utx
// row is re-read from L1/L2 by each.
// Above 32 covariates its working set lives in a per-lane slice of global
// scratch (the GT_DYN form, lmm_lane.cuh), lanes [s0, s0 + count) a
// launch.
#include "lmm_lane.cuh"

typedef SolveCtx<double, double> Ctx64;
template <int MC>
using Smem64 = SolveSmem<double, MC>;

template <int MC>
__device__ __forceinline__ double gt_dev1(const Ctx64& c, Smem64<MC>& sm,
                                          double lam) {
  double d1, d2;
  gt_dev12(c, sm, lam, &d1, &d2, 2);
  return d1;
}

// Pab-form (RE)ML log-likelihood (LogRL_f / LogL_f, lmm.cpp:566-642).
template <int MC>
__device__ double gt_logf_pab(const Ctx64& c, Smem64<MC>& sm, double lam,
                              const double* iab) {
  const int M = c.M, C1 = c.n_cvt + 1;
  auto f = [&](int q, int i) -> double {
    const double v = lam * c.eval[i] + 1.0;
    const double hi = 1.0 / v;
    if (q < M) return hi * c.wy[(long)i * M + q];
    q -= M;
    if (q < C1) return hi * c.x[i] * c.UtWy[(long)i * C1 + q];
    if (q == C1) return hi * c.x[i] * c.x[i];
    return log(fabs(v));
  };
  const int Q = M + C1 + 2;
  gt_block_sums(f, Q, c.n, sm.q, sm.red);
  const int ni = c.ni;
  for (int k = threadIdx.x; k < ni; k += GT_THREADS) {
    const int kind = c.t.kind[k], col = c.t.col[k];
    sm.rows[0][k] = kind == 0   ? sm.q[col]
                    : kind == 1 ? sm.q[M + C1]
                                : sm.q[M + col];
  }
  __syncthreads();
  const double logdet_h = sm.q[Q - 1];
  const int nc_total = c.calc_null ? c.n_cvt : c.n_cvt + 1;
  double logdet_hiw = 0.0;
  int cur = 0;
  for (int p = 1; p <= nc_total; ++p) {
    logdet_hiw = logdet_hiw + log(sm.rows[cur][c.t.diag[p - 1]]) - iab[p - 1];
    gt_pab_step<double>(c.t, ni, p, 1, sm.rows[cur], nullptr, nullptr,
                        sm.rows[1 - cur], nullptr, nullptr);
    __syncthreads();
    cur = 1 - cur;
  }
  double p_yy = sm.rows[cur][ni - 1];
  __syncthreads();  // rows and q are reused by the next evaluation
  if (p_yy >= 0.0 && p_yy < 1e-8) p_yy = 1e-8;
  if (c.reml) {
    const double df = (double)(c.calc_null ? c.n - c.n_cvt
                                           : c.n - c.n_cvt - 1);
    return c.logf_const - 0.5 * logdet_h - 0.5 * logdet_hiw -
           0.5 * df * log(p_yy);
  }
  return c.logf_const - 0.5 * logdet_h - 0.5 * (double)c.n * log(p_yy);
}

__device__ __forceinline__ double gt_nz(double v) { return v != 0.0 ? v : 1.0; }

// GSL Brent-Dekker on [lo, hi] (roots/brent.c, as _brent_batched runs
// it): stops once gsl_root_test_interval(epsabs = 0, epsrel) passes on
// (b, c).  Returns b; *converged is false when the cap was hit.
template <int MC>
__device__ double gt_brent(const Ctx64& c, Smem64<MC>& sm, double lo, double hi,
                           double flo, double fhi, double epsrel,
                           int max_iter, bool* converged) {
  const double eps = 2.220446049250313e-16;  // DBL_EPSILON
  double a = lo, b = hi, cc = hi, fa = flo, fb = fhi, fc = fhi;
  double d = hi - lo, e = hi - lo;
  for (int it = 0; it < max_iter; ++it) {
    const bool same_side = (fb < 0.0 && fc < 0.0) || (fb > 0.0 && fc > 0.0);
    bool ac_equal = same_side;
    if (same_side) {
      cc = a;
      fc = fa;
      d = b - a;
      e = b - a;
    }
    if (fabs(fc) < fabs(fb)) {
      ac_equal = true;
      a = b;
      b = cc;
      cc = a;
      fa = fb;
      fb = fc;
      fc = fa;
    }
    const double tol = 0.5 * eps * fabs(b);
    const double m = 0.5 * (cc - b);
    if (fb == 0.0 || fabs(m) <= tol) {
      *converged = true;
      return b;
    }
    const bool bisect = fabs(e) < tol || fabs(fa) <= fabs(fb);
    const double s_r = fb / gt_nz(fa);
    const double q_3 = fa / gt_nz(fc);
    const double r_3 = fb / gt_nz(fc);
    double p = ac_equal ? 2.0 * m * s_r
                        : s_r * (2.0 * m * q_3 * (q_3 - r_3) -
                                 (b - a) * (r_3 - 1.0));
    double q = ac_equal ? 1.0 - s_r
                        : (q_3 - 1.0) * (r_3 - 1.0) * (s_r - 1.0);
    if (p > 0.0)
      q = -q;
    else
      p = -p;
    // 2p < min(3mq - |tol q|, |e q|), false where either is NaN
    const bool interp_ok =
        2.0 * p < 3.0 * m * q - fabs(tol * q) && 2.0 * p < fabs(e * q);
    double d_new = interp_ok ? p / gt_nz(q) : m;
    double e_new = interp_ok ? d : m;
    if (bisect) {
      d_new = m;
      e_new = m;
    }
    const double step = fabs(d_new) > tol ? d_new : (m > 0.0 ? tol : -tol);
    const double b_n = b + step;
    const double fb_n = gt_dev1(c, sm, b_n);
    a = b;
    fa = fb;
    b = b_n;
    fb = fb_n;
    d = d_new;
    e = e_new;
    const double xlo = fmin(b, cc), xhi = fmax(b, cc);
    const bool same_sign = (xlo > 0.0 && xhi > 0.0) || (xlo < 0.0 && xhi < 0.0);
    const double min_abs = same_sign ? fmin(fabs(xlo), fabs(xhi)) : 0.0;
    if (fabs(xhi - xlo) < epsrel * min_abs) {
      *converged = true;
      return b;
    }
  }
  *converged = false;
  return b;
}

template <int MC>
__global__ void __launch_bounds__(GT_THREADS)
lambda_solve_f64_kernel(const double* __restrict__ grid, int n_region,
                        const double* __restrict__ eval,
                        const double* __restrict__ UtWy,
                        const double* __restrict__ wy,
                        const double* __restrict__ Utx,
                        const double* __restrict__ iab_logdiag,
                        const int* __restrict__ tab, int n_cvt, int n, int M,
                        int calc_null, int reml, int ustride, int wstride,
                        int xstride, double l_min, double l_max,
                        double brent_epsrel, double newton_epsrel,
                        int brent_max_iter, int newton_max_iter,
                        double logf_const, double* lam_out,
                        double* logf_out, int s0, unsigned char* scratch) {
  gt_with_solve<double, MC>(scratch, gt_solve_lane_bytes(n_cvt, 8), n_cvt,
                            [&](auto& sm) {
  const int s = s0 + blockIdx.x;
  Ctx64 c;
  c.eval = eval;
  c.UtWy = UtWy + (long)s * ustride;
  c.wy = wy + (long)s * wstride;
  c.x = Utx + (long)s * xstride;
  c.t = gt_tables(tab, n_cvt);
  c.n_cvt = n_cvt;
  c.n = n;
  c.M = M;
  c.ni = gt_n_index(n_cvt);
  c.calc_null = calc_null;
  c.reml = reml;
  c.logf_const = logf_const;
  const double* iab = iab_logdiag + (long)s * (n_cvt + 1);

  double best_logf = -INFINITY, best_lam = NAN;
  bool has_cand = false, failed = false;
  double d_lo = gt_dev1(c, sm, grid[0]);
  for (int iv = 0; iv < n_region && !failed; ++iv) {
    const double d_hi = gt_dev1(c, sm, grid[iv + 1]);
    const double flo = d_lo;
    d_lo = d_hi;
    if (!(flo * d_hi <= 0.0)) continue;
    bool brent_conv;
    const double root_b = gt_brent(c, sm, grid[iv], grid[iv + 1], flo, d_hi,
                                   brent_epsrel, brent_max_iter, &brent_conv);
    if (!brent_conv) break;  // the cap ends the walk (no Newton here)

    // Newton on (dev1, dev2), GEMMA exit semantics
    double x_prev = root_b, x = root_b, fv, dfv;
    gt_dev12(c, sm, root_b, &fv, &dfv, 3);
    bool conv = false, fail = false;
    for (int it = 0; it < newton_max_iter && !conv && !fail; ++it) {
      const bool zero_div = dfv == 0.0;
      const double step_x = x - fv / (zero_div ? 1.0 : dfv);
      double f_new, df_new;
      gt_dev12(c, sm, step_x, &f_new, &df_new, 3);
      const bool bad = !isfinite(f_new) || !isfinite(df_new);
      const bool cv = (fabs(step_x - x) < newton_epsrel * fabs(step_x)) ||
                      (step_x == x);
      const bool oob = !((step_x > l_min) && (step_x < l_max));
      const bool fail_now = zero_div || bad || (!cv && oob);
      const bool conv_now = !zero_div && !bad && cv;
      if (!zero_div) {
        x_prev = x;
        x = step_x;
      }
      if (!fail_now && !conv_now) {
        fv = f_new;
        dfv = df_new;
      }
      conv = conv || conv_now;
      fail = fail || fail_now;
    }
    if (!conv) {  // failed, or still live at the cap: NaN
      failed = true;
      break;
    }
    const double l_cand = gt_clip(x_prev, l_min, l_max);
    const double logf_cand = gt_logf_pab(c, sm, l_cand, iab);
    if (!has_cand || logf_cand > best_logf) {
      best_logf = logf_cand;
      best_lam = l_cand;
    }
    has_cand = true;
  }
  if (!failed) {
    const double logf_lmin = gt_logf_pab(c, sm, l_min, iab);
    const double logf_lmax = gt_logf_pab(c, sm, l_max, iab);
    if (logf_lmin > best_logf) {
      best_logf = logf_lmin;
      best_lam = l_min;
    }
    if (logf_lmax > best_logf) {
      best_logf = logf_lmax;
      best_lam = l_max;
    }
  }
  if (threadIdx.x == 0) {
    lam_out[s] = failed ? NAN : best_lam;
    logf_out[s] = failed ? NAN : best_logf;
  }
  });
}

extern "C" int lambda_solve_f64_launch(
    const void* grid, int n_region, const void* eval, const void* UtWy,
    const void* wy, const void* Utx, const void* iab_logdiag,
    const void* tab, int n_cvt, int S, int n, int M, int calc_null,
    int reml, int ustride, int wstride, int xstride, double l_min,
    double l_max, double brent_epsrel,
    double newton_epsrel, int brent_max_iter, int newton_max_iter,
    double logf_const, void* lam_out, void* logf_out, int s0, int count,
    void* scratch, void* stream) {
  // above GT_MAX_CVT covariates the GT_WIDE_CVT instantiation runs, above
  // GT_WIDE_CVT the GT_DYN form on lanes [s0, s0 + count) with `scratch`
  const int form = gt_form(n_cvt);
  auto kern = form == GT_MAX_CVT    ? lambda_solve_f64_kernel<GT_MAX_CVT>
              : form == GT_WIDE_CVT ? lambda_solve_f64_kernel<GT_WIDE_CVT>
                                    : lambda_solve_f64_kernel<GT_DYN>;
  const int smem = form == GT_MAX_CVT
                       ? gt_smem_bytes<Smem64<GT_MAX_CVT>>(kern)
                   : form == GT_WIDE_CVT
                       ? gt_smem_bytes<Smem64<GT_WIDE_CVT>>(kern)
                       : 0;
  if (count > 0)
    kern<<<count, GT_THREADS, smem, (cudaStream_t)stream>>>(
        (const double*)grid, n_region, (const double*)eval,
        (const double*)UtWy, (const double*)wy, (const double*)Utx,
        (const double*)iab_logdiag, (const int*)tab, n_cvt, n, M, calc_null,
        reml, ustride, wstride, xstride, l_min, l_max, brent_epsrel, newton_epsrel, brent_max_iter,
        newton_max_iter, logf_const, (double*)lam_out, (double*)logf_out, s0,
        (unsigned char*)scratch);
  return (int)cudaGetLastError();
}

// bytes of a lane's scratch (0 where a fixed instantiation takes n_cvt)
extern "C" long lambda_solve_f64_lane_bytes(int n_cvt) {
  return gt_form(n_cvt) == GT_DYN ? gt_solve_lane_bytes(n_cvt, 8) : 0;
}

GT_ERROR_FN(lambda_solve_f64)
