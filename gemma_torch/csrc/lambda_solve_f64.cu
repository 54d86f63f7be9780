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
// the interval walk.  The Pab logf's λ-independent REML piece, the
// identity-weighted recurrence diagonals, comes in as iab_logdiag
// (build_batch_data).
//
// Bound: operations — float64 evaluations of O(n·(c+1)²) each, at least
// the n_region + 1 scan points, one per Brent step, one per Newton step
// and the logf at each candidate and both ends, per lane.  The sums over
// n were 90-99% of a lane's clocks on an H100 before this design
// (scripts/k3_k7_phase_profile.py), so a block steps L lanes together
// through lane_search.cuh's rounds: four a block where they share their
// operands (each staged UtWy row serving four), one where they do not
// (GxE, gene mode).  Each lane's search runs on its team of the block's
// threads and keeps its own exits.  Above 32 covariates the working sets
// live in a per-lane slice of global scratch (the GT_DYN form), lanes
// [s0, s0 + count) a launch.
#include "lane_search.cuh"

typedef LsCtx<double, double> Ctx64;

template <int L, bool ROWS>
__device__ __forceinline__ double k7_dev1(const Ctx64& c, int l, double lam) {
  double d1;
  ls_eval<double, double, L, ROWS>(c, l, LS_DEV1, lam, 0.0, &d1, nullptr);
  return d1;
}

__device__ __forceinline__ double gt_nz(double v) { return v != 0.0 ? v : 1.0; }

// GSL Brent-Dekker on [lo, hi] (roots/brent.c, as _brent_batched runs
// it): stops once gsl_root_test_interval(epsabs = 0, epsrel) passes on
// (b, c).  Returns b; *converged is false when the cap was hit.
template <int L, bool ROWS>
__device__ double gt_brent(const Ctx64& c, int l, double lo, double hi,
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
    const double fb_n = k7_dev1<L, ROWS>(c, l, b_n);
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

// ROWS: the row-split sums (c <= 1), else the column sums; two blocks an
// SM either way.
template <int L, bool ROWS>
__global__ void __launch_bounds__(LS_THREADS, 2)
lambda_solve_f64_kernel(const double* __restrict__ grid, int n_region,
                        const double* __restrict__ eval,
                        const double* __restrict__ UtWy,
                        const double* __restrict__ Utx,
                        const double* __restrict__ iab_logdiag,
                        const int* __restrict__ tab, int n_cvt, int n,
                        int calc_null, int reml, int ustride, int xstride,
                        int TR, int resident, double l_min, double l_max,
                        double brent_epsrel, double newton_epsrel,
                        int brent_max_iter, int newton_max_iter,
                        double logf_const, double* lam_out,
                        double* logf_out, int* next, int s0, int count,
                        unsigned char* scratch) {
  Ctx64 c = ls_ctx<double, double>(eval, UtWy, Utx, ustride, xstride, tab,
                                    n_cvt, n, calc_null, reml, logf_const, L,
                                    TR, resident, 0, s0, count, scratch);
  c.iab = iab_logdiag;
  ls_begin(c);
  const int l = threadIdx.x / (LS_THREADS / L);
  GT_PROF_START();
  int s, taken = 0;
  while (l < c.nl && (s = ls_next<double, double, L>(c, l, next, s0, count,
                                                     taken)) >= 0) {
    if (threadIdx.x % (LS_THREADS / L) == 0) GT_PROF_ADD(GT_PC_LANES, 1);
    double best_logf = -INFINITY, best_lam = NAN;
    bool has_cand = false, failed = false;
    double d_lo = k7_dev1<L, ROWS>(c, l, grid[0]);
    for (int iv = 0; iv < n_region && !failed; ++iv) {
      const double d_hi = k7_dev1<L, ROWS>(c, l, grid[iv + 1]);
      const double flo = d_lo;
      d_lo = d_hi;
      if (!(flo * d_hi <= 0.0)) continue;
      bool brent_conv;
      const double root_b =
          gt_brent<L, ROWS>(c, l, grid[iv], grid[iv + 1], flo, d_hi, brent_epsrel,
                      brent_max_iter, &brent_conv);
      if (!brent_conv) break;  // the cap ends the walk (no Newton here)

      // Newton on (dev1, dev2), GEMMA exit semantics
      double x_prev = root_b, x = root_b, fv, dfv;
      ls_eval<double, double, L, ROWS>(c, l, LS_DEV12, root_b, 0.0, &fv, &dfv);
      bool conv = false, fail = false;
      for (int it = 0; it < newton_max_iter && !conv && !fail; ++it) {
        const bool zero_div = dfv == 0.0;
        const double step_x = x - fv / (zero_div ? 1.0 : dfv);
        double f_new, df_new;
        ls_eval<double, double, L, ROWS>(c, l, LS_DEV12, step_x, 0.0, &f_new,
                                   &df_new);
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
      double logf_cand;
      ls_eval<double, double, L, ROWS>(c, l, LS_LOGF, l_cand, 0.0, &logf_cand,
                                 nullptr);
      if (!has_cand || logf_cand > best_logf) {
        best_logf = logf_cand;
        best_lam = l_cand;
      }
      has_cand = true;
    }
    if (!failed) {
      double logf_lmin, logf_lmax;
      ls_eval<double, double, L, ROWS>(c, l, LS_LOGF, l_min, 0.0, &logf_lmin,
                                 nullptr);
      ls_eval<double, double, L, ROWS>(c, l, LS_LOGF, l_max, 0.0, &logf_lmax,
                                 nullptr);
      if (logf_lmin > best_logf) {
        best_logf = logf_lmin;
        best_lam = l_min;
      }
      if (logf_lmax > best_logf) {
        best_logf = logf_lmax;
        best_lam = l_max;
      }
    }
    if (threadIdx.x % (LS_THREADS / L) == 0) {
      lam_out[s] = failed ? NAN : best_lam;
      logf_out[s] = failed ? NAN : best_logf;
    }
  }
  ls_idle<double, double, L, ROWS>(c, l);
  GT_PROF(GT_PH_CONTROL);
}

// The launch's layout: L lanes a block (4 where they share their
// operands, else 1), working sets in shared memory up to GT_WIDE_CVT
// covariates, else in scratch.
static LsLayout k7_layout(int n_cvt, int n, int per_lane) {
  return ls_fit(n_cvt, n, per_lane ? 1 : 4, 8, 8, 0,
                gt_form(n_cvt) != GT_DYN);
}

template <int L, bool ROWS>
static void k7_run(const void* grid, int n_region, const void* eval,
                   const void* UtWy, const void* Utx, const void* iab_logdiag,
                   const void* tab, int n_cvt, int n, int calc_null, int reml,
                   int ustride, int xstride, const LsLayout& y, double l_min,
                   double l_max, double brent_epsrel, double newton_epsrel,
                   int brent_max_iter, int newton_max_iter,
                   double logf_const, void* lam_out, void* logf_out,
                   void* next, int s0, int count, void* scratch,
                   cudaStream_t stream) {
  auto kern = lambda_solve_f64_kernel<L, ROWS>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)y.bytes);
  kern<<<(count + L - 1) / L, LS_THREADS, y.bytes, stream>>>(
      (const double*)grid, n_region, (const double*)eval,
      (const double*)UtWy, (const double*)Utx, (const double*)iab_logdiag,
      (const int*)tab, n_cvt, n, calc_null, reml, ustride, xstride, y.TR,
      y.resident, l_min, l_max, brent_epsrel, newton_epsrel, brent_max_iter,
      newton_max_iter, logf_const, (double*)lam_out, (double*)logf_out,
      (int*)next, s0, count, (unsigned char*)scratch);
}

// ustride != 0 (per-lane UtWy) takes one lane a block; above GT_WIDE_CVT
// covariates lanes [s0, s0 + count) run with `scratch`
// (lambda_solve_f64_lane_bytes a lane).
extern "C" int lambda_solve_f64_launch(
    const void* grid, int n_region, const void* eval, const void* UtWy,
    const void* Utx, const void* iab_logdiag, const void* tab, int n_cvt,
    int S, int n, int calc_null, int reml, int ustride, int xstride,
    double l_min, double l_max, double brent_epsrel, double newton_epsrel,
    int brent_max_iter, int newton_max_iter, double logf_const,
    void* lam_out, void* logf_out, void* next, int s0, int count,
    void* scratch, void* stream) {
  const int per_lane = ustride != 0;
  const LsLayout y = k7_layout(n_cvt, n, per_lane);
  if (count > 0)
    (per_lane ? (y.rows ? k7_run<1, true> : k7_run<1, false>)
              : (y.rows ? k7_run<4, true> : k7_run<4, false>))(
        grid, n_region, eval, UtWy, Utx, iab_logdiag, tab, n_cvt, n,
        calc_null, reml, ustride, xstride, y, l_min, l_max, brent_epsrel,
        newton_epsrel, brent_max_iter, newton_max_iter, logf_const, lam_out,
        logf_out, next, s0, count,
        gt_form(n_cvt) == GT_DYN ? scratch : nullptr, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// bytes of a lane's scratch (0 where the working sets fit shared memory)
extern "C" long lambda_solve_f64_lane_bytes(int n_cvt) {
  return gt_form(n_cvt) == GT_DYN ? k7_layout(n_cvt, 1, 0).ws_bytes : 0;
}

// the shared-memory bytes of a block at n individuals
extern "C" long lambda_solve_f64_smem_bytes(int n_cvt, int n, int per_lane) {
  return k7_layout(n_cvt, n, per_lane).bytes;
}

GT_ERROR_FN(lambda_solve_f64)
