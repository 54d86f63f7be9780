// K3 — per-SNP λ solve: bracket choice, Newton polish, likelihood
// comparison, fused into one kernel.
//
// Replaces the float32 branch of the reference package's
//   gemma_tpu/models/lmm/optimize.py:247 calc_lambda
// after its grid scan: the bracket loop (:307-418), _newton_batched
// (:186-235) over likelihood.dev12 (likelihood.py:441-485) and
// likelihood.logf_stable (likelihood.py:269-341) at each candidate and
// at l_min/l_max (:420-434).  The lane's evaluations are lmm_lane.cuh's,
// which K6 and K7 share.  On the TPU this was a chain of XLA while
// loops in which every iteration re-read the whole (S, n) block for all
// lanes until the slowest lane finished; the fused Pallas version never
// compiled there.
//
// One thread block per SNP lane.  The block reads its column of the fine
// grid's dev1 (from K2), walks its sign-change intervals in order, takes
// the leftmost sign-changing fine sub-interval of each (the argmax-of-
// first-True of bracket_at, optimize.py:326-349) and runs Newton from
// its geometric midpoint with GEMMA's exit semantics: keep the second-to-
// last iterate, fail on a zero derivative, a non-finite value or a step
// out of (l_min, l_max) that has not converged, stop at 100 iterations,
// float32 tolerance 5e-4 and the fall-back to the bracket midpoint when
// Newton fails.  Each lane's UtWy, wy and Utx rows sit at its lane
// stride (0 where the lanes share them): per-lane covariates for GxE,
// a per-lane response for gene mode.
//
// Bound: the data moved is the lane's Utx row plus eval/UtWy/wy (shared
// by all lanes, L2-resident); per evaluation the work is O(n·(c+1)²)
// flops.  This simple version re-reads Utx from global memory (L1/L2) on
// every evaluation; keeping the row in shared memory across iterations
// is later work.  Lanes finish independently: no lane waits for the
// slowest one, unlike the lock-step while loops it replaces.
// Above 32 covariates its working set lives in a per-lane slice of global
// scratch (the GT_DYN form, lmm_lane.cuh), lanes [s0, s0 + count) a
// launch.
#include "lmm_lane.cuh"

// T is the working type: float, the arithmetic K3 always ran, for blocks
// whose lanes share their operands; double (float32 operands, float64
// sums, Newton to GSL's 1e-5) for per-lane blocks.  There each lane has
// its own response or covariates and its own null, the likelihood of a
// gene or a GxE lane is often flat at small λ, and float32 cannot tell
// its candidates apart: float32 sums left gene-mode p-values up to 1e-2
// from float64 at n = 1,940 (scripts/lane_f32_gap.py, PERF.md).
template <typename T, int MC>
__global__ void __launch_bounds__(GT_THREADS)
lambda_solve_kernel(const float* __restrict__ d1f, const T* __restrict__ fine,
                    int n_region, int refine, const float* __restrict__ eval,
                    const float* __restrict__ UtWy,
                    const float* __restrict__ wy,
                    const float* __restrict__ Utx,
                    const int* __restrict__ tab, int n_cvt, int S, int n,
                    int M, int calc_null, int reml, int ustride,
                    int wstride, int xstride, T l_min, T l_max, T epsrel,
                    int max_iter, T logf_const, float* lam_out,
                    float* logf_out, int s0, unsigned char* scratch) {
  gt_with_solve<T, MC>(scratch, gt_solve_lane_bytes(n_cvt, sizeof(T)), n_cvt,
                       [&](auto& sm) {
  const int s = s0 + blockIdx.x;
  SolveCtx<float, T> c;
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

  const int CZ = calc_null ? n_cvt : n_cvt + 1;
  gt_gram_pairs(sm, CZ);
  const T logdet0 = reml ? gt_logdet0(c, sm, CZ) : T(0);

  const float* col = d1f + s;  // column s of (G_fine, S)
  T best_logf = -INFINITY, best_lam = NAN;
  bool has_cand = false;
  for (int iv = 0; iv < n_region; ++iv) {
    const T da = col[(long)iv * refine * S];
    const T db = col[(long)(iv + 1) * refine * S];
    if (!(da * db <= T(0))) continue;
    int jf = 0;  // argmax of an all-false window is 0
    for (int f = iv * refine; f < (iv + 1) * refine; ++f)
      if ((T)col[(long)f * S] * (T)col[(long)(f + 1) * S] <= T(0)) {
        jf = f;
        break;
      }
    const T root_b = gt_sqrt(fine[jf] * fine[jf + 1]);

    // Newton on (dev1, dev2), GEMMA exit semantics
    T x_prev = root_b, x = root_b, fv, dfv;
    gt_dev12(c, sm, root_b, &fv, &dfv, 3);
    bool conv = false, failed = false;
    for (int it = 0; it < max_iter && !conv && !failed; ++it) {
      const bool zero_div = dfv == T(0);
      const T step_x = x - fv / (zero_div ? T(1) : dfv);
      T f_new, df_new;
      gt_dev12(c, sm, step_x, &f_new, &df_new, 3);
      const bool bad = !isfinite(f_new) || !isfinite(df_new);
      const bool cv =
          (gt_abs(step_x - x) < epsrel * gt_abs(step_x)) || (step_x == x);
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
      failed = failed || fail_now;
    }
    const T root_n = conv ? x_prev : root_b;
    const T l_cand = gt_clip(root_n, l_min, l_max);
    const T logf_cand = gt_logf_stable(c, sm, l_cand, logdet0);
    if (!has_cand || logf_cand > best_logf) {
      best_logf = logf_cand;
      best_lam = l_cand;
    }
    has_cand = true;
  }
  const T logf_lmin = gt_logf_stable(c, sm, l_min, logdet0);
  const T logf_lmax = gt_logf_stable(c, sm, l_max, logdet0);
  if (logf_lmin > best_logf) {
    best_logf = logf_lmin;
    best_lam = l_min;
  }
  if (logf_lmax > best_logf) {
    best_logf = logf_lmax;
    best_lam = l_max;
  }
  if (threadIdx.x == 0) {
    lam_out[s] = (float)best_lam;
    logf_out[s] = (float)best_logf;
  }
  });
}

template <int MC>
static void lambda_solve_run(const void* d1f, const void* fine, int n_region,
                             int refine, const void* eval, const void* UtWy,
                             const void* wy, const void* Utx, const void* tab,
                             int n_cvt, int S, int n, int M, int calc_null,
                             int reml, int ustride, int wstride, int xstride,
                             int wide, double l_min, double l_max,
                             double epsrel, int max_iter, double logf_const,
                             void* lam_out, void* logf_out, int s0,
                             int count, void* scratch, cudaStream_t stream) {
  if (wide) {
    auto kern = lambda_solve_kernel<double, MC>;
    const int smem = gt_smem_bytes<SolveSmem<double, MC>>(kern);
    kern<<<count, GT_THREADS, smem, stream>>>(
        (const float*)d1f, (const double*)fine, n_region, refine,
        (const float*)eval, (const float*)UtWy, (const float*)wy,
        (const float*)Utx, (const int*)tab, n_cvt, S, n, M, calc_null, reml,
        ustride, wstride, xstride, l_min, l_max, epsrel, max_iter,
        logf_const, (float*)lam_out, (float*)logf_out, s0,
        (unsigned char*)scratch);
  } else {
    auto kern = lambda_solve_kernel<float, MC>;
    const int smem = gt_smem_bytes<SolveSmem<float, MC>>(kern);
    kern<<<count, GT_THREADS, smem, stream>>>(
        (const float*)d1f, (const float*)fine, n_region, refine,
        (const float*)eval, (const float*)UtWy, (const float*)wy,
        (const float*)Utx, (const int*)tab, n_cvt, S, n, M, calc_null, reml,
        ustride, wstride, xstride, (float)l_min, (float)l_max,
        (float)epsrel, max_iter, (float)logf_const, (float*)lam_out,
        (float*)logf_out, s0, (unsigned char*)scratch);
  }
}

// `fine` is the float32 grid (wide = 0) or the float64 one (wide = 1).
// Above GT_MAX_CVT covariates the GT_WIDE_CVT instantiation runs, above
// GT_WIDE_CVT the GT_DYN form on lanes [s0, s0 + count) with `scratch`
// (lambda_solve_lane_bytes a lane); the fixed forms take s0 = 0, count =
// S.
extern "C" int lambda_solve_launch(const void* d1f, const void* fine,
                                   int n_region, int refine,
                                   const void* eval, const void* UtWy,
                                   const void* wy, const void* Utx,
                                   const void* tab, int n_cvt, int S, int n,
                                   int M, int calc_null, int reml,
                                   int ustride, int wstride, int xstride,
                                   int wide, double l_min, double l_max,
                                   double epsrel, int max_iter,
                                   double logf_const, void* lam_out,
                                   void* logf_out, int s0, int count,
                                   void* scratch, void* stream) {
  const int form = gt_form(n_cvt);
  if (count > 0)
    (form == GT_MAX_CVT    ? lambda_solve_run<GT_MAX_CVT>
     : form == GT_WIDE_CVT ? lambda_solve_run<GT_WIDE_CVT>
                           : lambda_solve_run<GT_DYN>)(
        d1f, fine, n_region, refine, eval, UtWy, wy, Utx, tab, n_cvt, S, n,
        M, calc_null, reml, ustride, wstride, xstride, wide, l_min, l_max,
        epsrel, max_iter, logf_const, lam_out, logf_out, s0, count, scratch,
        (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// bytes of a lane's scratch (0 where a fixed instantiation takes n_cvt)
extern "C" long lambda_solve_lane_bytes(int n_cvt, int wide) {
  if (gt_form(n_cvt) != GT_DYN) return 0;
  return gt_solve_lane_bytes(n_cvt, wide ? 8 : 4);
}

GT_ERROR_FN(lambda_solve)
