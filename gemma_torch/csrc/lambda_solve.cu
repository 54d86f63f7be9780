// K3 — per-SNP λ solve: bracket choice, Newton polish, likelihood
// comparison, fused into one kernel.
//
// Replaces the float32 branch of the reference package's
//   gemma_tpu/models/lmm/optimize.py:247 calc_lambda
// after its grid scan: the bracket loop (:307-418), _newton_batched
// (:186-235) over likelihood.dev12 (likelihood.py:441-485) and
// likelihood.logf_stable (likelihood.py:269-341) at each candidate and
// at l_min/l_max (:420-434).  On the TPU this was a chain of XLA while
// loops in which every iteration re-read the whole (S, n) block for all
// lanes until the slowest lane finished; the fused Pallas version never
// compiled there.
//
// Each lane reads its column of the fine grid's dev1 (from K2), walks its
// sign-change intervals in order, takes the leftmost sign-changing fine
// sub-interval of each (the argmax-of-first-True of bracket_at,
// optimize.py:326-349) and runs Newton from its geometric midpoint with
// GEMMA's exit semantics: keep the second-to-last iterate, fail on a zero
// derivative, a non-finite value or a step out of (l_min, l_max) that has
// not converged, stop at 100 iterations, float32 tolerance 5e-4 and the
// fall-back to the bracket midpoint when Newton fails.
//
// Bound: operations.  The time is the sums over n of the evaluations
// (89-98% of a lane's clocks on an H100 before this design,
// scripts/k3_k7_phase_profile.py).  So a block steps L lanes together
// through lane_search.cuh's rounds: lanes that share their operands (every
// -lmm block without -gxe or -gene) are eight a block and each staged
// UtWy row serves all eight; per-lane operands (GxE: per-lane covariates;
// gene mode: a per-lane response) are one lane a block.  Each lane's
// search runs on its team of the block's threads and keeps its own exits.
// Above 32 covariates the working sets live in a per-lane slice of global
// scratch (the GT_DYN form), lanes [s0, s0 + count) a launch.
#include "lane_search.cuh"

// T is the working type: float, the arithmetic K3 always ran, for blocks
// whose lanes share their operands; double (float32 operands, float64
// sums, Newton to GSL's 1e-5) for per-lane blocks.  There each lane has
// its own response or covariates and its own null, the likelihood of a
// gene or a GxE lane is often flat at small λ, and float32 cannot tell
// its candidates apart: float32 sums left gene-mode p-values up to 1e-2
// from float64 at n = 1,940 (scripts/lane_f32_gap.py, PERF.md).
// Two blocks an SM, but for the eight-lane column sums (c >= 2, lanes
// sharing their operands), whose accumulators spill at 128 registers a
// thread (scripts/k3_k7_phase_profile.py's c = 24 block on an H100: 43 ms
// at 128, 31 at 245).
template <typename T, int L, bool ROWS>
__global__ void __launch_bounds__(LS_THREADS, ROWS || L == 1 ? 2 : 1)
lambda_solve_kernel(const float* __restrict__ d1f, const T* __restrict__ fine,
                    int n_region, int refine, const float* __restrict__ eval,
                    const float* __restrict__ UtWy,
                    const float* __restrict__ Utx,
                    const int* __restrict__ tab, int n_cvt, int S, int n,
                    int calc_null, int reml, int ustride, int xstride, int TR,
                    int resident, T l_min, T l_max, T epsrel, int max_iter,
                    T logf_const,
                    float* lam_out, float* logf_out, int* next, int s0,
                    int count, unsigned char* scratch) {
  const LsCtx<float, T> c = ls_ctx<float, T>(
      eval, UtWy, Utx, ustride, xstride, tab, n_cvt, n, calc_null, reml,
      logf_const, L, TR, resident, 1, s0, count, scratch);
  ls_begin(c);
  const int l = threadIdx.x / (LS_THREADS / L);
  GT_PROF_START();
  int s, taken = 0;
  while (l < c.nl && (s = ls_next<float, T, L>(c, l, next, s0, count,
                                               taken)) >= 0) {
    if (threadIdx.x % (LS_THREADS / L) == 0) GT_PROF_ADD(GT_PC_LANES, 1);
    T logdet0 = T(0);
    if (reml) ls_eval<float, T, L, ROWS>(c, l, LS_GRAM0, T(0), T(0), &logdet0,
                                   nullptr);
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
      ls_eval<float, T, L, ROWS>(c, l, LS_DEV12, root_b, T(0), &fv, &dfv);
      bool conv = false, failed = false;
      for (int it = 0; it < max_iter && !conv && !failed; ++it) {
        const bool zero_div = dfv == T(0);
        const T step_x = x - fv / (zero_div ? T(1) : dfv);
        T f_new, df_new;
        ls_eval<float, T, L, ROWS>(c, l, LS_DEV12, step_x, T(0), &f_new, &df_new);
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
      T logf_cand;
      ls_eval<float, T, L, ROWS>(c, l, LS_STABLE, l_cand, logdet0, &logf_cand,
                           nullptr);
      if (!has_cand || logf_cand > best_logf) {
        best_logf = logf_cand;
        best_lam = l_cand;
      }
      has_cand = true;
    }
    T logf_lmin, logf_lmax;
    ls_eval<float, T, L, ROWS>(c, l, LS_STABLE, l_min, logdet0, &logf_lmin,
                         nullptr);
    ls_eval<float, T, L, ROWS>(c, l, LS_STABLE, l_max, logdet0, &logf_lmax,
                         nullptr);
    if (logf_lmin > best_logf) {
      best_logf = logf_lmin;
      best_lam = l_min;
    }
    if (logf_lmax > best_logf) {
      best_logf = logf_lmax;
      best_lam = l_max;
    }
    if (threadIdx.x % (LS_THREADS / L) == 0) {
      lam_out[s] = (float)best_lam;
      logf_out[s] = (float)best_logf;
    }
  }
  ls_idle<float, T, L, ROWS>(c, l);
  GT_PROF(GT_PH_CONTROL);
}

// The launch's layout: L lanes a block (8 where they share their operands
// in float32, else 1), working sets in shared memory up to GT_WIDE_CVT
// covariates, else in scratch.
static LsLayout k3_layout(int n_cvt, int n, int wide, int per_lane) {
  const int L = per_lane || wide ? 1 : 8;
  const int t = wide ? 8 : 4;
  return ls_fit(n_cvt, n, L, 4, t, 1, gt_form(n_cvt) != GT_DYN);
}

template <typename T, int L, bool ROWS>
static int k3_run(const void* d1f, const void* fine, int n_region,
                  int refine, const void* eval, const void* UtWy,
                  const void* Utx, const void* tab, int n_cvt, int S, int n,
                  int calc_null, int reml, int ustride, int xstride,
                  const LsLayout& y, double l_min, double l_max,
                  double epsrel, int max_iter, double logf_const,
                  void* lam_out, void* logf_out, void* next, int s0,
                  int count, void* scratch, cudaStream_t stream) {
  auto kern = lambda_solve_kernel<T, L, ROWS>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)y.bytes);
  kern<<<(count + L - 1) / L, LS_THREADS, y.bytes, stream>>>(
      (const float*)d1f, (const T*)fine, n_region, refine,
      (const float*)eval, (const float*)UtWy, (const float*)Utx,
      (const int*)tab, n_cvt, S, n, calc_null, reml, ustride, xstride, y.TR,
      y.resident, (T)l_min, (T)l_max, (T)epsrel, max_iter, (T)logf_const,
      (float*)lam_out, (float*)logf_out, (int*)next, s0, count,
      (unsigned char*)scratch);
  return 0;
}

// `fine` is the float32 grid (wide = 0) or the float64 one (wide = 1);
// ustride != 0 (per-lane UtWy) takes one lane a block.  Above GT_WIDE_CVT
// covariates lanes [s0, s0 + count) run with `scratch`
// (lambda_solve_lane_bytes a lane); below, s0 = 0 and count = S.
extern "C" int lambda_solve_launch(const void* d1f, const void* fine,
                                   int n_region, int refine,
                                   const void* eval, const void* UtWy,
                                   const void* Utx, const void* tab,
                                   int n_cvt, int S, int n, int calc_null,
                                   int reml, int ustride, int xstride,
                                   int wide, double l_min, double l_max,
                                   double epsrel, int max_iter,
                                   double logf_const, void* lam_out,
                                   void* logf_out, void* next, int s0,
                                   int count, void* scratch, void* stream) {
  const int per_lane = ustride != 0;
  const LsLayout y = k3_layout(n_cvt, n, wide, per_lane);
  if (count > 0)
    (wide       ? (y.rows ? k3_run<double, 1, true> : k3_run<double, 1, false>)
     : per_lane ? (y.rows ? k3_run<float, 1, true> : k3_run<float, 1, false>)
                : (y.rows ? k3_run<float, 8, true> : k3_run<float, 8, false>))(
        d1f, fine, n_region, refine, eval, UtWy, Utx, tab, n_cvt, S, n,
        calc_null, reml, ustride, xstride, y, l_min, l_max, epsrel, max_iter,
        logf_const, lam_out, logf_out, next, s0, count,
        gt_form(n_cvt) == GT_DYN ? scratch : nullptr, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// bytes of a lane's scratch (0 where the working sets fit shared memory)
extern "C" long lambda_solve_lane_bytes(int n_cvt, int wide) {
  if (gt_form(n_cvt) != GT_DYN) return 0;
  return k3_layout(n_cvt, 1, wide, 0).ws_bytes;
}

// the shared-memory bytes of a block at n individuals
extern "C" long lambda_solve_smem_bytes(int n_cvt, int n, int wide,
                                        int per_lane) {
  return k3_layout(n_cvt, n, wide, per_lane).bytes;
}

GT_ERROR_FN(lambda_solve)
