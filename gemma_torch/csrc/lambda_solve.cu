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
// Newton fails.
//
// Bound: the data moved is the lane's Utx row plus eval/UtWy/wy (shared
// by all lanes, L2-resident); per evaluation the work is O(n·(c+1)²)
// flops.  This simple version re-reads Utx from global memory (L1/L2) on
// every evaluation; keeping the row in shared memory across iterations
// is later work.  Lanes finish independently: no lane waits for the
// slowest one, unlike the lock-step while loops it replaces.
#include "lmm_lane.cuh"

__global__ void __launch_bounds__(GT_THREADS)
lambda_solve_kernel(const float* __restrict__ d1f,
                    const float* __restrict__ fine, int n_region,
                    int refine, const float* __restrict__ eval,
                    const float* __restrict__ UtWy,
                    const float* __restrict__ wy,
                    const float* __restrict__ Utx,
                    const int* __restrict__ tab, int n_cvt, int S, int n,
                    int M, int calc_null, int reml, float l_min, float l_max,
                    float epsrel, int max_iter, float logf_const,
                    float* lam_out, float* logf_out) {
  __shared__ SolveSmem<float> sm;
  const int s = blockIdx.x;
  SolveCtx<float, float> c;
  c.eval = eval;
  c.UtWy = UtWy;
  c.wy = wy;
  c.x = Utx + (long)s * n;
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
  const float logdet0 = reml ? gt_logdet0(c, sm, CZ) : 0.f;

  const float* col = d1f + s;  // column s of (G_fine, S)
  float best_logf = -INFINITY, best_lam = NAN;
  bool has_cand = false;
  for (int iv = 0; iv < n_region; ++iv) {
    const float da = col[(long)iv * refine * S];
    const float db = col[(long)(iv + 1) * refine * S];
    if (!(da * db <= 0.f)) continue;
    int jf = 0;  // argmax of an all-false window is 0
    for (int f = iv * refine; f < (iv + 1) * refine; ++f)
      if (col[(long)f * S] * col[(long)(f + 1) * S] <= 0.f) {
        jf = f;
        break;
      }
    const float root_b = sqrtf(fine[jf] * fine[jf + 1]);

    // Newton on (dev1, dev2), GEMMA exit semantics
    float x_prev = root_b, x = root_b, fv, dfv;
    gt_dev12(c, sm, root_b, &fv, &dfv, 3);
    bool conv = false, failed = false;
    for (int it = 0; it < max_iter && !conv && !failed; ++it) {
      const bool zero_div = dfv == 0.f;
      const float step_x = x - fv / (zero_div ? 1.f : dfv);
      float f_new, df_new;
      gt_dev12(c, sm, step_x, &f_new, &df_new, 3);
      const bool bad = !isfinite(f_new) || !isfinite(df_new);
      const bool cv =
          (fabsf(step_x - x) < epsrel * fabsf(step_x)) || (step_x == x);
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
    const float root_n = conv ? x_prev : root_b;
    const float l_cand = gt_clip(root_n, l_min, l_max);
    const float logf_cand = gt_logf_stable(c, sm, l_cand, logdet0);
    if (!has_cand || logf_cand > best_logf) {
      best_logf = logf_cand;
      best_lam = l_cand;
    }
    has_cand = true;
  }
  const float logf_lmin = gt_logf_stable(c, sm, l_min, logdet0);
  const float logf_lmax = gt_logf_stable(c, sm, l_max, logdet0);
  if (logf_lmin > best_logf) {
    best_logf = logf_lmin;
    best_lam = l_min;
  }
  if (logf_lmax > best_logf) {
    best_logf = logf_lmax;
    best_lam = l_max;
  }
  if (threadIdx.x == 0) {
    lam_out[s] = best_lam;
    logf_out[s] = best_logf;
  }
}

extern "C" int lambda_solve_launch(const void* d1f, const void* fine,
                                   int n_region, int refine,
                                   const void* eval, const void* UtWy,
                                   const void* wy, const void* Utx,
                                   const void* tab, int n_cvt, int S, int n,
                                   int M, int calc_null, int reml,
                                   float l_min, float l_max, float epsrel,
                                   int max_iter, float logf_const,
                                   void* lam_out, void* logf_out,
                                   void* stream) {
  if (S > 0)
    lambda_solve_kernel<<<S, GT_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)d1f, (const float*)fine, n_region, refine,
        (const float*)eval, (const float*)UtWy, (const float*)wy,
        (const float*)Utx, (const int*)tab, n_cvt, S, n, M, calc_null, reml,
        l_min, l_max, epsrel, max_iter, logf_const, (float*)lam_out,
        (float*)logf_out);
  return (int)cudaGetLastError();
}

GT_ERROR_FN(lambda_solve)
