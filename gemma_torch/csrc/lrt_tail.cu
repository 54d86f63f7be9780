// K6 — the likelihood-ratio test: p_lrt = Q(½, logl_H1 − logl_H0), the
// chi-square(1) tail of twice the log-likelihood difference.
//
// Replaces the reference package's device programs
//   gemma_tpu/ops/stats.py:46 chisq_sf and the LRT difference of
//   gemma_tpu/models/lmm/engine.py:163
// (LMM::Analyze, lmm.cpp:1553, with gsl_cdf_chisq_Q).
//
// The reference's float32 p_lrt misses the 1e-3 speed-mode contract: the
// two log-likelihoods are float32 sums of n terms, each about -10³, their
// difference is near 0 for null SNPs and the χ²(1) tail is infinitely
// steep at 0 (up to 4e-2 absolute at n = 1,940).  So in the speed mode
// (recompute = 1, float32 operands) one thread block per lane evaluates
// the ML log-likelihood again at the lane's float32 λ_mle in the
// logf_stable form (lmm_lane.cuh) with float64 sums, Gram, Cholesky and
// Σ h r²; λ̂ is a stationary point of logf, so λ's float32 error enters
// only at second order.  Launched once on the null lane (calc_null = 1,
// S = 1, at the null's λ_mle) it gives logl_H0, which the SNP launch
// reads from device memory.  In the parity mode (recompute = 0) the
// float64 logf_H1 of the λ search (K7) is taken as given and one thread
// per lane applies the tail.  Both write logl_H1 and p in float64.
//
// Bound: speed mode — bytes (one read of the lane's float32 Utx row) and
// two float64 passes over n per lane; parity mode — bytes (16 bytes in,
// 16 out per lane) and the tail's few hundred float64 operations.
#include "lmm_lane.cuh"
#include "tails.cuh"

__global__ void __launch_bounds__(GT_THREADS)
lrt_recompute_kernel(const float* __restrict__ lam,
                     const float* __restrict__ eval,
                     const float* __restrict__ UtWy,
                     const float* __restrict__ Utx, int n_cvt, int n,
                     int calc_null, double logf_const,
                     const double* __restrict__ logl0, double* logl_out,
                     double* p_out) {
  __shared__ SolveSmem<double> sm;
  const int s = blockIdx.x;
  SolveCtx<float, double> c;
  c.eval = eval;
  c.UtWy = UtWy;
  c.wy = nullptr;
  c.x = Utx + (long)s * n;
  c.t = PabTables{};
  c.n_cvt = n_cvt;
  c.n = n;
  c.M = 0;
  c.ni = gt_n_index(n_cvt);
  c.calc_null = calc_null;
  c.reml = 0;
  c.logf_const = logf_const;
  gt_gram_pairs(sm, calc_null ? n_cvt : n_cvt + 1);
  const double l1 = gt_logf_stable(c, sm, (double)lam[s], 0.0);
  if (threadIdx.x == 0) {
    logl_out[s] = l1;
    if (p_out != nullptr) p_out[s] = gt_chisq_sf(2.0 * (l1 - logl0[0]), 1.0);
  }
}

__global__ void lrt_tail_only_kernel(const double* __restrict__ logl_in,
                                     int S, const double* __restrict__ logl0,
                                     double* logl_out, double* p_out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const double l1 = logl_in[s];
  logl_out[s] = l1;
  p_out[s] = gt_chisq_sf(2.0 * (l1 - logl0[0]), 1.0);
}

extern "C" int lrt_tail_launch(int recompute, const void* lam,
                               const void* eval, const void* UtWy,
                               const void* Utx, int n_cvt, int S, int n,
                               int calc_null, double logf_const,
                               const void* logl_in, const void* logl0,
                               void* logl_out, void* p_out, void* stream) {
  if (S > 0 && recompute)
    lrt_recompute_kernel<<<S, GT_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)lam, (const float*)eval, (const float*)UtWy,
        (const float*)Utx, n_cvt, n, calc_null, logf_const,
        (const double*)logl0, (double*)logl_out, (double*)p_out);
  else if (S > 0)
    lrt_tail_only_kernel<<<(S + GT_THREADS - 1) / GT_THREADS, GT_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const double*)logl_in, S, (const double*)logl0, (double*)logl_out,
        (double*)p_out);
  return (int)cudaGetLastError();
}

GT_ERROR_FN(lrt_tail)
