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
// reads from device memory.  Where every lane has its own null (GxE:
// the covariates [W, env, x]; gene mode: the gene's response) the null
// launch has S lanes at their own λ, UtWy and Utx sit at their lane
// strides (0 = shared), and the SNP launch reads logl_H0 at stride 1.
// In the parity mode (recompute = 0) the
// float64 logf_H1 of the λ search (K7) is taken as given and one thread
// per lane applies the tail.  Both write logl_H1 and p in float64.
//
// Bound: speed mode — bytes (one read of the lane's float32 Utx row) and
// two float64 passes over n per lane; parity mode — bytes (16 bytes in,
// 16 out per lane) and the tail's few hundred float64 operations.
// Above 32 covariates its working set lives in a per-lane slice of global
// scratch (the GT_DYN form, lmm_lane.cuh), lanes [s0, s0 + count) a
// launch.
#include "lmm_lane.cuh"
#include "tails.cuh"

template <int MC>
__global__ void __launch_bounds__(GT_THREADS)
lrt_recompute_kernel(const float* __restrict__ lam,
                     const float* __restrict__ eval,
                     const float* __restrict__ UtWy,
                     const float* __restrict__ Utx, int n_cvt, int n,
                     int calc_null, int ustride, int xstride,
                     double logf_const, const double* __restrict__ logl0,
                     int l0_stride, double* logl_out, double* p_out,
                     int s0, unsigned char* scratch) {
  gt_with_solve<double, MC>(scratch, gt_solve_lane_bytes(n_cvt, 8), n_cvt,
                            [&](auto& sm) {
  const int s = s0 + blockIdx.x;
  SolveCtx<float, double> c;
  c.eval = eval;
  c.UtWy = UtWy + (long)s * ustride;
  c.wy = nullptr;
  c.x = Utx + (long)s * xstride;
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
    if (p_out != nullptr)
      p_out[s] = gt_chisq_sf(2.0 * (l1 - logl0[(long)s * l0_stride]), 1.0);
  }
  });
}

__global__ void lrt_tail_only_kernel(const double* __restrict__ logl_in,
                                     int S, const double* __restrict__ logl0,
                                     int l0_stride, double* logl_out,
                                     double* p_out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const double l1 = logl_in[s];
  logl_out[s] = l1;
  p_out[s] = gt_chisq_sf(2.0 * (l1 - logl0[(long)s * l0_stride]), 1.0);
}

extern "C" int lrt_tail_launch(int recompute, const void* lam,
                               const void* eval, const void* UtWy,
                               const void* Utx, int n_cvt, int S, int n,
                               int calc_null, int ustride, int xstride,
                               double logf_const, const void* logl_in,
                               const void* logl0, int l0_stride,
                               void* logl_out, void* p_out, int s0,
                               int count, void* scratch, void* stream) {
  // above GT_MAX_CVT covariates the GT_WIDE_CVT instantiation runs, above
  // GT_WIDE_CVT the GT_DYN form on lanes [s0, s0 + count) with `scratch`
  const int form = gt_form(n_cvt);
  auto kern = form == GT_MAX_CVT    ? lrt_recompute_kernel<GT_MAX_CVT>
              : form == GT_WIDE_CVT ? lrt_recompute_kernel<GT_WIDE_CVT>
                                    : lrt_recompute_kernel<GT_DYN>;
  if (count > 0 && recompute) {
    const int smem =
        form == GT_MAX_CVT
            ? gt_smem_bytes<SolveSmem<double, GT_MAX_CVT>>(kern)
            : gt_smem_bytes<SolveSmem<double, GT_WIDE_CVT>>(kern);
    kern<<<count, GT_THREADS, form == GT_DYN ? 0 : smem,
           (cudaStream_t)stream>>>(
        (const float*)lam, (const float*)eval, (const float*)UtWy,
        (const float*)Utx, n_cvt, n, calc_null, ustride, xstride, logf_const,
        (const double*)logl0, l0_stride, (double*)logl_out, (double*)p_out,
        s0, (unsigned char*)scratch);
  } else if (S > 0)
    lrt_tail_only_kernel<<<(S + GT_THREADS - 1) / GT_THREADS, GT_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const double*)logl_in, S, (const double*)logl0, l0_stride,
        (double*)logl_out, (double*)p_out);
  return (int)cudaGetLastError();
}

// bytes of a lane's scratch (0 where a fixed instantiation takes n_cvt)
extern "C" long lrt_tail_lane_bytes(int n_cvt) {
  return gt_form(n_cvt) == GT_DYN ? gt_solve_lane_bytes(n_cvt, 8) : 0;
}

GT_ERROR_FN(lrt_tail)
