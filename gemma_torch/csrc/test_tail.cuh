// The per-SNP test kernel behind K4 (Wald, wald_tail.cu) and K5 (score,
// score_tail.cu): one thread block per SNP builds the test rows at a λ
// (gt_test_rows, common.cuh), then one thread computes beta, se, the F
// statistic and p = f_sf(f, 1, df) with the float64 incomplete beta of
// tails.cuh.  The Wald test reads each lane's REML λ and the
// cancellation-free f = (p_xy²/p_xx)·tau (likelihood.py:506-515 of the
// reference); the score test reads the null model's ML λ, shared by all
// lanes, and f = n p_xy²/(p_yy p_xx).
//
// Bound: bytes — the lane's Utx row is read once from device memory
// (eval/UtWy/wy are shared by all lanes and stay in L2) and three values
// are written; the tail is a few hundred float64 operations per SNP.
#pragma once

#include "tails.cuh"

template <typename T, bool SCORE>
__global__ void __launch_bounds__(GT_THREADS)
test_tail_kernel(const T* __restrict__ lam, const T* __restrict__ eval,
                 const T* __restrict__ UtWy, const T* __restrict__ wy,
                 const T* __restrict__ Utx, const int* __restrict__ tab,
                 int n_cvt, int n, int M, int xx_pos, int xy_pos,
                 T* beta_out, T* se_out, T* p_out) {
  __shared__ TestSmem<T> sm;
  const int s = blockIdx.x;
  const TestRows<T> r =
      gt_test_rows<T>(lam[SCORE ? 0 : s], eval, UtWy, wy, Utx + (long)s * n,
                      tab, n_cvt, n, M, xx_pos, xy_pos, sm);
  if (threadIdx.x == 0) {
    const T df = (T)(n - n_cvt - 1);
    const T beta = r.p_xy / r.p_xx;
    const T tau = df / r.px_yy;
    const T se = gt_sqrt(T(1) / (tau * r.p_xx));
    const T f_stat = SCORE ? (T)n * r.p_xy * r.p_xy / (r.p_yy * r.p_xx)
                           : (r.p_xy * r.p_xy / r.p_xx) * tau;
    beta_out[s] = beta;
    se_out[s] = se;
    p_out[s] = (T)gt_f_sf((double)f_stat, 1.0, (double)df);
  }
}

template <typename T, bool SCORE>
static int gt_test_tail_run(const void* lam, const void* eval,
                            const void* UtWy, const void* wy,
                            const void* Utx, const void* tab, int n_cvt,
                            int S, int n, int M, int xx_pos, int xy_pos,
                            void* beta, void* se, void* p, void* stream) {
  if (S > 0)
    test_tail_kernel<T, SCORE><<<S, GT_THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)lam, (const T*)eval, (const T*)UtWy, (const T*)wy,
        (const T*)Utx, (const int*)tab, n_cvt, n, M, xx_pos, xy_pos,
        (T*)beta, (T*)se, (T*)p);
  return (int)cudaGetLastError();
}

// extern "C" entry point `name` of one instantiation; all share the
// argument list of kernels.WALD_TAIL in gemma_torch/kernels.
#define GT_TEST_TAIL_ENTRY(name, T, SCORE)                                 \
  extern "C" int name(const void* lam, const void* eval, const void* UtWy, \
                      const void* wy, const void* Utx, const void* tab,    \
                      int n_cvt, int S, int n, int M, int xx_pos,          \
                      int xy_pos, void* beta, void* se, void* p,           \
                      void* stream) {                                      \
    return gt_test_tail_run<T, SCORE>(lam, eval, UtWy, wy, Utx, tab,      \
                                      n_cvt, S, n, M, xx_pos, xy_pos,      \
                                      beta, se, p, stream);                \
  }
