// K13 — the DAP single-SNP Bayes factors on the (h, rho) grid: the
// epilogue after the two products xHx = (UtX∘UtX) w' and xHy = UtX (w∘Uty)'
// (dap_bf_launch, float32 products; dap_bf_f64_launch, float64).
//
// Replaces the reference package's device program
//   gemma_tpu/models/bslmmdap.py:43 _bf_table (CalcMarginal,
//   bslmmdap.cpp:480-562, with the 1x1 Omega closed form).
// Its plain version is gemma_torch/models/bslmmdap.py (bf_epilogue_plain).
//
// One thread per (SNP, grid point): logdet_O = log1p(sa2 xHx), P_yy =
// hi_yy - sa2 xHy² / (1 + sa2 xHx), the marginal log-likelihoods of the
// SNP model and the null as the reference writes them, and BF =
// exp(logm - logm_null), all in float64 whatever the products' type: in
// float32 exp(logm - logm_null) overflows once the difference passes
// 88.7, which a SNP with some tenth of the variance reaches at n = 1,940
// (scripts/dap_f32_overflow.py).  BF is float64.
// Bound: bytes — xHx, xHy read once and BF written once.
#include "common.cuh"

template <typename T>
__global__ void dap_bf_kernel(const T* __restrict__ xHx,
                              const T* __restrict__ xHy,
                              const double* __restrict__ logdet_H,
                              const double* __restrict__ hi_yy,
                              const double* __restrict__ sa2, double tau,
                              int n, long total, int G,
                              double* __restrict__ BF) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int g = (int)(e % G);
  const double xx = (double)xHx[e], xy = (double)xHy[e];
  const double s = sa2[g], lh = logdet_H[g], yy = hi_yy[g];
  const double half_n_logtau = 0.5 * n * log(tau);
  const double logm_null = -0.5 * lh - 0.5 * tau * yy + half_n_logtau;
  const double logdet_O = log1p(s * xx);
  const double P_yy = yy - s * xy * xy / (1.0 + s * xx);
  const double logm =
      -0.5 * lh - 0.5 * logdet_O - 0.5 * tau * P_yy + half_n_logtau;
  BF[e] = exp(logm - logm_null);
}

template <typename T>
static int dap_bf_run(const void* xHx, const void* xHy, const void* logdet_H,
                      const void* hi_yy, const void* sa2, double tau, int n,
                      int S, int G, void* BF, void* stream) {
  const long total = (long)S * G;
  if (total > 0) {
    const int threads = 256;
    const long blocks = (total + threads - 1) / threads;
    dap_bf_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)xHx, (const T*)xHy, (const double*)logdet_H,
        (const double*)hi_yy, (const double*)sa2, tau, n, total, G,
        (double*)BF);
  }
  return (int)cudaGetLastError();
}

#define DAP_BF_ENTRY(name, T)                                              \
  extern "C" int name(const void* xHx, const void* xHy,                    \
                      const void* logdet_H, const void* hi_yy,             \
                      const void* sa2, double tau, int n, int S, int G,    \
                      void* BF, void* stream) {                            \
    return dap_bf_run<T>(xHx, xHy, logdet_H, hi_yy, sa2, tau, n, S, G, BF, \
                         stream);                                          \
  }

DAP_BF_ENTRY(dap_bf_launch, float)
DAP_BF_ENTRY(dap_bf_f64_launch, double)
GT_ERROR_FN(dap_bf)
