// K8 — the linear model's per-row OLS and its three tests (-lm 1-4), in
// float32 (speed mode) and float64 (parity mode, entry point
// lm_tail_f64_launch).
//
// Replaces the reference package's device programs
//   gemma_tpu/models/lm.py:38 lm_block and :68 lm_gene_block
// with gemma_tpu/ops/stats.py:21 f_sf and :46 chisq_sf (GEMMA's CalcvPv
// and LmCalcP, lm.cpp:224-289).
//
// One warp per row: the row (a SNP's imputed genotypes, or in gene mode a
// gene's expression) is read once, coalesced, and each lane accumulates
// in float64 its share of r'r, r'v and the c products r'W_a, where v is
// the shared vector (the phenotype, or in gene mode the predictor) and W
// the covariates (both shared, L2-resident).  Warp shuffles reduce them;
// lane 0 then forms, with the shared (W'W)^-1, (W'W)^-1 W'v and v'P_W v
// that torch computes once in float64, the projections r'P_W r and
// r'P_W v, and from them beta, se and the F(1, n-c-1) Wald and score
// tails and the chi-square(1) LRT tail of tails.cuh.  The LRT statistic
// is -n log1p(-xPwy²/(xPwx yPwy)): the reference's log(yPwy) - log(yPxy)
// cancels for null SNPs.  In gene mode r'P_W r is yPwy and v'P_W v is
// xPwx; otherwise the other way round.
//
// Bound: bytes — S·n operand values read once (the shared v and W stay
// in L2) and five values written per row; the arithmetic is 2(c+2)
// float64 operations per element, below the float64 rate's share.
#include "tails.cuh"

#define LM_WARPS 8

template <typename T>
__device__ __forceinline__ void lm_tail_finish(
    double rr, double rv, double q, double b, const double* vPwv, int s,
    int n, int c, int gene, int se_score, T* beta_out, T* se_out, T* pw_out,
    T* pl_out, T* ps_out);

template <typename T, int MC>
__global__ void __launch_bounds__(LM_WARPS * 32)
lm_tail_kernel(const T* __restrict__ rows, const T* __restrict__ v,
               const T* __restrict__ W, const double* __restrict__ WtWi,
               const double* __restrict__ WtWi_Wtv,
               const double* __restrict__ vPwv, int S, int n, int c,
               int gene, int se_score, T* beta_out, T* se_out, T* pw_out,
               T* pl_out, T* ps_out) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * LM_WARPS + (threadIdx.x >> 5);
  if (s >= S) return;  // the whole warp leaves together
  const T* r = rows + (long)s * n;
  double rr = 0.0, rv = 0.0, rw[MC];
#pragma unroll
  for (int a = 0; a < MC; ++a) rw[a] = 0.0;
  for (int i = lane; i < n; i += 32) {
    const double ri = (double)r[i];
    rr += ri * ri;
    rv += ri * (double)v[i];
#pragma unroll
    for (int a = 0; a < MC; ++a)
      if (a < c) rw[a] += ri * (double)W[(long)i * c + a];
  }
  rr = gt_warp_sum(rr);
  rv = gt_warp_sum(rv);
#pragma unroll
  for (int a = 0; a < MC; ++a)
    if (a < c) rw[a] = gt_warp_sum(rw[a]);  // c is the same for all lanes
  if (lane != 0) return;

  double q = 0.0, b = 0.0;  // r'W (W'W)^-1 W'r and r'W (W'W)^-1 W'v
#pragma unroll
  for (int a = 0; a < MC; ++a) {
    if (a >= c) continue;
    double t = 0.0;
#pragma unroll
    for (int k = 0; k < MC; ++k)
      if (k < c) t += WtWi[a * c + k] * rw[k];
    q += rw[a] * t;
    b += rw[a] * WtWi_Wtv[a];
  }
  lm_tail_finish<T>(rr, rv, q, b, vPwv, s, n, c, gene, se_score, beta_out,
                    se_out, pw_out, pl_out, ps_out);
}

// The GT_DYN form (above GT_WIDE_CVT covariates): the same warp per row,
// r'W taken GT_WIDE_CVT columns a pass over the row and kept in the row's
// slice of `rw_scratch` (c doubles), then q and b from it on lane 0.  The
// order of every sum is the fixed forms'.
template <typename T>
__global__ void __launch_bounds__(LM_WARPS * 32)
lm_tail_dyn_kernel(const T* __restrict__ rows, const T* __restrict__ v,
                   const T* __restrict__ W, const double* __restrict__ WtWi,
                   const double* __restrict__ WtWi_Wtv,
                   const double* __restrict__ vPwv, int S, int n, int c,
                   int gene, int se_score, T* beta_out, T* se_out, T* pw_out,
                   T* pl_out, T* ps_out, double* rw_scratch) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * LM_WARPS + (threadIdx.x >> 5);
  if (s >= S) return;  // the whole warp leaves together
  const T* r = rows + (long)s * n;
  double* rw = rw_scratch + (long)s * c;
  double rr = 0.0, rv = 0.0;
  for (int a0 = 0; a0 < c; a0 += GT_WIDE_CVT) {
    double acc[GT_WIDE_CVT];
#pragma unroll
    for (int a = 0; a < GT_WIDE_CVT; ++a) acc[a] = 0.0;
    for (int i = lane; i < n; i += 32) {
      const double ri = (double)r[i];
      if (a0 == 0) {
        rr += ri * ri;
        rv += ri * (double)v[i];
      }
#pragma unroll
      for (int a = 0; a < GT_WIDE_CVT; ++a)
        if (a0 + a < c) acc[a] += ri * (double)W[(long)i * c + a0 + a];
    }
#pragma unroll
    for (int a = 0; a < GT_WIDE_CVT; ++a)
      if (a0 + a < c) {
        const double t = gt_warp_sum(acc[a]);
        if (lane == 0) rw[a0 + a] = t;
      }
  }
  rr = gt_warp_sum(rr);
  rv = gt_warp_sum(rv);
  if (lane != 0) return;

  double q = 0.0, b = 0.0;
  for (int a = 0; a < c; ++a) {
    double t = 0.0;
    for (int k = 0; k < c; ++k) t += WtWi[(long)a * c + k] * rw[k];
    q += rw[a] * t;
    b += rw[a] * WtWi_Wtv[a];
  }
  lm_tail_finish<T>(rr, rv, q, b, vPwv, s, n, c, gene, se_score, beta_out,
                    se_out, pw_out, pl_out, ps_out);
}

// the tests from the sums: rr = r'r, rv = r'v, q = r'W (W'W)^-1 W'r,
// b = r'W (W'W)^-1 W'v
template <typename T>
__device__ __forceinline__ void lm_tail_finish(
    double rr, double rv, double q, double b, const double* vPwv, int s,
    int n, int c, int gene, int se_score, T* beta_out, T* se_out, T* pw_out,
    T* pl_out, T* ps_out) {
  const double rPwr = rr - q;
  const double xPwy = rv - b;
  const double xPwx = gene ? vPwv[0] : rPwr;
  const double yPwy = gene ? rPwr : vPwv[0];
  const double nf = (double)n;
  const double df = (double)(n - c - 1);
  const double r2 = xPwy * xPwy / (xPwx * yPwy);
  const double yPxy = yPwy - xPwy * xPwy / xPwx;
  beta_out[s] = (T)(xPwy / xPwx);
  se_out[s] = (T)(se_score ? sqrt(yPwy / (nf * xPwx))
                           : sqrt(yPxy / (df * xPwx)));
  pw_out[s] = (T)gt_f_sf(xPwy * xPwy * df / (xPwx * yPxy), 1.0, df);
  ps_out[s] = (T)gt_f_sf(nf * r2, 1.0, df);
  pl_out[s] = (T)gt_chisq_sf(-nf * log1p(-r2), 1.0);
}

template <typename T>
static int gt_lm_tail_run(const void* rows, const void* v, const void* W,
                          const void* WtWi, const void* WtWi_Wtv,
                          const void* vPwv, int S, int n, int c, int gene,
                          int se_score, void* beta, void* se, void* pw,
                          void* pl, void* ps, void* scratch, void* stream) {
  // above GT_MAX_CVT covariates the GT_WIDE_CVT instantiation runs, above
  // GT_WIDE_CVT the GT_DYN form with `scratch` (c doubles a row)
  const int form = gt_form(c);
  const dim3 grid((S + LM_WARPS - 1) / LM_WARPS);
  if (S > 0 && form == GT_DYN)
    lm_tail_dyn_kernel<T><<<grid, LM_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const T*)rows, (const T*)v, (const T*)W, (const double*)WtWi,
        (const double*)WtWi_Wtv, (const double*)vPwv, S, n, c, gene,
        se_score, (T*)beta, (T*)se, (T*)pw, (T*)pl, (T*)ps,
        (double*)scratch);
  else if (S > 0)
    (form == GT_MAX_CVT ? lm_tail_kernel<T, GT_MAX_CVT>
                        : lm_tail_kernel<T, GT_WIDE_CVT>)<<<
        grid, LM_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const T*)rows, (const T*)v, (const T*)W, (const double*)WtWi,
        (const double*)WtWi_Wtv, (const double*)vPwv, S, n, c, gene,
        se_score, (T*)beta, (T*)se, (T*)pw, (T*)pl, (T*)ps);
  return (int)cudaGetLastError();
}

#define GT_LM_TAIL_ENTRY(name, T)                                           \
  extern "C" int name(const void* rows, const void* v, const void* W,       \
                      const void* WtWi, const void* WtWi_Wtv,               \
                      const void* vPwv, int S, int n, int c, int gene,      \
                      int se_score, void* beta, void* se, void* pw,         \
                      void* pl, void* ps, void* scratch, void* stream) {    \
    return gt_lm_tail_run<T>(rows, v, W, WtWi, WtWi_Wtv, vPwv, S, n, c,     \
                             gene, se_score, beta, se, pw, pl, ps, scratch, \
                             stream);                                       \
  }

// bytes of a row's scratch (0 where a fixed instantiation takes c)
extern "C" long lm_tail_lane_bytes(int c) {
  return gt_form(c) == GT_DYN ? 8L * c : 0;
}

GT_LM_TAIL_ENTRY(lm_tail_launch, float)
GT_LM_TAIL_ENTRY(lm_tail_f64_launch, double)
GT_ERROR_FN(lm_tail)
