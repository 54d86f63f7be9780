// One SNP lane's residual-form log-likelihood `logf_stable` (reference
// gemma_tpu/models/lmm/likelihood.py:269-341) by one thread block, in the
// lane's working set: K6's (lrt_tail.cu) re-evaluation of the ML
// log-likelihood with float64 sums of float32 operands.  (The λ searches
// K3 and K7 evaluate their lanes in lane_search.cuh.)
//
// Templates take the operand type Tin (what the lane's arrays hold) and
// the working type T (what is summed and factored).  logf_stable builds
// the (c+1)² weighted Gram by block reduction, factors it in one thread
// and forms Σ h r² by a second reduction: sums of non-negative terms, no
// cancellation.
#pragma once

#include "common.cuh"


template <typename Tin, typename T>
struct SolveCtx {
  const Tin* eval;
  const Tin* UtWy;  // (n, c+1), y last
  const Tin* x;     // (n,) this lane's Utx row
  int n_cvt, n, calc_null;
  T logf_const;     // the constant term of ML logf
};

// A lane's working set for at most MC covariates: the Q block sums of the
// Gram and its right-hand side, the Gram, its solve and the NG index
// pairs of its upper triangle.  A working set above static shared
// memory's 48 KB is dynamic shared memory (gt_smem).
template <typename T, int MC>
struct SolveSmem {
  static constexpr int C1 = GtDims<MC>::C1;
  static constexpr int NG = C1 * (C1 + 1) / 2;
  static constexpr int Q = NG + C1 + 1;
  T red[GT_WARPS * 8];
  T q[Q];
  T G[C1 * C1];
  T beta[C1];
  int pa[NG];
  int pb[NG];
  T bc[4];
};

// The GT_DYN form (above GT_WIDE_CVT covariates): the same arrays in the
// lane's slice of global scratch; red stays in shared memory.
template <typename T>
struct SolveSmem<T, GT_DYN> {
  T* red;
  T* q;
  T* G;
  T* beta;
  int* pa;
  int* pb;
  T* bc;
};

// bytes of one lane's slice (gt_solve_view's layout)
__host__ __device__ inline long gt_solve_lane_bytes(int n_cvt, int tsize) {
  const long C1 = n_cvt + 1, NG = C1 * (C1 + 1) / 2;
  const long Q = NG + C1 + 1;
  return gt_r16(Q * tsize) + gt_r16(C1 * C1 * tsize) + gt_r16(C1 * tsize) +
         2 * gt_r16(NG * 4) + gt_r16(4 * tsize);
}

template <typename T>
__device__ inline SolveSmem<T, GT_DYN> gt_solve_view(unsigned char* lane,
                                                     int n_cvt) {
  __shared__ T red[GT_WARPS * 8];
  const long C1 = n_cvt + 1, NG = C1 * (C1 + 1) / 2;
  GtCarve cv{lane};
  SolveSmem<T, GT_DYN> v;
  v.red = red;
  v.q = cv.take<T>(NG + C1 + 1);
  v.G = cv.take<T>(C1 * C1);
  v.beta = cv.take<T>(C1);
  v.pa = cv.take<int>(NG);
  v.pb = cv.take<int>(NG);
  v.bc = cv.take<T>(4);
  return v;
}

// The working set of a lane: the instantiation's shared memory, or for
// GT_DYN the lane's slice of `scratch` (lane_bytes a lane, indexed by the
// block), passed to `body`.
template <typename T, int MC, typename F>
__device__ __forceinline__ void gt_with_solve(unsigned char* scratch,
                                              long lane_bytes, int n_cvt,
                                              F body) {
  if constexpr (MC == GT_DYN) {
    SolveSmem<T, GT_DYN> v =
        gt_solve_view<T>(scratch + (long)blockIdx.x * lane_bytes, n_cvt);
    body(v);
  } else {
    body(gt_smem<SolveSmem<T, MC>>());
  }
}

// The (a, b) index pairs of the upper triangle of the CZ×CZ Gram, where
// CZ counts the covariates plus x for the alternative model.
template <typename T, int MC>
__device__ inline void gt_gram_pairs(SolveSmem<T, MC>& sm, int CZ) {
  if (threadIdx.x == 0) {
    int q = 0;
    for (int a = 0; a < CZ; ++a)
      for (int b = a; b < CZ; ++b) {
        sm.pa[q] = a;
        sm.pb[q] = b;
        ++q;
      }
  }
  __syncthreads();
}

// Column a of the GLS design: covariates, then x for the alternative.
template <typename Tin, typename T>
__device__ __forceinline__ Tin gt_z(const SolveCtx<Tin, T>& c, int a, int i) {
  return a < c.n_cvt ? c.UtWy[(long)i * (c.n_cvt + 1) + a] : c.x[i];
}

// In-place Cholesky of the CZ×CZ matrix in G (lower triangle); returns
// 2·Σ log|L_ii|, or NaN when a pivot is not positive (the reference's
// cholesky returns NaN factors there).  One thread.
template <typename T>
__device__ T gt_cholesky_logdet(T* G, int CZ) {
  T ld = T(0);
  for (int j = 0; j < CZ; ++j) {
    T s = G[j * CZ + j];
    for (int k = 0; k < j; ++k) s -= G[j * CZ + k] * G[j * CZ + k];
    if (!(s > T(0))) return T(NAN);
    const T ljj = gt_sqrt(s);
    G[j * CZ + j] = ljj;
    ld += gt_log(gt_abs(ljj));
    for (int i = j + 1; i < CZ; ++i) {
      T v = G[i * CZ + j];
      for (int k = 0; k < j; ++k) v -= G[i * CZ + k] * G[j * CZ + k];
      G[i * CZ + j] = v / ljj;
    }
  }
  return T(2) * ld;
}

// logf_stable: the ML log-likelihood via the explicit GLS residual.
// Needs the Gram pairs (gt_gram_pairs).
template <typename Tin, typename T, int MC>
__device__ T gt_logf_stable(const SolveCtx<Tin, T>& c, SolveSmem<T, MC>& sm,
                            T lam) {
  const int CZ = c.calc_null ? c.n_cvt : c.n_cvt + 1;
  const int C1 = c.n_cvt + 1;
  const int nG = CZ * (CZ + 1) / 2;
  const Tin* eval = c.eval;
  const Tin* UtWy = c.UtWy;
  auto f = [&](int q, int i) -> T {
    const T v = lam * (T)eval[i] + T(1);
    const T hi = T(1) / v;
    if (q < nG)
      return hi * (T)gt_z(c, sm.pa[q], i) * (T)gt_z(c, sm.pb[q], i);
    q -= nG;
    if (q < CZ)
      return hi * (T)gt_z(c, q, i) * (T)UtWy[(long)i * C1 + c.n_cvt];
    return gt_log(gt_abs(v));
  };
  gt_block_sums(f, nG + CZ + 1, c.n, sm.q, sm.red);
  if (threadIdx.x == 0) {
    for (int q = 0; q < nG; ++q) {
      sm.G[sm.pa[q] * CZ + sm.pb[q]] = sm.q[q];
      sm.G[sm.pb[q] * CZ + sm.pa[q]] = sm.q[q];
    }
    const T ld = gt_cholesky_logdet(sm.G, CZ);
    // L L' beta = rhs: forward then back substitution
    for (int i = 0; i < CZ; ++i) {
      T v = sm.q[nG + i];
      for (int k = 0; k < i; ++k) v -= sm.G[i * CZ + k] * sm.beta[k];
      sm.beta[i] = v / sm.G[i * CZ + i];
    }
    for (int i = CZ - 1; i >= 0; --i) {
      T v = sm.beta[i];
      for (int k = i + 1; k < CZ; ++k) v -= sm.G[k * CZ + i] * sm.beta[k];
      sm.beta[i] = v / sm.G[i * CZ + i];
    }
    if (isnan(ld))
      for (int i = 0; i < CZ; ++i) sm.beta[i] = T(NAN);
    sm.bc[1] = sm.q[nG + CZ];
  }
  __syncthreads();
  const T logdet_h = sm.bc[1];
  const int nc = c.n_cvt;
  auto fr = [&](int, int i) -> T {
    const T hi = T(1) / (lam * (T)eval[i] + T(1));
    T wb = T(0);
    for (int a = 0; a < nc; ++a) wb += (T)UtWy[(long)i * C1 + a] * sm.beta[a];
    T t = (T)UtWy[(long)i * C1 + nc] - wb;
    if (!c.calc_null) t = t - (T)c.x[i] * sm.beta[nc];
    return hi * (t * t);
  };
  gt_block_sums(fr, 1, c.n, sm.q, sm.red);
  T p_yy = sm.q[0];
  __syncthreads();
  if (p_yy >= T(0) && p_yy < T(1e-8)) p_yy = T(1e-8);
  return c.logf_const - T(0.5) * logdet_h - T(0.5) * (T)c.n * gt_log(p_yy);
}
