// One SNP lane's likelihood evaluations, by one thread block: the
// derivatives dev1/dev2 (LogRL_dev12 / LogL_dev12, lmm.cpp:820-1010) and
// the residual-form log-likelihood `logf_stable` (reference
// gemma_tpu/models/lmm/likelihood.py:269-341).  Shared by K3 (float32),
// K6 (float32 operands, float64 sums) and K7 (float64).
//
// Templates take the operand type Tin (what the lane's arrays hold) and
// the working type T (what is summed and factored); K3 runs <float,
// float>, the arithmetic it always ran.
//
// dev12 is one set of block reductions over n (the base rows of the
// weight powers hi^1..hi^P) followed by the recurrences, parallel over
// the flat index in shared memory.  logf_stable builds the (c+1)²
// weighted Gram by block reduction, factors it in one thread and forms
// Σ h r² by a second reduction: sums of non-negative terms, no
// cancellation.
#pragma once

#include "common.cuh"

#define GT_MAX_Q (3 * GT_MAX_M + 3 * GT_MAX_C1 + 5)
#define GT_MAX_NG (GT_MAX_C1 * (GT_MAX_C1 + 1) / 2)

template <typename Tin, typename T>
struct SolveCtx {
  const Tin* eval;
  const Tin* UtWy;  // (n, c+1), y last
  const Tin* wy;    // (n, M)
  const Tin* x;     // (n,) this lane's Utx row
  PabTables t;
  int n_cvt, n, M, ni, calc_null, reml;
  T logf_const;     // the constant term of (RE)ML logf
};

template <typename T>
struct SolveSmem {
  T red[GT_WARPS * 8];
  T q[GT_MAX_Q];
  T rows[6][GT_MAX_NI];
  T G[GT_MAX_C1 * GT_MAX_C1];
  T beta[GT_MAX_C1];
  int pa[GT_MAX_NG];
  int pb[GT_MAX_NG];
  T bc[4];
};

// The (a, b) index pairs of the upper triangle of the CZ×CZ Gram, where
// CZ counts the covariates plus x for the alternative model.
template <typename T>
__device__ inline void gt_gram_pairs(SolveSmem<T>& sm, int CZ) {
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

// d logL/dλ at lam and, with P = 3, d² logL/dλ² (LogRL_dev12 /
// LogL_dev12); P = 2 gives d1 alone (LogRL_dev1 / LogL_dev1), the same
// arithmetic for d1.
template <typename Tin, typename T>
__device__ void gt_dev12(const SolveCtx<Tin, T>& c, SolveSmem<T>& sm, T lam,
                         T* d1, T* d2, int P) {
  const int M = c.M, C1 = c.n_cvt + 1;
  const Tin* eval = c.eval;
  const Tin* x = c.x;
  const Tin* wy = c.wy;
  const Tin* UtWy = c.UtWy;
  auto f = [&](int q, int i) -> T {
    const T hi = T(1) / (lam * (T)eval[i] + T(1));
    if (q < P * M) {
      const int p = q / M, m = q - p * M;
      T w = hi;
      if (p >= 1) w = w * hi;
      if (p >= 2) w = w * hi;
      return w * (T)wy[(long)i * M + m];
    }
    q -= P * M;
    if (q < P * C1) {
      const int p = q / C1, j = q - p * C1;
      T v = hi * (T)x[i];
      if (p >= 1) v = v * hi;
      if (p >= 2) v = v * hi;
      return v * (T)UtWy[(long)i * C1 + j];
    }
    q -= P * C1;
    if (q < P) {
      const T v1 = hi * (T)x[i];
      if (q == 0) return v1 * (T)x[i];
      if (q == 1) return v1 * v1;
      return v1 * v1 * hi;
    }
    return q == P ? hi : hi * hi;
  };
  const int Q = P * M + P * C1 + P + 2;
  gt_block_sums(f, Q, c.n, sm.q, sm.red);
  const int ni = c.ni;
  for (int k = threadIdx.x; k < ni; k += GT_THREADS) {
    const int kind = c.t.kind[k], col = c.t.col[k];
    for (int p = 0; p < P; ++p) {
      T v;
      if (kind == 0)
        v = sm.q[p * M + col];
      else if (kind == 1)
        v = sm.q[P * M + P * C1 + p];
      else
        v = sm.q[P * M + p * C1 + col];
      sm.rows[p][k] = v;
    }
  }
  __syncthreads();
  const T trace_hi = sm.q[Q - 2];
  const T trace_hihi = sm.q[Q - 1];
  const int nc_total = c.calc_null ? c.n_cvt : c.n_cvt + 1;
  T trace_p = trace_hi, trace_pp = trace_hihi;
  int cur = 0;
  for (int p = 1; p <= nc_total; ++p) {
    T* pab = sm.rows[cur];
    T* ppab = sm.rows[cur + 1];
    T* pppab = sm.rows[cur + 2];
    const int d = c.t.diag[p - 1];
    const T ps_ww = pab[d], ps2_ww = ppab[d];
    trace_p = trace_p - ps2_ww / ps_ww;
    if (P == 3)
      trace_pp = trace_pp + ps2_ww * ps2_ww / (ps_ww * ps_ww) -
                 T(2) * pppab[d] / ps_ww;
    const int nxt = 3 - cur;
    gt_pab_step<T>(c.t, ni, p, P, pab, ppab, pppab, sm.rows[nxt],
                   sm.rows[nxt + 1], sm.rows[nxt + 2]);
    __syncthreads();
    cur = nxt;
  }
  const T p_yy = sm.rows[cur][ni - 1];
  const T pp_yy = sm.rows[cur + 1][ni - 1];
  const T ppp_yy = P == 3 ? sm.rows[cur + 2][ni - 1] : T(0);
  const T ypkpy = (p_yy - pp_yy) / lam;
  const T ypkpkpy = (p_yy + ppp_yy - T(2) * pp_yy) / (lam * lam);
  if (c.reml) {
    const T df = (T)(c.calc_null ? c.n - c.n_cvt : c.n - c.n_cvt - 1);
    const T trace_pk = (df - trace_p) / lam;
    const T trace_pkpk = (df + trace_pp - T(2) * trace_p) / (lam * lam);
    *d1 = T(-0.5) * trace_pk + T(0.5) * df * ypkpy / p_yy;
    *d2 = T(0.5) * trace_pkpk -
          T(0.5) * df * (T(2) * ypkpkpy * p_yy - ypkpy * ypkpy) /
              (p_yy * p_yy);
  } else {
    const T nf = (T)c.n;
    const T trace_hik = (nf - trace_hi) / lam;
    const T trace_hikhik = (nf + trace_hihi - T(2) * trace_hi) / (lam * lam);
    *d1 = T(-0.5) * trace_hik + T(0.5) * nf * ypkpy / p_yy;
    *d2 = T(0.5) * trace_hikhik -
          T(0.5) * nf * (T(2) * ypkpkpy * p_yy - ypkpy * ypkpy) /
              (p_yy * p_yy);
  }
  __syncthreads();  // rows and q are reused by the next evaluation
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

// Σ log|L0_ii| of the identity-weighted Gram (λ-independent REML piece).
// Needs the Gram pairs (gt_gram_pairs).
template <typename Tin, typename T>
__device__ T gt_logdet0(const SolveCtx<Tin, T>& c, SolveSmem<T>& sm,
                        int CZ) {
  const int nG = CZ * (CZ + 1) / 2;
  auto f = [&](int q, int i) -> T {
    return (T)gt_z(c, sm.pa[q], i) * (T)gt_z(c, sm.pb[q], i);
  };
  gt_block_sums(f, nG, c.n, sm.q, sm.red);
  if (threadIdx.x == 0) {
    for (int q = 0; q < nG; ++q) {
      sm.G[sm.pa[q] * CZ + sm.pb[q]] = sm.q[q];
      sm.G[sm.pb[q] * CZ + sm.pa[q]] = sm.q[q];
    }
    sm.bc[0] = gt_cholesky_logdet(sm.G, CZ);
  }
  __syncthreads();
  const T r = sm.bc[0];
  __syncthreads();
  return r;
}

// logf_stable: (RE)ML log-likelihood via the explicit GLS residual.
// Needs the Gram pairs (gt_gram_pairs).
template <typename Tin, typename T>
__device__ T gt_logf_stable(const SolveCtx<Tin, T>& c, SolveSmem<T>& sm,
                            T lam, T logdet0) {
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
    sm.bc[0] = ld;
    sm.bc[1] = sm.q[nG + CZ];
  }
  __syncthreads();
  const T ld = sm.bc[0];
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
  if (c.reml) {
    const T df = (T)(c.calc_null ? c.n - c.n_cvt : c.n - c.n_cvt - 1);
    const T logdet_hiw = ld - logdet0;
    return c.logf_const - T(0.5) * logdet_h - T(0.5) * logdet_hiw -
           T(0.5) * df * gt_log(p_yy);
  }
  return c.logf_const - T(0.5) * logdet_h - T(0.5) * (T)c.n * gt_log(p_yy);
}

template <typename T>
__device__ __forceinline__ T gt_clip(T v, T lo, T hi) {
  return isnan(v) ? v : (v < lo ? lo : (v > hi ? hi : v));
}
