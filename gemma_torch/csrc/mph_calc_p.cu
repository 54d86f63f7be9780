// K10 — the mvLMM Wald/score test of a lane's last row, and the χ²(d)
// tails.
//
// Replaces the reference package's device programs
//   gemma_tpu/models/mvlmm_core.py:712 mph_calc_p (MphCalcP,
//   mvlmm.cpp:727-831) and gemma_tpu/ops/stats.py:46 chisq_sf on its
//   statistic and on the LRT difference 2 (logl_H1 - logl_H0)
//   (gemma_tpu/models/mvlmm.py:479, :642).
//
// Per lane: EigenProc of its (Vg, Ve); one float64 pass over n for the
// whitened Gram blocks of the whole design (covariates X0, the lane's
// rows but the last, and the tested row x) and its xHiy; then per
// whitened phenotype l the eliminated x'P x and x'P y (Qi is block
// diagonal in l, so x'Px is diagonal), beta = UltVeh' bhat, Vbeta =
// UltVeh' diag(1/x'Px) UltVeh, the statistic Σ bhat x'Py and p =
// Q_χ²(d)(stat) (tails.cuh); where logl1 is given also p_lrt =
// Q_χ²(d)(2 (logl1 - logl0)).  Two forms:
//
// * The warp form (d·c small: d <= 2 and c <= 4, d <= 4 and c <= 3, or
//   d <= 8 and c <= 2, where eval, X0 and Y fit shared memory in float64;
//   k10w_warp): a warp a lane, eight lanes a block, no barrier but the
//   warp's on a lane's path.  eval, X0 and Y are staged once a block in
//   float64; the lane's own rows go to shared memory by cp.async while
//   EigenProc runs (where two blocks an SM still fit).  Each thread takes
//   the individuals k ≡ its lane (mod 32) in increasing k and keeps all
//   d (c(c+1)/2 + c) sums in registers (an instantiation per bound of
//   (d, c)), then a butterfly of shuffles.  EigenProc on the warp
//   (k10w_eigen_proc: at d = 2 on lane 0 with the closed-form 2×2 eigh;
//   above, the products an entry a lane and Jacobi in parallel order,
//   d/2 disjoint rotations a round, k10w_jacobi); the d eliminations one
//   l a thread, beta and Vbeta an entry a thread, the two χ² tails on
//   threads 0 and 16.  Where the lanes share (Vg, Ve) (vstride = 0, the
//   score test) EigenProc, the weights w = 1/(δ D_l + 1) with z = A y
//   (in shared memory where they fit) and the covariate-only sums are
//   made once a block, by the same expressions as a lane's, so the two
//   give the same numbers bit for bit.
// * The team form, every other shape: a team of warps a lane
//   (mvlmm_lane.cuh), the teams taking their lanes from the launch's
//   counter; the pass on the team (mv_pass); EigenProc on the team's
//   first warp (k10w_eigen_proc), once a team where the lanes share (Vg,
//   Ve); the tail spread over the team:
//   l on warp l mod W (the cw × cw inverse by Gauss-Jordan on the warp,
//   mv_w_inv_logdet), beta and Vbeta an entry a thread, the χ² tails on
//   threads 0 and 32, its working set in the team's staging buffer
//   (shared memory).  Beyond d = 8 or 10 design rows the run-time-sized
//   form (MD = MC = 0) keeps a lane's matrices, sums and frame in the
//   team's shared memory up to K10_SMEM_STATE bytes, in `scratch`
//   (mph_calc_p_lane_bytes a lane) beyond.
//
// Every sum's order depends on (n, d, c) and the form alone, never on the
// lanes a block holds or where a launch was split.
//
// Bound: bytes at small c — one read of the lane's rows (r n values) and
// of the shared operands from L2 — and O(n d c²) float64 operations.
#include "mvlmm_lane.cuh"
#include "test_sums.cuh"

#define K10W_WARPS 8   // lanes (warps) a block of the warp form
#define K10W_MINB 2    // blocks an SM the warp form's launch bounds ask for

// the pass: the whitened Gram blocks of the whole design and its xHiy
__host__ __device__ inline void mv_p_pass(MvPass& P, int d, int c) {
  mv_pass_begin(P, d, c);
  mv_pass_add(P, F_Q, 0);     // FC_Q
  mv_pass_add(P, F_XWZ);      // FC_XWZ
}

// doubles of a lane's state: the matrices, the sums and the team's
// temporaries (the team's shared memory in the fixed instantiation, the
// lane's scratch beyond it)
__host__ __device__ inline long mv_p_state(int d, int c) {
  MvPass P;
  mv_p_pass(P, d, c);
  return mv_state_len(d, c) + mv_pass_size(P) + mv_tframe_len(d, c);
}

// ---------------------------------------------------------------------------
// the warp form

// the instantiation (MD, MC) that holds (d, c): 0 (2, 2), 1 (2, 4),
// 2 (4, 3), 3 (8, 2); -1: the team form
__host__ __device__ inline int k10w_inst(int d, int c) {
  if (d <= 2 && c <= 2) return 0;
  if (d <= 2 && c <= 4) return 1;
  if (d <= 4 && c <= 3) return 2;
  if (d <= 8 && c <= 2) return 3;
  return -1;
}

// a lane's sums for one l: the Gram's upper triangle (row-major, mv_ti),
// then xWz (c)
__host__ __device__ inline int k10w_per_l(int c) {
  return c * (c + 1) / 2 + c;
}

// The warp form's dynamic shared memory, byte offsets: eval, X0, Y staged
// once a block in float64 (common: the warp form runs where they fit,
// k10w_warp); where the lanes share (Vg, Ve)
// the block's w and z (d × n each, where they fit) and the block's
// region (D, A, Uh, Ul, the covariate-only sums in a lane's layout);
// each lane's own rows (where two blocks an SM still fit); then a region
// a warp: D, A, Uh, Ul, the lane's sums, a frame for EigenProc or the
// tail.
struct K10wLay {
  int common, wz, rows;
  long o_wz, o_blk, o_rows, o_warp, warp, rbytes, bytes;
};

__host__ __device__ inline long k10w_frame(int d, int c) {
  const long dd = (long)d * d, cw = c - 1;
  const long eig = 8 * dd + 5L * d;        // EigenProc with its eigh
  const long tail = 3L * d + d * (2 * cw * cw + cw);
  return eig > tail ? eig : tail;
}

__host__ __device__ inline K10wLay k10w_layout(int n, int d, int c0, int c,
                                               int isz, int shared) {
  K10wLay g;
  const long dd = (long)d * d, nsum = (long)d * k10w_per_l(c);
  const long region = 3 * dd + d + nsum;
  g.warp = 8 * (region + k10w_frame(d, c));
  g.rbytes = gt_r16((long)(c - c0) * n * isz);   // a lane's own rows
  const long fixed = (shared ? gt_r16(8 * region) : 0) + K10W_WARPS * g.warp;
  const long cb = mv_common_bytes(n, d, c0, 8);   // staged in float64
  const long wzb = shared ? 16L * d * n : 0;
  long used = fixed;
  g.common = used + cb <= MV_SMEM_MAX;
  used += g.common ? cb : 0;
  g.wz = shared && used + wzb <= MV_SMEM_MAX;
  used += g.wz ? wzb : 0;
  g.rows = used + K10W_WARPS * g.rbytes <= MV_SMEM_MAX / K10W_MINB;
  g.o_wz = g.common ? cb : 0;
  g.o_blk = g.o_wz + (g.wz ? wzb : 0);
  g.o_rows = g.o_blk + (shared ? gt_r16(8 * region) : 0);
  g.o_warp = g.o_rows + (g.rows ? K10W_WARPS * g.rbytes : 0);
  g.bytes = g.o_warp + K10W_WARPS * g.warp;
  return g;
}

// whether a launch at (n, d, c0, c) takes the warp form: an instantiation
// holds (d, c) and the block's operands fit its shared memory in float64
// (as where the lanes share (Vg, Ve), the larger layout)
__host__ __device__ inline bool k10w_warp(int n, int d, int c0, int c,
                                          int isz) {
  return k10w_inst(d, c) >= 0 && k10w_layout(n, d, c0, c, isz, 1).common;
}

// the weight of individual k in phenotype l, and z_l = (A y)_l: the
// expressions every path of the warp form shares
__device__ __forceinline__ double k10w_weight(double Dl, double dl) {
  return __drcp_rn(__fma_rn(Dl, dl, 1.0));
}
__device__ __forceinline__ double k10w_z(const double* A, const double* y,
                                         int d, int l, int n, int k) {
  double z = 0.0;
  for (int m = 0; m < d; ++m) z = __fma_rn(A[l * d + m], y[(long)m * n + k], z);
  return z;
}

#define K10_JACOBI_NEAR 1e-20
#define K10_JACOBI_GAIN 0.5

// pair i of round r of the circle method over m (even) indices: index 0
// stays, the others turn by one a round; every pair meets once in m - 1
// rounds.  p < q; q >= d marks an index that pads an odd d.
__device__ __forceinline__ void k10_pair(int r, int i, int m, int& p,
                                         int& q) {
  auto at = [&](int k) { return k == 0 ? 0 : (r + k - 1) % (m - 1) + 1; };
  p = at(i);
  q = at(m - 1 - i);
  if (p > q) {
    const int t = p;
    p = q;
    q = t;
  }
}

// Symmetric d×d eigh (d > 2) on one warp: cyclic Jacobi in parallel
// order, each sweep m - 1 rounds of m/2 disjoint rotations (the circle
// method), a round's angles one a lane (mv_eigh's formulas), then the
// column updates of every rotation an (index, rotation) a lane and the
// row updates likewise.  The sweeps stop as mv_eigh's (off-diagonal squares at
// most MV_JACOBI_TOL of the diagonal's, summed by the warp's butterfly)
// or, once they are below K10_JACOBI_NEAR of it (quadratic convergence
// takes them from there to MV_JACOBI_TOL in a sweep), where a sweep no
// longer cuts them below K10_JACOBI_GAIN of the last sweep's: rounding's
// floor, which can lie above MV_JACOBI_TOL, where mv_eigh runs all
// MV_JACOBI_SWEEPS sweeps.
// Then eigenvalues ascending and each eigenvector's sign as mv_eigh's on
// lane 0.  M is overwritten; `fr` holds d² + d doubles.  Ends with the
// warp's barrier.
__device__ inline void k10w_jacobi(int ln, int d, double* M, double* w,
                                   double* V, double* fr) {
  const int m = d + (d & 1), h = m / 2;
  double* cs = fr;
  double* sn = fr + h;
  int* pq = reinterpret_cast<int*>(fr + 2 * h);   // a round's pairs
  for (int i = ln; i < d * d; i += 32) V[i] = i % (d + 1) == 0 ? 1.0 : 0.0;
  __syncwarp();
  double last = INFINITY;
  for (int sweep = 0; sweep < MV_JACOBI_SWEEPS; ++sweep) {
    double off = 0.0, dg = 0.0;
    for (int e = ln; e < d * d; e += 32) {
      const int i = e / d, j = e % d;
      if (i == j) dg += M[e] * M[e];
      else if (i < j) off += M[e] * M[e];
    }
    off = gt_warp_sum(off);
    dg = gt_warp_sum(dg);
    if (!(off > MV_JACOBI_TOL * dg) ||
        (off <= K10_JACOBI_NEAR * dg && !(off < K10_JACOBI_GAIN * last)))
      break;
    last = off;
    for (int r = 0; r < m - 1; ++r) {
      for (int i = ln; i < h; i += 32) {
        int p, q;
        k10_pair(r, i, m, p, q);
        double c = 1.0, s = 0.0;
        if (q < d && M[p * d + q] != 0.0) {
          const double apq = M[p * d + q];
          const double theta = (M[q * d + q] - M[p * d + p]) / (2.0 * apq);
          const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                           (fabs(theta) + sqrt(theta * theta + 1.0));
          c = 1.0 / sqrt(t * t + 1.0);
          s = t * c;
        }
        cs[i] = c;
        sn[i] = s;
        pq[2 * i] = p;
        pq[2 * i + 1] = q;
      }
      __syncwarp();
      // the columns p, q of M and V: an (index, rotation) a lane
      for (int e = ln; e < d * h; e += 32) {
        const int k = e / h, i = e % h;
        const double c = cs[i], s = sn[i];
        if (s == 0.0) continue;
        const int p = pq[2 * i], q = pq[2 * i + 1];
        const double mp = M[k * d + p], mq = M[k * d + q];
        M[k * d + p] = c * mp - s * mq;
        M[k * d + q] = s * mp + c * mq;
        const double vp = V[k * d + p], vq = V[k * d + q];
        V[k * d + p] = c * vp - s * vq;
        V[k * d + q] = s * vp + c * vq;
      }
      __syncwarp();
      // then the rows p, q of M
      for (int e = ln; e < d * h; e += 32) {
        const int k = e / h, i = e % h;
        const double c = cs[i], s = sn[i];
        if (s == 0.0) continue;
        const int p = pq[2 * i], q = pq[2 * i + 1];
        const double mp = M[p * d + k], mq = M[q * d + k];
        M[p * d + k] = c * mp - s * mq;
        M[q * d + k] = s * mp + c * mq;
      }
      __syncwarp();
    }
  }
  if (ln == 0) {
    // ascending, stable; then each eigenvector's sign (its largest
    // entry positive)
    int* ord = reinterpret_cast<int*>(fr + d * d);
    double* Vs = fr;
    for (int i = 0; i < d; ++i) ord[i] = i;
    for (int i = 1; i < d; ++i) {
      const int o = ord[i];
      int j = i;
      while (j > 0 && M[ord[j - 1] * d + ord[j - 1]] > M[o * d + o]) {
        ord[j] = ord[j - 1];
        --j;
      }
      ord[j] = o;
    }
    for (int j = 0; j < d; ++j) {
      w[j] = M[ord[j] * d + ord[j]];
      for (int i = 0; i < d; ++i) Vs[i * d + j] = V[i * d + ord[j]];
    }
    for (int j = 0; j < d; ++j) {
      int big = 0;
      for (int i = 1; i < d; ++i)
        if (fabs(Vs[i * d + j]) > fabs(Vs[big * d + j])) big = i;
      const bool neg = Vs[big * d + j] < 0.0;
      for (int i = 0; i < d; ++i)
        V[i * d + j] = neg ? -Vs[i * d + j] : Vs[i * d + j];
    }
  }
  __syncwarp();
}

// the 2×2 closed form on lane 0, Jacobi on the warp above; then the
// warp's barrier
__device__ inline void k10w_eigh(int ln, int d, double* M, double* w,
                                 double* V, double* fr) {
  if (d == 2) {
    if (ln == 0) mv_eigh2(M, w, V);
    __syncwarp();
  } else {
    k10w_jacobi(ln, d, M, w, V, fr);
  }
}

// EigenProc (mvlmm_core.py:106-128) into D, Ul, Uh = Ul'Veh, A =
// Ul'Vehi: mv_t_eigen_proc's entries, each as one thread computes it, the
// eighs by k10w_eigh; on the warp's lanes (ONE false), or on one thread
// (ONE: the 2×2 form, whose few entries do not pay the warp's barriers).
// `fr`: 8 d² + 5 d doubles.
template <bool ONE>
__device__ inline void k10w_ep(int ln, int d, const double* Vg,
                               const double* Ve, double* D, double* Ul,
                               double* Uh, double* A, double* fr) {
  const int dd = d * d, step = ONE ? 1 : 32;
  auto sync = [] {
    if constexpr (!ONE) __syncwarp();
  };
  auto eigh = [&](double* M, double* w, double* V, double* et) {
    if constexpr (ONE)
      mv_eigh2(M, w, V);
    else
      k10w_eigh(ln, d, M, w, V, et);
  };
  double* M = fr;
  double* ev = M + dd;
  double* Uv = ev + d;
  double* sq = Uv + dd;
  double* isq = sq + d;
  double* Veh = isq + d;
  double* Vehi = Veh + dd;
  double* T = Vehi + dd;
  double* et = T + dd;     // eigh's d² + d
  for (int i = ln; i < dd; i += step) M[i] = Ve[i];
  sync();
  eigh(M, ev, Uv, et);
  for (int k = ln; k < d; k += step) {
    const bool pos = ev[k] > 0.0;
    const double r = sqrt(pos ? ev[k] : 1.0);
    sq[k] = pos ? r : 0.0;
    isq[k] = pos ? 1.0 / r : 0.0;
  }
  sync();
  for (int e = ln; e < dd; e += step) {
    const int i = e / d, j = e % d;
    double a = 0.0, b = 0.0;
    for (int k = 0; k < d; ++k) {
      a += Uv[i * d + k] * sq[k] * Uv[j * d + k];
      b += Uv[i * d + k] * isq[k] * Uv[j * d + k];
    }
    Veh[e] = a;
    Vehi[e] = b;
  }
  sync();
  for (int e = ln; e < dd; e += step) {
    const int i = e / d, j = e % d;
    double a = 0.0;
    for (int k = 0; k < d; ++k) a += Vehi[i * d + k] * Vg[k * d + j];
    T[e] = a;
  }
  sync();
  for (int e = ln; e < dd; e += step) {
    const int i = e / d, j = e % d;
    double a = 0.0;
    for (int k = 0; k < d; ++k) a += T[i * d + k] * Vehi[k * d + j];
    M[e] = a;
  }
  sync();
  eigh(M, D, Ul, et);
  for (int l = ln; l < d; l += step)
    if (D[l] < 0.0) D[l] = 0.0;
  for (int e = ln; e < dd; e += step) {
    const int l = e / d, j = e % d;
    double a = 0.0, b = 0.0;
    for (int k = 0; k < d; ++k) {
      a += Ul[k * d + l] * Veh[k * d + j];
      b += Ul[k * d + l] * Vehi[k * d + j];
    }
    Uh[e] = a;
    A[e] = b;
  }
}

// EigenProc on one warp (ln its lane): at d = 2 on lane 0, above on the
// warp; ends with the warp's barrier
__device__ inline void k10w_eigen_proc(int ln, int d, const double* Vg,
                                       const double* Ve, double* D,
                                       double* Ul, double* Uh, double* A,
                                       double* fr) {
  if (d == 2) {
    if (ln == 0) k10w_ep<true>(0, d, Vg, Ve, D, Ul, Uh, A, fr);
  } else {
    k10w_ep<false>(ln, d, Vg, Ve, D, Ul, Uh, A, fr);
  }
  __syncwarp();
}

// A lane's sums on its warp, thread ln taking the individuals k ≡ ln (mod
// 32) in increasing k: per l the Gram Σ w x_i x_j (i <= j) and xWz Σ x_i
// w z, each product (x_i x_j) w or (x_i w) z added by one fused
// multiply-add; then the warp's butterfly, and lane 0 stores them at
// `out` in the runtime layout (l k10w_per_l(c) + mv_ti(i, j, c), then
// c (c+1)/2 + i).  With `own` only the sums that touch the lane's own
// rows (i or j >= c0; the block takes the others, k10w_cov_sums).  w and
// z from `wz` (d × n each) where given, else from D, A and Y.
template <typename T, int MD, int MC>
__device__ __forceinline__ void k10w_sums(int ln, int n, int d, int c0,
                                          int c, const double* ev,
                                          const double* x0, const double* y,
                                          const T* R,
                                          const double* D, const double* A,
                                          const double* wz, bool own,
                                          double* out) {
  constexpr int G = MC * (MC + 1) / 2, PL = G + MC;
  double acc[MD * PL];
#pragma unroll
  for (int q = 0; q < MD * PL; ++q) acc[q] = 0.0;
  auto want = [&](int i, int j) {   // j >= i; -1: xWz of i
    return !own || (j < 0 ? i : j) >= c0;
  };
  // the lane's rows of the next individual, loaded one ahead, by design
  // row
  T nx[MC];
  auto load = [&](int k) {
#pragma unroll
    for (int i = 0; i < MC; ++i)
      nx[i] = i >= c0 && i < c && k < n ? R[(long)(i - c0) * n + k] : T(0);
  };
  load(ln);
  for (int k = ln; k < n; k += 32) {
    double x[MC];
#pragma unroll
    for (int i = 0; i < MC; ++i)
      if (i < c) x[i] = i < c0 ? x0[(long)i * n + k] : (double)nx[i];
    load(k + 32);
    const double dl = ev[k];
#pragma unroll
    for (int l = 0; l < MD; ++l) {
      if (l >= d) break;
      double w, z;
      if (wz != nullptr) {
        w = wz[(long)l * n + k];
        z = wz[(long)(d + l) * n + k];
      } else {
        w = k10w_weight(D[l], dl);
        z = k10w_z(A, y, d, l, n, k);
      }
#pragma unroll
      for (int i = 0; i < MC; ++i)
#pragma unroll
        for (int j = i; j < MC; ++j) {
          const int q = l * PL + i * MC - i * (i - 1) / 2 + (j - i);
          if (j < c && want(i, j))
            acc[q] = __fma_rn(__dmul_rn(x[i], x[j]), w, acc[q]);
        }
#pragma unroll
      for (int i = 0; i < MC; ++i)
        if (i < c && want(i, -1))
          acc[l * PL + G + i] =
              __fma_rn(__dmul_rn(x[i], w), z, acc[l * PL + G + i]);
    }
  }
  const int pl = k10w_per_l(c), g = c * (c + 1) / 2;
#pragma unroll
  for (int l = 0; l < MD; ++l) {
    if (l >= d) break;
#pragma unroll
    for (int i = 0; i < MC; ++i) {
#pragma unroll
      for (int j = i; j < MC; ++j) {
        const int q = l * PL + i * MC - i * (i - 1) / 2 + (j - i);
        if (j < c && want(i, j)) {
          const double v = gt_warp_sum(acc[q]);
          if (ln == 0) out[l * pl + mv_ti(i, j, c)] = v;
        }
      }
      if (i < c && want(i, -1)) {
        const double v = gt_warp_sum(acc[l * PL + G + i]);
        if (ln == 0) out[l * pl + g + i] = v;
      }
    }
  }
}

// The covariate-only sums of the block (shared (Vg, Ve)), one sum a warp
// in turn over the block's warps: each as k10w_sums takes it (thread ln
// the individuals k ≡ ln (mod 32) in increasing k, the same fused
// multiply-adds, the butterfly), so the same numbers bit for bit; into
// `out` in a lane's layout.
__device__ inline void k10w_cov_sums(int warp, int ln, int n, int d, int c0,
                                     int c, const double* ev,
                                     const double* x0, const double* y,
                                     const double* D,
                                     const double* A, const double* wz,
                                     double* out) {
  const int g0 = c0 * (c0 + 1) / 2, per = g0 + c0;   // a phenotype's
  const int pl = k10w_per_l(c), g = c * (c + 1) / 2;
  for (int q = warp; q < d * per; q += K10W_WARPS) {
    const int l = q / per, e = q % per;
    int i, j = -1;
    if (e < g0)
      mv_tri_decode(e, c0, i, j);
    else
      i = e - g0;
    double acc = 0.0;
    for (int k = ln; k < n; k += 32) {
      const double w = wz != nullptr ? wz[(long)l * n + k]
                                     : k10w_weight(D[l], ev[k]);
      const double xi = x0[(long)i * n + k];
      if (j >= 0) {
        acc = __fma_rn(__dmul_rn(xi, x0[(long)j * n + k]), w, acc);
      } else {
        const double z = wz != nullptr ? wz[(long)(d + l) * n + k]
                                       : k10w_z(A, y, d, l, n, k);
        acc = __fma_rn(__dmul_rn(xi, w), z, acc);
      }
    }
    acc = gt_warp_sum(acc);
    if (ln == 0) out[l * pl + (j >= 0 ? mv_ti(i, j, c) : g + i)] = acc;
  }
}

template <typename T, int MD, int MC>
__global__ void __launch_bounds__(32 * K10W_WARPS, K10W_MINB)
mph_calc_p_warp_kernel(int n, int d, int c0, int r,
                       const T* __restrict__ eval, const T* __restrict__ X0,
                       const T* __restrict__ Y, const T* __restrict__ R,
                       const double* __restrict__ Vg,
                       const double* __restrict__ Ve, int vstride,
                       const double* __restrict__ logl1,
                       const double* __restrict__ logl0, int l0stride,
                       double* stat_out, double* p_out, double* beta_out,
                       double* Vbeta_out, double* p_lrt_out, K10wLay g,
                       int s0, int count) {
  extern __shared__ __align__(16) double mv_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(mv_smem);
  const int c = c0 + r, cw = c - 1, dd = d * d;
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int pl = k10w_per_l(c), nsum = d * pl, g0 = c * (c + 1) / 2;
  const bool shared = vstride == 0;
  // eval, X0 and Y, once a block, in float64
  double* cm = mv_smem;
  const long m = (long)(1 + c0 + d) * n;
  for (long i = threadIdx.x; i < m; i += blockDim.x)
    cm[i] = i < n ? (double)eval[i]
                  : i < (long)(1 + c0) * n ? (double)X0[i - n]
                                           : (double)Y[i - (long)(1 + c0) * n];
  const double* ev = cm;
  const double* x0 = cm + n;
  const double* y = cm + (long)(1 + c0) * n;
  double* reg = reinterpret_cast<double*>(sm + g.o_warp + warp * g.warp);
  double* fr = reg + 3 * dd + d + nsum;
  const int li = blockIdx.x * K10W_WARPS + warp;
  const bool live = li < count;
  const int lane = s0 + (live ? li : 0);
  // the lane's own rows into shared memory (where they fit), in flight
  // through EigenProc
  const T* Rl = R + (long)lane * r * n;
  if (g.rows && live) {
    T* rs = reinterpret_cast<T*>(sm + g.o_rows + warp * g.rbytes);
    for (int e = ln; e < r * n; e += 32) ts_cp(rs + e, Rl + e, true);
    ts_commit();
    Rl = rs;
  }
  MvProf pf;
  pf.start(ln == 0 && live);
  // D, A, Uh, Ul of the lane, or of the block where the lanes share them
  double* base = shared ? reinterpret_cast<double*>(sm + g.o_blk) : reg;
  double *D = base, *A = D + d, *Uh = A + dd, *Ul = Uh + dd;
  double* sums = reg + 3 * dd + d;
  const double* wz = nullptr;
  if (shared) {
    __syncthreads();   // the staged operands
    if (warp == 0) k10w_eigen_proc(ln, d, Vg, Ve, D, Ul, Uh, A, fr);
    __syncthreads();
    pf.mark(MV_PH_EIGEN);
    if (g.wz) {
      double* w = reinterpret_cast<double*>(sm + g.o_wz);
      for (long e = threadIdx.x; e < (long)d * n; e += blockDim.x) {
        const int l = (int)(e / n), k = (int)(e % n);
        w[e] = k10w_weight(D[l], ev[k]);
        w[(long)d * n + e] = k10w_z(A, y, d, l, n, k);
      }
      wz = w;
      __syncthreads();
      pf.mark(MV_PH_STAGE);
    }
    // the covariate-only sums, once a block into the block's region
    double* bsum = Ul + dd;
    k10w_cov_sums(warp, ln, n, d, c0, c, ev, x0, y, D, A, wz, bsum);
    __syncthreads();
    if (!live) return;
    for (int e = ln; e < g0 + c; e += 32) {
      bool cov = e - g0 < c0;          // xWz of a covariate
      if (e < g0) {                    // a pair of covariates
        int a, b;
        mv_tri_decode(e, c, a, b);
        cov = b < c0;
      }
      if (cov)
        for (int l = 0; l < d; ++l) sums[l * pl + e] = bsum[l * pl + e];
    }
  } else {
    __syncthreads();   // the staged operands
    if (!live) return;
    k10w_eigen_proc(ln, d, Vg + (long)lane * vstride,
                    Ve + (long)lane * vstride, D, Ul, Uh, A, fr);
    pf.mark(MV_PH_EIGEN);
  }
  if (g.rows) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();
  }
  k10w_sums<T, MD, MC>(ln, n, d, c0, c, ev, x0, y, Rl, D, A, wz, shared,
                       sums);
  pf.count(MV_PC_LANES, 1);
  pf.mark(MV_PH_SUMS);
  __syncwarp();
  // the eliminations: l on thread l
  double* xPx = fr;
  double* xPy = xPx + d;
  double* bhat = xPy + d;
  if (ln < d) {
    const int l = ln;
    const long per = 2L * cw * cw + cw;
    double* Q = bhat + d + l * per;
    double* Qi = Q + cw * cw;
    double* whx = Qi + cw * cw;
    const double* s = sums + l * pl;
    for (int i = 0; i < cw; ++i) {
      for (int j = 0; j < cw; ++j) Q[i * cw + j] = s[mv_ti(i, j, c)];
      whx[i] = s[mv_ti(i, cw, c)];
    }
    double ld;
    if (cw > 0) mv_inv_logdet<MC>(cw, Q, Qi, ld, nullptr);
    double px = s[mv_ti(cw, cw, c)];
    double py = s[g0 + cw];
    for (int i = 0; i < cw; ++i) {
      double qw = 0.0;
      for (int j = 0; j < cw; ++j) qw += Qi[i * cw + j] * whx[j];
      px -= whx[i] * qw;
      py -= qw * s[g0 + i];
    }
    xPx[l] = px;
    xPy[l] = py;
    bhat[l] = py / px;
  }
  __syncwarp();
  // beta and Vbeta an entry a thread
  for (int e = ln; e < d + dd; e += 32) {
    if (e < d) {
      double b = 0.0;
      for (int l = 0; l < d; ++l) b += Uh[l * d + e] * bhat[l];
      beta_out[(long)lane * d + e] = b;
    } else {
      const int i = (e - d) / d, j = (e - d) % d;
      double v = 0.0;
      for (int l = 0; l < d; ++l) v += Uh[l * d + i] * Uh[l * d + j] / xPx[l];
      Vbeta_out[(long)lane * dd + i * d + j] = v;
    }
  }
  pf.mark(MV_PH_GLS);
  // the statistic's tail on thread 0, the LRT's on thread 16
  if (ln == 0 || (ln == 16 && logl1 != nullptr)) {
    double stat = 0.0;
    for (int l = 0; l < d; ++l) stat += bhat[l] * xPy[l];
    const double x =
        ln == 0 ? stat
                : 2.0 * (logl1[lane] - logl0[(long)lane * l0stride]);
    const double pv = gt_chisq_sf(x, (double)d);
    if (ln == 0) {
      stat_out[lane] = stat;
      p_out[lane] = pv;
    } else {
      p_lrt_out[lane] = pv;
    }
  }
  pf.mark(MV_PH_STEP);
  pf.flush();
}

// ---------------------------------------------------------------------------
// the team form

// The tail of a lane on its team, after the pass: l on warp l mod W, its
// cw × cw inverse on the warp (mv_w_inv_logdet, or the adjugate at cw <=
// 2 on the warp's lane 0), (Qi whx)_i a thread an i, then x'Px, x'Py and
// bhat on the warp's lane 0 in i order; beta and Vbeta an entry a thread;
// the χ² tails on threads 0 and 32.  Each value as the one-thread tail
// computed it.  `tb`: 3 d + d (2 cw² + 3 cw) doubles, team-shared.
template <int MC>
__device__ inline void k10_team_tail(const MvTeam& tm, const double* acc,
                                     const MvPass& P,
                                     const MvState<0, 0>& s, double* tb,
                                     int lane, const double* logl1,
                                     const double* logl0, int l0stride,
                                     double* stat_out, double* p_out,
                                     double* beta_out, double* Vbeta_out,
                                     double* p_lrt_out, MvProf& pf) {
  const int d = P.d, c = P.c, cw = c - 1, dd = d * d;
  double* xPx = tb;
  double* xPy = xPx + d;
  double* bhat = xPy + d;
  const long per = 2L * cw * cw + 3L * cw;
  for (int l = tm.warp; l < d; l += tm.W) {
    double* Q = bhat + d + l * per;
    double* Qi = Q + cw * cw;
    double* whx = Qi + cw * cw;
    double* qw = whx + cw;
    double* f = qw + cw;
    for (int e = tm.lane; e < cw * cw; e += 32)
      Q[e] = mv_q(acc, P, FC_Q, l, e / cw, e % cw);
    for (int i = tm.lane; i < cw; i += 32)
      whx[i] = mv_q(acc, P, FC_Q, l, i, cw);
    __syncwarp();
    if (cw > 2) {
      mv_w_inv_logdet(tm.lane, cw, Q, Qi, f);
    } else if (cw > 0 && tm.lane == 0) {
      double ld;
      mv_inv_logdet<MC>(cw, Q, Qi, ld, f);
    }
    __syncwarp();
    for (int i = tm.lane; i < cw; i += 32) {
      double a = 0.0;
      for (int j = 0; j < cw; ++j) a += Qi[i * cw + j] * whx[j];
      qw[i] = a;
    }
    __syncwarp();
    if (tm.lane == 0) {
      double px = mv_q(acc, P, FC_Q, l, cw, cw);
      double py = mv_at(acc, P, FC_XWZ, l * c + cw);
      for (int i = 0; i < cw; ++i) {
        px -= whx[i] * qw[i];
        py -= qw[i] * mv_at(acc, P, FC_XWZ, l * c + i);
      }
      xPx[l] = px;
      xPy[l] = py;
      bhat[l] = py / px;
    }
    __syncwarp();
  }
  tm.sync();
  MV_TFOR(tm, e, d + dd) {
    if (e < d) {
      double b = 0.0;
      for (int l = 0; l < d; ++l) b += s.Uh[l * d + e] * bhat[l];
      beta_out[(long)lane * d + e] = b;
    } else {
      const int i = (e - d) / d, j = (e - d) % d;
      double v = 0.0;
      for (int l = 0; l < d; ++l)
        v += s.Uh[l * d + i] * s.Uh[l * d + j] / xPx[l];
      Vbeta_out[(long)lane * dd + i * d + j] = v;
    }
  }
  pf.mark(MV_PH_GLS);
  if (tm.rank == 0 || (tm.rank == 32 && logl1 != nullptr)) {
    double stat = 0.0;
    for (int l = 0; l < d; ++l) stat += bhat[l] * xPy[l];
    const double x =
        tm.rank == 0 ? stat
                     : 2.0 * (logl1[lane] - logl0[(long)lane * l0stride]);
    const double pv = gt_chisq_sf(x, (double)d);
    if (tm.rank == 0) {
      stat_out[lane] = stat;
      p_out[lane] = pv;
    } else {
      p_lrt_out[lane] = pv;
    }
  }
  pf.mark(MV_PH_STEP);
}

// doubles of the team tail's working set
__host__ __device__ inline long k10_tail_len(int d, int c) {
  const long cw = c - 1;
  return 3L * d + (long)d * (2 * cw * cw + 3 * cw);
}

// The run-time-sized form keeps a lane's matrices (Vg, Ve, A, Uh, Ul, D:
// 5 d² + d doubles), its sums and a frame for EigenProc and the tail in
// the team's shared memory (k10_smem_len doubles, which the geometry
// reserves) where they take at most K10_SMEM_STATE bytes: then no lane
// needs scratch.  Beyond, they live in the lane's scratch
// (mv_p_state doubles a lane) and EigenProc and the tail work in the
// staging buffer where they fit.
#define K10_SMEM_STATE (48 * 1024)
__host__ __device__ inline long k10_smem_len(int d, int c) {
  MvPass P;
  mv_p_pass(P, d, c);
  const long eig = 8L * d * d + 5L * d, tail = k10_tail_len(d, c);
  return 5L * d * d + d + mv_pass_size(P) + (eig > tail ? eig : tail);
}
__host__ __device__ inline bool k10_smem(int d, int c) {
  return mv_dyn(d, c) && 8 * k10_smem_len(d, c) <= K10_SMEM_STATE &&
         mv_nrow(d, c) <= 600;
}

// points the matrices K10 reads (Vg, Ve, A, Uh, Ul, D) into `w`
__device__ inline void k10_state_bind(MvState<0, 0>& s, double* w, int d) {
  const long dd = (long)d * d;
  s.Vg = w;
  s.Ve = s.Vg + dd;
  s.A = s.Ve + dd;
  s.Uh = s.A + dd;
  s.Ul = s.Uh + dd;
  s.D = s.Ul + dd;
  s.Qi = s.beta = s.Bc = s.Bn = nullptr;
}

template <typename T, int MD, int MC>
__global__ void __launch_bounds__(32 * MV_MAX_W, 1)
mph_calc_p_kernel(int n, int d, int c0, int r, const T* __restrict__ eval,
                  const T* __restrict__ X0, const T* __restrict__ Y,
                  const T* __restrict__ R, const double* __restrict__ Vg,
                  const double* __restrict__ Ve, int vstride,
                  const double* __restrict__ logl1,
                  const double* __restrict__ logl0, int l0stride,
                  double* stat_out, double* p_out, double* beta_out,
                  double* Vbeta_out, double* p_lrt_out, MvGeom geo, int* ctr,
                  int s0, int count, double* scratch) {
  extern __shared__ __align__(16) double mv_smem[];
  const int c = c0 + r, dd = d * d;
  const T *ev = eval, *x0 = X0, *y = Y;
  long cb = 0;
  if (geo.common) {
    T* cm = reinterpret_cast<T*>(mv_smem);
    const long m = (long)(1 + c0 + d) * n;
    for (long i = threadIdx.x; i < m; i += blockDim.x)
      cm[i] = i < n ? eval[i]
                    : i < (long)(1 + c0) * n ? X0[i - n] : Y[i - (long)(1 + c0) * n];
    __syncthreads();
    ev = cm;
    x0 = cm + n;
    y = cm + (long)(1 + c0) * n;
    cb = mv_common_bytes(n, d, c0, sizeof(T)) / 8;
  }
  MvTeam tm;
  tm.W = geo.W;
  tm.size = 32 * geo.W;
  tm.id = threadIdx.x / tm.size;
  tm.rank = threadIdx.x % tm.size;
  tm.warp = tm.rank / 32;
  tm.lane = tm.rank % 32;
  tm.whole = geo.L == 1;
  double* buf = mv_smem + cb + (long)tm.id * geo.team;
  const long nbuf = mv_team_buf(mv_nrow(d, c), geo.NB, geo.W);
  double* cbase = buf + nbuf;
  MvCtl<MvState<0, 0>>& ctl =
      *reinterpret_cast<MvCtl<MvState<0, 0>>*>(cbase);
  MvState<0, 0>& s = ctl.s;
  double* fixed = cbase + MV_CTL;
  MvPass P;
  mv_p_pass(P, d, c);
  // the run-time-sized form's state in the team's shared memory; else
  // EigenProc's frame and the tail's working set in the staging buffer
  // (free before and after the pass) where they fit
  const bool smem = MD == 0 && k10_smem(d, c);
  const bool tail_buf = !smem && k10_tail_len(d, c) <= nbuf;
  const bool eig_buf = !smem && 8L * d * d + 5L * d <= nbuf;
  // where the lanes share (Vg, Ve), the team's first lane's EigenProc
  // (its state stays bound) serves the team's later lanes
  bool eig = false;
  MvProf pf;
  pf.start(tm.leader());
  for (;;) {
    if (tm.leader()) ctl.lane = atomicAdd(ctr, 1);
    tm.sync();
    const int li = ctl.lane;
    if (li >= count) break;
    pf.count(MV_PC_LANES, 1);
    pf.mark(MV_PH_WAIT);
    const int lane = s0 + li;
    const MvLane<T> L = mv_lane(ev, x0, y, R, n, d, c0, r, lane);
    double* w = MD == 0 && !smem ? scratch + (long)li * mv_p_state(d, c)
                                 : fixed;
    double* acc = w + (smem ? 5L * dd + d : mv_state_len(d, c));
    double* fr = acc + mv_pass_size(P);
    if (!eig) {
      if (tm.leader()) {
        if (smem)
          k10_state_bind(s, w, d);
        else
          mv_state_bind(s, w, d, c);
      }
      tm.sync();
      MV_TFOR(tm, i, dd) {
        s.Vg[i] = Vg[(long)lane * vstride + i];
        s.Ve[i] = Ve[(long)lane * vstride + i];
      }
      tm.sync();
      if (tm.warp == 0)
        k10w_eigen_proc(tm.lane, d, s.Vg, s.Ve, s.D, s.Ul, s.Uh, s.A,
                        eig_buf ? buf : fr);
      tm.sync();
      eig = vstride == 0;
    }
    pf.mark(MV_PH_EIGEN);
    mv_pass<T, STAGE_Z>(tm, L, s, P, buf, geo.NB, acc, pf);
    k10_team_tail<MC>(tm, acc, P, s, tail_buf ? buf : fr, lane, logl1,
                      logl0, l0stride, stat_out, p_out, beta_out, Vbeta_out,
                      p_lrt_out, pf);
    tm.sync();
    pf.mark(MV_PH_WAIT);
    pf.flush();
  }
}

// the launch geometry of K10's team form at these sizes (mv_geom)
template <typename T>
__host__ inline MvGeom mv_p_geom(int count, int n, int d, int c0, int r) {
  const int c = c0 + r;
  return mv_geom(count, n, d, c0, c, sizeof(T),
                 !mv_dyn(d, c) ? mv_p_state(d, c)
                 : k10_smem(d, c) ? k10_smem_len(d, c) : 0);
}

// One field of K10's geometry: the team form's (mv_geom_field), or for
// the warp form W = 1, L = K10W_WARPS lanes a block, NB = 32, common, the
// doubles of a warp's region and the block's bytes (what = 5; 7 where the
// lanes share (Vg, Ve)); what = 6: 1 for the warp form, 0 for the team
// form; what = 8: whether a shared-(Vg, Ve) launch stages w and z.
template <typename T>
__host__ inline long mv_p_geom_field(int count, int n, int d, int c0, int r,
                                     int what) {
  const int c = c0 + r;
  const bool warp = k10w_warp(n, d, c0, c, sizeof(T));
  if (what == 6) return warp;
  if (!warp)
    return what > 6 ? 0
                    : mv_geom_field(mv_p_geom<T>(count, n, d, c0, r), what);
  const K10wLay g = k10w_layout(n, d, c0, c, sizeof(T), what >= 7);
  switch (what) {
    case 0: return 1;
    case 1: return K10W_WARPS;
    case 2: return 32;
    case 3: return g.common;
    case 4: return g.warp / 8;
    case 8: return g.wz;
  }
  return g.bytes;
}

template <typename T, int MD, int MC>
static int k10w_launch(int count, int n, int d, int c0, int r,
                       const void* eval, const void* X0, const void* Y,
                       const void* R, const void* Vg, const void* Ve,
                       int vstride, const void* logl1, const void* logl0,
                       int l0stride, void* stat, void* p, void* beta,
                       void* Vbeta, void* p_lrt, int s0, void* stream) {
  const K10wLay g =
      k10w_layout(n, d, c0, c0 + r, sizeof(T), vstride == 0);
  auto kern = mph_calc_p_warp_kernel<T, MD, MC>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)g.bytes);
  if (count > 0)
    kern<<<(count + K10W_WARPS - 1) / K10W_WARPS, 32 * K10W_WARPS, g.bytes,
           (cudaStream_t)stream>>>(
        n, d, c0, r, (const T*)eval, (const T*)X0, (const T*)Y, (const T*)R,
        (const double*)Vg, (const double*)Ve, vstride, (const double*)logl1,
        (const double*)logl0, l0stride, (double*)stat, (double*)p,
        (double*)beta, (double*)Vbeta, (double*)p_lrt, g, s0, count);
  return (int)cudaGetLastError();
}

#define MPH_CALC_P_LAUNCH(name, T)                                           \
  extern "C" int name##_launch(                                              \
      int S, int n, int d, int c0, int r, const void* eval, const void* X0,  \
      const void* Y, const void* R, const void* Vg, const void* Ve,          \
      int vstride, const void* logl1, const void* logl0, int l0stride,       \
      void* stat, void* p, void* beta, void* Vbeta, void* p_lrt, void* ctr,  \
      int s0, int count, void* scratch, void* stream) {                      \
    const int c = c0 + r;                                                    \
    switch (k10w_warp(n, d, c0, c, sizeof(T)) ? k10w_inst(d, c) : -1) {     \
      case 0:                                                                \
        return k10w_launch<T, 2, 2>(count, n, d, c0, r, eval, X0, Y, R, Vg,  \
                                    Ve, vstride, logl1, logl0, l0stride,     \
                                    stat, p, beta, Vbeta, p_lrt, s0,         \
                                    stream);                                 \
      case 1:                                                                \
        return k10w_launch<T, 2, 4>(count, n, d, c0, r, eval, X0, Y, R, Vg,  \
                                    Ve, vstride, logl1, logl0, l0stride,     \
                                    stat, p, beta, Vbeta, p_lrt, s0,         \
                                    stream);                                 \
      case 2:                                                                \
        return k10w_launch<T, 4, 3>(count, n, d, c0, r, eval, X0, Y, R, Vg,  \
                                    Ve, vstride, logl1, logl0, l0stride,     \
                                    stat, p, beta, Vbeta, p_lrt, s0,         \
                                    stream);                                 \
      case 3:                                                                \
        return k10w_launch<T, 8, 2>(count, n, d, c0, r, eval, X0, Y, R, Vg,  \
                                    Ve, vstride, logl1, logl0, l0stride,     \
                                    stat, p, beta, Vbeta, p_lrt, s0,         \
                                    stream);                                 \
    }                                                                        \
    const MvGeom g = mv_p_geom<T>(count, n, d, c0, r);                       \
    if (!mv_geom_ok(g, d, c)) return (int)cudaErrorInvalidValue;             \
    auto kern = mv_dyn(d, c) ? mph_calc_p_kernel<T, 0, 0>                    \
                             : mph_calc_p_kernel<T, MV_MAX_D, MV_MAX_C>;     \
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                         (int)g.bytes);                                      \
    if (count > 0)                                                           \
      kern<<<(count + g.L - 1) / g.L, 32 * g.W * g.L, g.bytes,               \
             (cudaStream_t)stream>>>(                                        \
          n, d, c0, r, (const T*)eval, (const T*)X0, (const T*)Y,            \
          (const T*)R, (const double*)Vg, (const double*)Ve, vstride,        \
          (const double*)logl1, (const double*)logl0, l0stride,              \
          (double*)stat, (double*)p, (double*)beta, (double*)Vbeta,          \
          (double*)p_lrt, g, (int*)ctr, s0, count, (double*)scratch);        \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" long name##_lane_bytes(int d, int c) {                          \
    return k10w_inst(d, c) < 0 && mv_dyn(d, c) && !k10_smem(d, c)          \
               ? 8 * mv_p_state(d, c) : 0;                                    \
  }                                                                          \
  extern "C" long name##_geometry(int count, int n, int d, int c0, int r,    \
                                  int what) {                                \
    return mv_p_geom_field<T>(count, n, d, c0, r, what);                     \
  }

// built once a precision (-DGT_ONLY=32 / 64, kernels.Kernel's `only`)
#if GT_ONLY != 64
MPH_CALC_P_LAUNCH(mph_calc_p, float)
#endif
#if GT_ONLY != 32
MPH_CALC_P_LAUNCH(mph_calc_p_f64, double)
#endif

GT_ERROR_FN(mph_calc_p)
