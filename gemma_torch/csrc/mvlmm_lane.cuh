// Shared device code of the mvLMM kernels K9 mph_em, K10 mph_calc_p and
// K11 mph_nr: one thread block per lane (SNP), float64 arithmetic
// throughout; the operands eval (n), X0 (c0, n), Y (d, n) and the lane's
// own rows R (r, n) are read in the operand type T (float in the speed
// mode, double in the parity mode).
//
// Every per-lane quantity is a sum over the n individuals of a product of
// per-individual values: in the whitened basis of (Vg, Ve) (EigenProc,
// mvlmm.cpp:213-282), with A = UltVehi, z_k = A y_k and the weights w_kl
// = 1/(δ_k D_l + 1), the Gram blocks Σ_k w_kl x_k x_k', xHiy = Σ_k w_kl
// z_kl x_k, the EM's outer products and the Newton derivatives' traces.
// A pass over n stages MV_CH individuals at a time in shared memory, one
// row per value (1, δ, δ², the design rows x_i, and up to five d-rows
// whose meaning the pass sets), and each thread owns up to MV_Q of the
// pass's sums: sum r is the product of up to six staged rows, named by
// its descriptor.  No sum is shared between threads, so no reduction and
// no atomics; the order of the additions is fixed (deterministic).  The
// small algebra (eigendecompositions, c×c inverses, the M-step, the
// Newton step) runs on thread 0.
//
// Passes are lists of families of sums (MvPass); the same lists give the
// kernels their accumulator layouts and the host the size of K11's
// scratch.
//
// The lane code is templated on (MD, MC), the bounds of d and c that its
// arrays are sized for.  (MV_MAX_D, MV_MAX_C) = (8, 10) is the first
// instantiation, the code the kernels always ran, in static shared memory
// and thread-local arrays.  (0, 0) is the form sized at run time for any
// d and c: the per-lane state, accumulators and thread 0's temporaries
// live in a per-lane slice of global scratch (the wrapper splits a launch's
// lanes under a byte budget, kernels.launch_lanes), and the staged rows in
// dynamic shared memory where they fit MV_ST_SMEM, else in that slice too.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "tails.cuh"

#define MV_MAX_D 8
#define MV_MAX_C 10
#define MV_THREADS 64
#define MV_CH 32
#define MV_Q 8
#define MV_NROW (3 + MV_MAX_C + 5 * MV_MAX_D)
#define MV_ST_SMEM (160 * 1024)  // largest dynamic staged rows (bytes)
#define MV_MAX_FAM 16
#define MV_TINY 2.2250738585072014e-308
#define MV_LOG_2PI 1.8378770664093453
#define MV_JACOBI_SWEEPS 50
#define MV_JACOBI_TOL 1e-30

// ---------------------------------------------------------------------------
// index helpers

__host__ __device__ inline int mv_tri(int c) { return c * (c + 1) / 2; }

// whether (d, c) takes the run-time-sized form
__host__ __device__ inline bool mv_dyn(int d, int c) {
  return d > MV_MAX_D || c > MV_MAX_C;
}

// staged rows of a lane: 1, δ, δ², the c design rows and five d-rows
__host__ __device__ inline int mv_nrow(int d, int c) { return 3 + c + 5 * d; }

// whether a lane of the run-time-sized form stages its rows in dynamic
// shared memory (else in its scratch)
__host__ __device__ inline bool mv_st_smem(int d, int c) {
  return (long)mv_nrow(d, c) * MV_CH * 8 <= MV_ST_SMEM;
}

// A thread's temporary array of n values of type U: a local array of the
// fixed instantiation's size N, or (N == 0) the next n values of the
// thread's frame `fr` in global scratch, which take() advances.
template <typename U, int N>
struct MvTmp {
  U a[N];
  __device__ __forceinline__ U* take(double*&, int) { return a; }
};
template <typename U>
struct MvTmp<U, 0> {
  __device__ __forceinline__ U* take(double*& fr, int n) {
    U* p = reinterpret_cast<U*>(fr);
    fr += ((long)n * sizeof(U) + 7) / 8;
    return p;
  }
};

// (i, j), i <= j, in row-major upper-triangle order
__host__ __device__ inline int mv_ti(int i, int j, int c) {
  if (j < i) {
    const int t = i;
    i = j;
    j = t;
  }
  return i * c - i * (i - 1) / 2 + (j - i);
}

__device__ inline void mv_tri_decode(int idx, int c, int& i, int& j) {
  i = 0;
  while (idx >= c - i) {
    idx -= c - i;
    ++i;
  }
  j = i + idx;
}

// GEMMA GetIndex pairs: parameter a < d(d+1)/2 ↔ (i, j), i <= j
__device__ inline void mv_vech_pair(int a, int d, int& i, int& j) {
  mv_tri_decode(a, d, i, j);
}

// ---------------------------------------------------------------------------
// families of sums and the passes built from them.  A family's sums are
// products of staged rows: t is the power of δ (row t: 1, δ, δ²), X(i)
// the design rows, W(l) the weights, Z(l), R3(l), R4(l), R5(l) the d-rows
// the pass stages.

enum {
  F_XX,    // (i <= j)            x_i x_j
  F_Q,     // (l; i <= j)         δ^t x_i x_j w_l
  F_XWZ,   // (l; i)              x_i w_l z_l
  F_QUAD,  // (l)                 z_l z_l w_l
  F_R3,    // (l)                 r3_l
  F_W,     // (l)                 δ^t w_l
  F_S1,    // (l; i)              r5_l x_i
  F_GG,    // (l <= m)            δ^t r4_l r4_m
  F_ZZ,    // (l <= m)            δ^t z_l z_m
  F_WWH,   // (l)                 δ^t w_l w_l r3_l
  F_WW,    // (l <= m)            δ^t w_l w_m
  F_N,     // (l <= m; i <= j)    δ^t x_i x_j w_l w_m
  F_K,     // (l; m <= q)         δ^t w_l z_m z_q
  F_F,     // (l; m; i)           δ^t x_i w_l z_m
  F_MTR    // (l; m)              δ^t w_l w_l r3_l w_m
};

__host__ __device__ inline int mv_fam_count(int kind, int d, int c) {
  switch (kind) {
    case F_XX: return mv_tri(c);
    case F_Q: return d * mv_tri(c);
    case F_XWZ:
    case F_S1: return d * c;
    case F_QUAD:
    case F_R3:
    case F_W:
    case F_WWH: return d;
    case F_GG:
    case F_ZZ:
    case F_WW: return mv_tri(d);
    case F_N: return mv_tri(d) * mv_tri(c);
    case F_K: return d * mv_tri(d);
    case F_F: return d * d * c;
    case F_MTR: return d * d;
  }
  return 0;
}

struct MvPass {
  int nf, d, c;
  int kind[MV_MAX_FAM];
  int t[MV_MAX_FAM];
  int base[MV_MAX_FAM + 1];
};

__host__ __device__ inline void mv_pass_begin(MvPass& P, int d, int c) {
  P.nf = 0;
  P.d = d;
  P.c = c;
  P.base[0] = 0;
}

// appends a family; returns its index in the pass
__host__ __device__ inline int mv_pass_add(MvPass& P, int kind, int t = 0) {
  P.kind[P.nf] = kind;
  P.t[P.nf] = t;
  P.base[P.nf + 1] = P.base[P.nf] + mv_fam_count(kind, P.d, P.c);
  return P.nf++;
}

__host__ __device__ inline int mv_pass_size(const MvPass& P) {
  return P.base[P.nf];
}

// the core of every likelihood pass, families 0-3: Q, XWZ, QUAD, R3 (log v)
enum { FC_Q = 0, FC_XWZ = 1, FC_QUAD = 2, FC_LOGV = 3 };

__host__ __device__ inline void mv_pass_core(MvPass& P, int d, int c) {
  mv_pass_begin(P, d, c);
  mv_pass_add(P, F_Q, 0);
  mv_pass_add(P, F_XWZ);
  mv_pass_add(P, F_QUAD);
  mv_pass_add(P, F_R3);
}

// staged rows
struct MvRows {
  int c, d;
  __device__ int X(int i) const { return 3 + i; }
  __device__ int W(int l) const { return 3 + c + l; }
  __device__ int Z(int l) const { return 3 + c + d + l; }
  __device__ int R3(int l) const { return 3 + c + 2 * d + l; }
  __device__ int R4(int l) const { return 3 + c + 3 * d + l; }
  __device__ int R5(int l) const { return 3 + c + 4 * d + l; }
};

// A sum's descriptor: its six row indices, 8 bits each in one word (the
// fixed instantiation: at most 53 rows) or 16 bits each (MvDesc6, the
// run-time-sized form).
struct MvDesc6 {
  unsigned short r[6];
};

template <typename D>
__device__ inline D mv_pack(int a, int b = 0, int c = 0, int d = 0, int e = 0,
                            int f = 0) {
  if constexpr (sizeof(D) == sizeof(unsigned long long)) {
    return (unsigned long long)a | ((unsigned long long)b << 8) |
           ((unsigned long long)c << 16) | ((unsigned long long)d << 24) |
           ((unsigned long long)e << 32) | ((unsigned long long)f << 40);
  } else {
    return MvDesc6{{(unsigned short)a, (unsigned short)b, (unsigned short)c,
                    (unsigned short)d, (unsigned short)e, (unsigned short)f}};
  }
}

__device__ __forceinline__ int mv_row(unsigned long long desc, int k) {
  return (int)((desc >> (8 * k)) & 0xff);
}
__device__ __forceinline__ int mv_row(const MvDesc6& desc, int k) {
  return desc.r[k];
}

// descriptor of sum r of pass P: six row indices (row 0 is all ones)
template <typename D>
__device__ inline D mv_desc(const MvPass& P, int r) {
  int f = 0;
  while (r >= P.base[f + 1]) ++f;
  const int loc = r - P.base[f];
  const int t = P.t[f], d = P.d, c = P.c;
  const MvRows R{c, d};
  int i, j, l, m, q;
  switch (P.kind[f]) {
    case F_XX:
      mv_tri_decode(loc, c, i, j);
      return mv_pack<D>(R.X(i), R.X(j));
    case F_Q:
      l = loc / mv_tri(c);
      mv_tri_decode(loc % mv_tri(c), c, i, j);
      return mv_pack<D>(t, R.X(i), R.X(j), R.W(l));
    case F_XWZ:
      l = loc / c;
      i = loc % c;
      return mv_pack<D>(R.X(i), R.W(l), R.Z(l));
    case F_QUAD:
      return mv_pack<D>(R.Z(loc), R.Z(loc), R.W(loc));
    case F_R3:
      return mv_pack<D>(R.R3(loc));
    case F_W:
      return mv_pack<D>(t, R.W(loc));
    case F_S1:
      l = loc / c;
      i = loc % c;
      return mv_pack<D>(R.R5(l), R.X(i));
    case F_GG:
      mv_tri_decode(loc, d, l, m);
      return mv_pack<D>(t, R.R4(l), R.R4(m));
    case F_ZZ:
      mv_tri_decode(loc, d, l, m);
      return mv_pack<D>(t, R.Z(l), R.Z(m));
    case F_WWH:
      return mv_pack<D>(t, R.W(loc), R.W(loc), R.R3(loc));
    case F_WW:
      mv_tri_decode(loc, d, l, m);
      return mv_pack<D>(t, R.W(l), R.W(m));
    case F_N:
      mv_tri_decode(loc / mv_tri(c), d, l, m);
      mv_tri_decode(loc % mv_tri(c), c, i, j);
      return mv_pack<D>(t, R.X(i), R.X(j), R.W(l), R.W(m));
    case F_K:
      l = loc / mv_tri(d);
      mv_tri_decode(loc % mv_tri(d), d, m, q);
      return mv_pack<D>(t, R.W(l), R.Z(m), R.Z(q));
    case F_F:
      l = loc / (d * c);
      m = (loc / c) % d;
      i = loc % c;
      return mv_pack<D>(t, R.X(i), R.W(l), R.Z(m));
    case F_MTR:
      l = loc / d;
      m = loc % d;
      return mv_pack<D>(t, R.W(l), R.W(l), R.R3(l), R.W(m));
  }
  return mv_pack<D>(0);
}

// accessors into a pass's accumulator
__device__ inline double mv_at(const double* acc, const MvPass& P, int f,
                               int loc) {
  return acc[P.base[f] + loc];
}
// F_Q / F_N blocks as full symmetric c×c
__device__ inline double mv_q(const double* acc, const MvPass& P, int f,
                              int l, int i, int j) {
  return acc[P.base[f] + l * mv_tri(P.c) + mv_ti(i, j, P.c)];
}
// F_ZZ / F_GG / F_WW as full symmetric d×d
__device__ inline double mv_dd(const double* acc, const MvPass& P, int f,
                               int l, int m) {
  return acc[P.base[f] + mv_ti(l, m, P.d)];
}

// ---------------------------------------------------------------------------
// the lane: operands and the per-lane state the stagers read

template <typename T>
struct MvLane {
  const T* eval;
  const T* X0;
  const T* Y;
  const T* R;     // the lane's rows
  int n, d, c0, r, c;
  __device__ double x(int i, int k) const {
    return i < c0 ? (double)X0[(long)i * n + k]
                  : (double)R[(long)(i - c0) * n + k];
  }
};

// per-lane small matrices, row-major, compact (d×d at stride d)
template <int MD, int MC>
struct MvState {
  double Vg[MD * MD], Ve[MD * MD];
  double D[MD];
  double A[MD * MD];    // UltVehi
  double Uh[MD * MD];   // UltVeh
  double Ul[MD * MD];   // eigenvectors of Ve^-1/2 Vg Ve^-1/2
  double Qi[MD * MC * MC];  // d inverse Gram blocks
  double beta[MD * MC];  // GLS coefficients, whitened (d, c)
  double Bc[MD * MC];    // ML: the carried UltVehiB (d, c)
  double Bn[MD * MC];    // ML: this iteration's UltVehiB
  double logdet_Ve, logl;
  int flag;
};

// the run-time-sized form: the same matrices in the lane's scratch (the
// state itself, pointers and scalars, stays in shared memory)
template <>
struct MvState<0, 0> {
  double *Vg, *Ve, *D, *A, *Uh, *Ul, *Qi, *beta, *Bc, *Bn;
  double logdet_Ve, logl;
  int flag;
};

// doubles of a run-time-sized state's matrices
__host__ __device__ inline long mv_state_len(int d, int c) {
  return 5L * d * d + d + (long)d * c * c + 3L * d * c;
}

// points the run-time-sized state into `w` (thread 0, before a barrier);
// returns the first double after it.  The fixed state needs nothing.
template <int MD, int MC>
__device__ inline double* mv_state_bind(MvState<MD, MC>& s, double* w, int d,
                                        int c) {
  if constexpr (MD == 0) {
    const long dd = (long)d * d, dc = (long)d * c;
    s.Vg = w;
    s.Ve = s.Vg + dd;
    s.A = s.Ve + dd;
    s.Uh = s.A + dd;
    s.Ul = s.Uh + dd;
    s.D = s.Ul + dd;
    s.Qi = s.D + d;
    s.beta = s.Qi + dc * c;
    s.Bc = s.beta + dc;
    s.Bn = s.Bc + dc;
    return s.Bn + dc;
  }
  return w;
}

// doubles of thread 0's frame in the run-time-sized form: the deepest
// chain of temporaries of the lane code (EigenProc and its eigh; a c×c
// inverse beside two c×c blocks) and of each kernel's own
__host__ __device__ inline long mv_frame_len(int d, int c) {
  const long dd = (long)d * d, cc = (long)c * c;
  return 12 * dd + 4 * cc + 8L * d + 4L * c + (long)d * (d + 1) + 16;
}

// The staged rows: static shared memory in the fixed instantiation; in
// the run-time-sized form dynamic shared memory or, where the launch gave
// none, `w` in the lane's scratch.
typedef double (*MvSt)[MV_CH];

template <int MD, int MC>
__device__ __forceinline__ MvSt mv_st(double* w) {
  if constexpr (MD > 0) {
    __shared__ double st[MV_NROW][MV_CH];
    return st;
  } else {
    extern __shared__ __align__(16) double mv_dyn_st[];
    return reinterpret_cast<MvSt>(w != nullptr ? w : mv_dyn_st);
  }
}

// what a pass stages in its five d-rows
enum {
  STAGE_X,    // only 1, δ, δ², x
  STAGE_Z,    // w, z, log v
  STAGE_ML,   // STAGE_Z and g = w (z - Bc x), e0 = z - δ D g
  STAGE_PY,   // w, py = w (z - beta x), h = x' Qi_l x
  STAGE_E     // E = e0 - Bn x
};

template <typename T, int MD, int MC>
__device__ inline void mv_stage(const MvLane<T>& L, const MvState<MD, MC>& s,
                                int mode, int k, int col,
                                double (*st)[MV_CH]) {
  const int d = L.d, c = L.c, n = L.n;
  const MvRows R{c, d};
  const double dl = (double)L.eval[k];
  st[0][col] = 1.0;
  st[1][col] = dl;
  st[2][col] = dl * dl;
  // the design rows: cached in a local array, or (run-time-sized form)
  // read back from their staged rows
  double xb[MC > 0 ? MC : 1];
  for (int i = 0; i < c; ++i) {
    const double v = L.x(i, k);
    if constexpr (MC > 0) xb[i] = v;
    st[R.X(i)][col] = v;
  }
  auto x = [&](int i) -> double {
    if constexpr (MC > 0) return xb[i];
    else return st[R.X(i)][col];
  };
  if (mode == STAGE_X) return;
  for (int l = 0; l < d; ++l) {
    const double v = s.D[l] * dl + 1.0;
    const double w = 1.0 / v;
    double z = 0.0;
    for (int m = 0; m < d; ++m) z += s.A[l * d + m] * (double)L.Y[(long)m * n + k];
    st[R.W(l)][col] = w;
    if (mode == STAGE_Z || mode == STAGE_ML) {
      st[R.Z(l)][col] = z;
      st[R.R3(l)][col] = log(v);
      if (mode == STAGE_ML) {
        double bx = 0.0;
        for (int i = 0; i < c; ++i) bx += s.Bc[l * c + i] * x(i);
        const double g = w * (z - bx);
        st[R.R4(l)][col] = g;
        st[R.R5(l)][col] = z - dl * s.D[l] * g;
      }
    } else if (mode == STAGE_PY) {
      double bx = 0.0;
      for (int i = 0; i < c; ++i) bx += s.beta[l * c + i] * x(i);
      st[R.Z(l)][col] = w * (z - bx);
      const double* Qi = s.Qi + l * c * c;
      double h = 0.0;
      for (int i = 0; i < c; ++i) {
        double qx = 0.0;
        for (int j = 0; j < c; ++j) qx += Qi[i * c + j] * x(j);
        h += x(i) * qx;
      }
      st[R.R3(l)][col] = h;
    } else {  // STAGE_E
      double bx = 0.0, bn = 0.0;
      for (int i = 0; i < c; ++i) {
        bx += s.Bc[l * c + i] * x(i);
        bn += s.Bn[l * c + i] * x(i);
      }
      const double g = w * (z - bx);
      st[R.Z(l)][col] = (z - dl * s.D[l] * g) - bn;
    }
  }
}

// one pass: acc[r] = Σ_k Π (the six rows of sum r), every sum of P
template <typename T, int MD, int MC>
__device__ void mv_accumulate(const MvLane<T>& L, const MvState<MD, MC>& s,
                              int mode, const MvPass& P, double (*st)[MV_CH],
                              double* acc) {
  using Desc = typename std::conditional<MD == 0, MvDesc6,
                                         unsigned long long>::type;
  const int tid = threadIdx.x;
  const int total = mv_pass_size(P);
  for (int r0 = 0; r0 < total; r0 += MV_THREADS * MV_Q) {
    Desc desc[MV_Q];
    double sum[MV_Q];
#pragma unroll
    for (int q = 0; q < MV_Q; ++q) {
      const int r = r0 + q * MV_THREADS + tid;
      desc[q] = r < total ? mv_desc<Desc>(P, r) : mv_pack<Desc>(0);
      sum[q] = 0.0;
    }
    for (int k0 = 0; k0 < L.n; k0 += MV_CH) {
      const int kn = min(MV_CH, L.n - k0);
      __syncthreads();
      if (tid < kn) mv_stage(L, s, mode, k0 + tid, tid, st);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < MV_Q; ++q) {
        if (r0 + q * MV_THREADS + tid >= total) continue;
        const double* f0 = st[mv_row(desc[q], 0)];
        const double* f1 = st[mv_row(desc[q], 1)];
        const double* f2 = st[mv_row(desc[q], 2)];
        const double* f3 = st[mv_row(desc[q], 3)];
        const double* f4 = st[mv_row(desc[q], 4)];
        const double* f5 = st[mv_row(desc[q], 5)];
        double a = sum[q];
        for (int k = 0; k < kn; ++k)
          a += f0[k] * f1[k] * f2[k] * f3[k] * f4[k] * f5[k];
        sum[q] = a;
      }
    }
#pragma unroll
    for (int q = 0; q < MV_Q; ++q) {
      const int r = r0 + q * MV_THREADS + tid;
      if (r < total) acc[r] = sum[q];
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// small algebra, one thread

// the reference's closed-form 2×2 eigh (_eigh2x2, mvlmm_core.py:59-95)
__device__ inline void mv_eigh2(const double* M, double* w, double* V) {
  const double a = M[0], b = M[1], dd = M[3];
  const double t = 0.5 * (a + dd);
  const double h2 = (0.5 * (a - dd)) * (0.5 * (a - dd)) + b * b;
  const double r = sqrt(fmax(h2, MV_TINY));
  const double w1 = t - r, w2 = t + r;
  const bool use1 = fabs(w2 - a) >= fabs(w2 - dd);
  double vx = use1 ? b : w2 - dd;
  double vy = use1 ? w2 - a : b;
  if (fabs(b) <= MV_TINY * 8) {
    const bool big_is_a = a >= dd;
    vx = big_is_a ? 1.0 : 0.0;
    vy = big_is_a ? 0.0 : 1.0;
  }
  double nrm = sqrt(vx * vx + vy * vy);
  if (nrm == 0.0) nrm = 1.0;
  vx /= nrm;
  vy /= nrm;
  w[0] = w1;
  w[1] = w2;
  // columns v(w1) = (-vy, vx), v(w2) = (vx, vy)
  V[0] = -vy;
  V[1] = vx;
  V[2] = vx;
  V[3] = vy;
}

// symmetric d×d eigh: the closed form at d = 2; cyclic Jacobi above, then
// eigenvalues ascending and each eigenvector signed to agree with prev (a
// non-negative dot product) or, without it, with its largest-magnitude
// component positive.  M is overwritten.
template <int MD>
__device__ inline void mv_eigh(int d, double* M, double* w, double* V,
                               const double* prev, double* fr) {
  if (d == 2) {
    mv_eigh2(M, w, V);
    return;
  }
  for (int i = 0; i < d * d; ++i) V[i] = 0.0;
  for (int i = 0; i < d; ++i) V[i * d + i] = 1.0;
  for (int sweep = 0; sweep < MV_JACOBI_SWEEPS; ++sweep) {
    double off = 0.0, dg = 0.0;
    for (int p = 0; p < d; ++p) {
      dg += M[p * d + p] * M[p * d + p];
      for (int q = p + 1; q < d; ++q) off += M[p * d + q] * M[p * d + q];
    }
    if (!(off > MV_JACOBI_TOL * dg)) break;
    for (int p = 0; p < d - 1; ++p) {
      for (int q = p + 1; q < d; ++q) {
        const double apq = M[p * d + q];
        if (apq == 0.0) continue;
        const double theta = (M[q * d + q] - M[p * d + p]) / (2.0 * apq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                         (fabs(theta) + sqrt(theta * theta + 1.0));
        const double cs = 1.0 / sqrt(t * t + 1.0), sn = t * cs;
        for (int k = 0; k < d; ++k) {
          const double mp = M[k * d + p], mq = M[k * d + q];
          M[k * d + p] = cs * mp - sn * mq;
          M[k * d + q] = sn * mp + cs * mq;
        }
        for (int k = 0; k < d; ++k) {
          const double mp = M[p * d + k], mq = M[q * d + k];
          M[p * d + k] = cs * mp - sn * mq;
          M[q * d + k] = sn * mp + cs * mq;
        }
        for (int k = 0; k < d; ++k) {
          const double vp = V[k * d + p], vq = V[k * d + q];
          V[k * d + p] = cs * vp - sn * vq;
          V[k * d + q] = sn * vp + cs * vq;
        }
      }
    }
  }
  // ascending, stable
  MvTmp<int, MD> tord;
  int* ord = tord.take(fr, d);
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
  MvTmp<double, MD * MD> tVs;
  double* Vs = tVs.take(fr, d * d);
  for (int j = 0; j < d; ++j) {
    w[j] = M[ord[j] * d + ord[j]];
    for (int i = 0; i < d; ++i) Vs[i * d + j] = V[i * d + ord[j]];
  }
  for (int j = 0; j < d; ++j) {
    bool neg;
    if (prev != nullptr) {
      double dot = 0.0;
      for (int i = 0; i < d; ++i) dot += Vs[i * d + j] * prev[i * d + j];
      neg = dot < 0.0;
    } else {
      int big = 0;
      for (int i = 1; i < d; ++i)
        if (fabs(Vs[i * d + j]) > fabs(Vs[big * d + j])) big = i;
      neg = Vs[big * d + j] < 0.0;
    }
    for (int i = 0; i < d; ++i) V[i * d + j] = neg ? -Vs[i * d + j] : Vs[i * d + j];
  }
}

// EigenProc (mvlmm_core.py:106-128) into s: D, Uh = Ul'Veh, A = Ul'Vehi,
// Ul, logdet_Ve; Ul's signs follow prev where given
template <int MD, int MC>
__device__ inline void mv_eigen_proc(int d, const double* Vg,
                                     const double* Ve, MvState<MD, MC>& s,
                                     const double* prev, double* fr) {
  MvTmp<double, MD * MD> tM, tUv, tVeh, tVehi, tT;
  MvTmp<double, MD> tev, tsq, tisq;
  double* M = tM.take(fr, d * d);
  double* ev = tev.take(fr, d);
  double* Uv = tUv.take(fr, d * d);
  for (int i = 0; i < d * d; ++i) M[i] = Ve[i];
  mv_eigh<MD>(d, M, ev, Uv, nullptr, fr);
  double* sq = tsq.take(fr, d);
  double* isq = tisq.take(fr, d);
  double ld = 0.0;
  for (int k = 0; k < d; ++k) {
    const bool pos = ev[k] > 0.0;
    const double r = sqrt(pos ? ev[k] : 1.0);
    sq[k] = pos ? r : 0.0;
    isq[k] = pos ? 1.0 / r : 0.0;
    if (pos) ld += log(ev[k]);
  }
  s.logdet_Ve = ld;
  double* Veh = tVeh.take(fr, d * d);
  double* Vehi = tVehi.take(fr, d * d);
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j) {
      double a = 0.0, b = 0.0;
      for (int k = 0; k < d; ++k) {
        a += Uv[i * d + k] * sq[k] * Uv[j * d + k];
        b += Uv[i * d + k] * isq[k] * Uv[j * d + k];
      }
      Veh[i * d + j] = a;
      Vehi[i * d + j] = b;
    }
  double* T = tT.take(fr, d * d);
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j) {
      double a = 0.0;
      for (int k = 0; k < d; ++k) a += Vehi[i * d + k] * Vg[k * d + j];
      T[i * d + j] = a;
    }
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j) {
      double a = 0.0;
      for (int k = 0; k < d; ++k) a += T[i * d + k] * Vehi[k * d + j];
      M[i * d + j] = a;
    }
  mv_eigh<MD>(d, M, s.D, s.Ul, prev, fr);
  for (int l = 0; l < d; ++l)
    if (s.D[l] < 0.0) s.D[l] = 0.0;
  for (int l = 0; l < d; ++l)
    for (int j = 0; j < d; ++j) {
      double a = 0.0, b = 0.0;
      for (int k = 0; k < d; ++k) {
        a += s.Ul[k * d + l] * Veh[k * d + j];
        b += s.Ul[k * d + l] * Vehi[k * d + j];
      }
      s.Uh[l * d + j] = a;
      s.A[l * d + j] = b;
    }
}

// inverse and log|det| of a c×c matrix: the adjugate at c <= 2 (as the
// reference), Gauss-Jordan with partial pivoting above
template <int MC>
__device__ inline void mv_inv_logdet(int c, const double* M, double* Mi,
                                     double& logdet, double* fr) {
  if (c == 1) {
    Mi[0] = 1.0 / M[0];
    logdet = log(fabs(M[0]));
    return;
  }
  if (c == 2) {
    const double a = M[0], b = M[1], e = M[2], f = M[3];
    const double det = a * f - b * e;
    Mi[0] = f / det;
    Mi[1] = -b / det;
    Mi[2] = -e / det;
    Mi[3] = a / det;
    logdet = log(fabs(det));
    return;
  }
  MvTmp<double, MC * MC> tW;
  double* W = tW.take(fr, c * c);
  for (int i = 0; i < c * c; ++i) {
    W[i] = M[i];
    Mi[i] = 0.0;
  }
  for (int i = 0; i < c; ++i) Mi[i * c + i] = 1.0;
  logdet = 0.0;
  for (int col = 0; col < c; ++col) {
    int piv = col;
    for (int i = col + 1; i < c; ++i)
      if (fabs(W[i * c + col]) > fabs(W[piv * c + col])) piv = i;
    if (piv != col)
      for (int j = 0; j < c; ++j) {
        double t = W[col * c + j];
        W[col * c + j] = W[piv * c + j];
        W[piv * c + j] = t;
        t = Mi[col * c + j];
        Mi[col * c + j] = Mi[piv * c + j];
        Mi[piv * c + j] = t;
      }
    const double p = W[col * c + col];
    logdet += log(fabs(p));
    for (int j = 0; j < c; ++j) {
      W[col * c + j] /= p;
      Mi[col * c + j] /= p;
    }
    for (int i = 0; i < c; ++i) {
      if (i == col) continue;
      const double f = W[i * c + col];
      if (f == 0.0) continue;
      for (int j = 0; j < c; ++j) {
        W[i * c + j] -= f * W[col * c + j];
        Mi[i * c + j] -= f * Mi[col * c + j];
      }
    }
  }
}

// Gauss-Jordan inverse of an n×n matrix in place (K11's Hessian), one
// thread; singular input gives inf/NaN as LU would
__device__ inline void mv_invert(int n, double* M, double* Mi) {
  for (int i = 0; i < n * n; ++i) Mi[i] = 0.0;
  for (int i = 0; i < n; ++i) Mi[i * n + i] = 1.0;
  for (int col = 0; col < n; ++col) {
    int piv = col;
    for (int i = col + 1; i < n; ++i)
      if (fabs(M[i * n + col]) > fabs(M[piv * n + col])) piv = i;
    if (piv != col)
      for (int j = 0; j < n; ++j) {
        double t = M[col * n + j];
        M[col * n + j] = M[piv * n + j];
        M[piv * n + j] = t;
        t = Mi[col * n + j];
        Mi[col * n + j] = Mi[piv * n + j];
        Mi[piv * n + j] = t;
      }
    const double p = M[col * n + col];
    for (int j = 0; j < n; ++j) {
      M[col * n + j] /= p;
      Mi[col * n + j] /= p;
    }
    for (int i = 0; i < n; ++i) {
      if (i == col) continue;
      const double f = M[i * n + col];
      if (f == 0.0) continue;
      for (int j = 0; j < n; ++j) {
        M[i * n + j] -= f * M[col * n + j];
        Mi[i * n + j] -= f * Mi[col * n + j];
      }
    }
  }
}

// the Gram blocks of a core pass → s.Qi, s.beta; returns Σ log|Q_l|
template <int MD, int MC>
__device__ inline double mv_gls(const double* acc, const MvPass& P,
                                MvState<MD, MC>& s, double* fr) {
  const int d = P.d, c = P.c;
  double ldq = 0.0;
  MvTmp<double, MC * MC> tQ;
  double* Q = tQ.take(fr, c * c);
  for (int l = 0; l < d; ++l) {
    for (int i = 0; i < c; ++i)
      for (int j = 0; j < c; ++j) Q[i * c + j] = mv_q(acc, P, FC_Q, l, i, j);
    double ld;
    mv_inv_logdet<MC>(c, Q, s.Qi + l * c * c, ld, fr);
    ldq += ld;
    for (int i = 0; i < c; ++i) {
      double b = 0.0;
      for (int j = 0; j < c; ++j)
        b += s.Qi[l * c * c + i * c + j] * mv_at(acc, P, FC_XWZ, l * c + j);
      s.beta[l * c + i] = b;
    }
  }
  return ldq;
}

// the (restricted) log-likelihood from a core pass and mv_gls's output
template <int MD, int MC>
__device__ inline double mv_logl(const double* acc, const MvPass& P,
                                 const MvState<MD, MC>& s, double ldq,
                                 int reml,
                                 double logl_const, int n) {
  const int d = P.d, c = P.c;
  double quad = 0.0, logd = 0.0, qQq = 0.0;
  for (int l = 0; l < d; ++l) {
    quad += mv_at(acc, P, FC_QUAD, l);
    logd += mv_at(acc, P, FC_LOGV, l);
    for (int i = 0; i < c; ++i)
      qQq += mv_at(acc, P, FC_XWZ, l * c + i) * s.beta[l * c + i];
  }
  double logl = logl_const - 0.5 * (quad + logd - qQq) - 0.5 * n * s.logdet_Ve;
  if (reml) logl -= 0.5 * (ldq - c * s.logdet_Ve);
  return logl;
}

// the REML constant -(n-c)d/2 log 2π + d/2 log|XX'| (or the ML one), and
// (XX')^-1 where Xi is given; thread 0 after an F_XX pass
template <int MC>
__device__ inline double mv_logl_const(const double* acc, const MvPass& P,
                                       int reml, int n, double* Xi,
                                       double* fr) {
  const int d = P.d, c = P.c;
  MvTmp<double, MC * MC> tM, tMi;
  double* M = tM.take(fr, c * c);
  double* Mi = tMi.take(fr, c * c);
  double ld;
  for (int i = 0; i < c; ++i)
    for (int j = 0; j < c; ++j) M[i * c + j] = acc[mv_ti(i, j, c)];
  mv_inv_logdet<MC>(c, M, Xi != nullptr ? Xi : Mi, ld, fr);
  if (reml) return -0.5 * (n - c) * d * MV_LOG_2PI + 0.5 * d * ld;
  return -0.5 * n * d * MV_LOG_2PI;
}

// the lane's operand pointers
template <typename T>
__device__ inline MvLane<T> mv_lane(const T* eval, const T* X0, const T* Y,
                                    const T* R, int n, int d, int c0, int r,
                                    int s) {
  MvLane<T> L;
  L.eval = eval;
  L.X0 = X0;
  L.Y = Y;
  L.R = R + (long)s * r * n;
  L.n = n;
  L.d = d;
  L.c0 = c0;
  L.r = r;
  L.c = c0 + r;
  return L;
}
