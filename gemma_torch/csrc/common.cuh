// Shared pieces of the gemma_torch kernels: the Pab index tables, block
// reductions over the individual axis, the covariate-elimination
// recurrences (GEMMA CalcPab/CalcPPab/CalcPPPab, lmm.cpp:283-482) and the
// per-SNP test rows that K4 and K5 read.
//
// The templates take the working scalar type T: float in the speed mode,
// double in the parity mode; the float instantiations are the arithmetic
// the float32 kernels always ran.  Index tables come from
// gemma_torch.models.lmm.indices.pab_indices and are passed as one int32
// array laid out by `pab_tables` in kernels/__init__.py:
//   aw (steps, ni) | bw (steps, ni) | ww (steps) | diag (steps)
//   | kind (ni) | col (ni)
// where steps = n_cvt + 1 and, for the base row of flat position k,
// kind 0 reads the shared {W,y} column `col`, kind 1 the x'x term and
// kind 2 the x-partner column `col` of [W | y].
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The covariate kernels K3-K8 are instantiated three times (K2 runs a
// per-thread form up to GT_MAX_CVT and a warp form above, lambda_grid.cu):
// for at most GT_MAX_CVT covariates, the code they always ran; for at most
// GT_WIDE_CVT, which a launch takes only above GT_MAX_CVT; and, above
// that, the form sized at run time (MC = GT_DYN), whose per-lane working
// sets live in a per-lane slice of global scratch that the wrapper
// allocates, lanes split into launches under a byte budget
// (kernels.lane_ranges).  GtDims sizes the per-block and per-thread
// arrays of the two fixed instantiations.
#define GT_MAX_CVT 16
#define GT_WIDE_CVT 32
#define GT_DYN 0
#define GT_THREADS 256
#define GT_WARPS (GT_THREADS / 32)

#define GT_ERROR_FN(name)                                              \
  extern "C" const char* name##_error(int e) {                         \
    return cudaGetErrorString((cudaError_t)e);                         \
  }

// Phase clocks of K3 and K7 (scripts/k3_k7_phase_profile.py builds
// them with -DGT_PROFILE): thread 0 of a block, which waits at every
// barrier, adds the clock64() cycles since its last mark to a phase's
// counter; GT_PROF_COUNT adds to a counter from thread 0, GT_PROF_ADD
// from the calling thread.  Without GT_PROFILE the marks compile to
// nothing.
#define GT_PH_SUMS 0     // the sums over n
#define GT_PH_RECUR 1    // the Pab recurrences
#define GT_PH_FACTOR 2   // the Gram's factor and solves
#define GT_PH_CONTROL 3  // Newton, Brent, the interval walk, the rest
#define GT_PC_LANES 8    // lanes the launch searched
#define GT_PC_DEV 9      // dev1 / dev12 evaluations
#define GT_PC_LOGF 10    // logf evaluations (logdet0 included)
#define GT_PC_STEPS 11   // block steps (evaluation rounds of a block)
#ifdef GT_PROFILE
__device__ unsigned long long gt_prof[16];
__device__ __forceinline__ long long& gt_prof_last() {
  __shared__ long long t;
  return t;
}
#define GT_PROF_START()                                     \
  do {                                                      \
    if (threadIdx.x == 0) gt_prof_last() = clock64();       \
  } while (0)
#define GT_PROF(k)                                                     \
  do {                                                                 \
    if (threadIdx.x == 0) {                                            \
      const long long now_ = clock64();                                \
      atomicAdd(&gt_prof[k], (unsigned long long)(now_ - gt_prof_last())); \
      gt_prof_last() = now_;                                           \
    }                                                                  \
  } while (0)
#define GT_PROF_COUNT(k, v)                                            \
  do {                                                                 \
    if (threadIdx.x == 0) atomicAdd(&gt_prof[k], (unsigned long long)(v)); \
  } while (0)
#define GT_PROF_ADD(k, v) atomicAdd(&gt_prof[k], (unsigned long long)(v))
extern "C" int gt_prof_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, gt_prof, sizeof(gt_prof));
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(gt_prof, z, sizeof(z));
  return (int)cudaGetLastError();
}
#else
#define GT_PROF_START()
#define GT_PROF(k)
#define GT_PROF_COUNT(k, v)
#define GT_PROF_ADD(k, v)
#endif

// float → the f-suffixed functions, double → the plain ones
__device__ __forceinline__ float gt_log(float v) { return logf(v); }
__device__ __forceinline__ double gt_log(double v) { return log(v); }
__device__ __forceinline__ float gt_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double gt_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float gt_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double gt_abs(double v) { return fabs(v); }
__device__ __forceinline__ float gt_max(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double gt_max(double a, double b) {
  return fmax(a, b);
}

// the instantiation a launch of n_cvt covariates takes
__host__ __device__ inline int gt_form(int n_cvt) {
  return n_cvt <= GT_MAX_CVT ? GT_MAX_CVT
                             : (n_cvt <= GT_WIDE_CVT ? GT_WIDE_CVT : GT_DYN);
}

__host__ __device__ inline long gt_r16(long b) { return (b + 15) / 16 * 16; }

// A bump allocator over one lane's slice of global scratch (the GT_DYN
// forms): take(k) returns the next k values of type U, 16-byte aligned.
struct GtCarve {
  unsigned char* p;
  template <typename U>
  __host__ __device__ U* take(long k) {
    U* r = reinterpret_cast<U*>(p);
    p += gt_r16((long)sizeof(U) * k);
    return r;
  }
};

template <int MC>
struct GtDims {
  static constexpr int NI = (MC + 3) * (MC + 2) / 2;  // flat Pab index
  static constexpr int C1 = MC + 1;                   // covariates and y
  static constexpr int M = C1 * (C1 + 1) / 2;         // {W,y} products
};

// A block's working set S in shared memory: a static __shared__ object
// where it fits the 48 KB that static shared memory may take, else the
// dynamic shared memory that gt_smem_bytes sizes at the launch (the
// float64 working sets of the GT_WIDE_CVT instantiations).
#define GT_STATIC_SMEM 49152

template <typename S>
__device__ __forceinline__ S& gt_smem() {
  if constexpr (sizeof(S) <= GT_STATIC_SMEM) {
    __shared__ S s;
    return s;
  } else {
    extern __shared__ __align__(16) unsigned char gt_dyn_smem[];
    return *reinterpret_cast<S*>(gt_dyn_smem);
  }
}

// The dynamic shared memory a launch of `kernel` needs for S (0 where S
// is static); raises the kernel's limit to it first.
template <typename S, typename K>
inline int gt_smem_bytes(K kernel) {
  if (sizeof(S) <= GT_STATIC_SMEM) return 0;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)sizeof(S));
  return (int)sizeof(S);
}

struct PabTables {
  const int* aw;
  const int* bw;
  const int* ww;
  const int* diag;
  const int* kind;
  const int* col;
};

__host__ __device__ constexpr int gt_n_index(int n_cvt) {
  return (n_cvt + 3) * (n_cvt + 2) / 2;
}

__device__ inline PabTables gt_tables(const int* tab, int n_cvt) {
  const int ni = gt_n_index(n_cvt);
  const int steps = n_cvt + 1;
  PabTables t;
  t.aw = tab;
  t.bw = t.aw + steps * ni;
  t.ww = t.bw + steps * ni;
  t.diag = t.ww + steps;
  t.kind = t.diag + steps;
  t.col = t.kind + ni;
  return t;
}

template <typename T>
__device__ inline T gt_warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of Q quantities over i in [0, n): out[q] = sum_i f(q, i).
// Eight quantities share one pass and one barrier.  Every thread of the
// block must call it; `out` and `red` are shared memory (red holds
// GT_WARPS * 8 values).  On return out[0..Q) is visible to all threads.
template <typename T, typename F>
__device__ inline void gt_block_sums(F f, int Q, int n, T* out, T* red) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int q0 = 0; q0 < Q; q0 += 8) {
    T acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = T(0);
    for (int i = tid; i < n; i += GT_THREADS) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (q0 + r < Q) acc[r] += f(q0 + r, i);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      T v = gt_warp_sum(acc[r]);
      if (lane == 0) red[warp * 8 + r] = v;
    }
    __syncthreads();
    if (tid < 8 && q0 + tid < Q) {
      T v = T(0);
      for (int w = 0; w < GT_WARPS; ++w) v += red[w * 8 + tid];
      out[q0 + tid] = v;
    }
    __syncthreads();
  }
}

// One elimination step of the three recurrences on rows held in shared
// memory, threads k0, k0 + ks, ... over the flat index k.  `order` says
// how many of (pab, ppab, pppab) are live.  Reads cur rows, writes nxt
// rows; the caller swaps and synchronises.
template <typename T>
__device__ inline void gt_pab_step(const PabTables& t, int ni, int p,
                                   int order, const T* pab, const T* ppab,
                                   const T* pppab, T* npab, T* nppab,
                                   T* npppab, int k0, int ks) {
  const int* aw = t.aw + (p - 1) * ni;
  const int* bw = t.bw + (p - 1) * ni;
  const int w = t.ww[p - 1];
  const T ps_ww = pab[w];
  const bool nz = ps_ww != T(0);
  const T safe = nz ? ps_ww : T(1);
  for (int k = k0; k < ni; k += ks) {
    const T ps_aw = pab[aw[k]];
    const T ps_bw = pab[bw[k]];
    npab[k] = nz ? pab[k] - ps_aw * ps_bw / safe : pab[k];
    if (order >= 2) {
      const T ps2_ab = ppab[k];
      const T ps2_aw = ppab[aw[k]];
      const T ps2_bw = ppab[bw[k]];
      const T ps2_ww = ppab[w];
      const T v = ps2_ab + ps_aw * ps_bw * ps2_ww / (safe * safe) -
                  (ps_aw * ps2_bw + ps_bw * ps2_aw) / safe;
      nppab[k] = nz ? v : ps2_ab;
      if (order >= 3) {
        const T ps3_ab = pppab[k];
        const T ps3_aw = pppab[aw[k]];
        const T ps3_bw = pppab[bw[k]];
        const T ps3_ww = pppab[w];
        const T v3 =
            ps3_ab -
            ps_aw * ps_bw * ps2_ww * ps2_ww / (safe * safe * safe) -
            (ps_aw * ps3_bw + ps_bw * ps3_aw + ps2_aw * ps2_bw) / safe +
            (ps_aw * ps2_bw * ps2_ww + ps_bw * ps2_aw * ps2_ww +
             ps_aw * ps_bw * ps3_ww) /
                (safe * safe);
        npppab[k] = nz ? v3 : ps3_ab;
      }
    }
  }
}

// The same steps for one thread holding its rows in local arrays (K2's
// per-thread form).
__device__ inline void gt_pab_step_local(const PabTables& t, int ni, int p,
                                         float* pab, float* ppab,
                                         float* npab, float* nppab) {
  const int* aw = t.aw + (p - 1) * ni;
  const int* bw = t.bw + (p - 1) * ni;
  const int w = t.ww[p - 1];
  const float ps_ww = pab[w];
  const float ps2_ww = ppab[w];
  const bool nz = ps_ww != 0.f;
  const float safe = nz ? ps_ww : 1.f;
  for (int k = 0; k < ni; ++k) {
    const float ps_aw = pab[aw[k]];
    const float ps_bw = pab[bw[k]];
    npab[k] = nz ? pab[k] - ps_aw * ps_bw / safe : pab[k];
    const float ps2_ab = ppab[k];
    const float ps2_aw = ppab[aw[k]];
    const float ps2_bw = ppab[bw[k]];
    const float v = ps2_ab + ps_aw * ps_bw * ps2_ww / (safe * safe) -
                    (ps_aw * ps2_bw + ps_bw * ps2_aw) / safe;
    nppab[k] = nz ? v : ps2_ab;
  }
}

// Shared memory of one SNP's test rows (K4, K5), for at most MC
// covariates: the base row's sums in float64 whatever T, its rows in T.
template <typename T, int MC>
struct TestSmem {
  double red[GT_WARPS * 8];
  double q[GtDims<MC>::M + GtDims<MC>::C1 + 1];
  T rows[2][GtDims<MC>::NI];
};

// The GT_DYN form: the same arrays in the lane's slice of global scratch
// (red stays in shared memory).
template <typename T>
struct TestSmem<T, GT_DYN> {
  double* red;
  double* q;
  T* rows[2];
};

__host__ __device__ inline long gt_test_lane_bytes(int n_cvt, int tsize) {
  const long C1 = n_cvt + 1, M = C1 * (C1 + 1) / 2;
  return gt_r16((M + C1 + 1) * 8) +
         2 * gt_r16(gt_n_index(n_cvt) * (long)tsize);
}

template <typename T>
__device__ inline TestSmem<T, GT_DYN> gt_test_view(unsigned char* lane,
                                                   int n_cvt) {
  __shared__ double red[GT_WARPS * 8];
  const long C1 = n_cvt + 1, M = C1 * (C1 + 1) / 2;
  GtCarve cv{lane};
  TestSmem<T, GT_DYN> v;
  v.red = red;
  v.q = cv.take<double>(M + C1 + 1);
  v.rows[0] = cv.take<T>(gt_n_index(n_cvt));
  v.rows[1] = cv.take<T>(gt_n_index(n_cvt));
  return v;
}

// The entries of the CalcPab rows that the Wald and score tests read:
// p_yy, p_xx, p_xy after the covariates are eliminated, px_yy after x.
template <typename T>
struct TestRows {
  T p_yy, p_xx, p_xy, px_yy;
};

// One SNP's test rows at weight λ = l: the base row by block reduction
// over n (hi = 1/(l·eval + 1)), then the CalcPab recurrence in shared
// memory, threads parallel over the flat index.  Every thread of the
// block calls it and gets the same values.  The terms are T's (hi and
// hi·x rounded to T), their products and sums float64, each sum rounded
// once to T: so the float32 base row is the correctly rounded one that
// the plain version (likelihood._base_row) also forms, and the two
// differ by the recurrence's rounding alone, not by two float32
// summation orders.
template <typename T, int MC>
__device__ inline TestRows<T> gt_test_rows(T l, const T* eval, const T* UtWy,
                                           const T* wy, const T* x,
                                           const int* tab, int n_cvt, int n,
                                           int M, int xx_pos, int xy_pos,
                                           TestSmem<T, MC>& sm) {
  const int C1 = n_cvt + 1;
  auto f = [&](int qi, int i) -> double {
    const T hi = T(1) / (l * eval[i] + T(1));
    if (qi < M) return (double)hi * (double)wy[(long)i * M + qi];
    qi -= M;
    const T wx = hi * x[i];
    if (qi < C1) return (double)wx * (double)UtWy[(long)i * C1 + qi];
    return (double)wx * (double)x[i];
  };
  gt_block_sums(f, M + C1 + 1, n, sm.q, sm.red);
  const PabTables t = gt_tables(tab, n_cvt);
  const int ni = gt_n_index(n_cvt);
  for (int k = threadIdx.x; k < ni; k += GT_THREADS) {
    const int kind = t.kind[k], col = t.col[k];
    sm.rows[0][k] = (T)(kind == 0   ? sm.q[col]
                        : kind == 1 ? sm.q[M + C1]
                                    : sm.q[M + col]);
  }
  __syncthreads();
  TestRows<T> r;
  r.p_yy = r.p_xx = r.p_xy = T(0);
  int cur = 0;
  for (int p = 1; p <= n_cvt + 1; ++p) {
    if (p == n_cvt + 1) {
      r.p_yy = sm.rows[cur][ni - 1];
      r.p_xx = sm.rows[cur][xx_pos];
      r.p_xy = sm.rows[cur][xy_pos];
    }
    gt_pab_step<T>(t, ni, p, 1, sm.rows[cur], nullptr, nullptr,
                   sm.rows[1 - cur], nullptr, nullptr, threadIdx.x,
                   GT_THREADS);
    __syncthreads();
    cur = 1 - cur;
  }
  r.px_yy = sm.rows[cur][ni - 1];  // yy is the last flat position
  return r;
}
