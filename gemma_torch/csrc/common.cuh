// Shared pieces of the gemma_torch kernels: the Pab index tables, block
// reductions over the individual axis and the covariate-elimination
// recurrences (GEMMA CalcPab/CalcPPab/CalcPPPab, lmm.cpp:283-482).
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
// the test kernels' phases (K4-K6; scripts/k4_k6_phase_profile.py)
#define TT_PH_WEIGHTS 0  // each lane's weights h and h·x
#define TT_PH_SUMS 1     // the sums over n (staging and products)
#define TT_PH_POST 2     // the Pab recurrence (K4, K5) or the factor (K6)
#define TT_PH_RESID 3    // the residual pass (K6)
#define TT_PH_TAIL 4     // the F or chi-square tail and the stores
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

template <int MC>
struct GtDims {
  static constexpr int NI = (MC + 3) * (MC + 2) / 2;  // flat Pab index
  static constexpr int C1 = MC + 1;                   // covariates and y
  static constexpr int M = C1 * (C1 + 1) / 2;         // {W,y} products
};

// Static shared memory's most bytes (above it, dynamic shared memory after
// cudaFuncSetAttribute).
#define GT_STATIC_SMEM 49152

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
