// The per-SNP test kernel behind K4 (Wald, wald_tail.cu) and K5 (score,
// score_tail.cu): each lane's CalcPab base row from the sums of
// test_sums.cuh, the recurrence on a warp, then beta, se, the F statistic
// and p = f_sf(f, 1, df) with the float64 incomplete beta of tails.cuh.
// The Wald test reads each lane's REML λ and the cancellation-free f =
// (p_xy²/p_xx)·tau (likelihood.py:506-515 of the reference); the score
// test reads the null model's ML λ, shared by all lanes (lam_stride 0) or
// one per lane (gene mode), and f = n p_xy²/(p_yy p_xx).  UtWy, wy and
// Utx are offset by their lane strides (0 where all lanes share them).
//
// Design (test_sums.cuh has the stage of sums and its forms): a block
// takes a lane a warp (c <= 3), a tile of 8 lanes (shared operands: the
// sums on DMMA) or one lane (per-lane operands).  The sums land, rounded
// once to T, at their flat positions of the lanes' rows; each warp then
// runs its lanes' recurrences in place over the live entries only
// (ts_recur), without a block barrier between steps, and writes beta, se
// and f; a second launch takes the tails, a thread a lane.
//
// Bound: with shared operands, operations: the {W, y} sums are 2 M n
// float64 multiply-adds a lane on DMMA (67 TFLOP/s), the x sums 2 (c + 2)
// n more, against one read of the lanes' Utx rows (eval, UtWy, wy_prod
// stay in L2) — bytes at c <= 3; with per-lane operands, bytes: each
// lane's wy_prod and UtWy rows are read once.  Above 32 covariates the
// rows live in a per-lane slice of global scratch (lanes [s0, s0 + count)
// a launch).
#pragma once

#include "test_sums.cuh"

template <typename T>
struct TtArgs {
  const T *lam, *eval, *UtWy, *wy, *Utx;
  const int* tab;
  int c, n, xx_pos, xy_pos, lam_stride, ustride, wstride, xstride, s0,
      count;
  T *beta, *se, *p;
  unsigned char* scratch;
};

template <typename T, bool SCORE, int FORM, int C1R>
__global__ void __launch_bounds__(TS_THREADS, TS_MIN_BLOCKS(FORM, 1, 1))
test_tail_kernel(const __grid_constant__ TtArgs<T> a) {
  extern __shared__ __align__(16) unsigned char ts_smem[];
  __shared__ double red[TS_WARPS];
  using Ops = TsTest<T>;
  const TsLay L = ts_layout(a.c, FORM, TS_TEST, sizeof(T));
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  GT_PROF_START();
  GT_PROF_COUNT(GT_PC_LANES, 1);
  const PabTables tb = gt_tables(a.tab, a.c);
  const int ni = L.Q;
  unsigned* lab = L.o_lab < 0 ? nullptr
                              : reinterpret_cast<unsigned*>(ts_smem + L.o_lab);
  if (lab != nullptr) ts_labels(lab, a.c);
  __syncthreads();
  const int b0 = blockIdx.x * L.lanes;
  const int nl = min(L.lanes, a.count - b0);
  auto lane_at = [&](int r) {
    const long s = a.s0 + b0 + (r < nl ? r : 0);
    TsLane<Ops> ln;
    ln.lam = a.lam[s * a.lam_stride];
    ln.UtWy = a.UtWy + s * a.ustride;
    ln.wy = a.wy + s * a.wstride;
    ln.x = a.Utx + s * a.xstride;
    ln.live = r < nl;
    return ln;
  };
  // lane r's row: in shared memory, or (dyn) the lane's scratch
  auto row_of = [&](int r) -> T* {
    return reinterpret_cast<T*>(
        L.dyn ? a.scratch + (long)(b0 + r) * L.lane_bytes
              : ts_smem + L.o_set + r * L.lane_set);
  };
  auto put = [&](int r, int q, double v) { row_of(r)[ts_flat(L, q)] = (T)v; };
  // lane r's recurrence and statistics on the calling warp; p holds f
  // until the tail kernel
  auto stats = [&](int r) {
    const TestRows<T> rw =
        ts_recur<T>(row_of(r), lab, tb, a.c, ni, a.xx_pos, a.xy_pos);
    if (lid == 0) {
      const long s = a.s0 + b0 + r;
      const T df = (T)(a.n - a.c - 1);
      const T tau = df / rw.px_yy;
      a.beta[s] = rw.p_xy / rw.p_xx;
      a.se[s] = gt_sqrt(T(1) / (tau * rw.p_xx));
      a.p[s] = SCORE ? (T)a.n * rw.p_xy * rw.p_xy / (rw.p_yy * rw.p_xx)
                     : (rw.p_xy * rw.p_xy / rw.p_xx) * tau;
    }
  };
  if constexpr (FORM == TS_REG) {
    double out[TS_REG_Q + 1];
    ts_sums_reg<Ops, C1R>(lane_at(warp), a.eval, a.n, L.xc, out);
    GT_PROF(TT_PH_SUMS);
    if (warp < nl) {
      constexpr int QR = C1R * (C1R + 1) / 2 + C1R + 1;
      if (lid == 0) {
#pragma unroll
        for (int q = 0; q < QR; ++q) put(warp, q, out[q]);
      }
      __syncwarp();
      stats(warp);
    }
  } else {
    if constexpr (FORM == TS_MMA)
      ts_sums_mma<Ops>(L, ts_smem, lane_at, nl, a.eval, a.n, put);
    else
      ts_sums_lane<Ops>(L, ts_smem, lane_at(0), a.eval, 0, a.n, red, put);
    __syncthreads();
    for (int r = warp; r < nl; r += TS_WARPS) stats(r);
  }
  GT_PROF(TT_PH_POST);
}

// the F(1, df) tail of lanes [s0, s0 + count), a thread a lane: p holds
// the statistic f on entry
template <typename T>
__global__ void test_tail_sf(T* p, int s0, int count, double df) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < count) p[s0 + s] = (T)gt_f_sf((double)p[s0 + s], 1.0, df);
}

template <typename T>
using TtKernel = void (*)(const TtArgs<T>);

template <typename T, bool SCORE>
static TtKernel<T> tt_kernel(const TsLay& L) {
  if (L.form == TS_MMA) return test_tail_kernel<T, SCORE, TS_MMA, 0>;
  if (L.form == TS_LANE) return test_tail_kernel<T, SCORE, TS_LANE, 0>;
  switch (L.C1) {
    case 1: return test_tail_kernel<T, SCORE, TS_REG, 1>;
    case 2: return test_tail_kernel<T, SCORE, TS_REG, 2>;
    case 3: return test_tail_kernel<T, SCORE, TS_REG, 3>;
    default: return test_tail_kernel<T, SCORE, TS_REG, 4>;
  }
}

template <typename T, bool SCORE>
static int gt_test_tail_run(const void* lam, const void* eval,
                            const void* UtWy, const void* wy,
                            const void* Utx, const void* tab, int n_cvt,
                            int n, int xx_pos, int xy_pos, int lam_stride,
                            int ustride, int wstride, int xstride, void* beta,
                            void* se, void* p, int s0, int count,
                            void* scratch, void* stream) {
  const TsLay L =
      ts_layout(n_cvt, ts_form(n_cvt, ustride == 0 && wstride == 0),
                TS_TEST, sizeof(T));
  TtArgs<T> a{(const T*)lam, (const T*)eval, (const T*)UtWy, (const T*)wy,
              (const T*)Utx, (const int*)tab, n_cvt, n, xx_pos, xy_pos,
              lam_stride, ustride, wstride, xstride, s0, count, (T*)beta,
              (T*)se, (T*)p, (unsigned char*)scratch};
  const TtKernel<T> kern = tt_kernel<T, SCORE>(L);
  if (count > 0) {
    if (L.bytes > GT_STATIC_SMEM)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)L.bytes);
    kern<<<(count + L.lanes - 1) / L.lanes, TS_THREADS, L.bytes,
           (cudaStream_t)stream>>>(a);
    test_tail_sf<T><<<(count + TS_THREADS - 1) / TS_THREADS, TS_THREADS, 0,
                      (cudaStream_t)stream>>>((T*)p, s0, count,
                                              (double)(n - n_cvt - 1));
  }
  return (int)cudaGetLastError();
}

// extern "C" entry points `name`_launch, `name`_lane_bytes and
// `name`_smem_bytes of one instantiation; the launch shares the argument
// list of kernels.WALD_TAIL in gemma_torch/kernels.
#define GT_TEST_TAIL_ENTRY(name, T, SCORE)                                 \
  extern "C" int name##_launch(                                            \
      const void* lam, const void* eval, const void* UtWy, const void* wy, \
      const void* Utx, const void* tab, int n_cvt, int S, int n, int M,    \
      int xx_pos, int xy_pos, int lam_stride, int ustride, int wstride,    \
      int xstride, void* beta, void* se, void* p, int s0, int count,       \
      void* scratch, void* stream) {                                       \
    return gt_test_tail_run<T, SCORE>(lam, eval, UtWy, wy, Utx, tab,      \
                                      n_cvt, n, xx_pos, xy_pos,            \
                                      lam_stride, ustride, wstride,        \
                                      xstride, beta, se, p, s0, count,     \
                                      scratch, stream);                    \
  }                                                                        \
  extern "C" long name##_lane_bytes(int n_cvt) {                           \
    return ts_layout(n_cvt, TS_MMA, TS_TEST, sizeof(T)).lane_bytes;        \
  }                                                                        \
  extern "C" long name##_smem_bytes(int n_cvt, int shared_ops) {           \
    return ts_layout(n_cvt, ts_form(n_cvt, shared_ops), TS_TEST, sizeof(T)) \
        .bytes;                                                            \
  }
