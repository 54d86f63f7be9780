// K10 — the mvLMM Wald/score test of a lane's last row, and the χ²(d)
// tails.
//
// Replaces the reference package's device programs
//   gemma_tpu/models/mvlmm_core.py:712 mph_calc_p (MphCalcP,
//   mvlmm.cpp:727-831) and gemma_tpu/ops/stats.py:46 chisq_sf on its
//   statistic and on the LRT difference 2 (logl_H1 - logl_H0)
//   (gemma_tpu/models/mvlmm.py:479, :642).
//
// One thread block per lane: EigenProc of the lane's (Vg, Ve) on thread
// 0, one float64 pass over n for the whitened Gram blocks of the whole
// design (covariates X0, the lane's rows but the last, and the tested row
// x) and its xHiy; then on thread 0 per whitened phenotype l the
// eliminated x'P x and x'P y (Qi is block diagonal in l, so x'Px is
// diagonal), beta = UltVeh' bhat, Vbeta = UltVeh' diag(1/x'Px) UltVeh,
// the statistic Σ bhat x'Py and p = Q_χ²(d)(stat) (tails.cuh); where
// logl1 is given also p_lrt = Q_χ²(d)(2 (logl1 - logl0)).
//
// Bound: bytes at small c — one read of the lane's rows (r n values) and
// of the shared operands from L2 — and O(n d c²) float64 operations.
// Beyond d = 8 or 10 design rows the run-time-sized form (MD = MC = 0,
// mvlmm_lane.cuh) runs on lanes [s0, s0 + count), its state, sums and
// thread 0's frame in `scratch` (mph_calc_p_lane_bytes a lane).
#include "mvlmm_lane.cuh"

#define MV_ACC_P 528   // Gram blocks and xHiy at d = 8, c = 10: 520 sums

// the pass: the whitened Gram blocks of the whole design and its xHiy
__host__ __device__ inline void mv_p_pass(MvPass& P, int d, int c) {
  mv_pass_begin(P, d, c);
  mv_pass_add(P, F_Q, 0);     // FC_Q
  mv_pass_add(P, F_XWZ);      // FC_XWZ
}

// doubles of a lane's scratch in the run-time-sized form: the state, the
// sums, thread 0's frame (its own d- and c-arrays beside the lane code's)
// and, where they outgrow MV_ST_SMEM, the staged rows
__host__ __device__ inline long mv_p_scratch(int d, int c) {
  MvPass P;
  mv_p_pass(P, d, c);
  return mv_state_len(d, c) + mv_pass_size(P) + mv_frame_len(d, c) +
         3L * d + 2L * c * c + c +
         (mv_st_smem(d, c) ? 0 : (long)mv_nrow(d, c) * MV_CH);
}

template <typename T, int MD, int MC>
__global__ void __launch_bounds__(MV_THREADS)
mph_calc_p_kernel(int n, int d, int c0, int r, const T* __restrict__ eval,
                  const T* __restrict__ X0, const T* __restrict__ Y,
                  const T* __restrict__ R, const double* __restrict__ Vg,
                  const double* __restrict__ Ve, int vstride,
                  const double* __restrict__ logl1,
                  const double* __restrict__ logl0, int l0stride,
                  double* stat_out, double* p_out, double* beta_out,
                  double* Vbeta_out, double* p_lrt_out, int s0,
                  double* scratch) {
  __shared__ MvState<MD, MC> s;
  const int lane = s0 + blockIdx.x, tid = threadIdx.x;
  const MvLane<T> L = mv_lane(eval, X0, Y, R, n, d, c0, r, lane);
  const int c = L.c, cw = c - 1, dd = d * d;
  MvPass P;
  mv_p_pass(P, d, c);
  double* w = nullptr;        // the lane's scratch (run-time-sized form)
  double* acc;
  double* fr = nullptr;       // thread 0's frame in it
  double* wst = nullptr;      // the staged rows in it, if there
  if constexpr (MD == 0) {
    w = scratch + (long)blockIdx.x * mv_p_scratch(d, c);
    acc = w + mv_state_len(d, c);
    fr = acc + mv_pass_size(P);
    if (!mv_st_smem(d, c))
      wst = fr + mv_frame_len(d, c) + 3L * d + 2L * c * c + c;
  } else {
    __shared__ double acc_s[MV_ACC_P];
    acc = acc_s;
  }
  const MvSt st = mv_st<MD, MC>(wst);
  if (tid == 0) {
    mv_state_bind(s, w, d, c);
    for (int i = 0; i < dd; ++i) {
      s.Vg[i] = Vg[(long)lane * vstride + i];
      s.Ve[i] = Ve[(long)lane * vstride + i];
    }
    mv_eigen_proc(d, s.Vg, s.Ve, s, nullptr, fr);
  }
  __syncthreads();
  mv_accumulate(L, s, STAGE_Z, P, st, acc);
  if (tid == 0) {
    MvTmp<double, MD> txPx, txPy, tbhat;
    MvTmp<double, MC * MC> tQ, tQi;
    MvTmp<double, MC> twhx;
    double* xPx = txPx.take(fr, d);
    double* xPy = txPy.take(fr, d);
    double* bhat = tbhat.take(fr, d);
    double* Q = tQ.take(fr, c * c);
    double* Qi = tQi.take(fr, c * c);
    double* whx = twhx.take(fr, c);
    double stat = 0.0;
    for (int l = 0; l < d; ++l) {
      for (int i = 0; i < cw; ++i) {
        for (int j = 0; j < cw; ++j) Q[i * cw + j] = mv_q(acc, P, FC_Q, l, i, j);
        whx[i] = mv_q(acc, P, FC_Q, l, i, cw);
      }
      double ld;
      if (cw > 0) mv_inv_logdet<MC>(cw, Q, Qi, ld, fr);
      double px = mv_q(acc, P, FC_Q, l, cw, cw);
      double py = mv_at(acc, P, FC_XWZ, l * c + cw);
      for (int i = 0; i < cw; ++i) {
        double qw = 0.0;
        for (int j = 0; j < cw; ++j) qw += Qi[i * cw + j] * whx[j];
        px -= whx[i] * qw;
        py -= qw * mv_at(acc, P, FC_XWZ, l * c + i);
      }
      xPx[l] = px;
      xPy[l] = py;
      bhat[l] = py / px;
      stat += bhat[l] * py;
    }
    for (int i = 0; i < d; ++i) {
      double b = 0.0;
      for (int l = 0; l < d; ++l) b += s.Uh[l * d + i] * bhat[l];
      beta_out[(long)lane * d + i] = b;
      for (int j = 0; j < d; ++j) {
        double v = 0.0;
        for (int l = 0; l < d; ++l)
          v += s.Uh[l * d + i] * s.Uh[l * d + j] / xPx[l];
        Vbeta_out[(long)lane * dd + i * d + j] = v;
      }
    }
    stat_out[lane] = stat;
    p_out[lane] = gt_chisq_sf(stat, (double)d);
    if (logl1 != nullptr)
      p_lrt_out[lane] = gt_chisq_sf(
          2.0 * (logl1[lane] - logl0[(long)lane * l0stride]), (double)d);
  }
}

#define MPH_CALC_P_LAUNCH(name, T)                                           \
  extern "C" int name##_launch(                                              \
      int S, int n, int d, int c0, int r, const void* eval, const void* X0,  \
      const void* Y, const void* R, const void* Vg, const void* Ve,          \
      int vstride, const void* logl1, const void* logl0, int l0stride,       \
      void* stat, void* p, void* beta, void* Vbeta, void* p_lrt, int s0,     \
      int count, void* scratch, void* stream) {                              \
    const int c = c0 + r;                                                    \
    const bool dyn = mv_dyn(d, c);                                           \
    auto kern = dyn ? mph_calc_p_kernel<T, 0, 0>                             \
                    : mph_calc_p_kernel<T, MV_MAX_D, MV_MAX_C>;              \
    const int smem = dyn && mv_st_smem(d, c)                                 \
                         ? mv_nrow(d, c) * MV_CH * 8 : 0;                    \
    if (smem > 0)                                                            \
      cudaFuncSetAttribute(kern,                                             \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,      \
                           smem);                                            \
    if (count > 0)                                                           \
      kern<<<count, MV_THREADS, smem, (cudaStream_t)stream>>>(               \
          n, d, c0, r, (const T*)eval, (const T*)X0, (const T*)Y,            \
          (const T*)R, (const double*)Vg, (const double*)Ve, vstride,        \
          (const double*)logl1, (const double*)logl0, l0stride,              \
          (double*)stat, (double*)p, (double*)beta, (double*)Vbeta,          \
          (double*)p_lrt, s0, (double*)scratch);                             \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" long name##_lane_bytes(int d, int c) {                          \
    return mv_dyn(d, c) ? 8 * mv_p_scratch(d, c) : 0;                        \
  }

MPH_CALC_P_LAUNCH(mph_calc_p, float)
MPH_CALC_P_LAUNCH(mph_calc_p_f64, double)

GT_ERROR_FN(mph_calc_p)
