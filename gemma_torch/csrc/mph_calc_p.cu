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
#include "mvlmm_lane.cuh"

#define MV_ACC_P 528   // Gram blocks and xHiy at d = 8, c = 10: 520 sums

template <typename T>
__global__ void __launch_bounds__(MV_THREADS)
mph_calc_p_kernel(int n, int d, int c0, int r, const T* __restrict__ eval,
                  const T* __restrict__ X0, const T* __restrict__ Y,
                  const T* __restrict__ R, const double* __restrict__ Vg,
                  const double* __restrict__ Ve, int vstride,
                  const double* __restrict__ logl1,
                  const double* __restrict__ logl0, int l0stride,
                  double* stat_out, double* p_out, double* beta_out,
                  double* Vbeta_out, double* p_lrt_out) {
  __shared__ double st[MV_NROW][MV_CH];
  __shared__ MvState s;
  __shared__ double acc[MV_ACC_P];
  const int lane = blockIdx.x, tid = threadIdx.x;
  const MvLane<T> L = mv_lane(eval, X0, Y, R, n, d, c0, r, lane);
  const int c = L.c, cw = c - 1, dd = d * d;
  MvPass P;
  mv_pass_begin(P, d, c);
  mv_pass_add(P, F_Q, 0);     // FC_Q
  mv_pass_add(P, F_XWZ);      // FC_XWZ
  if (tid == 0) {
    for (int i = 0; i < dd; ++i) {
      s.Vg[i] = Vg[(long)lane * vstride + i];
      s.Ve[i] = Ve[(long)lane * vstride + i];
    }
    mv_eigen_proc(d, s.Vg, s.Ve, s, nullptr);
  }
  __syncthreads();
  mv_accumulate(L, s, STAGE_Z, P, st, acc);
  if (tid == 0) {
    double xPx[MV_MAX_D], xPy[MV_MAX_D], bhat[MV_MAX_D];
    double stat = 0.0;
    for (int l = 0; l < d; ++l) {
      double Q[MV_MAX_C * MV_MAX_C], Qi[MV_MAX_C * MV_MAX_C], whx[MV_MAX_C];
      for (int i = 0; i < cw; ++i) {
        for (int j = 0; j < cw; ++j) Q[i * cw + j] = mv_q(acc, P, FC_Q, l, i, j);
        whx[i] = mv_q(acc, P, FC_Q, l, i, cw);
      }
      double ld;
      if (cw > 0) mv_inv_logdet(cw, Q, Qi, ld);
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
      void* stat, void* p, void* beta, void* Vbeta, void* p_lrt,             \
      void* stream) {                                                        \
    if (S > 0)                                                               \
      mph_calc_p_kernel<T><<<S, MV_THREADS, 0, (cudaStream_t)stream>>>(      \
          n, d, c0, r, (const T*)eval, (const T*)X0, (const T*)Y,            \
          (const T*)R, (const double*)Vg, (const double*)Ve, vstride,        \
          (const double*)logl1, (const double*)logl0, l0stride,              \
          (double*)stat, (double*)p, (double*)beta, (double*)Vbeta,          \
          (double*)p_lrt);                                                   \
    return (int)cudaGetLastError();                                          \
  }

MPH_CALC_P_LAUNCH(mph_calc_p, float)
MPH_CALC_P_LAUNCH(mph_calc_p_f64, double)

GT_ERROR_FN(mph_calc_p)
