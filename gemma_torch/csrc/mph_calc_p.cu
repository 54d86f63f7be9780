// K10 — the mvLMM Wald/score test of a lane's last row, and the χ²(d)
// tails.
//
// Replaces the reference package's device programs
//   gemma_tpu/models/mvlmm_core.py:712 mph_calc_p (MphCalcP,
//   mvlmm.cpp:727-831) and gemma_tpu/ops/stats.py:46 chisq_sf on its
//   statistic and on the LRT difference 2 (logl_H1 - logl_H0)
//   (gemma_tpu/models/mvlmm.py:479, :642).
//
// A team of warps a lane (mvlmm_lane.cuh), the teams taking their lanes
// from the launch's counter: EigenProc of the lane's (Vg, Ve) on the
// team, one float64 pass over n for the whitened Gram blocks of the whole
// design (covariates X0, the lane's rows but the last, and the tested row
// x) and its xHiy; then on the leader per whitened phenotype l the
// eliminated x'P x and x'P y (Qi is block diagonal in l, so x'Px is
// diagonal), beta = UltVeh' bhat, Vbeta = UltVeh' diag(1/x'Px) UltVeh,
// the statistic Σ bhat x'Py and p = Q_χ²(d)(stat) (tails.cuh); where
// logl1 is given also p_lrt = Q_χ²(d)(2 (logl1 - logl0)).
//
// Bound: bytes at small c — one read of the lane's rows (r n values) and
// of the shared operands from L2 — and O(n d c²) float64 operations.
// Beyond d = 8 or 10 design rows the run-time-sized form (MD = MC = 0)
// keeps a lane's state, sums and temporaries in `scratch`
// (mph_calc_p_lane_bytes a lane).
#include "mvlmm_lane.cuh"

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
  const int c = c0 + r, cw = c - 1, dd = d * d;
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
  double* cbase = buf + mv_team_buf(mv_nrow(d, c), geo.NB, geo.W);
  MvCtl<MvState<0, 0>>& ctl =
      *reinterpret_cast<MvCtl<MvState<0, 0>>*>(cbase);
  MvState<0, 0>& s = ctl.s;
  double* fixed = cbase + MV_CTL;
  MvPass P;
  mv_p_pass(P, d, c);
  MvProf pf;
  pf.start(false);
  for (;;) {
    if (tm.leader()) ctl.lane = atomicAdd(ctr, 1);
    tm.sync();
    const int li = ctl.lane;
    if (li >= count) break;
    const int lane = s0 + li;
    const MvLane<T> L = mv_lane(ev, x0, y, R, n, d, c0, r, lane);
    double* w = MD == 0 ? scratch + (long)li * mv_p_state(d, c) : fixed;
    double* acc = w + mv_state_len(d, c);
    double* fr = acc + mv_pass_size(P);
    if (tm.leader()) mv_state_bind(s, w, d, c);
    tm.sync();
    MV_TFOR(tm, i, dd) {
      s.Vg[i] = Vg[(long)lane * vstride + i];
      s.Ve[i] = Ve[(long)lane * vstride + i];
    }
    tm.sync();
    mv_t_eigen_proc(tm, d, s.Vg, s.Ve, s, &s.logdet_Ve, nullptr, fr);
    mv_pass<T, STAGE_Z>(tm, L, s, P, buf, geo.NB, acc, pf);
    if (tm.leader()) {
      double* xPx = fr;
      double* xPy = xPx + d;
      double* bhat = xPy + d;
      double* Q = bhat + d;
      double* Qi = Q + (long)c * c;
      double* whx = Qi + (long)c * c;
      double* fq = whx + c;
      double stat = 0.0;
      for (int l = 0; l < d; ++l) {
        for (int i = 0; i < cw; ++i) {
          for (int j = 0; j < cw; ++j)
            Q[i * cw + j] = mv_q(acc, P, FC_Q, l, i, j);
          whx[i] = mv_q(acc, P, FC_Q, l, i, cw);
        }
        double ld;
        if (cw > 0) mv_inv_logdet<MC>(cw, Q, Qi, ld, fq);
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
    tm.sync();
  }
}

// the launch geometry of K10 at these sizes (mv_geom)
template <typename T>
__host__ inline MvGeom mv_p_geom(int count, int n, int d, int c0, int r) {
  const int c = c0 + r;
  return mv_geom(count, n, d, c0, c, sizeof(T),
                 mv_dyn(d, c) ? 0 : mv_p_state(d, c));
}

#define MPH_CALC_P_LAUNCH(name, T)                                           \
  extern "C" int name##_launch(                                              \
      int S, int n, int d, int c0, int r, const void* eval, const void* X0,  \
      const void* Y, const void* R, const void* Vg, const void* Ve,          \
      int vstride, const void* logl1, const void* logl0, int l0stride,       \
      void* stat, void* p, void* beta, void* Vbeta, void* p_lrt, void* ctr,  \
      int s0, int count, void* scratch, void* stream) {                      \
    const int c = c0 + r;                                                    \
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
    return mv_dyn(d, c) ? 8 * mv_p_state(d, c) : 0;                          \
  }                                                                          \
  extern "C" long name##_geometry(int count, int n, int d, int c0, int r,    \
                                  int what) {                                \
    return mv_geom_field(mv_p_geom<T>(count, n, d, c0, r), what);            \
  }

MPH_CALC_P_LAUNCH(mph_calc_p, float)
MPH_CALC_P_LAUNCH(mph_calc_p_f64, double)

GT_ERROR_FN(mph_calc_p)
