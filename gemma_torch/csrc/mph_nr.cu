// K11 — the mvLMM Newton-Raphson on θ = (vech Vg, vech Ve), per lane.
//
// Replaces the reference package's device program
//   gemma_tpu/models/mvlmm_core.py:439 mph_nr (MphNR, mvlmm.cpp:2608-2761)
// with its likelihood _nr_logl_fn (:393) and positive-definiteness test
// _is_pd (:423).
//
// The reference takes the gradient and Hessian by autodiff.  Here they are
// GEMMA's CalcDev quantities in closed form: H_k = δ_k Vg + Ve is linear
// in θ with ∂H_k/∂θ_a = δ_k^{t_a} S_a (S_a the vech basis, an off-diagonal
// parameter at both (i, j) and (j, i); t_a = 1 for Vg, 0 for Ve), so with
// P the REML projection (H^-1 in the trace terms for ML)
//     g_a  = -½ tr(P D_a) + ½ y'P D_a P y
//     H_ab =  ½ tr(P D_a P D_b) - y'P D_a P D_b P y.
// In the whitened basis P is block diagonal in the whitened phenotype l
// (P_l = W_l - W_l X'Qi_l X W_l) and D_a's blocks are δ^t A S_a A', so all
// of it reduces to sums over n (mvlmm_lane.cuh: F_WW, F_N, F_ZZ, F_K,
// F_F, F_MTR, F_WWH) contracted with the d inverse Gram blocks Qi_l.
//
// A team of warps a lane (mvlmm_lane.cuh), the teams taking their lanes
// from the launch's counter.  Per Newton iteration: up to ten step
// halvings, each the PD tests and EigenProc on the team and one pass over
// n for the likelihood (accepted as GEMMA: positive definite, not lower,
// at most 10 higher); GEMMA's exit rules; then at the new point two
// passes over n for the derivative sums, the gradient, the trace tables
// and the Hessian's p2² entries across the team, and its Gauss-Jordan
// inverse across the team (the pivot by a fixed-order reduction, as one
// thread's partial pivoting).  The sums and the Hessian live in a
// per-lane scratch the wrapper allocates (mph_nr_lane_bytes).  Hvar =
// -H^-1 at the last point where derivatives were taken, as the reference
// returns it.
//
// Bound: operations — O(n (d² c² + d³)) float64 multiply-adds per
// derivative evaluation and O(n d c²) per likelihood evaluation.
//
// Lanes [s0, s0 + count) of a launch; the scratch holds `count` lanes
// (the wrapper splits a block's lanes under a byte budget).  Beyond d = 8
// or 10 design rows the run-time-sized form (MD = MC = 0) keeps the
// state, v, vsave, step, grad, the team's temporaries and the trace
// tables' per-thread rows in the scratch too.
#include "mvlmm_lane.cuh"

struct NrFam {
  int t1[3], sw[2], n[2];         // pass A (after the core families)
  int g[2], k[3], f[2], mtr[3], tc[2];   // pass B
};

__host__ __device__ inline void mv_nr_passes(MvPass& A, MvPass& B, NrFam& F,
                                             int d, int c, int reml) {
  mv_pass_core(A, d, c);
  for (int t = 0; t < 3; ++t) F.t1[t] = mv_pass_add(A, F_WW, t);
  for (int t = 0; t < 2; ++t) F.sw[t] = mv_pass_add(A, F_W, t);
  if (reml)
    for (int t = 0; t < 2; ++t) F.n[t] = mv_pass_add(A, F_N, t);
  mv_pass_begin(B, d, c);
  for (int t = 0; t < 2; ++t) F.g[t] = mv_pass_add(B, F_ZZ, t);
  for (int t = 0; t < 3; ++t) F.k[t] = mv_pass_add(B, F_K, t);
  for (int t = 0; t < 2; ++t) F.f[t] = mv_pass_add(B, F_F, t);
  if (reml) {
    for (int t = 0; t < 3; ++t) F.mtr[t] = mv_pass_add(B, F_MTR, t);
    for (int t = 0; t < 2; ++t) F.tc[t] = mv_pass_add(B, F_WWH, t);
  }
}

// float64 values of one lane's scratch: the two passes' sums (REML, the
// larger), the Hessian and its inverse, A S_a A', the trace tables and
// the f vectors
__host__ __device__ inline long mv_nr_scratch(int d, int c) {
  MvPass A, B;
  NrFam F;
  mv_nr_passes(A, B, F, d, c, 1);
  const long p2 = d * (d + 1), nv = p2 / 2;
  return mv_pass_size(A) + mv_pass_size(B) + 2 * p2 * p2 + nv * d * d +
         4 * d * d + p2 * d * c;
}

// doubles of a lane's state: the matrices, v, vsave, step, grad and the
// team's temporaries (the team's shared memory in the fixed
// instantiation, the lane's scratch beyond it)
__host__ __device__ inline long mv_nr_state(int d, int c) {
  const long p2 = (long)d * (d + 1);
  return mv_state_len(d, c) + 4 * p2 + mv_tframe_len(d, c) + p2;
}

// the run-time-sized form's additions to a lane's scratch: the state and
// the trace tables' per-thread rows (two c-vectors a thread)
__host__ __device__ inline long mv_nr_dyn_extra(int d, int c) {
  return mv_nr_state(d, c) + 2L * 32 * MV_MAX_W * c;
}

// v (vech Vg, vech Ve) → the symmetric Vg, Ve, one parameter a thread
__device__ inline void mv_t_unpack(const MvTeam& tm, int d, const double* v,
                                   double* Vg, double* Ve) {
  const int nv = d * (d + 1) / 2;
  MV_TFOR(tm, a, nv) {
    int i, j;
    mv_vech_pair(a, d, i, j);
    Vg[i * d + j] = Vg[j * d + i] = v[a];
    Ve[i * d + j] = Ve[j * d + i] = v[nv + a];
  }
  tm.sync();
}

template <typename T, int MD, int MC>
__global__ void __launch_bounds__(32 * MV_MAX_W, 1)
mph_nr_kernel(int reml, int max_iter, double prec, int n, int d, int c0,
              int r, const T* __restrict__ eval, const T* __restrict__ X0,
              const T* __restrict__ Y, const T* __restrict__ R,
              const double* __restrict__ Vg0, const double* __restrict__ Ve0,
              int vstride, double* scratch, double* Vg_out, double* Ve_out,
              double* logl_out, double* Hvar_out, MvGeom geo, int* ctr,
              int s0, int count) {
  extern __shared__ __align__(16) double mv_smem[];
  const int c = c0 + r, dd = d * d, p2 = d * (d + 1), nv = p2 / 2;
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
  const int nrow = mv_nrow(d, c);
  double* buf = mv_smem + cb + (long)tm.id * geo.team;
  double* cbase = buf + mv_team_buf(nrow, geo.NB, geo.W);
  MvCtl<MvState<0, 0>>& ctl =
      *reinterpret_cast<MvCtl<MvState<0, 0>>*>(cbase);
  MvState<0, 0>& s = ctl.s;
  double* fixed = cbase + MV_CTL;

  MvPass PA, PB, PC, PX;
  NrFam F;
  mv_nr_passes(PA, PB, F, d, c, reml);
  mv_pass_core(PC, d, c);
  mv_pass_begin(PX, d, c);
  mv_pass_add(PX, F_XX);
  MvPass PAr, PBr;           // the REML layout fixes the scratch offsets
  NrFam Fr;
  mv_nr_passes(PAr, PBr, Fr, d, c, 1);
  const long lane_len =
      mv_nr_scratch(d, c) + (MD == 0 ? mv_nr_dyn_extra(d, c) : 0);
  MvProf pf;
  pf.start(tm.leader());

  for (;;) {
    if (tm.leader()) ctl.lane = atomicAdd(ctr, 1);
    tm.sync();
    const int li = ctl.lane;
    if (li >= count) break;
    const int lane = s0 + li;
    pf.count(MV_PC_LANES, 1);
    const MvLane<T> L = mv_lane(ev, x0, y, R, n, d, c0, r, lane);
    double* accA = scratch + (long)li * lane_len;
    double* accB = accA + mv_pass_size(PAr);
    double* H = accB + mv_pass_size(PBr);
    double* Hinv = H + (long)p2 * p2;
    double* St = Hinv + (long)p2 * p2;
    double* Tt = St + (long)nv * dd;
    double* fv = Tt + 4 * dd;
    double* w = MD == 0 ? fv + (long)p2 * d * c : fixed;
    double* v = w + mv_state_len(d, c);
    double* vsave = v + p2;
    double* step = vsave + p2;
    double* grad = step + p2;
    double* fr = grad + p2;    // the team's temporaries
    double* fpiv = fr + mv_tframe_len(d, c);   // the inverse's column
    // the trace tables' per-thread rows (run-time-sized form)
    double* xrow = MD == 0 ? w + mv_nr_state(d, c) + 2L * tm.rank * c
                           : nullptr;
    if (tm.leader()) {
      mv_state_bind(s, w, d, c);
      ctl.logl = -INFINITY;
    }
    tm.sync();
    MV_TFOR(tm, i, dd) {
      s.Vg[i] = Vg0[(long)lane * vstride + i];
      s.Ve[i] = Ve0[(long)lane * vstride + i];
    }
    tm.sync();
    MV_TFOR(tm, a, nv) {
      int i, j;
      mv_vech_pair(a, d, i, j);
      v[a] = s.Vg[i * d + j];
      v[nv + a] = s.Ve[i * d + j];
    }
    MV_TFOR(tm, a, p2) grad[a] = 0.0;
    MV_TFOR(tm, e, p2 * p2) Hinv[e] = e / p2 == e % p2 ? 1.0 : 0.0;
    mv_pass<T, STAGE_X>(tm, L, s, PX, buf, geo.NB, accA, pf);
    if (tm.leader())
      ctl.logl_const = mv_logl_const<MC>(accA, PX, reml, n, nullptr, fr);
    pf.mark(MV_PH_GLS);
    tm.sync();
    pf.mark(MV_PH_WAIT);

    for (int t = 0; t < max_iter; ++t) {
      const bool first = t == 0;
      pf.count(MV_PC_ITERS, 1);
      MV_TFOR(tm, a, p2) {
        vsave[a] = v[a];
        double g = 0.0;
        for (int b = 0; b < p2; ++b) g += Hinv[a * p2 + b] * grad[b];
        step[a] = g;
      }
      pf.mark(MV_PH_STEP);
      tm.sync();
      pf.mark(MV_PH_WAIT);
      // the halving loop: every thread holds the same lnew, pdnew
      double lnew = -INFINITY;
      bool pdnew = false;
      for (int i = 0; i < 10; ++i) {
        const double scale = ldexp(1.0, -i);
        MV_TFOR(tm, a, p2) v[a] = first ? vsave[a] : vsave[a] - scale * step[a];
        tm.sync();
        mv_t_unpack(tm, d, v, s.Vg, s.Ve);
        bool pd = mv_t_is_pd(tm, d, s.Vg, fr);
        if (pd) pd = mv_t_is_pd(tm, d, s.Ve, fr);
        mv_t_eigen_proc(tm, d, s.Vg, s.Ve, s, &s.logdet_Ve, nullptr, fr);
        pf.mark(MV_PH_EIGEN);
        pf.count(MV_PC_LIK, 1);
        mv_pass<T, STAGE_Z>(tm, L, s, PC, buf, geo.NB, accA, pf);
        const double ldq = mv_t_gls<MC>(tm, accA, PC, s, fr);
        const double lt = mv_logl(accA, PC, s, ldq, reml, ctl.logl_const, n);
        lnew = lt;
        pdnew = pd;
        const double lg = ctl.logl;
        pf.mark(MV_PH_GLS);
        if (first || (pd && lt >= lg && lt - lg <= 10.0)) break;
      }
      // GEMMA's exit rules (mvlmm.cpp:2724-2734)
      const double lg = ctl.logl;
      const bool revert = !first && (lnew < lg || !pdnew);
      const bool small = !first && (lnew - lg < prec);
      const bool done = revert || small || !isfinite(lnew);
      tm.sync();               // every thread has read logl
      if (revert)
        MV_TFOR(tm, a, p2) v[a] = vsave[a];
      else if (tm.leader())
        ctl.logl = lnew;
      pf.mark(MV_PH_STEP);
      tm.sync();
      pf.mark(MV_PH_WAIT);
      if (done) break;

      // the derivatives at the new point
      pf.count(MV_PC_DER, 1);
      mv_t_unpack(tm, d, v, s.Vg, s.Ve);
      mv_t_eigen_proc(tm, d, s.Vg, s.Ve, s, &s.logdet_Ve, nullptr, fr);
      pf.mark(MV_PH_EIGEN);
      mv_pass<T, STAGE_Z>(tm, L, s, PA, buf, geo.NB, accA, pf);
      mv_t_gls<MC>(tm, accA, PA, s, fr);
      pf.mark(MV_PH_GLS);
      mv_pass<T, STAGE_PY>(tm, L, s, PB, buf, geo.NB, accB, pf);
      // A S_a A' (whitened derivative basis)
      MV_TFOR(tm, e, nv * dd) {
        const int a = e / dd, l = (e % dd) / d, m = e % d;
        int i, j;
        mv_vech_pair(a, d, i, j);
        St[e] = i == j ? s.A[l * d + i] * s.A[m * d + i]
                       : s.A[l * d + i] * s.A[m * d + j] +
                             s.A[l * d + j] * s.A[m * d + i];
      }
      tm.sync();
      // the gradient and the f vectors
      MV_TFOR(tm, a, p2) {
        const int ta = a < nv ? 1 : 0;
        const double* Sa = St + (a % nv) * dd;
        double g = 0.0;
        for (int l = 0; l < d; ++l) {
          double tau = mv_at(accA, PA, F.sw[ta], l);
          if (reml) tau -= mv_at(accB, PB, F.tc[ta], l);
          g -= 0.5 * Sa[l * d + l] * tau;
          for (int m = 0; m < d; ++m)
            g += 0.5 * Sa[l * d + m] * mv_dd(accB, PB, F.g[ta], l, m);
        }
        grad[a] = g;
      }
      MV_TFOR(tm, e, p2 * d * c) {
        const int a = e / (d * c), l = (e / c) % d, i = e % c;
        const int ta = a < nv ? 1 : 0;
        const double* Sa = St + (a % nv) * dd;
        double f = 0.0;
        for (int m = 0; m < d; ++m)
          f += Sa[l * d + m] * mv_at(accB, PB, F.f[ta], (l * d + m) * c + i);
        fv[e] = f;
      }
      // the trace tables T^{uv}_{lm}; tr(Ql Nu Qm Nw) a row of Ql Nu and a
      // column of Qm Nw at a time
      MV_TFOR(tm, e, 4 * dd) {
        const int u = e / (2 * dd), ww = (e / dd) % 2, l = (e % dd) / d,
                  m = e % d;
        double tv = mv_dd(accA, PA, F.t1[u + ww], l, m);
        if (reml) {
          tv -= mv_at(accB, PB, F.mtr[u + ww], l * d + m) +
                mv_at(accB, PB, F.mtr[u + ww], m * d + l);
          const double* Nu = accA + PA.base[F.n[u]] + mv_ti(l, m, d) * mv_tri(c);
          const double* Nw = accA + PA.base[F.n[ww]] + mv_ti(l, m, d) * mv_tri(c);
          const double* Ql = s.Qi + l * c * c;
          const double* Qm = s.Qi + m * c * c;
          double rl[MC > 0 ? MC : 1], cm[MC > 0 ? MC : 1];
          double* r1 = MC > 0 ? rl : xrow;
          double* c2 = MC > 0 ? cm : xrow + c;
          double tr = 0.0;
          for (int i = 0; i < c; ++i) {
            for (int j = 0; j < c; ++j) {
              double a1 = 0.0, a2 = 0.0;
              for (int k = 0; k < c; ++k) {
                a1 += Ql[i * c + k] * Nu[mv_ti(k, j, c)];
                a2 += Qm[j * c + k] * Nw[mv_ti(k, i, c)];
              }
              r1[j] = a1;
              c2[j] = a2;
            }
            for (int j = 0; j < c; ++j) tr += r1[j] * c2[j];
          }
          tv += tr;
        }
        Tt[e] = tv;
      }
      pf.mark(MV_PH_DERIV);
      tm.sync();
      pf.mark(MV_PH_WAIT);
      // the Hessian, one entry a thread at a time
      MV_TFOR(tm, e, p2 * p2) {
        const int a = e / p2, b = e % p2;
        const int ta = a < nv ? 1 : 0, tb = b < nv ? 1 : 0;
        const double* Sa = St + (a % nv) * dd;
        const double* Sb = St + (b % nv) * dd;
        const double* Tab = Tt + (ta * 2 + tb) * dd;
        const double* K = accB + PB.base[F.k[ta + tb]];
        double tr = 0.0, qd = 0.0;
        for (int l = 0; l < d; ++l) {
          for (int m = 0; m < d; ++m) {
            tr += Sa[l * d + m] * Sb[m * d + l] * Tab[l * d + m];
            for (int q = 0; q < d; ++q)
              qd += Sa[l * d + m] * Sb[l * d + q] *
                    K[l * mv_tri(d) + mv_ti(m, q, d)];
          }
          const double* fa = fv + (a * d + l) * c;
          const double* fb = fv + (b * d + l) * c;
          const double* Ql = s.Qi + l * c * c;
          for (int i = 0; i < c; ++i)
            for (int j = 0; j < c; ++j) qd -= fa[i] * Ql[i * c + j] * fb[j];
        }
        H[e] = 0.5 * tr - qd;
      }
      pf.mark(MV_PH_DERIV);
      tm.sync();
      pf.mark(MV_PH_WAIT);
      mv_t_invert(tm, p2, H, Hinv, &ctl.piv, fpiv);
      pf.mark(MV_PH_INV);
    }
    mv_t_unpack(tm, d, v, s.Vg, s.Ve);
    MV_TFOR(tm, i, dd) {
      Vg_out[(long)lane * dd + i] = s.Vg[i];
      Ve_out[(long)lane * dd + i] = s.Ve[i];
    }
    MV_TFOR(tm, e, p2 * p2) Hvar_out[(long)lane * p2 * p2 + e] = -Hinv[e];
    if (tm.leader()) logl_out[lane] = ctl.logl;
    pf.flush();
    tm.sync();
  }
}

// the launch geometry of K11 at these sizes (mv_geom)
template <typename T>
__host__ inline MvGeom mv_nr_geom(int count, int n, int d, int c0, int r) {
  const int c = c0 + r;
  return mv_geom(count, n, d, c0, c, sizeof(T),
                 mv_dyn(d, c) ? 0 : mv_nr_state(d, c));
}

#define MPH_NR_LAUNCH(name, T)                                               \
  extern "C" int name##_launch(                                              \
      int reml, int max_iter, double prec, int S, int n, int d, int c0,      \
      int r, const void* eval, const void* X0, const void* Y, const void* R, \
      const void* Vg0, const void* Ve0, int vstride, void* Vg, void* Ve,     \
      void* logl, void* Hvar, void* ctr, int s0, int count, void* scratch,   \
      void* stream) {                                                        \
    const int c = c0 + r;                                                    \
    const MvGeom g = mv_nr_geom<T>(count, n, d, c0, r);                      \
    if (!mv_geom_ok(g, d, c)) return (int)cudaErrorInvalidValue;             \
    auto kern = mv_dyn(d, c) ? mph_nr_kernel<T, 0, 0>                        \
                             : mph_nr_kernel<T, MV_MAX_D, MV_MAX_C>;         \
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                         (int)g.bytes);                                      \
    if (count > 0)                                                           \
      kern<<<(count + g.L - 1) / g.L, 32 * g.W * g.L, g.bytes,               \
             (cudaStream_t)stream>>>(                                        \
          reml, max_iter, prec, n, d, c0, r, (const T*)eval, (const T*)X0,   \
          (const T*)Y, (const T*)R, (const double*)Vg0, (const double*)Ve0,  \
          vstride, (double*)scratch, (double*)Vg, (double*)Ve,               \
          (double*)logl, (double*)Hvar, g, (int*)ctr, s0, count);            \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" long name##_lane_bytes(int d, int c) {                          \
    return 8 * (mv_nr_scratch(d, c) +                                        \
                (mv_dyn(d, c) ? mv_nr_dyn_extra(d, c) : 0));                 \
  }                                                                          \
  extern "C" long name##_geometry(int count, int n, int d, int c0, int r,    \
                                  int what) {                                \
    return mv_geom_field(mv_nr_geom<T>(count, n, d, c0, r), what);           \
  }

// built once a precision (-DGT_ONLY=32 / 64, kernels.Kernel's `only`)
#if GT_ONLY != 64
MPH_NR_LAUNCH(mph_nr, float)
#endif
#if GT_ONLY != 32
MPH_NR_LAUNCH(mph_nr_f64, double)
#endif

GT_ERROR_FN(mph_nr)
