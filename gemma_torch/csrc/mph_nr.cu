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
// One thread block per lane.  Per Newton iteration: up to ten step
// halvings, each an EigenProc and one pass over n for the likelihood
// (accepted as GEMMA: positive definite, not lower, at most 10 higher);
// GEMMA's exit rules; then at the new point two passes over n for the
// derivative sums, the Hessian's p2² entries across the block's threads
// and its inverse on thread 0 (Gauss-Jordan, partial pivoting).  The
// sums and the Hessian live in a per-lane scratch the wrapper allocates
// (its size: mph_nr_lane_bytes).  Hvar = -H^-1 at the last point where
// derivatives were taken, as the reference returns it.
//
// Bound: operations — O(n (d² c² + d³)) float64 multiply-adds per
// derivative evaluation and O(n d c²) per likelihood evaluation.
//
// Lanes [s0, s0 + count) of a launch; the scratch holds `count` lanes
// (the wrapper splits a block's lanes under a byte budget).  Beyond d = 8
// or 10 design rows the run-time-sized form (MD = MC = 0, mvlmm_lane.cuh)
// runs, with its state, v, vsave, step, grad, thread 0's frame and the
// trace tables' per-thread c×c products in the scratch too.
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

__device__ inline void mv_unpack(int d, const double* v, double* Vg,
                                 double* Ve) {
  const int nv = d * (d + 1) / 2;
  for (int a = 0; a < nv; ++a) {
    int i, j;
    mv_vech_pair(a, d, i, j);
    Vg[i * d + j] = Vg[j * d + i] = v[a];
    Ve[i * d + j] = Ve[j * d + i] = v[nv + a];
  }
}

// the run-time-sized form's additions to a lane's scratch: the state, v,
// vsave, step, grad, thread 0's frame, the trace tables' per-thread
// products and, where they outgrow MV_ST_SMEM, the staged rows
__host__ __device__ inline long mv_nr_dyn_extra(int d, int c) {
  const long p2 = (long)d * (d + 1);
  return mv_state_len(d, c) + 4 * p2 + mv_frame_len(d, c) +
         2L * MV_THREADS * c * c +
         (mv_st_smem(d, c) ? 0 : (long)mv_nrow(d, c) * MV_CH);
}

template <int MD>
__device__ inline bool mv_is_pd(int d, const double* M, double* fr) {
  MvTmp<double, MD * MD> tW, tV;
  MvTmp<double, MD> tw;
  double* W = tW.take(fr, d * d);
  double* w = tw.take(fr, d);
  double* V = tV.take(fr, d * d);
  for (int i = 0; i < d * d; ++i) W[i] = M[i];
  mv_eigh<MD>(d, W, w, V, nullptr, fr);
  for (int i = 0; i < d; ++i)
    if (!(w[i] > 0.0)) return false;
  return true;
}

template <typename T, int MD, int MC>
__global__ void __launch_bounds__(MV_THREADS)
mph_nr_kernel(int reml, int max_iter, double prec, int n, int d, int c0,
              int r, const T* __restrict__ eval, const T* __restrict__ X0,
              const T* __restrict__ Y, const T* __restrict__ R,
              const double* __restrict__ Vg0, const double* __restrict__ Ve0,
              int vstride, double* scratch, double* Vg_out, double* Ve_out,
              double* logl_out, double* Hvar_out, int s0) {
  __shared__ MvState<MD, MC> s;
  __shared__ double logl_const, logl;
  __shared__ int accepted, done;
  const int lane = s0 + blockIdx.x, tid = threadIdx.x;
  const MvLane<T> L = mv_lane(eval, X0, Y, R, n, d, c0, r, lane);
  const int c = L.c, dd = d * d, p2 = d * (d + 1), nv = p2 / 2;

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
  double* accA = scratch + (long)blockIdx.x * lane_len;
  double* accB = accA + mv_pass_size(PAr);
  double* H = accB + mv_pass_size(PBr);
  double* Hinv = H + (long)p2 * p2;
  double* St = Hinv + (long)p2 * p2;
  double* Tt = St + (long)nv * dd;
  double* fv = Tt + 4 * dd;
  double *v, *vsave, *step, *grad;
  double* w = fv + (long)p2 * d * c;  // the run-time-sized form's part
  double* fr = nullptr;       // thread 0's frame in it
  double* xfr = nullptr;      // the trace tables' per-thread products
  double* wst = nullptr;      // the staged rows in it, if there
  if constexpr (MD == 0) {
    v = w + mv_state_len(d, c);
    vsave = v + p2;
    step = vsave + p2;
    grad = step + p2;
    fr = grad + p2;
    xfr = fr + mv_frame_len(d, c);
    if (!mv_st_smem(d, c)) wst = xfr + 2L * MV_THREADS * c * c;
  } else {
    __shared__ double v_s[MV_MAX_D * (MV_MAX_D + 1)],
        vsave_s[MV_MAX_D * (MV_MAX_D + 1)], step_s[MV_MAX_D * (MV_MAX_D + 1)],
        grad_s[MV_MAX_D * (MV_MAX_D + 1)];
    v = v_s;
    vsave = vsave_s;
    step = step_s;
    grad = grad_s;
  }
  const MvSt st = mv_st<MD, MC>(wst);

  if (tid == 0) {
    mv_state_bind(s, w, d, c);
    for (int i = 0; i < dd; ++i) {
      s.Vg[i] = Vg0[(long)lane * vstride + i];
      s.Ve[i] = Ve0[(long)lane * vstride + i];
    }
    for (int a = 0; a < nv; ++a) {
      int i, j;
      mv_vech_pair(a, d, i, j);
      v[a] = s.Vg[i * d + j];
      v[nv + a] = s.Ve[i * d + j];
    }
    for (int a = 0; a < p2; ++a) {
      grad[a] = 0.0;
      for (int b = 0; b < p2; ++b) Hinv[a * p2 + b] = a == b ? 1.0 : 0.0;
    }
    logl = -INFINITY;
    done = 0;
  }
  mv_accumulate(L, s, STAGE_X, PX, st, accA);
  if (tid == 0)
    logl_const = mv_logl_const<MC>(accA, PX, reml, n, nullptr, fr);
  __syncthreads();

  for (int t = 0; t < max_iter; ++t) {
    const bool first = t == 0;
    // thread 0's view of the halving loop
    double lnew = -INFINITY;
    bool pdnew = false;
    if (tid == 0) {
      for (int a = 0; a < p2; ++a) {
        vsave[a] = v[a];
        double g = 0.0;
        for (int b = 0; b < p2; ++b) g += Hinv[a * p2 + b] * grad[b];
        step[a] = g;
      }
      accepted = 0;
    }
    __syncthreads();
    for (int i = 0; i < 10; ++i) {
      bool pd = false;
      if (tid == 0) {
        const double scale = ldexp(1.0, -i);
        for (int a = 0; a < p2; ++a)
          v[a] = first ? vsave[a] : vsave[a] - scale * step[a];
        mv_unpack(d, v, s.Vg, s.Ve);
        pd = mv_is_pd<MD>(d, s.Vg, fr) && mv_is_pd<MD>(d, s.Ve, fr);
        mv_eigen_proc(d, s.Vg, s.Ve, s, nullptr, fr);
      }
      __syncthreads();
      mv_accumulate(L, s, STAGE_Z, PC, st, accA);
      if (tid == 0) {
        const double ldq = mv_gls(accA, PC, s, fr);
        const double lt = mv_logl(accA, PC, s, ldq, reml, logl_const, n);
        lnew = lt;
        pdnew = pd;
        accepted = first || (pd && lt >= logl && lt - logl <= 10.0);
      }
      __syncthreads();
      if (accepted) break;
    }
    if (tid == 0) {
      // GEMMA's exit rules (mvlmm.cpp:2724-2734)
      const bool revert = !first && (lnew < logl || !pdnew);
      const bool small = !first && (lnew - logl < prec);
      done = revert || small || !isfinite(lnew);
      if (revert)
        for (int a = 0; a < p2; ++a) v[a] = vsave[a];
      else
        logl = lnew;
    }
    __syncthreads();
    if (done) break;

    // the derivatives at the new point
    if (tid == 0) {
      mv_unpack(d, v, s.Vg, s.Ve);
      mv_eigen_proc(d, s.Vg, s.Ve, s, nullptr, fr);
    }
    __syncthreads();
    mv_accumulate(L, s, STAGE_Z, PA, st, accA);
    if (tid == 0) mv_gls(accA, PA, s, fr);
    __syncthreads();
    mv_accumulate(L, s, STAGE_PY, PB, st, accB);
    if (tid == 0) {
      // A S_a A' (whitened derivative basis), the gradient, the f vectors
      for (int a = 0; a < nv; ++a) {
        int i, j;
        mv_vech_pair(a, d, i, j);
        for (int l = 0; l < d; ++l)
          for (int m = 0; m < d; ++m)
            St[a * dd + l * d + m] =
                i == j ? s.A[l * d + i] * s.A[m * d + i]
                       : s.A[l * d + i] * s.A[m * d + j] +
                             s.A[l * d + j] * s.A[m * d + i];
      }
      for (int a = 0; a < p2; ++a) {
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
        for (int l = 0; l < d; ++l)
          for (int i = 0; i < c; ++i) {
            double f = 0.0;
            for (int m = 0; m < d; ++m)
              f += Sa[l * d + m] *
                   mv_at(accB, PB, F.f[ta], (l * d + m) * c + i);
            fv[(a * d + l) * c + i] = f;
          }
      }
    }
    // the trace tables T^{uv}_{lm}
    for (int e = tid; e < 4 * dd; e += MV_THREADS) {
      const int u = e / (2 * dd), w = (e / dd) % 2, l = (e % dd) / d,
                m = e % d;
      double tv = mv_dd(accA, PA, F.t1[u + w], l, m);
      if (reml) {
        tv -= mv_at(accB, PB, F.mtr[u + w], l * d + m) +
              mv_at(accB, PB, F.mtr[u + w], m * d + l);
        const double* Nu = accA + PA.base[F.n[u]] + mv_ti(l, m, d) * mv_tri(c);
        const double* Nw = accA + PA.base[F.n[w]] + mv_ti(l, m, d) * mv_tri(c);
        const double* Ql = s.Qi + l * c * c;
        const double* Qm = s.Qi + m * c * c;
        MvTmp<double, MC * MC> tX1, tX2;
        double* xf = xfr + 2L * tid * c * c;
        double* X1 = tX1.take(xf, c * c);
        double* X2 = tX2.take(xf, c * c);
        for (int i = 0; i < c; ++i)
          for (int j = 0; j < c; ++j) {
            double a1 = 0.0, a2 = 0.0;
            for (int k = 0; k < c; ++k) {
              a1 += Ql[i * c + k] * Nu[mv_ti(k, j, c)];
              a2 += Qm[i * c + k] * Nw[mv_ti(k, j, c)];
            }
            X1[i * c + j] = a1;
            X2[i * c + j] = a2;
          }
        double tr = 0.0;
        for (int i = 0; i < c; ++i)
          for (int j = 0; j < c; ++j) tr += X1[i * c + j] * X2[j * c + i];
        tv += tr;
      }
      Tt[e] = tv;
    }
    __syncthreads();
    // the Hessian, one entry per thread at a time
    for (int e = tid; e < p2 * p2; e += MV_THREADS) {
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
    __syncthreads();
    if (tid == 0) mv_invert(p2, H, Hinv);
    __syncthreads();
  }
  if (tid == 0) {
    mv_unpack(d, v, s.Vg, s.Ve);
    for (int i = 0; i < dd; ++i) {
      Vg_out[(long)lane * dd + i] = s.Vg[i];
      Ve_out[(long)lane * dd + i] = s.Ve[i];
    }
    logl_out[lane] = logl;
    for (int e = 0; e < p2 * p2; ++e)
      Hvar_out[(long)lane * p2 * p2 + e] = -Hinv[e];
  }
}

#define MPH_NR_LAUNCH(name, T)                                               \
  extern "C" int name##_launch(                                              \
      int reml, int max_iter, double prec, int S, int n, int d, int c0,      \
      int r, const void* eval, const void* X0, const void* Y, const void* R, \
      const void* Vg0, const void* Ve0, int vstride, void* Vg, void* Ve,     \
      void* logl, void* Hvar, int s0, int count, void* scratch,              \
      void* stream) {                                                        \
    const int c = c0 + r;                                                    \
    const bool dyn = mv_dyn(d, c);                                           \
    auto kern = dyn ? mph_nr_kernel<T, 0, 0>                                 \
                    : mph_nr_kernel<T, MV_MAX_D, MV_MAX_C>;                  \
    const int smem = dyn && mv_st_smem(d, c)                                 \
                         ? mv_nrow(d, c) * MV_CH * 8 : 0;                    \
    if (smem > 0)                                                            \
      cudaFuncSetAttribute(kern,                                             \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,      \
                           smem);                                            \
    if (count > 0)                                                           \
      kern<<<count, MV_THREADS, smem, (cudaStream_t)stream>>>(               \
          reml, max_iter, prec, n, d, c0, r, (const T*)eval, (const T*)X0,   \
          (const T*)Y, (const T*)R, (const double*)Vg0, (const double*)Ve0,  \
          vstride, (double*)scratch, (double*)Vg, (double*)Ve,               \
          (double*)logl, (double*)Hvar, s0);                                 \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" long name##_lane_bytes(int d, int c) {                          \
    return 8 * (mv_nr_scratch(d, c) +                                        \
                (mv_dyn(d, c) ? mv_nr_dyn_extra(d, c) : 0));                 \
  }

MPH_NR_LAUNCH(mph_nr, float)
MPH_NR_LAUNCH(mph_nr_f64, double)

GT_ERROR_FN(mph_nr)
