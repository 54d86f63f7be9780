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
// (mvlmm_core.nr_scratch mirrors mv_nr_scratch).  Hvar = -H^-1 at the last point where
// derivatives were taken, as the reference returns it.
//
// Bound: operations — O(n (d² c² + d³)) float64 multiply-adds per
// derivative evaluation and O(n d c²) per likelihood evaluation.
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

__device__ inline bool mv_is_pd(int d, const double* M) {
  double W[MV_MAX_D * MV_MAX_D], w[MV_MAX_D], V[MV_MAX_D * MV_MAX_D];
  for (int i = 0; i < d * d; ++i) W[i] = M[i];
  mv_eigh(d, W, w, V, nullptr);
  for (int i = 0; i < d; ++i)
    if (!(w[i] > 0.0)) return false;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(MV_THREADS)
mph_nr_kernel(int reml, int max_iter, double prec, int n, int d, int c0,
              int r, const T* __restrict__ eval, const T* __restrict__ X0,
              const T* __restrict__ Y, const T* __restrict__ R,
              const double* __restrict__ Vg0, const double* __restrict__ Ve0,
              int vstride, double* scratch, double* Vg_out, double* Ve_out,
              double* logl_out, double* Hvar_out) {
  __shared__ double st[MV_NROW][MV_CH];
  __shared__ MvState s;
  __shared__ double v[MV_MAX_D * (MV_MAX_D + 1)],
      vsave[MV_MAX_D * (MV_MAX_D + 1)], step[MV_MAX_D * (MV_MAX_D + 1)],
      grad[MV_MAX_D * (MV_MAX_D + 1)];
  __shared__ double logl_const, logl;
  __shared__ int accepted, done;
  const int lane = blockIdx.x, tid = threadIdx.x;
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
  double* accA = scratch + (long)lane * mv_nr_scratch(d, c);
  double* accB = accA + mv_pass_size(PAr);
  double* H = accB + mv_pass_size(PBr);
  double* Hinv = H + p2 * p2;
  double* St = Hinv + p2 * p2;
  double* Tt = St + nv * dd;
  double* fv = Tt + 4 * dd;

  if (tid == 0) {
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
  if (tid == 0) logl_const = mv_logl_const(accA, PX, reml, n, nullptr);
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
        pd = mv_is_pd(d, s.Vg) && mv_is_pd(d, s.Ve);
        mv_eigen_proc(d, s.Vg, s.Ve, s, nullptr);
      }
      __syncthreads();
      mv_accumulate(L, s, STAGE_Z, PC, st, accA);
      if (tid == 0) {
        const double ldq = mv_gls(accA, PC, s);
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
      mv_eigen_proc(d, s.Vg, s.Ve, s, nullptr);
    }
    __syncthreads();
    mv_accumulate(L, s, STAGE_Z, PA, st, accA);
    if (tid == 0) mv_gls(accA, PA, s);
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
        double X1[MV_MAX_C * MV_MAX_C], X2[MV_MAX_C * MV_MAX_C];
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
      const void* Vg0, const void* Ve0, int vstride, void* scratch,          \
      void* Vg, void* Ve, void* logl, void* Hvar, void* stream) {            \
    if (S > 0)                                                               \
      mph_nr_kernel<T><<<S, MV_THREADS, 0, (cudaStream_t)stream>>>(          \
          reml, max_iter, prec, n, d, c0, r, (const T*)eval, (const T*)X0,   \
          (const T*)Y, (const T*)R, (const double*)Vg0, (const double*)Ve0,  \
          vstride, (double*)scratch, (double*)Vg, (double*)Ve,               \
          (double*)logl, (double*)Hvar);                                     \
    return (int)cudaGetLastError();                                          \
  }

MPH_NR_LAUNCH(mph_nr, float)
MPH_NR_LAUNCH(mph_nr_f64, double)

GT_ERROR_FN(mph_nr)
