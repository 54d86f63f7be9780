// K9 — the mvLMM PX-EM for (Vg, Ve, B), per lane until it converges.
//
// Replaces the reference package's device program
//   gemma_tpu/models/mvlmm_core.py:225 mph_em (MphEM, mvlmm.cpp:599-724)
// and the straggler compaction of its staged driver
//   gemma_tpu/models/mvlmm.py:173 _em_staged.
//
// One thread block per lane.  Each iteration: EigenProc on thread 0, one
// pass over n for the d Gram blocks Σ w x x', xHiy, y'H^-1y and log|H|
// (and, in ML, GEMMA's residual sums with the carried UltVehiB), the
// log-likelihood and the exit test on thread 0, a second pass for the
// M-step's outer products once B is known (REML: E = w (z - B x) and the
// trace terms x'Qi x; ML: E with this iteration's B), then CalcSigma and
// UpdateV on thread 0.  A lane stops when |Δlogl| < prec (tested from t =
// 1, and with `staged` not at the reference's burst starts 32, 96, 224,
// ...), when its logl goes non-finite (Vg, Ve, B NaN-poisoned, as the
// reference), or at max_iter; it writes its iteration count.  So no lane
// waits for another and nothing is compacted.  In ML the eigenvectors of
// Ve^-1/2 Vg Ve^-1/2 keep the previous iteration's signs (d >= 3), since
// GEMMA's UltVehiBX is carried in the previous basis.
//
// Bound: operations — per iteration and lane two float64 passes of
// O(n d (c² + d)) multiply-adds; the lane's rows are read once per pass
// (from L2 after the first).  Staging a lane's rows in shared memory is
// left for a later change.
#include "mvlmm_lane.cuh"

#define MV_ACC_A 672   // pass A at d = 8, c = 10 (ML): 668 sums
#define MV_ACC_B 96    // pass B at d = 8 (REML): 88 sums

// the first iteration of each of the reference's EM bursts (32, then
// doubling up to 512)
__device__ inline bool mv_burst_start(int t) {
  int b = 32, len = 32;
  while (b < t) {
    len = min(2 * len, 512);
    b += len;
  }
  return b == t;
}

template <typename T>
__global__ void __launch_bounds__(MV_THREADS)
mph_em_kernel(int reml, int staged, int max_iter, double prec, int n, int d,
              int c0, int r, const T* __restrict__ eval,
              const T* __restrict__ X0, const T* __restrict__ Y,
              const T* __restrict__ R, const double* __restrict__ Vg0,
              const double* __restrict__ Ve0, int vstride,
              const double* __restrict__ B0, int bstride, double* Vg_out,
              double* Ve_out, double* B_out, double* logl_out, int* done_out,
              int* iters_out) {
  __shared__ double st[MV_NROW][MV_CH];
  __shared__ MvState s;
  __shared__ double accA[MV_ACC_A];
  __shared__ double accB[MV_ACC_B];
  __shared__ double XXi[MV_MAX_C * MV_MAX_C];
  __shared__ double Ulp[MV_MAX_D * MV_MAX_D];
  __shared__ double B[MV_MAX_D * MV_MAX_C];
  __shared__ double logl_const;
  const int lane = blockIdx.x, tid = threadIdx.x;
  const MvLane<T> L = mv_lane(eval, X0, Y, R, n, d, c0, r, lane);
  const int c = L.c, dd = d * d;

  MvPass PX;
  mv_pass_begin(PX, d, c);
  mv_pass_add(PX, F_XX);
  MvPass PA;
  mv_pass_core(PA, d, c);
  const int fSW = mv_pass_add(PA, F_W, 0), fSDW = mv_pass_add(PA, F_W, 1);
  int fS1 = 0, fGG = 0;
  if (!reml) {
    fS1 = mv_pass_add(PA, F_S1);
    fGG = mv_pass_add(PA, F_GG, 1);
  }
  MvPass PB;
  mv_pass_begin(PB, d, c);
  int fG0 = 0, fG1 = 0, fSE = 0, fSU = 0;
  if (reml) {
    fG0 = mv_pass_add(PB, F_ZZ, 0);
    fG1 = mv_pass_add(PB, F_ZZ, 1);
    fSE = mv_pass_add(PB, F_WWH, 0);
    fSU = mv_pass_add(PB, F_WWH, 1);
  } else {
    fG0 = mv_pass_add(PB, F_ZZ, 0);
  }

  if (tid == 0) {
    for (int i = 0; i < dd; ++i) {
      s.Vg[i] = Vg0[(long)lane * vstride + i];
      s.Ve[i] = Ve0[(long)lane * vstride + i];
    }
    for (int i = 0; i < d * c; ++i) B[i] = B0[(long)lane * bstride + i];
    s.flag = 0;
  }
  mv_accumulate(L, s, STAGE_X, PX, st, accA);
  if (tid == 0) logl_const = mv_logl_const(accA, PX, reml, n, XXi);
  __syncthreads();

  double logl = 0.0, logl_prev = 0.0;      // thread 0's
  int done = 0, iters = max_iter;
  for (int t = 0; t < max_iter; ++t) {
    if (tid == 0) {
      mv_eigen_proc(d, s.Vg, s.Ve, s, (!reml && t > 0) ? Ulp : nullptr);
      if (!reml && t == 0)     // GEMMA seeds UltVehiBX from the input B
        for (int l = 0; l < d; ++l)
          for (int i = 0; i < c; ++i) {
            double a = 0.0;
            for (int m = 0; m < d; ++m) a += s.A[l * d + m] * B[m * c + i];
            s.Bc[l * c + i] = a;
          }
    }
    __syncthreads();
    mv_accumulate(L, s, reml ? STAGE_Z : STAGE_ML, PA, st, accA);
    if (tid == 0) {
      const double ldq = mv_gls(accA, PA, s);
      const double ll = mv_logl(accA, PA, s, ldq, reml, logl_const, n);
      const bool check = t > 0 && !(staged && mv_burst_start(t));
      const bool fin = isfinite(ll);
      s.flag = 0;
      if (check && (fabs(ll - logl_prev) < prec || !fin)) {
        done = 1;
        iters = t;
        s.flag = 1;
        if (!fin) {            // NaN-poisoned, as the reference
          const double nan = ll - ll;
          for (int i = 0; i < dd; ++i) s.Vg[i] = s.Ve[i] = nan;
          for (int i = 0; i < d * c; ++i) B[i] = nan;
          logl = ll;
        }
      } else {
        logl = logl_prev = ll;
        if (!reml)             // UpdateL_B: this iteration's UltVehiB
          for (int l = 0; l < d; ++l)
            for (int i = 0; i < c; ++i) {
              double a = 0.0;
              for (int j = 0; j < c; ++j)
                a += mv_at(accA, PA, fS1, l * c + j) * XXi[j * c + i];
              s.Bn[l * c + i] = a;
            }
      }
    }
    __syncthreads();
    if (s.flag) break;
    mv_accumulate(L, s, reml ? STAGE_PY : STAGE_E, PB, st, accB);
    if (tid == 0) {
      // CalcSigma and UpdateV in the whitened basis, then rotated back
      double U[MV_MAX_D * MV_MAX_D], E[MV_MAX_D * MV_MAX_D];
      for (int l = 0; l < d; ++l) {
        for (int m = 0; m < d; ++m) {
          const double uu = reml ? mv_dd(accB, PB, fG1, l, m)
                                 : mv_dd(accA, PA, fGG, l, m);
          U[l * d + m] = s.D[l] * uu * s.D[m];
          E[l * d + m] = mv_dd(accB, PB, fG0, l, m);
        }
        const double sw = mv_at(accA, PA, fSW, l);
        const double sdw = mv_at(accA, PA, fSDW, l);
        U[l * d + l] += s.D[l] * sw;
        E[l * d + l] += s.D[l] * sdw;
        if (reml) {
          U[l * d + l] += s.D[l] * s.D[l] * mv_at(accB, PB, fSU, l);
          E[l * d + l] += mv_at(accB, PB, fSE, l);
        }
      }
      for (int i = 0; i < d; ++i)
        for (int j = 0; j < d; ++j) {
          double g = 0.0, e = 0.0;
          for (int l = 0; l < d; ++l)
            for (int m = 0; m < d; ++m) {
              const double h = s.Uh[l * d + i] * s.Uh[m * d + j];
              g += h * U[l * d + m];
              e += h * E[l * d + m];
            }
          s.Vg[i * d + j] = g / n;
          s.Ve[i * d + j] = e / n;
        }
      const double* Bw = reml ? s.beta : s.Bn;
      for (int i = 0; i < d; ++i)
        for (int j = 0; j < c; ++j) {
          double a = 0.0;
          for (int l = 0; l < d; ++l) a += s.Uh[l * d + i] * Bw[l * c + j];
          B[i * c + j] = a;
        }
      if (!reml) {
        for (int i = 0; i < d * c; ++i) s.Bc[i] = s.Bn[i];
        for (int i = 0; i < dd; ++i) Ulp[i] = s.Ul[i];
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    for (int i = 0; i < dd; ++i) {
      Vg_out[(long)lane * dd + i] = s.Vg[i];
      Ve_out[(long)lane * dd + i] = s.Ve[i];
    }
    for (int i = 0; i < d * c; ++i) B_out[(long)lane * d * c + i] = B[i];
    logl_out[lane] = logl;
    done_out[lane] = done;
    iters_out[lane] = iters;
  }
}

#define MPH_EM_LAUNCH(name, T)                                               \
  extern "C" int name##_launch(                                              \
      int reml, int staged, int max_iter, double prec, int S, int n, int d,  \
      int c0, int r, const void* eval, const void* X0, const void* Y,        \
      const void* R, const void* Vg0, const void* Ve0, int vstride,          \
      const void* B0, int bstride, void* Vg, void* Ve, void* B, void* logl,  \
      void* done, void* iters, void* stream) {                               \
    if (S > 0)                                                               \
      mph_em_kernel<T><<<S, MV_THREADS, 0, (cudaStream_t)stream>>>(          \
          reml, staged, max_iter, prec, n, d, c0, r, (const T*)eval,         \
          (const T*)X0, (const T*)Y, (const T*)R, (const double*)Vg0,        \
          (const double*)Ve0, vstride, (const double*)B0, bstride,           \
          (double*)Vg, (double*)Ve, (double*)B, (double*)logl, (int*)done,   \
          (int*)iters);                                                      \
    return (int)cudaGetLastError();                                          \
  }

MPH_EM_LAUNCH(mph_em, float)
MPH_EM_LAUNCH(mph_em_f64, double)

GT_ERROR_FN(mph_em)
