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
// left for a later change.  Beyond d = 8 or 10 design rows the
// run-time-sized form (MD = MC = 0, mvlmm_lane.cuh) runs on lanes [s0,
// s0 + count), its state, sums, XXi, Ulp, B and thread 0's frame in
// `scratch` (mph_em_lane_bytes a lane).
#include "mvlmm_lane.cuh"

#define MV_ACC_A 672   // pass A at d = 8, c = 10 (ML): 668 sums
#define MV_ACC_B 96    // pass B at d = 8 (REML): 88 sums

// the EM's passes: PX (X X'), PA (the likelihood and, in ML, GEMMA's
// residual sums) and PB (the M-step's outer products); returns the
// families the M-step reads
struct EmFam {
  int sw, sdw, s1, gg, g0, g1, se, su;
};

__host__ __device__ inline EmFam mv_em_passes(MvPass& PX, MvPass& PA,
                                              MvPass& PB, int d, int c,
                                              int reml) {
  EmFam F{0, 0, 0, 0, 0, 0, 0, 0};
  mv_pass_begin(PX, d, c);
  mv_pass_add(PX, F_XX);
  mv_pass_core(PA, d, c);
  F.sw = mv_pass_add(PA, F_W, 0);
  F.sdw = mv_pass_add(PA, F_W, 1);
  if (!reml) {
    F.s1 = mv_pass_add(PA, F_S1);
    F.gg = mv_pass_add(PA, F_GG, 1);
  }
  mv_pass_begin(PB, d, c);
  if (reml) {
    F.g0 = mv_pass_add(PB, F_ZZ, 0);
    F.g1 = mv_pass_add(PB, F_ZZ, 1);
    F.se = mv_pass_add(PB, F_WWH, 0);
    F.su = mv_pass_add(PB, F_WWH, 1);
  } else {
    F.g0 = mv_pass_add(PB, F_ZZ, 0);
  }
  return F;
}

// doubles of a lane's scratch in the run-time-sized form: the state, the
// largest pass A and B (ML's A, REML's B; PX fits in A), XXi, Ulp, B,
// thread 0's frame (U and E beside the lane code's) and, where they
// outgrow MV_ST_SMEM, the staged rows
__host__ __device__ inline long mv_em_acc_a(int d, int c) {
  MvPass PX, PA, PB;
  mv_em_passes(PX, PA, PB, d, c, 0);
  const long a = mv_pass_size(PA), x = mv_pass_size(PX);
  return a > x ? a : x;
}
__host__ __device__ inline long mv_em_acc_b(int d, int c) {
  MvPass PX, PA, PB;
  mv_em_passes(PX, PA, PB, d, c, 1);
  return mv_pass_size(PB);
}
__host__ __device__ inline long mv_em_scratch(int d, int c) {
  return mv_state_len(d, c) + mv_em_acc_a(d, c) + mv_em_acc_b(d, c) +
         (long)c * c + (long)d * d + (long)d * c + mv_frame_len(d, c) +
         2L * d * d + (mv_st_smem(d, c) ? 0 : (long)mv_nrow(d, c) * MV_CH);
}

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

template <typename T, int MD, int MC>
__global__ void __launch_bounds__(MV_THREADS)
mph_em_kernel(int reml, int staged, int max_iter, double prec, int n, int d,
              int c0, int r, const T* __restrict__ eval,
              const T* __restrict__ X0, const T* __restrict__ Y,
              const T* __restrict__ R, const double* __restrict__ Vg0,
              const double* __restrict__ Ve0, int vstride,
              const double* __restrict__ B0, int bstride, double* Vg_out,
              double* Ve_out, double* B_out, double* logl_out, int* done_out,
              int* iters_out, int s0, double* scratch) {
  __shared__ MvState<MD, MC> s;
  __shared__ double logl_const;
  const int lane = s0 + blockIdx.x, tid = threadIdx.x;
  const MvLane<T> L = mv_lane(eval, X0, Y, R, n, d, c0, r, lane);
  const int c = L.c, dd = d * d;

  MvPass PX, PA, PB;
  const EmFam F = mv_em_passes(PX, PA, PB, d, c, reml);
  const int fSW = F.sw, fSDW = F.sdw, fS1 = F.s1, fGG = F.gg, fG0 = F.g0,
            fG1 = F.g1, fSE = F.se, fSU = F.su;

  double* w = nullptr;        // the lane's scratch (run-time-sized form)
  double *accA, *accB, *XXi, *Ulp, *B;
  double* fr = nullptr;       // thread 0's frame in it
  double* wst = nullptr;      // the staged rows in it, if there
  if constexpr (MD == 0) {
    w = scratch + (long)blockIdx.x * mv_em_scratch(d, c);
    accA = w + mv_state_len(d, c);
    accB = accA + mv_em_acc_a(d, c);
    XXi = accB + mv_em_acc_b(d, c);
    Ulp = XXi + (long)c * c;
    B = Ulp + (long)d * d;
    fr = B + (long)d * c;
    if (!mv_st_smem(d, c)) wst = fr + mv_frame_len(d, c) + 2L * d * d;
  } else {
    __shared__ double accA_s[MV_ACC_A];
    __shared__ double accB_s[MV_ACC_B];
    __shared__ double XXi_s[MV_MAX_C * MV_MAX_C];
    __shared__ double Ulp_s[MV_MAX_D * MV_MAX_D];
    __shared__ double B_s[MV_MAX_D * MV_MAX_C];
    accA = accA_s;
    accB = accB_s;
    XXi = XXi_s;
    Ulp = Ulp_s;
    B = B_s;
  }
  const MvSt st = mv_st<MD, MC>(wst);

  if (tid == 0) {
    mv_state_bind(s, w, d, c);
    for (int i = 0; i < dd; ++i) {
      s.Vg[i] = Vg0[(long)lane * vstride + i];
      s.Ve[i] = Ve0[(long)lane * vstride + i];
    }
    for (int i = 0; i < d * c; ++i) B[i] = B0[(long)lane * bstride + i];
    s.flag = 0;
  }
  mv_accumulate(L, s, STAGE_X, PX, st, accA);
  if (tid == 0) logl_const = mv_logl_const<MC>(accA, PX, reml, n, XXi, fr);
  __syncthreads();

  double logl = 0.0, logl_prev = 0.0;      // thread 0's
  int done = 0, iters = max_iter;
  for (int t = 0; t < max_iter; ++t) {
    if (tid == 0) {
      mv_eigen_proc(d, s.Vg, s.Ve, s, (!reml && t > 0) ? Ulp : nullptr, fr);
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
      const double ldq = mv_gls(accA, PA, s, fr);
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
      MvTmp<double, MD * MD> tU, tE;
      double* fr2 = fr;
      double* U = tU.take(fr2, d * d);
      double* E = tE.take(fr2, d * d);
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
      void* done, void* iters, int s0, int count, void* scratch,             \
      void* stream) {                                                        \
    const int c = c0 + r;                                                    \
    const bool dyn = mv_dyn(d, c);                                           \
    auto kern = dyn ? mph_em_kernel<T, 0, 0>                                 \
                    : mph_em_kernel<T, MV_MAX_D, MV_MAX_C>;                  \
    const int smem = dyn && mv_st_smem(d, c)                                 \
                         ? mv_nrow(d, c) * MV_CH * 8 : 0;                    \
    if (smem > 0)                                                            \
      cudaFuncSetAttribute(kern,                                             \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,      \
                           smem);                                            \
    if (count > 0)                                                           \
      kern<<<count, MV_THREADS, smem, (cudaStream_t)stream>>>(               \
          reml, staged, max_iter, prec, n, d, c0, r, (const T*)eval,         \
          (const T*)X0, (const T*)Y, (const T*)R, (const double*)Vg0,        \
          (const double*)Ve0, vstride, (const double*)B0, bstride,           \
          (double*)Vg, (double*)Ve, (double*)B, (double*)logl, (int*)done,   \
          (int*)iters, s0, (double*)scratch);                                \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" long name##_lane_bytes(int d, int c) {                          \
    return mv_dyn(d, c) ? 8 * mv_em_scratch(d, c) : 0;                       \
  }

// built once a precision (-DGT_ONLY=32 / 64, kernels.Kernel's `only`)
#if GT_ONLY != 64
MPH_EM_LAUNCH(mph_em, float)
#endif
#if GT_ONLY != 32
MPH_EM_LAUNCH(mph_em_f64, double)
#endif

GT_ERROR_FN(mph_em)
