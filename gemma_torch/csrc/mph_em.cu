// K9 — the mvLMM PX-EM for (Vg, Ve, B), per lane until it converges.
//
// Replaces the reference package's device program
//   gemma_tpu/models/mvlmm_core.py:225 mph_em (MphEM, mvlmm.cpp:599-724)
// and the straggler compaction of its staged driver
//   gemma_tpu/models/mvlmm.py:173 _em_staged.
//
// A team of warps a lane (mvlmm_lane.cuh: four warps when the launch has
// more than 256 lanes, sixteen at 128 and fewer), the teams taking their
// lanes from the launch's counter.  Each iteration: EigenProc on the team, one
// pass over n for the d Gram blocks Σ w x x', xHiy, y'H^-1y and log|H|
// (and, in ML, GEMMA's residual sums with the carried UltVehiB), GLS (the
// d inverses one a thread), the log-likelihood and the exit test, a
// second pass for the M-step's outer products once B is known (REML: E =
// w (z - B x) and the trace terms x'Qi x; ML: E with this iteration's
// B), then CalcSigma and UpdateV entry by entry.  A lane stops when
// |Δlogl| < prec (tested from t = 1, and with `staged` not at the
// reference's burst starts 32, 96, 224, ...), when its logl goes
// non-finite (Vg, Ve, B NaN-poisoned, as the reference), or at max_iter;
// it writes its iteration count.  So no lane waits for another and
// nothing is compacted.  In ML the eigenvectors of Ve^-1/2 Vg Ve^-1/2
// keep the previous iteration's signs (d >= 3), since GEMMA's UltVehiBX
// is carried in the previous basis.
//
// Bound: operations — per iteration and lane two float64 passes of
// O(n d (c² + d)) multiply-adds.  The passes' sums run on every thread of
// the team from registers, the individuals' values staged once a group
// (a warp) or a round of W groups (a larger team); the common operands
// are read from shared memory where they fit.  Beyond d = 8 or 10 design
// rows the run-time-sized form (MD = MC = 0) keeps a lane's state, sums,
// XXi, Ulp, B and temporaries in `scratch` (mph_em_lane_bytes a lane).
#include "mvlmm_lane.cuh"

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

// the largest pass A and B (ML's A, REML's B; PX fits in A)
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

// doubles of a lane's state: the matrices, the two passes' sums, XXi,
// Ulp, B and the team's temporaries; in the team's shared memory (fixed
// instantiation) or the lane's scratch (run-time-sized form)
__host__ __device__ inline long mv_em_state(int d, int c) {
  return mv_state_len(d, c) + mv_em_acc_a(d, c) + mv_em_acc_b(d, c) +
         (long)c * c + (long)d * d + (long)d * c + mv_tframe_len(d, c);
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
__global__ void __launch_bounds__(32 * MV_MAX_W, 1)
mph_em_kernel(int reml, int staged, int max_iter, double prec, int n, int d,
              int c0, int r, const T* __restrict__ eval,
              const T* __restrict__ X0, const T* __restrict__ Y,
              const T* __restrict__ R, const double* __restrict__ Vg0,
              const double* __restrict__ Ve0, int vstride,
              const double* __restrict__ B0, int bstride, double* Vg_out,
              double* Ve_out, double* B_out, double* logl_out, int* done_out,
              int* iters_out, MvGeom geo, int* ctr, int s0, int count,
              double* scratch) {
  extern __shared__ __align__(16) double mv_smem[];
  const int c = c0 + r, dd = d * d, dc = d * c;
  // the block's copy of the common operands
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
  double* base = mv_smem + cb + (long)tm.id * geo.team;
  double* buf = base;
  double* cbase = buf + mv_team_buf(nrow, geo.NB, geo.W);
  MvCtl<MvState<0, 0>>& ctl =
      *reinterpret_cast<MvCtl<MvState<0, 0>>*>(cbase);
  MvState<0, 0>& s = ctl.s;
  double* fixed = cbase + MV_CTL;

  MvPass PX, PA, PB;
  const EmFam F = mv_em_passes(PX, PA, PB, d, c, reml);
  MvProf pf;
  pf.start(tm.leader());

  for (;;) {
    if (tm.leader()) ctl.lane = atomicAdd(ctr, 1);
    tm.sync();
    const int li = ctl.lane;
    if (li >= count) break;
    const int lane = s0 + li;
    pf.count(MV_PC_LANES, 1);
    MvLane<T> L = mv_lane(ev, x0, y, R, n, d, c0, r, lane);
    double* w = MD == 0 ? scratch + (long)li * mv_em_state(d, c) : fixed;
    double* accA = w + mv_state_len(d, c);
    double* accB = accA + mv_em_acc_a(d, c);
    double* XXi = accB + mv_em_acc_b(d, c);
    double* Ulp = XXi + (long)c * c;
    double* B = Ulp + dd;
    double* fr = B + dc;       // the team's temporaries
    if (tm.leader()) {
      mv_state_bind(s, w, d, c);
      ctl.logl = ctl.logl_prev = 0.0;
      ctl.done = 0;
      ctl.iters = max_iter;
    }
    tm.sync();
    MV_TFOR(tm, i, dd) {
      s.Vg[i] = Vg0[(long)lane * vstride + i];
      s.Ve[i] = Ve0[(long)lane * vstride + i];
    }
    MV_TFOR(tm, i, dc) B[i] = B0[(long)lane * bstride + i];
    mv_pass<T, STAGE_X>(tm, L, s, PX, buf, geo.NB, accA, pf);
    if (tm.leader())
      ctl.logl_const = mv_logl_const<MC>(accA, PX, reml, n, XXi, fr);
    pf.mark(MV_PH_GLS);
    tm.sync();
    pf.mark(MV_PH_WAIT);

    for (int t = 0; t < max_iter; ++t) {
      pf.count(MV_PC_ITERS, 1);
      mv_t_eigen_proc(tm, d, s.Vg, s.Ve, s, &s.logdet_Ve,
                      (!reml && t > 0) ? Ulp : nullptr, fr);
      if (!reml && t == 0)     // GEMMA seeds UltVehiBX from the input B
        MV_TFOR(tm, e, dc) {
          const int l = e / c, i = e % c;
          double a = 0.0;
          for (int m = 0; m < d; ++m) a += s.A[l * d + m] * B[m * c + i];
          s.Bc[e] = a;
        }
      pf.mark(MV_PH_EIGEN);
      tm.sync();
      pf.mark(MV_PH_WAIT);
      pf.count(MV_PC_LIK, 1);
      if (reml)
        mv_pass<T, STAGE_Z>(tm, L, s, PA, buf, geo.NB, accA, pf);
      else
        mv_pass<T, STAGE_ML>(tm, L, s, PA, buf, geo.NB, accA, pf);
      const double ldq = mv_t_gls<MC>(tm, accA, PA, s, fr);
      const double ll = mv_logl(accA, PA, s, ldq, reml, ctl.logl_const, n);
      const bool check = t > 0 && !(staged && mv_burst_start(t));
      const bool fin = isfinite(ll);
      const bool stop = check && (fabs(ll - ctl.logl_prev) < prec || !fin);
      tm.sync();               // every thread has read logl_prev
      if (stop) {
        if (tm.leader()) {
          ctl.done = 1;
          ctl.iters = t;
          if (!fin) ctl.logl = ll;
        }
        if (!fin) {            // NaN-poisoned, as the reference
          const double nan = ll - ll;
          MV_TFOR(tm, i, dd) s.Vg[i] = s.Ve[i] = nan;
          MV_TFOR(tm, i, dc) B[i] = nan;
        }
      } else {
        if (tm.leader()) ctl.logl = ctl.logl_prev = ll;
        if (!reml)             // UpdateL_B: this iteration's UltVehiB
          MV_TFOR(tm, e, dc) {
            const int l = e / c, i = e % c;
            double a = 0.0;
            for (int j = 0; j < c; ++j)
              a += mv_at(accA, PA, F.s1, l * c + j) * XXi[j * c + i];
            s.Bn[e] = a;
          }
      }
      pf.mark(MV_PH_GLS);
      tm.sync();
      pf.mark(MV_PH_WAIT);
      if (stop) break;
      pf.count(MV_PC_DER, 1);
      if (reml)
        mv_pass<T, STAGE_PY>(tm, L, s, PB, buf, geo.NB, accB, pf);
      else
        mv_pass<T, STAGE_E>(tm, L, s, PB, buf, geo.NB, accB, pf);
      // CalcSigma and UpdateV in the whitened basis, then rotated back
      double* U = fr;
      double* E = U + dd;
      MV_TFOR(tm, e, dd) {
        const int l = e / d, m = e % d;
        const double uu = reml ? mv_dd(accB, PB, F.g1, l, m)
                               : mv_dd(accA, PA, F.gg, l, m);
        // D U D rounded before the diagonal's additions, as one thread
        // computing U and then its diagonal did: nothing fuses it
        double u = __dmul_rn(__dmul_rn(s.D[l], uu), s.D[m]);
        double v = mv_dd(accB, PB, F.g0, l, m);
        if (l == m) {
          u += s.D[l] * mv_at(accA, PA, F.sw, l);
          v += s.D[l] * mv_at(accA, PA, F.sdw, l);
          if (reml) {
            u += s.D[l] * s.D[l] * mv_at(accB, PB, F.su, l);
            v += mv_at(accB, PB, F.se, l);
          }
        }
        U[e] = u;
        E[e] = v;
      }
      tm.sync();
      MV_TFOR(tm, e, dd) {
        const int i = e / d, j = e % d;
        double g = 0.0, ee = 0.0;
        for (int l = 0; l < d; ++l)
          for (int m = 0; m < d; ++m) {
            const double h = s.Uh[l * d + i] * s.Uh[m * d + j];
            g += h * U[l * d + m];
            ee += h * E[l * d + m];
          }
        s.Vg[e] = g / n;
        s.Ve[e] = ee / n;
      }
      const double* Bw = reml ? s.beta : s.Bn;
      MV_TFOR(tm, e, dc) {
        const int i = e / c, j = e % c;
        double a = 0.0;
        for (int l = 0; l < d; ++l) a += s.Uh[l * d + i] * Bw[l * c + j];
        B[e] = a;
      }
      if (!reml) {
        tm.sync();             // B has read Bn
        MV_TFOR(tm, i, dc) s.Bc[i] = s.Bn[i];
        MV_TFOR(tm, i, dd) Ulp[i] = s.Ul[i];
      }
      pf.mark(MV_PH_STEP);
      tm.sync();
      pf.mark(MV_PH_WAIT);
    }
    MV_TFOR(tm, i, dd) {
      Vg_out[(long)lane * dd + i] = s.Vg[i];
      Ve_out[(long)lane * dd + i] = s.Ve[i];
    }
    MV_TFOR(tm, i, dc) B_out[(long)lane * dc + i] = B[i];
    if (tm.leader()) {
      logl_out[lane] = ctl.logl;
      done_out[lane] = ctl.done;
      iters_out[lane] = ctl.iters;
    }
    pf.flush();
    tm.sync();
  }
}

// the launch geometry of K9 at these sizes (mv_geom)
template <typename T>
__host__ inline MvGeom mv_em_geom(int count, int n, int d, int c0, int r) {
  const int c = c0 + r;
  return mv_geom(count, n, d, c0, c, sizeof(T),
                 mv_dyn(d, c) ? 0 : mv_em_state(d, c));
}

#define MPH_EM_LAUNCH(name, T)                                               \
  extern "C" int name##_launch(                                              \
      int reml, int staged, int max_iter, double prec, int S, int n, int d,  \
      int c0, int r, const void* eval, const void* X0, const void* Y,        \
      const void* R, const void* Vg0, const void* Ve0, int vstride,          \
      const void* B0, int bstride, void* Vg, void* Ve, void* B, void* logl,  \
      void* done, void* iters, void* ctr, int s0, int count, void* scratch,  \
      void* stream) {                                                        \
    const int c = c0 + r;                                                    \
    const MvGeom g = mv_em_geom<T>(count, n, d, c0, r);                      \
    if (!mv_geom_ok(g, d, c)) return (int)cudaErrorInvalidValue;             \
    auto kern = mv_dyn(d, c) ? mph_em_kernel<T, 0, 0>                        \
                             : mph_em_kernel<T, MV_MAX_D, MV_MAX_C>;         \
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                         (int)g.bytes);                                      \
    if (count > 0)                                                           \
      kern<<<(count + g.L - 1) / g.L, 32 * g.W * g.L, g.bytes,               \
             (cudaStream_t)stream>>>(                                        \
          reml, staged, max_iter, prec, n, d, c0, r, (const T*)eval,         \
          (const T*)X0, (const T*)Y, (const T*)R, (const double*)Vg0,        \
          (const double*)Ve0, vstride, (const double*)B0, bstride,           \
          (double*)Vg, (double*)Ve, (double*)B, (double*)logl, (int*)done,   \
          (int*)iters, g, (int*)ctr, s0, count, (double*)scratch);           \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" long name##_lane_bytes(int d, int c) {                          \
    return mv_dyn(d, c) ? 8 * mv_em_state(d, c) : 0;                         \
  }                                                                          \
  extern "C" long name##_geometry(int count, int n, int d, int c0, int r,    \
                                  int what) {                                \
    return mv_geom_field(mv_em_geom<T>(count, n, d, c0, r), what);           \
  }

// built once a precision (-DGT_ONLY=32 / 64, kernels.Kernel's `only`)
#if GT_ONLY != 64
MPH_EM_LAUNCH(mph_em, float)
#endif
#if GT_ONLY != 32
MPH_EM_LAUNCH(mph_em_f64, double)
#endif

GT_ERROR_FN(mph_em)
