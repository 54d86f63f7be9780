// K6 — the likelihood-ratio test: p_lrt = Q(½, logl_H1 − logl_H0), the
// chi-square(1) tail of twice the log-likelihood difference.
//
// Replaces the reference package's device programs
//   gemma_tpu/ops/stats.py:46 chisq_sf and the LRT difference of
//   gemma_tpu/models/lmm/engine.py:163
// (LMM::Analyze, lmm.cpp:1553, with gsl_cdf_chisq_Q).
//
// The reference's float32 p_lrt misses the 1e-3 speed-mode contract: the
// two log-likelihoods are float32 sums of n terms, each about -10³, their
// difference is near 0 for null SNPs and the χ²(1) tail is infinitely
// steep at 0 (up to 4e-2 absolute at n = 1,940).  So in the speed mode
// (recompute = 1, float32 operands) each lane's ML log-likelihood is
// evaluated again at its float32 λ_mle in the logf_stable form
// (likelihood.py) with float64 sums, Gram, Cholesky and Σ h r²; λ̂ is a
// stationary point of logf, so λ's float32 error enters only at second
// order.  Launched once on the null (calc_null = 1, at the null's λ_mle)
// it gives logl_H0, which the SNP launch reads from device memory.  Where
// every lane has its own null (GxE: the covariates [W, env, x]; gene
// mode: the gene's response) the null launch has S lanes at their own λ,
// UtWy and Utx sit at their lane strides (0 = shared), and the SNP launch
// reads logl_H0 at stride 1.  In the parity mode (recompute = 0) the
// float64 logf_H1 of the λ search (K7) is taken as given and one thread
// per lane applies the tail.  Both write logl_H1 and p in float64.
//
// Design: the Gram of Z = [W, x] and its right-hand side are test_sums.cuh's
// sums (the pairs of [W, y] as float64 products, their x sums and Σ h x²)
// with Σ log(λ eval + 1) beside them: a warp a lane (c <= 3), a tile of
// 8 lanes on DMMA (shared operands) or a block a lane (per-lane
// operands).  Each lane's Cholesky, solves and log-determinant run on a
// warp (ts_factor); the residual pass Σ h (y − Wβ − xβ_x)² keeps its
// explicit, cancellation-free form: a warp a lane, the tile's lanes on the
// same staged rows of [W, y] (a warp a lane), or the block over the
// lane's individuals; a second launch takes the tails, a thread a lane.  A
// launch of one null lane (S = 1, calc_null) splits
// n over blocks of TS_PART individuals: four launches (partial sums, their
// sum in order and the factor, partial residuals, their sum and logl), so
// the single-lane null no longer runs on one block of the card.
//
// Bound: speed mode — with shared operands, operations: per lane the
// (c+1)(c+2)/2 pair sums on DMMA and the x sums, Σ log and the residual
// pass on the float64 CUDA cores; with per-lane operands, bytes (each
// lane's UtWy read twice) or those operations; parity mode — bytes (16
// bytes in, 16 out per lane) and the tail's few hundred float64
// operations.  Above 32 covariates each lane's sums and factor live in a
// per-lane slice of global scratch, lanes [s0, s0 + count) a launch; past
// 5,119 the launch is refused (test_sums.cuh).
#include "test_sums.cuh"

struct LrtArgs {
  const float *lam, *eval, *UtWy, *Utx;
  int c, n, calc_null, ustride, xstride, l0_stride, s0, count;
  double logf_const;
  const double* logl0;
  double *logl_out, *p_out;
  unsigned char* scratch;
};

// the set of the block's lane r (the launch's lane b0 + r): its sums (Q +
// 1, Σ log last), packed Gram and solution
__device__ __forceinline__ double* lrt_set(const TsLay& L,
                                           unsigned char* smem,
                                           unsigned char* scratch, int b0,
                                           int r) {
  return reinterpret_cast<double*>(
      L.dyn ? scratch + (long)(b0 + r) * L.lane_bytes
            : smem + L.o_set + r * L.lane_set);
}
__device__ __forceinline__ double* lrt_gram(const TsLay& L, double* set) {
  return set + gt_r16(8L * (L.Q + 1)) / 8;
}

template <int FORM, int C1R>
__global__ void __launch_bounds__(TS_THREADS, TS_MIN_BLOCKS(FORM, 3, 4))
lrt_kernel(const __grid_constant__ LrtArgs a) {
  extern __shared__ __align__(16) unsigned char ts_smem[];
  __shared__ double red[TS_WARPS];
  __shared__ double res[2][TS_L];  // Σ log and Σ h r² of the block's lanes
  const TsLay L = ts_layout(a.c, FORM, a.calc_null ? TS_LRT_NULL : TS_LRT, 8);
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  const int c = a.c, C1 = L.C1, CZ = L.CZ;
  GT_PROF_START();
  GT_PROF_COUNT(GT_PC_LANES, 1);
  const int b0 = blockIdx.x * L.lanes;
  const int nl = min(L.lanes, a.count - b0);
  auto lane_at = [&](int r) {
    const long s = a.s0 + b0 + (r < nl ? r : 0);
    TsLane<TsLrt> ln;
    ln.lam = a.lam[s];
    ln.UtWy = a.UtWy + s * a.ustride;
    ln.wy = nullptr;
    ln.x = a.Utx + s * a.xstride;
    ln.live = r < nl;
    return ln;
  };
  auto set_of = [&](int r) { return lrt_set(L, ts_smem, a.scratch, b0, r); };
  double* B = reinterpret_cast<double*>(ts_smem + L.o_beta);  // lanes × CZ
  // lane r's solution: in B, or (the DMMA form past 319 covariates) where
  // the factor left it in its set
  const bool b_set = FORM == TS_MMA && L.rc == 0;
  auto put = [&](int r, int q, double v) { set_of(r)[q] = v; };
  // lane r's factor (on the calling warp): β into B, Σ log into res
  auto factor = [&](int r) {
    double* set = set_of(r);
    double* P = lrt_gram(L, set);
    ts_factor(L, set, P, P + L.nG);
    if (!b_set)
      for (int k = lid; k < CZ; k += 32) B[r * CZ + k] = P[L.nG + k];
    if (lid == 0) res[0][r] = set[L.Q];
    __syncwarp();
  };
  if constexpr (FORM == TS_REG) {
    double out[TS_REG_Q + 1];
    const TsLane<TsLrt> ln = lane_at(warp);
    ts_sums_reg<TsLrt, C1R>(ln, a.eval, a.n, L.xc, out);
    GT_PROF(TT_PH_SUMS);
    if (warp < nl) {
      constexpr int QR = C1R * (C1R + 1) / 2 + C1R + 1;
      if (lid == 0) {
#pragma unroll
        for (int q = 0; q <= QR; ++q) put(warp, q, out[q]);
      }
      __syncwarp();
      factor(warp);
      GT_PROF(TT_PH_POST);
      const double* beta = B + warp * CZ;
      double acc = 0.0;
      // TS_RU_X individuals a round, their x loaded first, summed in i
      // order
      for (int i0 = lid; i0 < a.n; i0 += 32 * TS_RU_X) {
        float xs[TS_RU_X];
#pragma unroll
        for (int u = 0; u < TS_RU_X; ++u) {
          const int i = i0 + 32 * u < a.n ? i0 + 32 * u : i0;
          xs[u] = a.calc_null ? 0.f : ln.x[i];
        }
#pragma unroll
        for (int u = 0; u < TS_RU_X; ++u) {
          const int i = i0 + 32 * u;
          if (i >= a.n) break;
          acc += ts_resid(ln.UtWy + (long)i * C1, (double)xs[u], beta,
                          C1R - 1, a.calc_null,
                          1.0 / ((double)ln.lam * (double)a.eval[i] + 1.0));
        }
      }
      acc = gt_warp_sum(acc);
      if (lid == 0) res[1][warp] = acc;
    }
    GT_PROF(TT_PH_RESID);
  } else if constexpr (FORM == TS_MMA) {
    ts_sums_mma<TsLrt>(L, ts_smem, lane_at, nl, a.eval, a.n, put);
    __syncthreads();
    for (int r = warp; r < nl; r += TS_WARPS) factor(r);
    __syncthreads();
    GT_PROF(TT_PH_POST);
    // the residual pass: the tile's lanes over the same rows of [W, y],
    // TS_RC a chunk copied by cp.async a chunk ahead (rc = 0: read from
    // device memory); lane s on warp s, the individuals ≡ its lane (mod
    // 32) in order
    float* Wb = reinterpret_cast<float*>(ts_smem + L.o_A);
    const int ws = warp, wj = lid;
    const TsLane<TsLrt> mine = lane_at(ws < nl ? ws : 0);
    const TsLane<TsLrt> op = lane_at(0);
    auto term = [&](const float* z, int i, const double* beta) {
      const double h = 1.0 / ((double)mine.lam * (double)a.eval[i] + 1.0);
      const double xi = a.calc_null ? 0.0 : (double)mine.x[i];
      return ts_resid(z, xi, beta, c, a.calc_null, h);
    };
    double acc = 0.0;
    if (b_set) {
      if (ws < nl) {
        const double* beta = lrt_gram(L, set_of(ws)) + L.nG;
        for (int i = wj; i < a.n; i += 32)
          acc += term(op.UtWy + (long)i * C1, i, beta);
      }
    } else {
      const int wsz = TS_RC * C1, nch = (a.n + TS_RC - 1) / TS_RC;
      auto fetch = [&](int ch) {
        const long i0 = (long)ch * TS_RC;
        float* w = Wb + (ch & 1) * wsz;
        for (int e = tid; e < wsz; e += TS_THREADS) {
          const bool v = i0 + e / C1 < a.n;
          ts_cp(w + e, op.UtWy + (v ? i0 * C1 + e : 0), v);
        }
        ts_commit();
      };
      fetch(0);
      for (int ch = 0; ch < nch; ++ch) {
        if (ch + 1 < nch) fetch(ch + 1);
        else ts_commit();
        ts_wait1();
        __syncthreads();
        const float* w = Wb + (ch & 1) * wsz;
#pragma unroll
        for (int u = 0; u < TS_RC / 32; ++u) {
          const int k = wj + 32 * u, i = ch * TS_RC + k;
          if (ws < nl && i < a.n) acc += term(w + k * C1, i, B + ws * CZ);
        }
        __syncthreads();
      }
    }
    acc = gt_warp_sum(acc);
    if (wj == 0 && ws < nl) res[1][ws] = acc;
    GT_PROF(TT_PH_RESID);
  } else {
    const TsLane<TsLrt> ln = lane_at(0);
    ts_sums_lane<TsLrt>(L, ts_smem, ln, a.eval, 0, a.n, red, put);
    __syncthreads();
    if (warp == 0) factor(0);
    __syncthreads();
    GT_PROF(TT_PH_POST);
    double acc = 0.0;
#pragma unroll 4
    for (int i = tid; i < a.n; i += TS_THREADS) {
      const double h = 1.0 / ((double)ln.lam * (double)a.eval[i] + 1.0);
      const double xi = a.calc_null ? 0.0 : (double)ln.x[i];
      acc += ts_resid(ln.UtWy + (long)i * C1, xi, B, c, a.calc_null, h);
    }
    acc = ts_block_sum(acc, red);
    if (tid == 0) res[1][0] = acc;
    GT_PROF(TT_PH_RESID);
  }
  __syncthreads();
  if (tid < nl)
    a.logl_out[a.s0 + b0 + tid] =
        ts_logl(a.logf_const, res[0][tid], res[1][tid], a.n);
  GT_PROF(TT_PH_TAIL);
}

__global__ void lrt_tail_only_kernel(const double* __restrict__ logl_in,
                                     int S, const double* __restrict__ logl0,
                                     int l0_stride, double* logl_out,
                                     double* p_out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const double l1 = logl_in[s];
  logl_out[s] = l1;
  p_out[s] = gt_chisq_sf(2.0 * (l1 - logl0[(long)s * l0_stride]), 1.0);
}

// --- one null lane, n split over blocks of TS_PART individuals ----------
// scratch (doubles): the parts' sums (parts × (Q + 1)), the lane's set
// (TsLay.lane_set's layout), the parts' residuals (parts)
__host__ __device__ inline int lrt_parts(int n) {
  return (n + TS_PART - 1) / TS_PART;
}
__host__ __device__ inline long lrt_null_doubles(const TsLay& L, int n) {
  return (long)lrt_parts(n) * (L.Q + 1) + gt_r16(8L * (L.Q + 1)) / 8 +
         gt_r16(8L * (L.M + L.C1)) / 8 + lrt_parts(n);
}

// 1: block b's partial sums over [b TS_PART, (b + 1) TS_PART)
__global__ void __launch_bounds__(TS_THREADS)
lrt_null_sums(const __grid_constant__ LrtArgs a) {
  extern __shared__ __align__(16) unsigned char ts_smem[];
  __shared__ double red[TS_WARPS];
  const TsLay L = ts_layout(a.c, TS_LANE, TS_LRT_NULL, 8);
  GT_PROF_START();
  GT_PROF_COUNT(GT_PC_LANES, 1);
  TsLane<TsLrt> ln;
  ln.lam = a.lam[a.s0];
  ln.UtWy = a.UtWy + (long)a.s0 * a.ustride;
  ln.wy = nullptr;
  ln.x = nullptr;
  ln.live = true;
  double* part = reinterpret_cast<double*>(a.scratch) + blockIdx.x * (L.Q + 1);
  const int i0 = blockIdx.x * TS_PART;
  ts_sums_lane<TsLrt>(L, ts_smem, ln, a.eval, i0, min(a.n, i0 + TS_PART),
                      red, [&](int, int q, double v) { part[q] = v; });
}

// 2 (one block): the parts summed in order, then the factor on warp 0
__global__ void __launch_bounds__(TS_THREADS)
lrt_null_factor(const __grid_constant__ LrtArgs a) {
  const TsLay L = ts_layout(a.c, TS_LANE, TS_LRT_NULL, 8);
  const int P = lrt_parts(a.n);
  double* sc = reinterpret_cast<double*>(a.scratch);
  double* set = sc + (long)P * (L.Q + 1);
  // the null's sums: the pairs (q < M) and Σ log (q = Q)
  for (int e = threadIdx.x; e <= L.M; e += TS_THREADS) {
    const int q = e < L.M ? e : L.Q;
    double v = 0.0;
    for (int b = 0; b < P; ++b) v += sc[(long)b * (L.Q + 1) + q];
    set[q] = v;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    double* G = lrt_gram(L, set);
    ts_factor(L, set, G, G + L.nG);
  }
}

// 3: block b's partial residual
__global__ void __launch_bounds__(TS_THREADS)
lrt_null_resid(const __grid_constant__ LrtArgs a) {
  __shared__ double red[TS_WARPS];
  const TsLay L = ts_layout(a.c, TS_LANE, TS_LRT_NULL, 8);
  const int P = lrt_parts(a.n);
  double* sc = reinterpret_cast<double*>(a.scratch);
  const double* set = sc + (long)P * (L.Q + 1);
  const double* beta = set + gt_r16(8L * (L.Q + 1)) / 8 + L.nG;
  const double l = (double)a.lam[a.s0];
  const float* UtWy = a.UtWy + (long)a.s0 * a.ustride;
  const int i1 = min(a.n, (int)(blockIdx.x + 1) * TS_PART);
  double acc = 0.0;
  for (int i = blockIdx.x * TS_PART + threadIdx.x; i < i1; i += TS_THREADS)
    acc += ts_resid(UtWy + (long)i * L.C1, 0.0, beta, a.c, 1,
                    1.0 / (l * (double)a.eval[i] + 1.0));
  acc = ts_block_sum(acc, red);
  if (threadIdx.x == 0) sc[lrt_null_doubles(L, a.n) - P + blockIdx.x] = acc;
}

// 4 (one thread): the residuals summed in order, logl
__global__ void lrt_null_final(const __grid_constant__ LrtArgs a) {
  const TsLay L = ts_layout(a.c, TS_LANE, TS_LRT_NULL, 8);
  const int P = lrt_parts(a.n);
  const double* sc = reinterpret_cast<const double*>(a.scratch);
  const double* rp = sc + lrt_null_doubles(L, a.n) - P;
  double p_yy = 0.0;
  for (int b = 0; b < P; ++b) p_yy += rp[b];
  const double ld = sc[(long)P * (L.Q + 1) + L.Q];
  const double l1 = ts_logl(a.logf_const, ld, p_yy, a.n);
  a.logl_out[a.s0] = l1;
  if (a.p_out != nullptr)
    a.p_out[a.s0] = gt_chisq_sf(2.0 * (l1 - a.logl0[0]), 1.0);
}

using LrtKernel = void (*)(const LrtArgs);

static LrtKernel lrt_pick(const TsLay& L) {
  if (L.form == TS_MMA) return lrt_kernel<TS_MMA, 0>;
  if (L.form == TS_LANE) return lrt_kernel<TS_LANE, 0>;
  switch (L.C1) {
    case 1: return lrt_kernel<TS_REG, 1>;
    case 2: return lrt_kernel<TS_REG, 2>;
    case 3: return lrt_kernel<TS_REG, 3>;
    default: return lrt_kernel<TS_REG, 4>;
  }
}

static void lrt_smem(LrtKernel k, long bytes) {
  if (bytes > GT_STATIC_SMEM)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
}

// A launch of one null lane (calc_null, S = 1) takes the split form and
// `scratch` of lrt_tail_null_bytes; other launches take lanes [s0, s0 +
// count) and, above 32 covariates, `scratch` of lrt_tail_lane_bytes a lane.
extern "C" int lrt_tail_launch(int recompute, const void* lam,
                               const void* eval, const void* UtWy,
                               const void* Utx, int n_cvt, int S, int n,
                               int calc_null, int ustride, int xstride,
                               double logf_const, const void* logl_in,
                               const void* logl0, int l0_stride,
                               void* logl_out, void* p_out, int s0,
                               int count, void* scratch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const LrtArgs a{(const float*)lam, (const float*)eval, (const float*)UtWy,
                  (const float*)Utx, n_cvt, n, calc_null, ustride, xstride,
                  l0_stride, s0, count, logf_const, (const double*)logl0,
                  (double*)logl_out, (double*)p_out,
                  (unsigned char*)scratch};
  // K6 stages whole rows of [W, y]: up to 5,119 covariates
  if (count > 0 && recompute &&
      !ts_layout(n_cvt, TS_LANE, TS_LRT, 8).raw)
    return (int)cudaErrorInvalidValue;
  if (count > 0 && recompute && calc_null && S == 1) {
    const TsLay L = ts_layout(n_cvt, TS_LANE, TS_LRT_NULL, 8);
    lrt_smem(lrt_null_sums, L.bytes);
    lrt_null_sums<<<lrt_parts(n), TS_THREADS, L.bytes, st>>>(a);
    lrt_null_factor<<<1, TS_THREADS, 0, st>>>(a);
    lrt_null_resid<<<lrt_parts(n), TS_THREADS, 0, st>>>(a);
    lrt_null_final<<<1, 1, 0, st>>>(a);
  } else if (count > 0 && recompute) {
    const TsLay L = ts_layout(n_cvt, ts_form(n_cvt, ustride == 0),
                              calc_null ? TS_LRT_NULL : TS_LRT, 8);
    const LrtKernel k = lrt_pick(L);
    lrt_smem(k, L.bytes);
    k<<<(count + L.lanes - 1) / L.lanes, TS_THREADS, L.bytes, st>>>(a);
    // the tails, a thread a lane
    if (p_out != nullptr)
      lrt_tail_only_kernel<<<(count + GT_THREADS - 1) / GT_THREADS,
                             GT_THREADS, 0, st>>>(
          a.logl_out + s0, count, a.logl0 + (long)s0 * l0_stride, l0_stride,
          a.logl_out + s0, a.p_out + s0);
  } else if (S > 0) {
    lrt_tail_only_kernel<<<(S + GT_THREADS - 1) / GT_THREADS, GT_THREADS, 0,
                           st>>>((const double*)logl_in, S,
                                 (const double*)logl0, l0_stride,
                                 (double*)logl_out, (double*)p_out);
  }
  return (int)cudaGetLastError();
}

// bytes of a lane's scratch (0 where its set fits shared memory)
extern "C" long lrt_tail_lane_bytes(int n_cvt) {
  return ts_layout(n_cvt, TS_MMA, TS_LRT, 8).lane_bytes;
}

// bytes of the scratch of a single-lane null launch
extern "C" long lrt_tail_null_bytes(int n_cvt, int n) {
  return 8 * lrt_null_doubles(ts_layout(n_cvt, TS_LANE, TS_LRT_NULL, 8), n);
}

// dynamic shared memory of a launch (calc_null: the null model)
extern "C" long lrt_tail_smem_bytes(int n_cvt, int shared_ops,
                                    int calc_null) {
  return ts_layout(n_cvt, ts_form(n_cvt, shared_ops),
                   calc_null ? TS_LRT_NULL : TS_LRT, 8)
      .bytes;
}

GT_ERROR_FN(lrt_tail)
