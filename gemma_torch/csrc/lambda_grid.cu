// K2 — λ grid epilogue: dev1 of every SNP at the shared fine λ grid.
//
// Replaces the recurrence half of the reference package's device program
//   gemma_tpu/models/lmm/likelihood.py:380 dev1_grid
// (the _pab_rows/_ppab_rows recurrences and _dev1_from_rows after its
// two products).  The two products themselves stay torch.matmul on the
// card, laid out so this kernel reads them coalesced:
//   xcross (2, G, c+1, S) = (hi^p ⊙ UtWy)ᵀ Utxᵀ,   xx (2, G, S) = hi^pᵀ (Utx²)ᵀ,
// plus the x-free {W,y} rows shared (2, G, m_wy), trace_hi (G) and the
// grid λ (G).  Output d1f (G, S).  With per-lane operands (GxE: each
// SNP's covariates hold its x; gene mode: each gene is a response) the
// x-free rows are per lane too, shared (2, G, m_wy, S), read coalesced
// like xcross (wy_lane = 1).
//
// One thread per (grid point g, SNP s), s fastest: it assembles row 0 of
// both weight powers from the products, runs the two recurrences in
// local arrays and writes dev1.  Bound: bytes — the products are read
// once (S·2·G·(c+2)·4 bytes) and d1f written once; the recurrence is
// O((c+1)·n_index) flops per thread.  Rows live in per-thread local
// arrays sized for the instantiation's bound MC: GT_MAX_CVT (four rows
// of 171 floats, 2.7 KB a thread), or GT_WIDE_CVT above it (595 floats,
// 9.5 KB a thread, which the CUDA driver reserves for every resident
// thread); at c = 1 only 6 of their entries are touched, so they stay
// in L1.  Above GT_WIDE_CVT (the GT_DYN form) the four rows live in
// global scratch, ni floats each a thread, interleaved across the
// launch's threads so that their loads coalesce (lambda_grid_lane_bytes
// a lane: G threads); the wrapper splits the lanes into launches under a
// byte budget.
#include "common.cuh"

// One thread's dev1 with its four rows in a0, a1, b0, b1 (local arrays or
// strided global scratch).
template <typename R>
__device__ __forceinline__ void lambda_grid_thread(
    R a0, R a1, R b0, R b1, const float* __restrict__ xcross,
    const float* __restrict__ xx, const float* __restrict__ shared,
    const float* __restrict__ trace_hi, const float* __restrict__ lam,
    const int* __restrict__ tab, int n_cvt, int S, int G, int M, int n,
    int calc_null, int reml, int wy_lane, float* d1f, int s, int g) {
  const PabTables t = gt_tables(tab, n_cvt);
  const int ni = gt_n_index(n_cvt);
  const int C1 = n_cvt + 1;
  R pab = a0;
  R ppab = a1;
  R npab = b0;
  R nppab = b1;
  for (int k = 0; k < ni; ++k) {
    const int kind = t.kind[k];
    const int col = t.col[k];
    float v0, v1;
    if (kind == 0 && wy_lane) {
      v0 = shared[(((long)0 * G + g) * M + col) * S + s];
      v1 = shared[(((long)1 * G + g) * M + col) * S + s];
    } else if (kind == 0) {
      v0 = shared[((long)0 * G + g) * M + col];
      v1 = shared[((long)1 * G + g) * M + col];
    } else if (kind == 1) {
      v0 = xx[((long)0 * G + g) * S + s];
      v1 = xx[((long)1 * G + g) * S + s];
    } else {
      v0 = xcross[(((long)0 * G + g) * C1 + col) * S + s];
      v1 = xcross[(((long)1 * G + g) * C1 + col) * S + s];
    }
    pab[k] = v0;
    ppab[k] = v1;
  }
  const int nc_total = calc_null ? n_cvt : n_cvt + 1;
  float trace_p = trace_hi[g];
  for (int p = 1; p <= nc_total; ++p) {
    const int d = t.diag[p - 1];
    trace_p = trace_p - ppab[d] / pab[d];
    gt_pab_step_local(t, ni, p, pab, ppab, npab, nppab);
    R tmp = pab; pab = npab; npab = tmp;
    tmp = ppab; ppab = nppab; nppab = tmp;
  }
  // yy is the last flat position
  const float p_yy = pab[ni - 1];
  const float pp_yy = ppab[ni - 1];
  const float l = lam[g];
  const float ypkpy = (p_yy - pp_yy) / l;
  float out;
  if (reml) {
    const float df = (float)(calc_null ? n - n_cvt : n - n_cvt - 1);
    const float trace_pk = (df - trace_p) / l;
    out = -0.5f * trace_pk + 0.5f * df * ypkpy / p_yy;
  } else {
    const float trace_hik = ((float)n - trace_hi[g]) / l;
    out = -0.5f * trace_hik + 0.5f * (float)n * ypkpy / p_yy;
  }
  d1f[(long)g * S + s] = out;
}

// lanes [s0, s0 + count) of S; the GT_DYN form's rows in `scratch`
template <int MC>
__global__ void lambda_grid_kernel(const float* __restrict__ xcross,
                                   const float* __restrict__ xx,
                                   const float* __restrict__ shared,
                                   const float* __restrict__ trace_hi,
                                   const float* __restrict__ lam,
                                   const int* __restrict__ tab, int n_cvt,
                                   int S, int G, int M, int n,
                                   int calc_null, int reml, int wy_lane,
                                   float* d1f, int s0, int count,
                                   float* scratch) {
  const int sl = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  if (sl >= count) return;
  const int s = s0 + sl;
  if constexpr (MC == GT_DYN) {
    // row r of thread (g, sl) at scratch[(r ni + k) nt + g count + sl]
    const long nt = (long)count * G, ni = gt_n_index(n_cvt);
    float* base = scratch + (long)g * count + sl;
    lambda_grid_thread<GtStrided>(
        GtStrided{base, nt}, GtStrided{base + ni * nt, nt},
        GtStrided{base + 2 * ni * nt, nt}, GtStrided{base + 3 * ni * nt, nt},
        xcross, xx, shared, trace_hi, lam, tab, n_cvt, S, G, M, n, calc_null,
        reml, wy_lane, d1f, s, g);
  } else {
    float a0[GtDims<MC>::NI], a1[GtDims<MC>::NI], b0[GtDims<MC>::NI],
        b1[GtDims<MC>::NI];
    lambda_grid_thread<float*>(a0, a1, b0, b1, xcross, xx, shared, trace_hi,
                               lam, tab, n_cvt, S, G, M, n, calc_null, reml,
                               wy_lane, d1f, s, g);
  }
}

extern "C" int lambda_grid_launch(const void* xcross, const void* xx,
                                  const void* shared, const void* trace_hi,
                                  const void* lam, const void* tab,
                                  int n_cvt, int S, int G, int M, int n,
                                  int calc_null, int reml, int wy_lane,
                                  void* d1f, int s0, int count,
                                  void* scratch, void* stream) {
  // above GT_MAX_CVT covariates the GT_WIDE_CVT instantiation runs, above
  // GT_WIDE_CVT the GT_DYN form on lanes [s0, s0 + count) with `scratch`
  const int form = gt_form(n_cvt);
  auto kern = form == GT_MAX_CVT    ? lambda_grid_kernel<GT_MAX_CVT>
              : form == GT_WIDE_CVT ? lambda_grid_kernel<GT_WIDE_CVT>
                                    : lambda_grid_kernel<GT_DYN>;
  if (count > 0 && G > 0) {
    dim3 grid((count + 127) / 128, G);
    kern<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const float*)xcross, (const float*)xx, (const float*)shared,
        (const float*)trace_hi, (const float*)lam, (const int*)tab, n_cvt, S,
        G, M, n, calc_null, reml, wy_lane, (float*)d1f, s0, count,
        (float*)scratch);
  }
  return (int)cudaGetLastError();
}

// bytes of a lane's scratch: four rows for each of its G threads (0
// where a fixed instantiation takes n_cvt)
extern "C" long lambda_grid_lane_bytes(int n_cvt, int G) {
  return gt_form(n_cvt) == GT_DYN ? 16L * G * gt_n_index(n_cvt) : 0;
}

GT_ERROR_FN(lambda_grid)
