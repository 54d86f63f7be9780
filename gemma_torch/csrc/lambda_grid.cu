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
// Bound: operations — the recurrence, O(c³) flops a (grid point, SNP);
// the products are read once (S·2·G·(c+2)·4 bytes) and d1f written once.
// Two forms:
// * at most GT_MAX_CVT covariates (the main path): one thread per (grid
//   point g, SNP s), s fastest: it assembles row 0 of both weight powers
//   from the products, runs the two recurrences in local arrays (four rows
//   of 171 floats, 2.7 KB a thread; at c = 1 only 6 of their entries are
//   touched, so they stay in L1) and writes dev1.
// * above it, a warp per (g, s), LG_WARPS warps a block on consecutive
//   SNPs at one g (lambda_grid_warp).  The block assembles row 0 of its
//   SNPs together, SNPs fastest, so that each product's consecutive values
//   are read at once; then each warp's two rows live in shared memory,
//   updated in place.  Step p eliminates label p (GEMMA's GetabIndex
//   layout: row-major pairs a <= b of the labels 1..c+2), and only the
//   pairs a, b > p are read again, by the later steps or dev1; they are
//   the flat range [base(p+1), ni), which the warp's lanes stride.  Each
//   reads the pivot row p (the pairs (p, a), (p, b), (p, p): row p's
//   segment of the flat array, which no lane writes at step p) straight
//   from shared memory, a broadcast where lanes share a label; the entry
//   (a, b) itself is read and written by its own lane.  The two rows are
//   interleaved, (pab, ppab) a float2 an entry, so that an entry and each
//   pivot are one load.  So the dead
//   entries are skipped, a __syncwarp() separates the steps, and each
//   live entry's expression is gt_pab_step_local's (npab, nppab, the nz
//   guard).  The block keeps each flat index's labels (a, b) in shared
//   memory; above 338 covariates, where they pass the shared memory a
//   block can take, the lanes read the pivots' flat indices from the
//   tables' aw/bw instead.  Where even one warp's rows do not fit beside
//   the labels (above 194 covariates) they live in global scratch, 2 ni
//   floats a (g, s) (lambda_grid_lane_bytes a lane: G of them; the wrapper
//   splits the lanes into launches under a byte budget).
#include "common.cuh"

// phase marks (scripts/k2_k14_phase_profile.py, -DGT_PROFILE): thread 0
// of a block
#define LG_PH_ROWS 0    // assembling row 0 of both weight powers
#define LG_PH_STEPS 1   // the recurrence steps
#define LG_PH_DEV1 2    // dev1 from the last rows, and its store

#define LG_WARPS 8                  // warps of a block of the warp form
#define LG_SMEM_MAX (227 * 1024)
#define LG_STATIC_SMEM (48 * 1024)

// the warp form's geometry for ni flat entries: bytes of the labels
// table in shared memory (0 where it does not fit), and the warps of a
// block whose rows fit beside it (0 where one warp's do not: the rows
// then live in scratch, LG_WARPS warps a block)
__host__ __device__ inline long lg_lab_bytes(int ni) {
  return gt_r16(4L * ni) <= LG_SMEM_MAX ? gt_r16(4L * ni) : 0;
}
__host__ __device__ inline int lg_smem_warps(int ni) {
  int w = LG_WARPS;
  while (w > 0 && lg_lab_bytes(ni) + 8L * ni * w > LG_SMEM_MAX) w /= 2;
  return w;
}

// One thread's dev1 with its four rows in the local arrays a0, a1, b0, b1.
__device__ __forceinline__ void lambda_grid_thread(
    float* a0, float* a1, float* b0, float* b1,
    const float* __restrict__ xcross,
    const float* __restrict__ xx, const float* __restrict__ shared,
    const float* __restrict__ trace_hi, const float* __restrict__ lam,
    const int* __restrict__ tab, int n_cvt, int S, int G, int M, int n,
    int calc_null, int reml, int wy_lane, float* d1f, int s, int g) {
  const PabTables t = gt_tables(tab, n_cvt);
  const int ni = gt_n_index(n_cvt);
  const int C1 = n_cvt + 1;
  float* pab = a0;
  float* ppab = a1;
  float* npab = b0;
  float* nppab = b1;
  GT_PROF_START();
  GT_PROF_COUNT(GT_PC_LANES, 1);
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
  GT_PROF(LG_PH_ROWS);
  const int nc_total = calc_null ? n_cvt : n_cvt + 1;
  float trace_p = trace_hi[g];
  for (int p = 1; p <= nc_total; ++p) {
    const int d = t.diag[p - 1];
    trace_p = trace_p - ppab[d] / pab[d];
    gt_pab_step_local(t, ni, p, pab, ppab, npab, nppab);
    float* tmp = pab; pab = npab; npab = tmp;
    tmp = ppab; ppab = nppab; nppab = tmp;
  }
  GT_PROF(LG_PH_STEPS);
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
  GT_PROF(LG_PH_DEV1);
}

// the per-thread form (at most GT_MAX_CVT covariates): lanes [s0, s0 +
// count) of S, a thread a (g, s), its rows in local arrays
__global__ void lambda_grid_kernel(const float* __restrict__ xcross,
                                   const float* __restrict__ xx,
                                   const float* __restrict__ shared,
                                   const float* __restrict__ trace_hi,
                                   const float* __restrict__ lam,
                                   const int* __restrict__ tab, int n_cvt,
                                   int S, int G, int M, int n,
                                   int calc_null, int reml, int wy_lane,
                                   float* d1f, int s0, int count) {
  const int sl = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  if (sl >= count) return;
  float a0[GtDims<GT_MAX_CVT>::NI], a1[GtDims<GT_MAX_CVT>::NI],
      b0[GtDims<GT_MAX_CVT>::NI], b1[GtDims<GT_MAX_CVT>::NI];
  lambda_grid_thread(a0, a1, b0, b1, xcross, xx, shared, trace_hi, lam, tab,
                     n_cvt, S, G, M, n, calc_null, reml, wy_lane, d1f,
                     s0 + sl, g);
}

// the flat position of the pair (p, p): row p of GetabIndex's layout over
// cols = c + 2 labels
__device__ __forceinline__ int lg_base(int p, int cols) {
  return (2 * cols - p + 2) * (p - 1) / 2;
}

// one step p of the warp form on the rows pp, lanes striding the live
// range from k0: the pivots (p, a), (p, b) of entry k at bp + a - p and
// bp + b - p, from the labels lab[k] (LAB) or from the step's aw/bw
template <bool LAB>
__device__ __forceinline__ void lg_step(float2* pp, const unsigned* lab,
                                        const int* aw, const int* bw, int p,
                                        int bp, int k0, int ni, float ps_ww,
                                        float ps2_ww) {
  const bool nz = ps_ww != 0.f;
  const float safe = nz ? ps_ww : 1.f;
  for (int k = k0; k < ni; k += 32) {
    int ia, ib;
    if (LAB) {
      const unsigned ab = lab[k];
      ia = bp + (int)(ab & 0xffffu) - p;
      ib = bp + (int)(ab >> 16) - p;
    } else {
      ia = aw[k];
      ib = bw[k];
    }
    const float2 a2 = pp[ia];
    const float2 b2 = pp[ib];
    const float2 kk = pp[k];
    const float ps_aw = a2.x, ps_bw = b2.x, ps2_aw = a2.y, ps2_bw = b2.y;
    const float ps2_ab = kk.y;
    const float v = ps2_ab + ps_aw * ps_bw * ps2_ww / (safe * safe) -
                    (ps_aw * ps2_bw + ps_bw * ps2_aw) / safe;
    pp[k] = make_float2(nz ? kk.x - ps_aw * ps_bw / safe : kk.x,
                        nz ? v : ps2_ab);
  }
}

// The warp form: lanes [s0, s0 + count) of S, a warp a (g, s), warps on
// consecutive SNPs; rows in shared memory, or in `scratch` (2 ni floats
// a (g, s)) where they do not fit.
__global__ void lambda_grid_warp(const float* __restrict__ xcross,
                                 const float* __restrict__ xx,
                                 const float* __restrict__ shared,
                                 const float* __restrict__ trace_hi,
                                 const float* __restrict__ lam,
                                 const int* __restrict__ tab, int n_cvt,
                                 int S, int G, int M, int n, int calc_null,
                                 int reml, int wy_lane, float* d1f, int s0,
                                 int count, float* scratch) {
  extern __shared__ __align__(16) unsigned char lg_dyn[];
  const int ni = gt_n_index(n_cvt), cols = n_cvt + 2, C1 = n_cvt + 1;
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int g = blockIdx.y;
  // the labels a | b << 16 of each flat k: row a holds (a, a..cols)
  const long lab_bytes = lg_lab_bytes(ni);
  unsigned* lab = reinterpret_cast<unsigned*>(lg_dyn);
  for (int a = 1 + threadIdx.x; lab_bytes && a <= cols; a += blockDim.x) {
    const int b0 = lg_base(a, cols);
    for (int b = a; b <= cols; ++b) lab[b0 + b - a] = a | b << 16;
  }
  GT_PROF_START();
  GT_PROF_COUNT(GT_PC_LANES, 1);
  // the rows of the block's warps: ni (pab, ppab) pairs each
  const bool rows_smem = lg_smem_warps(ni) > 0;
  auto rows = [&](int w) -> float2* {
    return rows_smem
               ? reinterpret_cast<float2*>(lg_dyn + lab_bytes) +
                     (long)ni * w
               : reinterpret_cast<float2*>(scratch) +
                     ((long)g * count + blockIdx.x * W + w) * ni;
  };
  // row 0 of both weight powers for the block's W SNPs, an entry and SNP
  // a thread, SNPs fastest: the block reads each product's W consecutive
  // values together
  const PabTables t = gt_tables(tab, n_cvt);
  const int wlog = __ffs(W) - 1;               // W is a power of two
  for (int e = threadIdx.x; e < ni * W; e += blockDim.x) {
    const int k = e >> wlog, w = e & (W - 1), slw = blockIdx.x * W + w;
    if (slw >= count) continue;
    const int s = s0 + slw;
    const int kind = t.kind[k], col = t.col[k];
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
    rows(w)[k] = make_float2(v0, v1);
  }
  __syncthreads();
  GT_PROF(LG_PH_ROWS);
  const int sl = blockIdx.x * W + warp;
  if (sl >= count) return;
  const int s = s0 + sl;
  float2* pp = rows(warp);
  const int nc_total = calc_null ? n_cvt : n_cvt + 1;
  float trace_p = trace_hi[g];
  for (int p = 1; p <= nc_total; ++p) {
    const int bp = lg_base(p, cols);           // (p, p)
    const float2 ww = pp[bp];
    trace_p = trace_p - ww.y / ww.x;
    const int k0 = lg_base(p + 1, cols) + lane;
    if (lab_bytes)
      lg_step<true>(pp, lab, nullptr, nullptr, p, bp, k0, ni, ww.x, ww.y);
    else
      lg_step<false>(pp, nullptr, t.aw + (long)(p - 1) * ni,
                     t.bw + (long)(p - 1) * ni, p, bp, k0, ni, ww.x, ww.y);
    __syncwarp();
  }
  GT_PROF(LG_PH_STEPS);
  if (lane == 0) {
    // yy is the last flat position
    const float p_yy = pp[ni - 1].x;
    const float pp_yy = pp[ni - 1].y;
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
  GT_PROF(LG_PH_DEV1);
}

extern "C" int lambda_grid_launch(const void* xcross, const void* xx,
                                  const void* shared, const void* trace_hi,
                                  const void* lam, const void* tab,
                                  int n_cvt, int S, int G, int M, int n,
                                  int calc_null, int reml, int wy_lane,
                                  void* d1f, int s0, int count,
                                  void* scratch, void* stream) {
  if (count > 0 && G > 0 && n_cvt <= GT_MAX_CVT) {
    dim3 grid((count + 127) / 128, G);
    lambda_grid_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const float*)xcross, (const float*)xx, (const float*)shared,
        (const float*)trace_hi, (const float*)lam, (const int*)tab, n_cvt, S,
        G, M, n, calc_null, reml, wy_lane, (float*)d1f, s0, count);
  } else if (count > 0 && G > 0) {
    // above GT_MAX_CVT covariates the warp form
    const int ni = gt_n_index(n_cvt), Ws = lg_smem_warps(ni);
    const int W = Ws ? Ws : LG_WARPS;
    const long smem = lg_lab_bytes(ni) + 8L * ni * Ws;
    if (smem > LG_STATIC_SMEM)
      cudaFuncSetAttribute(lambda_grid_warp,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    dim3 grid((count + W - 1) / W, G);
    lambda_grid_warp<<<grid, 32 * W, smem, (cudaStream_t)stream>>>(
        (const float*)xcross, (const float*)xx, (const float*)shared,
        (const float*)trace_hi, (const float*)lam, (const int*)tab, n_cvt, S,
        G, M, n, calc_null, reml, wy_lane, (float*)d1f, s0, count,
        (float*)scratch);
  }
  return (int)cudaGetLastError();
}

// bytes of a lane's scratch: the two rows of each of its G (g, s) where
// the warp form's rows do not fit shared memory, else 0
extern "C" long lambda_grid_lane_bytes(int n_cvt, int G) {
  const int ni = gt_n_index(n_cvt);
  return n_cvt > GT_MAX_CVT && !lg_smem_warps(ni) ? 8L * G * ni : 0;
}

GT_ERROR_FN(lambda_grid)
