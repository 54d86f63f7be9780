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
// Bound: bytes at small c (the products are read once, S·2·G·(c+2)·4
// bytes, and d1f written once), operations above (the recurrence, O(c³)
// flops a (grid point, SNP)).  Two forms:
// * up to LG_REG_MAX covariates (the main path: c = 1): the register
//   form, one thread a (grid point g, SNP s), s fastest, instantiated at
//   each c (lambda_grid_reg<C>).  Every flat index, every row-0 source
//   and every pivot is a compile-time constant (GEMMA's GetabIndex layout
//   in closed form, lg_ab/lg_kind/lg_col), so the thread's two rows live
//   in registers, the recurrence is unrolled, and the launch reads no
//   index table.  Step p eliminates label p and updates only the pairs
//   a, b > p, the ones a later step or dev1 reads again, in place: the
//   pivots (p, a), (p, b), (p, p) are row p's, which step p does not
//   write.  All row-0 loads are issued at once (coalesced over s).
// * above LG_REG_MAX, a warp per (g, s) (lambda_grid_warp: at 13 and 16
//   covariates faster than one thread a (g, s) with its rows in shared
//   memory, which also lost to the register form at 8 and 12, PERF.md §6),
//   LG_WARPS warps a block on consecutive SNPs at one g.  The block
//   assembles row 0 of its SNPs together, SNPs fastest, so that each
//   product's consecutive values are read at once; then each warp's two rows
//   live in shared memory, updated in place.  Step p eliminates label p
//   (GEMMA's GetabIndex layout: row-major pairs a <= b of the labels
//   1..c+2), and only the pairs a, b > p are read again, by the later steps
//   or dev1; they are the flat range [base(p+1), ni), which the warp's lanes
//   stride.  Each reads the pivot row p (the pairs (p, a), (p, b), (p, p):
//   row p's segment of the flat array, which no lane writes at step p)
//   straight from shared memory, a broadcast where lanes share a label; the
//   entry (a, b) itself is read and written by its own lane.  The two rows
//   are interleaved, (pab, ppab) a float2 an entry, so that an entry and
//   each pivot are one load.  So the dead entries are skipped and a
//   __syncwarp() separates the steps.  The block keeps each flat index's
//   labels (a, b) in shared memory; above 338 covariates, where they pass
//   the shared memory a block can take, the lanes read the pivots' flat
//   indices from the tables' aw/bw instead.  Where even one warp's rows do
//   not fit beside the labels (above 194 covariates) they live in global
//   scratch, 2 ni floats a (g, s) (lambda_grid_lane_bytes a lane: G of them;
//   the wrapper splits the lanes into launches under a byte budget).
// Each live entry's expression is lg_entry's in both forms: the plain
// recurrence's (_pab_rows, _ppab_rows: npab, nppab, the nz guard).
#include "common.cuh"

// phase marks (scripts/k1_k2_phase_profile.py, k2_k14, -DGT_PROFILE): thread 0
// of a block
#define LG_PH_ROWS 0    // assembling row 0 of both weight powers
#define LG_PH_STEPS 1   // the recurrence steps
#define LG_PH_DEV1 2    // dev1 from the last rows, and its store

#define LG_WARPS 8                  // warps of a block of the warp form
#define LG_SMEM_MAX (227 * 1024)
// a block may take this much shared memory without opting in to more;
// the launch opts in LG_PROF_SMEM below it (GT_PROFILE's static mark)
#define LG_DEFAULT_SMEM (48 * 1024)
#define LG_PROF_SMEM 64

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

// the register form's instantiations c = 0..LG_REG_MAX: at c = 12 its
// rows take 210 of 248 registers, at 13 they spill (PERF.md §6)
#define LG_REG_MAX 12
// threads of a block of the register form (256: faster than 128 at c = 2
// and 4, no slower at 1 and 8; scripts/k1_k2_phase_profile.py times both)
#define LG_REG_TPB 256

// GEMMA's GetabIndex over cols = c + 2 labels (a <= b): the flat position
// of the pair (a, b); labels 1..c are the covariates, c + 1 is x, c + 2 y
__host__ __device__ constexpr int lg_ab(int a, int b, int cols) {
  return (2 * cols - a + 2) * (a - 1) / 2 + (b - a);
}
// where row 0's entry (a, b) comes from: kind 0 the x-free {W,y} product
// column lg_col (the pair's rank among the pairs without x, in flat
// order), 1 the x'x term, 2 the x-partner column lg_col of [W | y]
__host__ __device__ constexpr int lg_kind(int a, int b, int c) {
  return (a == c + 1 && b == c + 1) ? 1 : (a == c + 1 || b == c + 1) ? 2 : 0;
}
__host__ __device__ constexpr int lg_col(int a, int b, int c) {
  return (a == c + 1 && b == c + 1) ? 0
         : b == c + 1               ? a - 1
         : a == c + 1               ? c
         : a == c + 2               ? (c + 1) * (c + 2) / 2 - 1
                      : (a - 1) * (c + 2) - (a - 1) * a / 2 +
                            (b <= c ? b - a : b - a - 1);
}

// row 0's entry (a, b) of both weight powers for (g, s)
__device__ __forceinline__ float2 lg_row0(
    int kind, int col, const float* __restrict__ xcross,
    const float* __restrict__ xx, const float* __restrict__ shared, int C1,
    int S, int G, int M, int wy_lane, int s, int g) {
  if (kind == 0 && wy_lane)
    return make_float2(shared[(((long)0 * G + g) * M + col) * S + s],
                       shared[(((long)1 * G + g) * M + col) * S + s]);
  if (kind == 0)
    return make_float2(shared[((long)0 * G + g) * M + col],
                       shared[((long)1 * G + g) * M + col]);
  if (kind == 1)
    return make_float2(xx[((long)0 * G + g) * S + s],
                       xx[((long)1 * G + g) * S + s]);
  return make_float2(xcross[(((long)0 * G + g) * C1 + col) * S + s],
                     xcross[(((long)1 * G + g) * C1 + col) * S + s]);
}

// one live entry of step p: (pab, ppab) of the pair from its pivots
// (p, a) and (p, b), as the plain _pab_rows/_ppab_rows
__device__ __forceinline__ float2 lg_entry(float2 kk, float2 a2, float2 b2,
                                           bool nz, float safe,
                                           float ps2_ww) {
  const float ps_aw = a2.x, ps_bw = b2.x, ps2_aw = a2.y, ps2_bw = b2.y;
  const float ps2_ab = kk.y;
  const float v = ps2_ab + ps_aw * ps_bw * ps2_ww / (safe * safe) -
                  (ps_aw * ps2_bw + ps_bw * ps2_aw) / safe;
  return make_float2(nz ? kk.x - ps_aw * ps_bw / safe : kk.x,
                     nz ? v : ps2_ab);
}

// dev1 from the last rows' yy entries and the trace
__device__ __forceinline__ float lg_dev1(float p_yy, float pp_yy,
                                         float trace_p, float th, float l,
                                         int n, int n_cvt, int calc_null,
                                         int reml) {
  const float ypkpy = (p_yy - pp_yy) / l;
  if (reml) {
    const float df = (float)(calc_null ? n - n_cvt : n - n_cvt - 1);
    const float trace_pk = (df - trace_p) / l;
    return -0.5f * trace_pk + 0.5f * df * ypkpy / p_yy;
  }
  const float trace_hik = ((float)n - th) / l;
  return -0.5f * trace_hik + 0.5f * (float)n * ypkpy / p_yy;
}

// the register form at C covariates: lanes [s0, s0 + count) of S, a
// thread a (g, s), its rows in registers
template <int C>
__global__ void __launch_bounds__(LG_REG_TPB)
    lambda_grid_reg(const float* __restrict__ xcross,
                    const float* __restrict__ xx,
                    const float* __restrict__ shared,
                    const float* __restrict__ trace_hi,
                    const float* __restrict__ lam, int S, int G, int M,
                    int n, int calc_null, int reml, int wy_lane,
                    float* __restrict__ d1f, int s0, int count) {
  constexpr int COLS = C + 2, NI = (C + 3) * (C + 2) / 2;
  const int sl = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  GT_PROF_START();
  GT_PROF_COUNT(GT_PC_LANES, 1);
  if (sl >= count) return;
  const int s = s0 + sl;
  float2 r[NI];
#pragma unroll
  for (int a = 1; a <= COLS; ++a)
#pragma unroll
    for (int b = a; b <= COLS; ++b)
      r[lg_ab(a, b, COLS)] =
          lg_row0(lg_kind(a, b, C), lg_col(a, b, C), xcross, xx, shared,
                  C + 1, S, G, M, wy_lane, s, g);
  GT_PROF(LG_PH_ROWS);
  float trace_p = trace_hi[g];
#pragma unroll
  for (int p = 1; p <= C + 1; ++p) {
    if (p == C + 1 && calc_null) break;
    const float2 ww = r[lg_ab(p, p, COLS)];
    trace_p = trace_p - ww.y / ww.x;
    const bool nz = ww.x != 0.f;
    const float safe = nz ? ww.x : 1.f;
#pragma unroll
    for (int a = p + 1; a <= COLS; ++a)
#pragma unroll
      for (int b = a; b <= COLS; ++b) {
        const int k = lg_ab(a, b, COLS);
        r[k] = lg_entry(r[k], r[lg_ab(p, a, COLS)], r[lg_ab(p, b, COLS)],
                        nz, safe, ww.y);
      }
  }
  GT_PROF(LG_PH_STEPS);
  // yy is the last flat position
  d1f[(long)g * S + s] = lg_dev1(r[NI - 1].x, r[NI - 1].y, trace_p,
                                 trace_hi[g], lam[g], n, C, calc_null, reml);
  GT_PROF(LG_PH_DEV1);
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
    pp[k] = lg_entry(pp[k], pp[ia], pp[ib], nz, safe, ps2_ww);
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
    const int b0 = lg_ab(a, a, cols);
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
    rows(w)[k] = lg_row0(t.kind[k], t.col[k], xcross, xx, shared, C1, S, G,
                         M, wy_lane, s0 + slw, g);
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
    const int bp = lg_ab(p, p, cols);          // (p, p)
    const float2 ww = pp[bp];
    trace_p = trace_p - ww.y / ww.x;
    const int k0 = lg_ab(p + 1, p + 1, cols) + lane;
    if (lab_bytes)
      lg_step<true>(pp, lab, nullptr, nullptr, p, bp, k0, ni, ww.x, ww.y);
    else
      lg_step<false>(pp, nullptr, t.aw + (long)(p - 1) * ni,
                     t.bw + (long)(p - 1) * ni, p, bp, k0, ni, ww.x, ww.y);
    __syncwarp();
  }
  GT_PROF(LG_PH_STEPS);
  if (lane == 0)   // yy is the last flat position
    d1f[(long)g * S + s] = lg_dev1(pp[ni - 1].x, pp[ni - 1].y, trace_p,
                                   trace_hi[g], lam[g], n, n_cvt, calc_null,
                                   reml);
  GT_PROF(LG_PH_DEV1);
}

template <int C>
static void lg_reg_launch(int n_cvt, dim3 grid, cudaStream_t st,
                          const float* xcross, const float* xx,
                          const float* shared, const float* trace_hi,
                          const float* lam, int S, int G, int M, int n,
                          int calc_null, int reml, int wy_lane, float* d1f,
                          int s0, int count) {
  if constexpr (C <= LG_REG_MAX) {
    if (n_cvt == C)
      lambda_grid_reg<C><<<grid, LG_REG_TPB, 0, st>>>(
          xcross, xx, shared, trace_hi, lam, S, G, M, n, calc_null, reml,
          wy_lane, d1f, s0, count);
    else
      lg_reg_launch<C + 1>(n_cvt, grid, st, xcross, xx, shared, trace_hi,
                           lam, S, G, M, n, calc_null, reml, wy_lane, d1f,
                           s0, count);
  }
}

// up to LG_REG_MAX covariates the register form, above it the warp form,
// which alone reads `tab` (kernels.pab_tables)
extern "C" int lambda_grid_launch(const void* xcross, const void* xx,
                                  const void* shared, const void* trace_hi,
                                  const void* lam, const void* tab,
                                  int n_cvt, int S, int G, int M, int n,
                                  int calc_null, int reml, int wy_lane,
                                  void* d1f, int s0, int count,
                                  void* scratch, void* stream) {
  const bool reg = n_cvt <= LG_REG_MAX;
  if (n_cvt < 0 || (!reg && !tab)) return (int)cudaErrorInvalidValue;
  if (count <= 0 || G <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const float *xc = (const float*)xcross, *x2 = (const float*)xx,
              *sh = (const float*)shared, *th = (const float*)trace_hi,
              *lm = (const float*)lam;
  const int ni = gt_n_index(n_cvt);
  if (reg) {
    const dim3 grid((count + LG_REG_TPB - 1) / LG_REG_TPB, G);
    lg_reg_launch<0>(n_cvt, grid, st, xc, x2, sh, th, lm, S, G, M, n,
                     calc_null, reml, wy_lane, (float*)d1f, s0, count);
  } else {
    const int Ws = lg_smem_warps(ni);
    const int W = Ws ? Ws : LG_WARPS;
    const long smem = lg_lab_bytes(ni) + 8L * ni * Ws;
    if (smem + LG_PROF_SMEM > LG_DEFAULT_SMEM)
      cudaFuncSetAttribute(lambda_grid_warp,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    const dim3 grid((count + W - 1) / W, G);
    lambda_grid_warp<<<grid, 32 * W, smem, st>>>(
        xc, x2, sh, th, lm, (const int*)tab, n_cvt, S, G, M, n, calc_null,
        reml, wy_lane, (float*)d1f, s0, count, (float*)scratch);
  }
  return (int)cudaGetLastError();
}

// 1 where a launch of n_cvt covariates reads the Pab index tables (the
// warp form), else 0
extern "C" long lambda_grid_tables(int n_cvt) { return n_cvt > LG_REG_MAX; }

// bytes of a lane's scratch: the two rows of each of its G (g, s) where
// the warp form's rows do not fit shared memory, else 0
extern "C" long lambda_grid_lane_bytes(int n_cvt, int G) {
  const int ni = gt_n_index(n_cvt);
  return n_cvt > GT_MAX_CVT && !lg_smem_warps(ni) ? 8L * G * ni : 0;
}

GT_ERROR_FN(lambda_grid)
