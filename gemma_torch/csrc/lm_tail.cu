// K8 — the linear model's per-row OLS and its three tests (-lm 1-4), in
// float32 (speed mode) and float64 (parity mode, entry point
// lm_tail_f64_launch).
//
// Replaces the reference package's device programs
//   gemma_tpu/models/lm.py:38 lm_block and :68 lm_gene_block
// with gemma_tpu/ops/stats.py:21 f_sf and :46 chisq_sf (GEMMA's CalcvPv
// and LmCalcP, lm.cpp:224-289).
//
// Per row r (a SNP's imputed genotypes, or in gene mode a gene's
// expression), in float64 from operands of either type: the sums r'r,
// r'v and r'W_a (v the shared vector: the phenotype, or in gene mode the
// predictor; W the covariates), then with the shared (W'W)^-1, (W'W)^-1
// W'v and v'P_W v that torch computes once the projections r'P_W r =
// r'r - r'W (W'W)^-1 W'r and r'P_W v, and from them beta, se, the F(1,
// n-c-1) Wald and score tails and the chi-square(1) LRT tail of
// tails.cuh.  The LRT statistic is -n log1p(-xPwy²/(xPwx yPwy)): the
// reference's log(yPwy) - log(yPxy) cancels for null SNPs.  In gene mode
// r'P_W r is yPwy and v'P_W v is xPwx; otherwise the other way round.
//
// Two launches a call.  The first takes the sums and the projections and
// leaves (r'P_W r, r'P_W v) in the row's scratch, in one of two forms:
// * the warp form (c <= LM_NARROW): a warp a row, eight a block, exactly
//   c + 2 float64 sums in registers (an instantiation per c); each thread
//   reads 16 bytes of the row (and of v and W) at a time where the rows
//   are 16-byte aligned (vec), the elements i ≡ its lane (mod 32)
//   otherwise, then a butterfly of shuffles; lane 0 the projections.
// * the tile form (c > LM_NARROW): a block of four warps a tile of LM_TR
//   = 32 rows walks n in chunks of up to 128 individuals; the chunk's
//   rows of the tile and of [W, v] are copied once into shared memory by
//   16-byte cp.async (element copies where a row is not aligned), the
//   next two chunks in flight while the block multiplies the current
//   one.  r'[W, v] is the product (tile's rows) × (chunk's [W, v]) on
//   the FP64 tensor cores, mma.sync m8n8k4 (DMMA), the float32 operands
//   widened to float64 as they are loaded: a warp eight rows and every
//   8-wide column tile of a pass (up to 64 columns a pass over n), one A
//   fragment for all of them; with one, two or four column tiles, four,
//   two or two accumulators a tile take the k-steps in turn.  Σ r² is a
//   row sum on 4 threads a row.  r'[W, v] goes to the row's scratch; then
//   a warp a row: t = (W'W)^-1 W'r an entry a lane ((W'W)^-1 in shared
//   memory where it fits), q = r'W t and b = r'W (W'W)^-1 W'v by the
//   warp's butterfly.
// The second launch takes the three tests, a thread a (row, test), the
// tests in warps of their own (so the warps' F and chi-square loops do
// not diverge), beta and se with the Wald test.
//
// Every sum's order depends on (n, c, the operand type and the form)
// alone; DMMA rows do not mix.
//
// Bound: bytes — S·n operand values read once (the shared v and W stay
// in L2) and five values written per row; the products are 2 (c + 2)
// float64 operations per element, on the FP64 tensor cores above
// LM_NARROW covariates.
#include "test_sums.cuh"

#define LM_WARPS 8         // rows a block of the warp form
#define LM_THREADS 256
#define LM_NARROW 3        // the most covariates of the warp form
#define LM_TR 32           // rows of a tile (four m8 row tiles)
#define LM_TT 128          // threads of a tile's block: a warp a row tile
#define LM_STAGES 3        // chunks of the tile form in shared memory
#define LM_BUDGET (56 * 1024)       // their bytes for four blocks an SM
#define LM_BUDGET_MAX (200 * 1024)  // their bytes for one
#define LM_WTW_SMEM 64     // (W'W)^-1 in shared memory up to this c

// a row's scratch: (r'P_W r, r'P_W v), then in the tile form r'[W, v]
__host__ __device__ inline int lm_c1p(int c) { return (c + 1 + 7) / 8 * 8; }
__host__ __device__ inline long lm_row_doubles(int c) {
  return 2 + (c > LM_NARROW ? lm_c1p(c) : 0);
}

// --- the warp form ----------------------------------------------------------

template <typename T>
struct LmVec;
template <>
struct LmVec<float> {
  using V = float4;
  static constexpr int E = 4;
  __device__ static float at(const V& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};
template <>
struct LmVec<double> {
  using V = double2;
  static constexpr int E = 2;
  __device__ static double at(const V& v, int e) { return e == 0 ? v.x : v.y; }
};

// the sums of one element: acc = (r'r, r'v, r'W_0 .. r'W_{C-1})
template <int C>
__device__ __forceinline__ void lm_add(double ri, double vi, const double* wi,
                                       double (&acc)[C + 2]) {
  acc[0] += ri * ri;
  acc[1] += ri * vi;
#pragma unroll
  for (int a = 0; a < C; ++a) acc[2 + a] += ri * wi[a];
}

// the projections of a row's sums: (r'P_W r, r'P_W v) into pr
__device__ __forceinline__ void lm_project_serial(
    const double* rw, double rr, double rv, int c, const double* WtWi,
    const double* WtWi_Wtv, double* pr) {
  double q = 0.0, b = 0.0;
  for (int a = 0; a < c; ++a) {
    double t = 0.0;
    for (int k = 0; k < c; ++k) t += WtWi[a * c + k] * rw[k];
    q += rw[a] * t;
    b += rw[a] * WtWi_Wtv[a];
  }
  pr[0] = rr - q;
  pr[1] = rv - b;
}

template <typename T, int C, bool VEC>
__global__ void __launch_bounds__(LM_WARPS * 32)
lm_warp_kernel(const T* __restrict__ rows, const T* __restrict__ v,
               const T* __restrict__ W, const double* __restrict__ WtWi,
               const double* __restrict__ WtWi_Wtv, int S, int n,
               double* __restrict__ scratch) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * LM_WARPS + (threadIdx.x >> 5);
  if (s >= S) return;  // the whole warp leaves together
  GT_PROF_START();
  GT_PROF_COUNT(GT_PC_LANES, 1);
  const T* r = rows + (long)s * n;
  double acc[C + 2];
#pragma unroll
  for (int q = 0; q < C + 2; ++q) acc[q] = 0.0;
  if constexpr (VEC) {
    using LV = LmVec<T>;
    using V = typename LV::V;
    constexpr int E = LV::E;
    const V* r4 = reinterpret_cast<const V*>(r);
    const V* v4 = reinterpret_cast<const V*>(v);
    const V* w4 = reinterpret_cast<const V*>(W);
    const int nv = n / E;
#pragma unroll 2
    for (int j = lane; j < nv; j += 32) {
      const V rj = __ldg(r4 + j), vj = __ldg(v4 + j);
      V wj[C > 0 ? C : 1];
#pragma unroll
      for (int a = 0; a < C; ++a) wj[a] = __ldg(w4 + (long)j * C + a);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        double wi[C > 0 ? C : 1];
#pragma unroll
        for (int a = 0; a < C; ++a)
          wi[a] = (double)LV::at(wj[(e * C + a) / E], (e * C + a) % E);
        lm_add<C>((double)LV::at(rj, e), (double)LV::at(vj, e), wi, acc);
      }
    }
  } else {
    for (int i = lane; i < n; i += 32) {
      double wi[C > 0 ? C : 1];
#pragma unroll
      for (int a = 0; a < C; ++a) wi[a] = (double)W[(long)i * C + a];
      lm_add<C>((double)r[i], (double)v[i], wi, acc);
    }
  }
#pragma unroll
  for (int q = 0; q < C + 2; ++q) acc[q] = gt_warp_sum(acc[q]);
  GT_PROF(TT_PH_SUMS);
  if (lane == 0)
    lm_project_serial(acc + 2, acc[0], acc[1], C, WtWi, WtWi_Wtv,
                      scratch + 2L * s);
  GT_PROF(TT_PH_POST);
}

// --- the tile form ----------------------------------------------------------

// The tile form's shared memory, byte offsets: LM_STAGES chunks (the
// tile's rows at stride rstr, the pass's columns of W, v), then (W'W)^-1
// where c <= LM_WTW_SMEM.  A pass takes pc = 8 nct columns of [W, v] (all
// of them up to 64); a chunk kc individuals, the most of 128, 64, 32, 16
// whose stages fit LM_BUDGET (four blocks an SM), else LM_BUDGET_MAX.
struct LmTile {
  int c, C1p, nct, pc, wc, passes, kc, rstr;
  long o_r, o_w, o_v, buf, o_wtw, bytes;
};

__host__ __device__ inline LmTile lm_tile(int c, int isz) {
  LmTile L;
  L.c = c;
  L.C1p = lm_c1p(c);
  L.nct = L.C1p <= 8 ? 1 : L.C1p <= 16 ? 2 : L.C1p <= 32 ? 4 : 8;
  L.pc = 8 * L.nct;
  L.passes = (L.C1p + L.pc - 1) / L.pc;
  L.wc = L.passes == 1 ? c : L.pc;   // W's columns a staged row
  for (int pass = 0; pass < 2; ++pass) {
    const long budget = pass == 0 ? LM_BUDGET : LM_BUDGET_MAX;
    for (L.kc = 128; L.kc >= 16; L.kc /= 2) {
      L.rstr = L.kc + 4;
      L.o_r = 0;
      L.o_w = gt_r16((long)LM_TR * L.rstr * isz);
      L.o_v = L.o_w + gt_r16((long)L.kc * L.wc * isz);
      L.buf = L.o_v + gt_r16((long)L.kc * isz);
      if (LM_STAGES * L.buf <= budget) break;
    }
    if (L.kc >= 16) break;
  }
  if (L.kc < 16) L.kc = 16;   // past LM_BUDGET_MAX: refused by the launch
  L.o_wtw = LM_STAGES * L.buf;
  L.bytes = L.o_wtw + (c <= LM_WTW_SMEM ? 8L * c * c : 0);
  return L;
}

__device__ __forceinline__ void lm_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::);
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// count elements from src to dst by the tile's block (dst 16-aligned),
// those from valid on zero: 16 bytes a copy where al
template <typename T>
__device__ __forceinline__ void lm_copy(T* dst, const T* src, int count,
                                        int valid, bool al) {
  constexpr int E = 16 / sizeof(T);
  for (int e = threadIdx.x * E; e < count; e += LM_TT * E) {
    if (al && e + E <= valid) {
      ts_cp16(dst + e, src + e);
    } else {
      for (int u = 0; u < E && e + u < count; ++u)
        ts_cp(dst + e + u, e + u < valid ? src + e + u : src, e + u < valid);
    }
  }
}

// chunk [k0, k0 + kc) of the tile's rows and of the pass's columns
// [c0, c0 + pc) of [W, v] into buffer b, one cp.async group; zero past n
// and past the last row.  al: W and v 16-byte aligned; ral: every row's
// chunks too
template <typename T>
__device__ __forceinline__ void lm_fetch(const LmTile& L, unsigned char* b,
                                         const T* rows, int s0, int S,
                                         int n, const T* W, const T* v,
                                         int k0, int c0, bool al, bool ral) {
  constexpr int E = 16 / sizeof(T);
  const int kn = min(L.kc, n - k0), vpr = L.kc / E;
  T* R = reinterpret_cast<T*>(b + L.o_r);
  for (int e = threadIdx.x; e < LM_TR * vpr; e += LM_TT) {
    const int row = e / vpr, j = e % vpr * E;
    const bool live = s0 + row < S;
    const int valid = live ? kn - j : 0;
    const T* src = rows + (long)(live ? s0 + row : 0) * n + k0 + j;
    T* dst = R + row * L.rstr + j;
    if (ral && valid >= E) {
      ts_cp16(dst, src);
    } else {
      for (int u = 0; u < E; ++u)
        ts_cp(dst + u, u < valid ? src + u : rows, u < valid);
    }
  }
  const int c = L.c;
  T* Wb = reinterpret_cast<T*>(b + L.o_w);
  const int wn = min(L.pc, c - c0);    // the pass's columns of W
  if (L.passes == 1) {
    lm_copy(Wb, W + (long)k0 * c, L.kc * c, kn * c, al);
  } else if (wn > 0) {
    for (int e = threadIdx.x; e < L.kc * wn; e += LM_TT) {
      const int k = e / wn, a = e % wn;
      ts_cp(Wb + k * L.pc + a, k < kn ? W + (long)(k0 + k) * c + c0 + a : W,
            k < kn);
    }
  }
  lm_copy(reinterpret_cast<T*>(b + L.o_v), v + k0, L.kc, kn, al);
  ts_commit();
}

// DMMA m8n8k4 (as ts_dmma, but not volatile: the compiler may overlap
// a step's products with the next step's loads)
__device__ __forceinline__ void lm_dmma(double& c0, double& c1, double a,
                                        double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// A block of LM_TT threads, warp w the rows 8w .. 8w + 7 of the tile and
// all NCT column tiles of a pass; U accumulators a column tile, the
// warp's k-steps going to them in turn (U products in flight where NCT
// is small), added as ((0 + 1) + (2 + 3)).
template <typename T, int NCT, int U>
__global__ void __launch_bounds__(LM_TT, 4)
lm_tile_kernel(const T* __restrict__ rows, const T* __restrict__ v,
               const T* __restrict__ W, const double* __restrict__ WtWi,
               const double* __restrict__ WtWi_Wtv, int S, int n, int c,
               double* __restrict__ scratch, int al) {
  extern __shared__ __align__(16) unsigned char lm_smem[];
  const LmTile L = lm_tile(c, sizeof(T));
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  const int g = lid >> 2, t = lid & 3;
  const int s0 = blockIdx.x * LM_TR;
  GT_PROF_START();
  GT_PROF_COUNT(GT_PC_LANES, 1);
  // a row's chunks are 16-byte aligned where n allows
  const bool ral = al && (n * sizeof(T)) % 16 == 0;
  const long rd = lm_row_doubles(c);
  const int kc = L.kc, nch = (n + kc - 1) / kc;
  const int rrow = tid >> 2, rk = tid & 3;   // Σ r²: 4 threads a row
  double rr = 0.0;
  for (int pass = 0; pass < L.passes; ++pass) {
    const int c0 = pass * L.pc;
    double acc[U][NCT][2];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NCT; ++j) acc[u][j][0] = acc[u][j][1] = 0.0;
    // the pass's column tiles that hold a column of [W, v]; where this
    // thread's B column of tile j lies: W's column bcol (0), v (1), or
    // padding (2)
    const int ntl = min(NCT, (c + 1 - c0 + 7) / 8);
    int bsel[NCT], bcol[NCT];
#pragma unroll
    for (int j = 0; j < NCT; ++j) {
      const int col = j * 8 + g, gc = c0 + col;
      bsel[j] = gc < c ? 0 : gc == c ? 1 : 2;
      bcol[j] = gc < c ? col : 0;
    }
    __syncthreads();
    // LM_STAGES - 1 chunks in flight ahead of the one multiplied
#pragma unroll
    for (int p = 0; p < LM_STAGES - 1; ++p) {
      if (p < nch)
        lm_fetch<T>(L, lm_smem + p * L.buf, rows, s0, S, n, W, v, p * kc,
                    c0, al, ral);
      else
        ts_commit();
    }
    for (int ch = 0; ch < nch; ++ch) {
      const int nx = ch + LM_STAGES - 1;
      if (nx < nch)
        lm_fetch<T>(L, lm_smem + (nx % LM_STAGES) * L.buf, rows, s0, S, n, W,
                    v, nx * kc, c0, al, ral);
      else
        ts_commit();
      lm_wait(LM_STAGES - 1);
      __syncthreads();
      GT_PROF(TT_PH_WEIGHTS);
      const unsigned char* b = lm_smem + (ch % LM_STAGES) * L.buf;
      const T* R = reinterpret_cast<const T*>(b + L.o_r);
      if (pass == 0)
        for (int k = rk; k < kc; k += 4) {
          const double x = (double)R[rrow * L.rstr + k];
          rr += x * x;
        }
      const T* Ra = R + (warp * 8 + g) * L.rstr + t;
      const T* Wb = reinterpret_cast<const T*>(b + L.o_w) + t * L.wc;
      const T* vb = reinterpret_cast<const T*>(b + L.o_v) + t;
      for (int k = 0; k < kc; k += 4 * U) {
        // the step's fragments first, then its products
        double av[U], bv[U][NCT];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kk = k + 4 * u;
          av[u] = (double)Ra[kk];
#pragma unroll
          for (int j = 0; j < NCT; ++j)
            bv[u][j] = bsel[j] == 0   ? (double)Wb[kk * L.wc + bcol[j]]
                       : bsel[j] == 1 ? (double)vb[kk]
                                      : 0.0;
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < NCT; ++j)
            if (j < ntl) lm_dmma(acc[u][j][0], acc[u][j][1], av[u], bv[u][j]);
      }
      __syncthreads();
      GT_PROF(TT_PH_SUMS);
    }
    // row g of the warp's rows, columns 2t, 2t + 1 of column tile j
#pragma unroll
    for (int j = 0; j < NCT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        double x = acc[0][j][h];
        if constexpr (U == 4)
          x = (acc[0][j][h] + acc[1][j][h]) + (acc[2][j][h] + acc[3][j][h]);
        else if constexpr (U == 2)
          x = acc[0][j][h] + acc[1][j][h];
        const int row = warp * 8 + g, col = j * 8 + 2 * t + h;
        if (s0 + row < S && c0 + col <= c)
          scratch[(s0 + row) * rd + 2 + c0 + col] = x;
      }
  }
  // Σ r²: the 4 threads of a row, a butterfly within them
#pragma unroll
  for (int o = 2; o > 0; o >>= 1) rr += __shfl_xor_sync(0xffffffffu, rr, o);
  double* wtw = reinterpret_cast<double*>(lm_smem + L.o_wtw);
  if (c <= LM_WTW_SMEM)
    for (int e = tid; e < c * c; e += LM_TT) wtw[e] = WtWi[e];
  else
    wtw = const_cast<double*>(WtWi);
  double* rrs = reinterpret_cast<double*>(lm_smem);   // the chunks are done
  __syncthreads();
  if (rk == 0) rrs[rrow] = rr;
  __syncthreads();
  // the projections, a warp a row
  for (int row = warp; row < LM_TR; row += LM_TT / 32) {
    if (s0 + row >= S) break;
    double* sc = scratch + (s0 + row) * rd;
    const double* rw = sc + 2;
    double q = 0.0, b = 0.0;
    for (int a = lid; a < c; a += 32) {
      double tt = 0.0;
      for (int k = 0; k < c; ++k) tt += wtw[(long)a * c + k] * rw[k];
      q += rw[a] * tt;
      b += rw[a] * WtWi_Wtv[a];
    }
    q = gt_warp_sum(q);
    b = gt_warp_sum(b);
    if (lid == 0) {
      sc[0] = rrs[row] - q;
      sc[1] = rw[c] - b;
    }
  }
  GT_PROF(TT_PH_POST);
}

// --- the tests --------------------------------------------------------------

// thread (test, row): test 0 the Wald test with beta and se, 1 the score
// test, 2 the LRT; rows padded to whole warps so that a warp runs one test
template <typename T>
__global__ void __launch_bounds__(LM_THREADS)
lm_tests_kernel(const double* __restrict__ scratch, long rd,
                const double* __restrict__ vPwv, int S, int n, int c,
                int gene, int se_score, T* beta_out, T* se_out, T* pw_out,
                T* pl_out, T* ps_out) {
  GT_PROF_START();
  const int Sp = (S + 31) / 32 * 32;
  const long gi = (long)blockIdx.x * LM_THREADS + threadIdx.x;
  const int test = (int)(gi / Sp), s = (int)(gi % Sp);
  if (test < 3 && s < S) {
    const double rPwr = scratch[s * rd], xPwy = scratch[s * rd + 1];
    const double xPwx = gene ? vPwv[0] : rPwr;
    const double yPwy = gene ? rPwr : vPwv[0];
    const double nf = (double)n;
    const double df = (double)(n - c - 1);
    const double r2 = xPwy * xPwy / (xPwx * yPwy);
    if (test == 0) {
      const double yPxy = yPwy - xPwy * xPwy / xPwx;
      beta_out[s] = (T)(xPwy / xPwx);
      se_out[s] = (T)(se_score ? sqrt(yPwy / (nf * xPwx))
                               : sqrt(yPxy / (df * xPwx)));
      pw_out[s] = (T)gt_f_sf(xPwy * xPwy * df / (xPwx * yPxy), 1.0, df);
    } else if (test == 1) {
      ps_out[s] = (T)gt_f_sf(nf * r2, 1.0, df);
    } else {
      pl_out[s] = (T)gt_chisq_sf(-nf * log1p(-r2), 1.0);
    }
  }
  GT_PROF(TT_PH_TAIL);
}

template <typename T, int C>
static void lm_warp_launch(bool vec, const T* rows, const T* v, const T* W,
                           const double* WtWi, const double* WtWi_Wtv, int S,
                           int n, double* scratch, cudaStream_t st) {
  const dim3 grid((S + LM_WARPS - 1) / LM_WARPS);
  (vec ? lm_warp_kernel<T, C, true> : lm_warp_kernel<T, C, false>)<<<
      grid, LM_WARPS * 32, 0, st>>>(rows, v, W, WtWi, WtWi_Wtv, S, n,
                                    scratch);
}

static bool lm_al16(const void* p) {
  return (reinterpret_cast<unsigned long>(p) & 15) == 0;
}

template <typename T>
static int gt_lm_tail_run(const void* rows, const void* v, const void* W,
                          const void* WtWi, const void* WtWi_Wtv,
                          const void* vPwv, int S, int n, int c, int gene,
                          int se_score, void* beta, void* se, void* pw,
                          void* pl, void* ps, void* scratch, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const T *r = (const T*)rows, *vv = (const T*)v, *w = (const T*)W;
  const double *wi = (const double*)WtWi, *wv = (const double*)WtWi_Wtv;
  double* sc = (double*)scratch;
  constexpr int E = 16 / sizeof(T);
  if (c <= LM_NARROW) {
    // 16-byte reads where every row, v and W are 16-byte aligned
    const bool vec = n % E == 0 && lm_al16(rows) && lm_al16(v) &&
                     (c == 0 || lm_al16(W));
    switch (c) {
      case 0: lm_warp_launch<T, 0>(vec, r, vv, w, wi, wv, S, n, sc, st); break;
      case 1: lm_warp_launch<T, 1>(vec, r, vv, w, wi, wv, S, n, sc, st); break;
      case 2: lm_warp_launch<T, 2>(vec, r, vv, w, wi, wv, S, n, sc, st); break;
      default: lm_warp_launch<T, 3>(vec, r, vv, w, wi, wv, S, n, sc, st);
    }
  } else {
    const LmTile L = lm_tile(c, sizeof(T));
    if (L.bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
    auto kern = L.nct == 1   ? lm_tile_kernel<T, 1, 4>
                : L.nct == 2 ? lm_tile_kernel<T, 2, 2>
                : L.nct == 4 ? lm_tile_kernel<T, 4, 2>
                             : lm_tile_kernel<T, 8, 1>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)L.bytes);
    kern<<<(S + LM_TR - 1) / LM_TR, LM_TT, L.bytes, st>>>(
        r, vv, w, wi, wv, S, n, c, sc,
        lm_al16(rows) && lm_al16(W) && lm_al16(v));
  }
  const int Sp = (S + 31) / 32 * 32;
  lm_tests_kernel<T><<<(3 * Sp + LM_THREADS - 1) / LM_THREADS, LM_THREADS, 0,
                       st>>>(sc, lm_row_doubles(c), (const double*)vPwv, S,
                             n, c, gene, se_score, (T*)beta, (T*)se, (T*)pw,
                             (T*)pl, (T*)ps);
  return (int)cudaGetLastError();
}

#define GT_LM_TAIL_ENTRY(name, T)                                           \
  extern "C" int name(const void* rows, const void* v, const void* W,       \
                      const void* WtWi, const void* WtWi_Wtv,               \
                      const void* vPwv, int S, int n, int c, int gene,      \
                      int se_score, void* beta, void* se, void* pw,         \
                      void* pl, void* ps, void* scratch, void* stream) {    \
    return gt_lm_tail_run<T>(rows, v, W, WtWi, WtWi_Wtv, vPwv, S, n, c,     \
                             gene, se_score, beta, se, pw, pl, ps, scratch, \
                             stream);                                       \
  }

// bytes of a row's scratch: the projections, and in the tile form r'[W, v]
extern "C" long lm_tail_lane_bytes(int c) { return 8 * lm_row_doubles(c); }

// the form of c covariates (0 warp, 1 tile) and the tile form's layout:
// what = 0 form, 1 passes, 2 column tiles a pass, 3 a chunk's
// individuals, 4 shared bytes; `isz` the operands' bytes
extern "C" long lm_tail_geometry(int c, int isz, int what) {
  const LmTile L = lm_tile(c, isz);
  switch (what) {
    case 0: return c > LM_NARROW;
    case 1: return L.passes;
    case 2: return L.nct;
    case 3: return L.kc;
  }
  return L.bytes;
}

GT_LM_TAIL_ENTRY(lm_tail_launch, float)
GT_LM_TAIL_ENTRY(lm_tail_f64_launch, double)
GT_ERROR_FN(lm_tail)
