// The per-SNP test stage shared by K4/K5 (test_tail.cuh) and K6's speed
// mode (lrt_tail.cu): every sum over the n individuals that the Wald and
// score rows (CalcPab's base row) and the ML log-likelihood's weighted
// Gram and right-hand side need, then the work a lane does on its own.
//
// The sums of a lane s, Q = M + C1 + 1 of them (C1 = c + 1 columns of
// [W, y], M = C1 (C1 + 1) / 2 of their pairs), in one layout for both:
//   q < M          Σ_i h_si · B_i[q],  B the pair (a, b) of [W, y], a <= b
//                  (row-major upper triangle): wy_prod's column for K4/K5,
//                  the float64 product W_a W_b formed here for K6
//   q = M + j      Σ_i (h x)_si · [W, y]_ij
//   q = M + C1     Σ_i (h x)_si · x_si
// and, for K6, Σ_i log(λ_s eval_i + 1).  Each lane's weights h = 1/(λ_s
// eval_i + 1) and h·x are made once an individual: K4/K5 round them to the
// operand type T and take float64 products and sums (the plain version
// likelihood._base_row does the same, so a float32 base row is the float64
// sum rounded once); K6 makes them in float64 from float32 operands.
//
// Three forms, by (c, whether the lanes share [W, y] and wy_prod):
// * TS_REG, Q <= 16 (c <= 3): a warp a lane, eight a block; each thread
//   takes the individuals i ≡ its lane (mod 32), four at a time with their
//   operands loaded first (K6: eight, their x first), the Q sums in
//   registers, then a butterfly of shuffles; K6 sums the log of each
//   round's product of (λ eval + 1).
//   The work is bound by reading the lanes' Utx rows.
// * TS_MMA, shared operands, Q > 16: a block a tile of TS_L = 8 lanes
//   walks n in chunks of 32 individuals (16, 8 or 4 at wider c).  The
//   chunk's rows of wy_prod and [W, y] (K6: of [W, y] alone), contiguous
//   in device memory, are copied once for the tile into shared memory by
//   16-byte cp.async, the next chunk's copy in flight while the
//   tile multiplies the current one; warp s makes lane s's weights, a
//   thread an individual, a chunk ahead.  The pairs are then the product
//   (tile's h) × (chunk's pair rows) and the x sums (tile's h·x) × (chunk's
//   [W, y]) on the FP64 tensor cores: mma.sync m8n8k4 (DMMA), the padded
//   columns split into 8-wide tiles, a warp holding up to TS_TPW of them;
//   K6's B fragments are the float64 products W_a W_b formed from the
//   staged row as they are loaded.  Σ h·x·x and Σ log are row sums of a
//   lane's warp.
// * TS_LANE, per-lane operands (GxE, gene mode), Q > 16: a block a lane;
//   the lane's rows are copied a chunk at a time in the same way, read
//   once and coalesced, and each thread sums up to TS_QPT columns.
// Columns past what a pass holds (TS_MMA 640, TS_LANE 768) are taken in
// further passes over n (above 30 covariates).  Every sum's order
// depends on (n, c) and the form alone: never on the tile a lane shares
// or where a launch was split (DMMA rows do not mix), so a split call
// equals the unsplit one bit for bit.
//
// Above GT_WIDE_CVT covariates (dyn) each lane's rows (K4/K5) or sums
// and factor (K6; past 319 covariates its solution too) live in its
// slice of global scratch instead of shared memory (ts_lane_bytes a lane; the wrappers split a block's
// lanes into launches under a byte budget, kernels.launch_lanes).  Every
// launch then fits the card's 227 KB a block at any c: the staging stays
// within TS_STAGE (K4/K5 past ~75 covariates stage the pass's columns
// alone), K6's residual chunks shrink and then give way to reads from
// device memory.  K6 stages whole rows of [W, y], four at least: up to
// 5,119 covariates (K3's search, which gives K6 its λ, stops below
// that); past it lrt_tail_launch refuses the launch.
#pragma once

#include "tails.cuh"

#define TS_THREADS 256
#define TS_WARPS (TS_THREADS / 32)
#define TS_REG_Q 16       // the register form's most sums a lane
#define TS_L 8            // lanes of a DMMA tile (one m8 row tile)
#define TS_KM 32          // the most individuals of a DMMA chunk
#define TS_KL 16          // the most individuals of a lane-form chunk
#define TS_RC 64          // individuals of a chunk of K6's DMMA residual
#define TS_RU 4           // individuals a thread a round, K4/K5 register form
#define TS_RU_X 8         // the same, K6's (x alone loaded ahead)
#define TS_TPW 10         // column tiles a warp a DMMA pass
#define TS_QPT 3          // columns a thread a lane-form pass
#define TS_ASTR (TS_L + 4)  // staged weights: TS_L lanes a row, padded
#define TS_PART 128       // individuals a block of a single-lane null
#define TS_STAGE (160 * 1024)  // the most bytes of the two staged chunks
#define TS_LAB_MAX (16 * 1024)  // the most bytes of the labels table

enum { TS_REG = 0, TS_MMA = 1, TS_LANE = 2 };
// blocks an SM a form's launch bounds ask for (the lane and register
// forms' from their kernel): the register caps under which each form ran
// fastest on the card (scripts/k4_k6_phase_profile.py)
#define TS_MIN_BLOCKS(form, lane, reg) \
  ((form) == TS_MMA ? 2 : ((form) == TS_LANE ? (lane) : (reg)))
// what a launch sums: K4/K5's rows, K6's alternative or null model (the
// null has no x: no x columns, CZ = c)
enum { TS_TEST = 0, TS_LRT = 1, TS_LRT_NULL = 2 };

// A launch's geometry and its dynamic shared memory, in bytes from the
// start (16-aligned); the same on the host (sizes) and the device.
// chip_smoke.py tail_layout mirrors it.
struct TsLay {
  int c, C1, M, Q, CZ, nG, xc, form, dyn, lanes;
  int Mp, Qp, pcols, passes, kc, raw, bst, bsz;
  int rc;  // K6's DMMA residual chunks: TS_RC rows, or 0 (not staged)
  long o_lab, o_beta, o_set, o_A, o_B, bytes;
  long lane_set;    // bytes of a lane's set (rows, or sums and factor)
  long lane_bytes;  // scratch a lane (dyn: the sets), else 0
};

__host__ __device__ inline int ts_r8(int v) { return (v + 7) / 8 * 8; }

// the form of a launch of c covariates
__host__ __device__ inline int ts_form(int c, int shared_ops) {
  const int C1 = c + 1, Q = C1 * (C1 + 1) / 2 + C1 + 1;
  return Q <= TS_REG_Q ? TS_REG : (shared_ops ? TS_MMA : TS_LANE);
}

__host__ __device__ inline TsLay ts_layout(int c, int form, int kind,
                                           int tsize) {
  TsLay L;
  L.c = c;
  L.C1 = c + 1;
  L.M = L.C1 * (L.C1 + 1) / 2;
  L.Q = L.M + L.C1 + 1;
  L.CZ = kind == TS_LRT_NULL ? c : c + 1;
  L.nG = L.CZ * (L.CZ + 1) / 2;
  L.xc = kind == TS_LRT_NULL ? 0 : L.C1;
  L.form = form;
  L.dyn = c > GT_WIDE_CVT;
  L.lanes = form == TS_REG ? TS_WARPS : (form == TS_MMA ? TS_L : 1);
  const bool mma = form == TS_MMA;
  L.Mp = mma ? ts_r8(L.M) : L.M;
  L.Qp = mma ? L.Mp + ts_r8(L.xc) : L.M + L.xc;
  const int most = mma ? TS_WARPS * TS_TPW * 8 : TS_THREADS * TS_QPT;
  L.pcols = L.Qp < most ? L.Qp : most;
  L.passes = (L.Qp + L.pcols - 1) / L.pcols;
  // the staged chunk: the chunk's whole rows (raw: K4/K5's wy_prod then
  // [W, y], K6's [W, y], copied 16 bytes at a time), TS_KM (DMMA) or TS_KL
  // rows, halved down to 4 until two fit TS_STAGE; else (K4/K5 past ~75
  // covariates) TS_KL rows of the pass's
  // columns a row at stride bst (floats ≡ 8 or 24 mod 32, doubles ≡ 4 or
  // 12 mod 16: B fragments without bank conflicts)
  const int isz = kind == TS_TEST ? tsize : 4;
  const long row = kind == TS_TEST ? (long)L.M + L.C1 : L.C1;
  L.kc = mma ? TS_KM : TS_KL;
  while (L.kc > 4 && 2L * L.kc * row * isz > TS_STAGE) L.kc /= 2;
  L.raw = 2L * L.kc * row * isz <= TS_STAGE;
  const int pc8 = ts_r8(L.pcols);
  L.bst = L.raw ? 0 : (tsize == 8 ? pc8 + 4 : pc8 + (pc8 % 16 == 0 ? 8 : 0));
  if (!L.raw) L.kc = TS_KL;
  L.bsz = L.raw ? (int)(L.kc * row) : L.kc * L.bst;
  // each lane's set: its rows (K4/K5: Q values of T), or its sums (Q + 1,
  // Σ log last), packed Gram and solution (K6)
  L.lane_set = kind == TS_TEST ? gt_r16((long)L.Q * tsize)
                               : gt_r16(8L * (L.Q + 1)) +
                                     gt_r16(8L * (L.M + L.C1));
  L.lane_bytes = L.dyn ? L.lane_set : 0;
  const long sets = L.dyn ? 0 : L.lanes * L.lane_set;
  long o = 0;
  // K4/K5: the recurrence's labels, where they fit
  L.o_lab = kind == TS_TEST && 4L * L.Q <= TS_LAB_MAX ? o : -1;
  o += L.o_lab < 0 ? 0 : gt_r16(4L * L.Q);
  // K6's DMMA residual pass: two chunks of TS_RC rows of [W, y] where they
  // fit TS_STAGE; past 319 covariates (rc = 0) it reads the rows from
  // device memory
  L.rc = 2L * TS_RC * L.C1 * 4 <= TS_STAGE ? TS_RC : 0;
  // K6: each lane's solution, for the residual pass (the DMMA form past
  // 319 covariates: in the lane's set)
  L.o_beta = o;
  o += kind == TS_TEST || (mma && L.rc == 0) ? 0
                                            : gt_r16(8L * L.lanes * L.CZ);
  L.o_set = o;
  if (form == TS_REG) {
    L.o_A = L.o_B = o;
    L.bytes = o + sets;
    return L;
  }
  // the lane form keeps its one set beside the staging; the DMMA form's
  // sets take the staging's place once the sums are done
  if (form == TS_LANE) o += sets;
  const long base = o;
  L.o_A = base;  // weights: two chunks of (h, h·x)
  o += gt_r16(8L * 2 * 2 * (mma ? TS_KM * TS_ASTR : TS_KL));
  L.o_B = o;     // two staged chunks
  o += gt_r16(2L * L.bsz * isz);
  L.bytes = o;
  if (mma) {
    const long p2 = base + sets;
    // K6's residual pass: two chunks of rc rows of [W, y]
    const long p3 = kind == TS_TEST ? 0 : base + gt_r16(4L * 2 * L.rc * L.C1);
    if (p2 > L.bytes) L.bytes = p2;
    if (p3 > L.bytes) L.bytes = p3;
  }
  return L;
}

// the pair (a, b), a <= b, of C1 columns at row-major flat position q
__host__ __device__ inline void ts_pair_of(int q, int C1, int& a, int& b) {
  a = 0;
  while (q >= C1 - a) {
    q -= C1 - a;
    ++a;
  }
  b = a + q;
}

// flat position of the pair a <= b of C1 columns, row-major
__host__ __device__ __forceinline__ int ts_pair(int a, int b, int C1) {
  return a * C1 - a * (a - 1) / 2 + (b - a);
}

// GEMMA's flat position (GetabIndex) of the labels a <= b over cols
__device__ __forceinline__ int ts_ab(int a, int b, int cols) {
  return (2 * cols - a + 2) * (a - 1) / 2 + (b - a);
}

// the flat CalcPab position of sum q (K4/K5's base row): labels 1..c the
// covariates, c + 1 x, c + 2 y
__device__ inline int ts_flat(const TsLay& L, int q) {
  const int c = L.c, cols = c + 2, x = c + 1;
  auto lab = [&](int j) { return j < c ? j + 1 : c + 2; };
  if (q < L.M) {
    int a, b;
    ts_pair_of(q, L.C1, a, b);
    return ts_ab(lab(a), lab(b), cols);
  }
  if (q < L.M + L.C1) {
    const int j = lab(q - L.M);
    return j < x ? ts_ab(j, x, cols) : ts_ab(x, j, cols);
  }
  return ts_ab(x, x, cols);
}

// the sums index of padded column col, or -1 for padding
__device__ __forceinline__ int ts_col_q(const TsLay& L, int col) {
  if (col < L.Mp) return col < L.M ? col : -1;
  return col - L.Mp < L.xc ? L.M + col - L.Mp : -1;
}

// Where a thread finds column col of a staged chunk's row k: K4/K5 the
// value at a + k s (a < 0: zero, padding); K6 the float64 product of the
// row's [W, y] columns a and b (b < 0: column a alone; a < 0: zero).
struct TsSrc {
  int a, b, s;
};
template <class Ops>
__device__ __forceinline__ TsSrc ts_src(const TsLay& L, int col, int c0) {
  TsSrc r{-1, -1, L.C1};
  const int q = ts_col_q(L, col);
  if (q < 0) return r;
  if (Ops::LRT) {
    if (q < L.M)
      ts_pair_of(q, L.C1, r.a, r.b);
    else
      r.a = q - L.M;
  } else if (!L.raw) {
    r.a = col - c0;
    r.s = L.bst;
  } else if (q < L.M) {
    r.a = q;
    r.s = L.M;
  } else {
    r.a = L.kc * L.M + q - L.M;
  }
  return r;
}
template <class Ops>
__device__ __forceinline__ double ts_bval(const TsSrc& c,
                                          const typename Ops::In* b, int k) {
  if (c.a < 0) return 0.0;
  if (!Ops::LRT) return (double)b[c.a + k * c.s];
  const typename Ops::In* z = b + k * c.s;
  return c.b < 0 ? (double)z[c.a] : (double)z[c.a] * (double)z[c.b];
}

__device__ __forceinline__ void ts_dmma(double& c0, double& c1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// one element from global to shared memory by cp.async, zero-filled
// where !valid
template <typename T>
__device__ __forceinline__ void ts_cp(T* dst, const T* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 8 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0));
}
// sixteen bytes (both addresses 16-aligned)
__device__ __forceinline__ void ts_cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void ts_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void ts_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// count elements from src to dst by the block (dst 16-aligned), those
// from valid on zero: 16 bytes a copy where src is 16-aligned
template <typename T>
__device__ __forceinline__ void ts_copy(T* dst, const T* src, int count,
                                        int valid) {
  constexpr int E = 16 / sizeof(T);
  const int tid = threadIdx.x;
  if ((reinterpret_cast<unsigned long>(src) & 15) == 0 && count % E == 0) {
    for (int v = tid; v < count / E; v += TS_THREADS) {
      if ((v + 1) * E <= valid) {
        ts_cp16(dst + v * E, src + v * E);
      } else {
        for (int e = v * E; e < (v + 1) * E; ++e)
          ts_cp(dst + e, src + (e < valid ? e : 0), e < valid);
      }
    }
  } else {
    for (int e = tid; e < count; e += TS_THREADS)
      ts_cp(dst + e, src + (e < valid ? e : 0), e < valid);
  }
}

// K4/K5's operands: lam, eval, [W, y], wy_prod and x of type T; weights
// rounded to T
template <typename T>
struct TsTest {
  using In = T;
  static constexpr bool LRT = false;
  __device__ static void weights(T l, T e, T x, double& a1, double& a2,
                                 double& lv) {
    const T h = T(1) / (l * e + T(1));
    a1 = (double)h;
    a2 = (double)(T)(h * x);
    lv = 0.0;
  }
};

// K6's: float32 operands, float64 weights and v = λ eval + 1, whose logs
// the forms sum (Σ log v)
struct TsLrt {
  using In = float;
  static constexpr bool LRT = true;
  __device__ static void weights(float l, float e, float x, double& a1,
                                 double& a2, double& v) {
    v = (double)l * (double)e + 1.0;
    a1 = 1.0 / v;
    a2 = a1 * (double)x;
  }
};

// One lane's operands (pointers already at its lane strides).
template <class Ops>
struct TsLane {
  typename Ops::In lam;
  const typename Ops::In* UtWy;  // (n, C1)
  const typename Ops::In* wy;    // (n, M), K4/K5 only
  const typename Ops::In* x;     // (n,)
  bool live;
};

// --- the register form: a warp a lane ----------------------------------
// out[q] (q < Q) the lane's sums, out[Q] K6's Σ log; every lane of the
// warp gets them.  C1 is a template argument so that the sums stay in
// registers.
template <class Ops, int C1>
__device__ __forceinline__ void ts_sums_reg(const TsLane<Ops>& ln,
                                            const typename Ops::In* eval,
                                            int n, const int xc,
                                            double (&out)[TS_REG_Q + 1]) {
  constexpr int M = C1 * (C1 + 1) / 2;
  constexpr int Q = M + C1 + 1;
  using In = typename Ops::In;
  const int lid = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q <= TS_REG_Q; ++q) out[q] = 0.0;
  if (!ln.live) n = 0;
  // RU individuals a round, i0 + 32 u, loaded before their sums, which
  // follow in i order: K4/K5 load all their operands four at a time, K6
  // (more arithmetic an individual) only x, eight at a time, and sums the
  // log of the round's product of v (v >= 1 up to rounding: eight of them
  // stay far inside float64's range)
  constexpr int RU = Ops::LRT ? TS_RU_X : TS_RU;
  constexpr int RW = Ops::LRT ? 1 : RU;  // individuals with staged rows
  for (int i0 = lid; i0 < n; i0 += 32 * RU) {
    In xs[RU], es[RW], zs[RW][C1], ws[RW][Ops::LRT ? 1 : M];
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      const int i = i0 + 32 * u < n ? i0 + 32 * u : i0;
      xs[u] = xc ? ln.x[i] : In(0);
      if constexpr (!Ops::LRT) {
        es[u] = eval[i];
#pragma unroll
        for (int j = 0; j < C1; ++j) zs[u][j] = ln.UtWy[(long)i * C1 + j];
#pragma unroll
        for (int q = 0; q < M; ++q) ws[u][q] = ln.wy[(long)i * M + q];
      }
    }
    double vp = 1.0;
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      const int i = i0 + 32 * u;
      if (i >= n) break;
      double a1, a2, v, z[C1];
      if constexpr (Ops::LRT) {
        Ops::weights(ln.lam, eval[i], xs[u], a1, a2, v);
#pragma unroll
        for (int j = 0; j < C1; ++j) z[j] = (double)ln.UtWy[(long)i * C1 + j];
        int q = 0;
#pragma unroll
        for (int a = 0; a < C1; ++a)
#pragma unroll
          for (int b = a; b < C1; ++b) out[q++] += a1 * (z[a] * z[b]);
        vp *= v;
      } else {
        Ops::weights(ln.lam, es[u], xs[u], a1, a2, v);
#pragma unroll
        for (int j = 0; j < C1; ++j) z[j] = (double)zs[u][j];
#pragma unroll
        for (int q = 0; q < M; ++q) out[q] += a1 * (double)ws[u][q];
      }
      if (xc) {
#pragma unroll
        for (int j = 0; j < C1; ++j) out[M + j] += a2 * z[j];
        out[M + C1] += a2 * (double)xs[u];
      }
    }
    if constexpr (Ops::LRT) out[Q] += log(fabs(vp));
  }
#pragma unroll
  for (int q = 0; q <= Q; ++q) out[q] = gt_warp_sum(out[q]);
}

// --- the staged chunks of the DMMA and lane forms -----------------------
// Rows i0 .. i0 + kc of the chunk (zero past i_end) into buffer b, one
// cp.async group: the whole rows (raw), or K4/K5's pass columns [c0, c0 +
// cn) at stride bst.
template <class Ops>
__device__ __forceinline__ void ts_fetch(const TsLay& L,
                                         const TsLane<Ops>& op, int i0,
                                         int i_end, int c0, int cn,
                                         typename Ops::In* b) {
  const int tid = threadIdx.x;
  const int rows = min(L.kc, i_end - i0);
  if (L.raw) {
    if (!Ops::LRT)
      ts_copy(b, op.wy + (long)i0 * L.M, L.kc * L.M, rows * L.M);
    ts_copy(b + (Ops::LRT ? 0 : L.kc * L.M), op.UtWy + (long)i0 * L.C1,
            L.kc * L.C1, rows * L.C1);
  } else {
    for (int k = 0; k < L.kc; ++k) {
      const long i = i0 + k;
      const bool v = k < rows;
      for (int cl = tid; cl < cn; cl += TS_THREADS) {
        const int col = c0 + cl;
        if (col < L.Mp) {
          if (col < L.M)
            ts_cp(b + k * L.bst + cl, op.wy + (v ? i * L.M + col : 0), v);
        } else if (col - L.Mp < L.xc) {
          ts_cp(b + k * L.bst + cl,
                op.UtWy + (v ? i * L.C1 + col - L.Mp : 0), v);
        }
      }
    }
  }
  ts_commit();
}

// --- the DMMA form: a block a tile of up to TS_L lanes ------------------
// lane_at(r) the tile's lane r (r < nl; every lane's [W, y] and wy_prod
// are the same); put(r, q, v) receives lane r's sum q (q = Q: K6's Σ log),
// after a barrier that ends every read of the staging.
template <class Ops, class LaneAt, class Put>
__device__ void ts_sums_mma(const TsLay& L, unsigned char* smem,
                            LaneAt lane_at, int nl,
                            const typename Ops::In* eval, int n, Put put) {
  using In = typename Ops::In;
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  const int g = lid >> 2, t = lid & 3;
  double* A = reinterpret_cast<double*>(smem + L.o_A);
  In* Bb = reinterpret_cast<In*>(smem + L.o_B);
  constexpr int AW = TS_KM * TS_ASTR;  // one weight array of a chunk
  const int kc = L.kc;
  // this thread's (lane, individual) of the weights: a warp a lane
  const int ws = warp, wj = lid;
  const TsLane<Ops> mine = lane_at(ws < nl ? ws : 0);
  const TsLane<Ops> op = lane_at(0);
  const bool wl = ws < nl && mine.live && wj < kc;
  const int nch = (n + kc - 1) / kc;
  double xxp = 0.0, ldp = 0.0;
  for (int pass = 0; pass < L.passes; ++pass) {
    const int c0 = pass * L.pcols;
    const int cn = min(L.pcols, L.Qp - c0), nct = cn / 8;
    TsSrc src[TS_TPW];
#pragma unroll
    for (int j = 0; j < TS_TPW; ++j)
      src[j] = ts_src<Ops>(L, c0 + (warp + TS_WARPS * j) * 8 + g, c0);
    double acc[TS_TPW][2];
#pragma unroll
    for (int j = 0; j < TS_TPW; ++j) acc[j][0] = acc[j][1] = 0.0;
    __syncthreads();
    // chunk ch's weights of this thread's (lane, individual): made before
    // the previous chunk's products, stored after them
    auto wcalc = [&](int ch, double& a1, double& a2) {
      double lv = 0.0;
      a1 = a2 = 0.0;
      const int i = ch * kc + wj;
      if (wl && i < n) {
        const In xi = L.xc ? mine.x[i] : In(0);
        Ops::weights(mine.lam, eval[i], xi, a1, a2, lv);
        if (pass == 0) {
          xxp += a2 * (double)xi;
          if constexpr (Ops::LRT) ldp += log(fabs(lv));
        }
      }
    };
    auto wstore = [&](int ch, double a1, double a2) {
      double* a = A + (ch & 1) * 2 * AW;
      a[wj * TS_ASTR + ws] = a1;
      a[AW + wj * TS_ASTR + ws] = a2;
    };
    ts_fetch<Ops>(L, op, 0, n, c0, cn, Bb);
    {
      double a1, a2;
      wcalc(0, a1, a2);
      wstore(0, a1, a2);
    }
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch)
        ts_fetch<Ops>(L, op, (ch + 1) * kc, n, c0, cn,
                      Bb + ((ch + 1) & 1) * L.bsz);
      else
        ts_commit();
      ts_wait1();
      __syncthreads();
      GT_PROF(TT_PH_WEIGHTS);
      double n1 = 0.0, n2 = 0.0;
      if (ch + 1 < nch) wcalc(ch + 1, n1, n2);
      const double* a = A + (ch & 1) * 2 * AW;
      const In* b = Bb + (ch & 1) * L.bsz;
#pragma unroll 2
      for (int k = 0; k < kc; k += 4) {
        const double af[2] = {a[(k + t) * TS_ASTR + g],
                              a[AW + (k + t) * TS_ASTR + g]};
#pragma unroll
        for (int j = 0; j < TS_TPW; ++j) {
          const int ct = warp + TS_WARPS * j;
          if (ct < nct) {
            const double bf = ts_bval<Ops>(src[j], b, k + t);
            const int w = c0 + ct * 8 < L.Mp ? 0 : 1;
            ts_dmma(acc[j][0], acc[j][1], af[w], bf);
          }
        }
      }
      if (ch + 1 < nch) wstore(ch + 1, n1, n2);
      __syncthreads();
      GT_PROF(TT_PH_SUMS);
    }
    // the m8n8 accumulators: row g, columns 2t and 2t + 1
#pragma unroll
    for (int j = 0; j < TS_TPW; ++j) {
      const int ct = warp + TS_WARPS * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = ct < nct ? ts_col_q(L, c0 + ct * 8 + 2 * t + h) : -1;
        if (g < nl && q >= 0) put(g, q, acc[j][h]);
      }
    }
  }
  // the row sums: the warp of a lane
  xxp = gt_warp_sum(xxp);
  ldp = gt_warp_sum(ldp);
  if (wj == 0 && ws < nl) {
    if (L.xc) put(ws, L.M + L.C1, xxp);
    if constexpr (Ops::LRT) put(ws, L.Q, ldp);
  }
}

// block sum of one value a thread, in a fixed order: the warps'
// butterflies, then the warps in order; every thread gets it
__device__ __forceinline__ double ts_block_sum(double v, double* red) {
  v = gt_warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < TS_WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

// --- the lane form: a block a lane, individuals [i_begin, i_end) --------
template <class Ops, class Put>
__device__ void ts_sums_lane(const TsLay& L, unsigned char* smem,
                             const TsLane<Ops>& ln,
                             const typename Ops::In* eval, int i_begin,
                             int i_end, double* red, Put put) {
  using In = typename Ops::In;
  const int tid = threadIdx.x, kc = L.kc;
  double* A = reinterpret_cast<double*>(smem + L.o_A);
  In* Bb = reinterpret_cast<In*>(smem + L.o_B);
  const int nch = (i_end - i_begin + kc - 1) / kc;
  double xxp = 0.0, ldp = 0.0;
  for (int pass = 0; pass < L.passes; ++pass) {
    const int c0 = pass * L.pcols;
    const int cn = min(L.pcols, L.Qp - c0);
    TsSrc src[TS_QPT];
    double acc[TS_QPT];
#pragma unroll
    for (int u = 0; u < TS_QPT; ++u) {
      src[u] = ts_src<Ops>(L, c0 + tid + TS_THREADS * u, c0);
      acc[u] = 0.0;
    }
    __syncthreads();
    // chunk ch's weights on the block's last kc threads (the fewest
    // columns): made before the previous chunk's sums, stored after them
    const int wk = tid - (TS_THREADS - kc);
    auto wcalc = [&](int ch, double& a1, double& a2) {
      double lv = 0.0;
      a1 = a2 = 0.0;
      const int i = i_begin + ch * kc + wk;
      if (wk >= 0 && ln.live && i < i_end) {
        const In xi = L.xc ? ln.x[i] : In(0);
        Ops::weights(ln.lam, eval[i], xi, a1, a2, lv);
        if (pass == 0) {
          xxp += a2 * (double)xi;
          if constexpr (Ops::LRT) ldp += log(fabs(lv));
        }
      }
    };
    auto wstore = [&](int ch, double a1, double a2) {
      if (wk >= 0) {
        A[(ch & 1) * 2 * TS_KL + wk] = a1;
        A[(ch & 1) * 2 * TS_KL + TS_KL + wk] = a2;
      }
    };
    ts_fetch<Ops>(L, ln, i_begin, i_end, c0, cn, Bb);
    {
      double a1, a2;
      wcalc(0, a1, a2);
      wstore(0, a1, a2);
    }
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch)
        ts_fetch<Ops>(L, ln, i_begin + (ch + 1) * kc, i_end, c0, cn,
                      Bb + ((ch + 1) & 1) * L.bsz);
      else
        ts_commit();
      ts_wait1();
      __syncthreads();
      GT_PROF(TT_PH_WEIGHTS);
      double n1 = 0.0, n2 = 0.0;
      if (ch + 1 < nch) wcalc(ch + 1, n1, n2);
      const double* a = A + (ch & 1) * 2 * TS_KL;
      const In* b = Bb + (ch & 1) * L.bsz;
#pragma unroll
      for (int u = 0; u < TS_QPT; ++u) {
        const int cl = tid + TS_THREADS * u;
        if (cl < cn) {
          const double* aw = c0 + cl < L.Mp ? a : a + TS_KL;
          double v = acc[u];
#pragma unroll 16
          for (int k = 0; k < kc; ++k)
            v += aw[k] * ts_bval<Ops>(src[u], b, k);
          acc[u] = v;
        }
      }
      if (ch + 1 < nch) wstore(ch + 1, n1, n2);
      __syncthreads();
      GT_PROF(TT_PH_SUMS);
    }
#pragma unroll
    for (int u = 0; u < TS_QPT; ++u) {
      const int cl = tid + TS_THREADS * u;
      if (cl < cn) put(0, ts_col_q(L, c0 + cl), acc[u]);
    }
  }
  // the row sums: the last kc threads' partials
  const double xx = ts_block_sum(xxp, red);
  const double ld = ts_block_sum(ldp, red);
  if (tid == 0) {
    if (L.xc) put(0, L.M + L.C1, xx);
    if constexpr (Ops::LRT) put(0, L.Q, ld);
  }
}

// the labels a | b << 16 of each flat position of c covariates' rows,
// by the block
__device__ inline void ts_labels(unsigned* lab, int c) {
  const int cols = c + 2;
  for (int a = 1 + threadIdx.x; a <= cols; a += blockDim.x) {
    const int b0 = ts_ab(a, a, cols);
    for (int b = a; b <= cols; ++b) lab[b0 + b - a] = a | b << 16;
  }
}

// --- K4/K5: the recurrence and the statistics on a warp ----------------
// The entries of the CalcPab rows that the Wald and score tests read:
// p_yy, p_xx, p_xy after the covariates are eliminated, px_yy after x.
template <typename T>
struct TestRows {
  T p_yy, p_xx, p_xy, px_yy;
};

// row: the lane's CalcPab row 0 (ni values of T, GEMMA's flat layout),
// updated in place: step p eliminates label p and touches only the pairs
// a, b > p (the flat range from (p+1, p+1)), each from the pivots (p, a),
// (p, b), (p, p), which no lane writes in that step; __syncwarp()
// separates the steps.  Each entry's expression is gt_pab_step's.
// The pivots of entry k = (a, b) at step p are row p's (p, a) and (p, b),
// at (p, p) + a - p and + b - p: from the labels a | b << 16 of each flat
// k in shared memory (lab, ts_labels), or where they do not fit (lab
// null, past ~88 covariates) from the tables' aw/bw.
template <typename T>
__device__ inline TestRows<T> ts_recur(T* row, const unsigned* lab,
                                       const PabTables& tb, int c, int ni,
                                       int xx_pos, int xy_pos) {
  const int lid = threadIdx.x & 31, cols = c + 2;
  for (int p = 1; p <= c; ++p) {
    const int bp = ts_ab(p, p, cols);
    const T ps_ww = row[bp];
    const bool nz = ps_ww != T(0);
    const T safe = nz ? ps_ww : T(1);
    for (int k = ts_ab(p + 1, p + 1, cols) + lid; k < ni; k += 32) {
      int ia, ib;
      if (lab != nullptr) {
        const unsigned ab = lab[k];
        ia = bp + (int)(ab & 0xffffu) - p;
        ib = bp + (int)(ab >> 16) - p;
      } else {
        ia = tb.aw[(long)(p - 1) * ni + k];
        ib = tb.bw[(long)(p - 1) * ni + k];
      }
      const T v = row[k];
      const T ps_aw = row[ia], ps_bw = row[ib];
      row[k] = nz ? v - ps_aw * ps_bw / safe : v;
    }
    __syncwarp();
  }
  TestRows<T> r;
  r.p_yy = row[ni - 1];
  r.p_xx = row[xx_pos];
  r.p_xy = row[xy_pos];
  // step c + 1 (x) on (y, y), the one entry the test reads after it
  const bool nz = r.p_xx != T(0);
  const T safe = nz ? r.p_xx : T(1);
  r.px_yy = nz ? r.p_yy - r.p_xy * r.p_xy / safe : r.p_yy;
  __syncwarp();
  return r;
}

// --- K6: the Gram's factor and solve on a warp --------------------------
// From the lane's sums q: the packed lower CZ × CZ Gram P of Z = [W, x]
// (W alone for the null) and its right-hand side in beta; then Cholesky
// (column by column: lane 0 the pivot, the rows below a lane each, each
// entry's sum in gt_cholesky_logdet's order), forward substitution (β_k
// broadcast, row i subtracting in k order) and back substitution.
// Returns false (and β NaN) where a pivot is not positive, as the
// reference's NaN factor.
__device__ inline bool ts_factor(const TsLay& L, const double* q, double* P,
                                 double* beta) {
  const int lid = threadIdx.x & 31, c = L.c, C1 = L.C1, CZ = L.CZ;
  auto tri = [](int i, int j) { return i * (i + 1) / 2 + j; };
  for (int i = lid; i < CZ; i += 32) {
    for (int j = 0; j <= i; ++j)
      P[tri(i, j)] = i < c ? q[ts_pair(j, i, C1)]
                           : (j < c ? q[L.M + j] : q[L.M + C1]);
    beta[i] = i < c ? q[ts_pair(i, c, C1)] : q[L.M + c];
  }
  __syncwarp();
  bool ok = true;
  for (int j = 0; j < CZ && ok; ++j) {
    double ljj = 0.0;
    if (lid == 0) {
      double s = P[tri(j, j)];
      for (int k = 0; k < j; ++k) s -= P[tri(j, k)] * P[tri(j, k)];
      ljj = s > 0.0 ? sqrt(s) : 0.0;
      if (s > 0.0) P[tri(j, j)] = ljj;
    }
    ljj = __shfl_sync(0xffffffffu, ljj, 0);
    ok = ljj > 0.0;
    __syncwarp();
    if (ok)
      for (int i = j + 1 + lid; i < CZ; i += 32) {
        double v = P[tri(i, j)];
        for (int k = 0; k < j; ++k) v -= P[tri(i, k)] * P[tri(j, k)];
        P[tri(i, j)] = v / ljj;
      }
    __syncwarp();
  }
  if (ok) {
    for (int k = 0; k < CZ; ++k) {
      if (lid == 0) beta[k] = beta[k] / P[tri(k, k)];
      __syncwarp();
      const double bk = beta[k];
      for (int i = k + 1 + lid; i < CZ; i += 32) beta[i] -= P[tri(i, k)] * bk;
      __syncwarp();
    }
    for (int k = CZ - 1; k >= 0; --k) {
      if (lid == 0) beta[k] = beta[k] / P[tri(k, k)];
      __syncwarp();
      const double bk = beta[k];
      for (int i = lid; i < k; i += 32) beta[i] -= P[tri(k, i)] * bk;
      __syncwarp();
    }
  } else {
    for (int i = lid; i < CZ; i += 32) beta[i] = NAN;
    __syncwarp();
  }
  return ok;
}

// K6's residual term of individual i: h (y - W β - x β_x)², in
// gt_logf_stable's order
template <typename Z>
__device__ __forceinline__ double ts_resid(const Z* z, double xi,
                                           const double* beta, int c,
                                           int calc_null, double h) {
  double wb = 0.0;
  for (int a = 0; a < c; ++a) wb += (double)z[a] * beta[a];
  double t = (double)z[c] - wb;
  if (!calc_null) t = t - xi * beta[c];
  return h * (t * t);
}

// ML logf from Σ log, Σ h r² and the constant (gt_logf_stable's end)
__device__ __forceinline__ double ts_logl(double logf_const, double ld,
                                          double p_yy, int n) {
  if (p_yy >= 0.0 && p_yy < 1e-8) p_yy = 1e-8;
  return logf_const - 0.5 * ld - 0.5 * (double)n * log(p_yy);
}
