// The evaluation core of the λ searches K3 (lambda_solve.cu) and K7
// (lambda_solve_f64.cu): L SNP lanes a thread block, stepped together.
//
// A search is a chain of likelihood evaluations, each a set of sums over
// the n individuals followed by small dependent work: the derivatives
// dev1/dev2 (LogRL_dev12 / LogL_dev12, lmm.cpp:820-1010), the Pab-form
// logf (LogRL_f / LogL_f, lmm.cpp:566-642) and the residual-form
// logf_stable (reference gemma_tpu/models/lmm/likelihood.py:269-341).
// Every one of them reads the flat base rows of GEMMA's Pab recurrence
// at orders p = 1..P, row_p[k] = Σ_i h_i^p z_a,i z_b,i over the pairs
// (a, b) of [W, x, y] (h_i = 1/(λ d_i + 1)), plus Σ h, Σ h² and Σ log v.
//
// The block's 256 threads form L teams of 256/L threads, one team a lane;
// each team runs its lane's search (the same scalar code on every thread
// of the team) and posts one evaluation at a time.  Where the lanes share
// their operands (L > 1) a team that has finished its lane takes the next
// from the launch's counter, so no block waits for its slowest lane; with
// per-lane operands (GxE, gene mode) a block is one lane (L = 1).  A
// round (ls_round) serves the requests of every lane at once:
//   1. the sums, over the lanes that asked for something only, in one of
//      two forms chosen by the covariate count:
//      - c <= 1 (the main path's 20 sums): each team's threads split its
//        lane's rows and keep every sum in registers, one division a row,
//        then add their threads' sums in order; no block barrier;
//      - else: the rows in tiles of TR, UtWy resident in shared memory
//        where it fits, else staged a tile ahead with cp.async; the slot
//        threads turn each lane's eval and x (loaded a tile ahead into
//        registers) into h^p and h^p·x once; then each thread owns an
//        item of two flat positions (pair columns) and adds, for every
//        lane and order, the products of its rows of the tile: for lanes
//        that share their operands the (L·P × n)·(n × ni) product on FMAs,
//        the weights read as vectors, each staged UtWy row serving L
//        lanes.  A pair column z_a z_b is formed from the UtWy row
//        (rounded to the operand type, as wy_prod holds it), so wy_prod
//        is not read.  Under 256 items the threads split a tile's rows
//        too (slices, added in order at the end); above, the items take
//        ceil(items/256) passes over n.  Two block barriers a tile.
//      Either way no sum runs over more than 16 or 64 of a thread's rows
//      before it is added to its running sum.
//   2. each team finishes its lane's evaluation on its own: the Pab
//      recurrences, or the Gram's Cholesky and two triangular solves,
//      parallel over the team's threads with team barriers only;
//   3. logf_stable's Σ h r² with the GLS residual: one more pass over n,
//      every lane that asked for it at once.
// A lane's sums and the order in which they are added depend on the form
// and its geometry alone, never on which lanes share its block or on what
// they asked.
//
// The teams' working sets (recurrence rows, Gram, solve) sit in shared
// memory, or, above GT_WIDE_CVT covariates (the GT_DYN form), in a team's
// slice of global scratch.
#pragma once

#include <type_traits>

#include "common.cuh"

#define LS_THREADS GT_THREADS
#define LS_LMAX 8
#define LS_PMAX 3
#define LS_TR 64  // tile rows, halved while the block's bytes pass the limit
#define LS_SMEM_MAX 232448  // an H100 block's opt-in shared memory
// a block with UtWy resident stays within this, so that two blocks share
// an SM
#define LS_RESIDENT_MAX 102400
// per-lane scalar sums: Σ h, Σ h², Σ log v, Σ h^p x² (p = 1..3)
#define LS_NSC 6
// the row-split sums: flat positions at most, a thread's sums
#define LS_ROWS_NI 6
#define LS_ROWS_NS (LS_PMAX * LS_ROWS_NI + LS_NSC)
#define LS_ROWS_BLOCK 16  // a thread's rows summed before its running sum
#define LS_FOLD_ROWS 64   // the same for a column's slice

// request kinds
#define LS_NONE 0
#define LS_DEV1 1    // dev1 (orders 1-2)
#define LS_DEV12 2   // dev1 and dev2 (orders 1-3)
#define LS_LOGF 3    // Pab-form logf (order 1, Σ log v): K7
#define LS_STABLE 4  // logf_stable (order 1, Σ log v, Gram, residual): K3
#define LS_GRAM0 5   // log det of the identity-weighted Gram (λ = 0): K3

template <typename T>
__device__ __forceinline__ T gt_clip(T v, T lo, T hi) {
  return isnan(v) ? v : (v < lo ? lo : (v > hi ? hi : v));
}

__host__ __device__ inline int ls_order(int kind) {
  return kind == LS_NONE ? 0 : kind == LS_DEV1 ? 2 : kind == LS_DEV12 ? 3 : 1;
}

// The block's shared-memory layout and the lane working set's, the same
// arithmetic on the host (the launch's bytes) and in the kernel.  `tin`
// and `t` are the operand and working types' sizes; `gram`: K3's Gram and
// solve arrays; `ws_smem`: the working sets in shared memory (else in
// scratch, ws_bytes a lane); `resident`: the block's UtWy rows all in
// shared memory for the kernel's life (else staged a tile at a time).
// The sums' columns are items of two flat positions of one kind (pairs
// of UtWy columns, or x with a UtWy column), items × slices threads.
struct LsLayout {
  int L, TR, C1, ni, M, items, slices, passes, resident, rows;
  long o_kind, o_lane, o_lam, o_aux, o_res, o_lsc, o_wred, o_u, o_h, o_hx, o_sc,
      o_sl, o_ws, ws_bytes, bytes;
};

__host__ __device__ inline long ls_take(long& o, long b) {
  const long r = o;
  o += gt_r16(b);
  return r;
}

__host__ __device__ inline LsLayout ls_layout(int n_cvt, int n, int L, int TR,
                                              int tin, int t, int gram,
                                              int ws_smem, int resident) {
  LsLayout y;
  y.L = L;
  y.TR = TR;
  y.resident = resident;
  y.C1 = n_cvt + 1;
  y.ni = gt_n_index(n_cvt);
  y.M = y.C1 * (y.C1 + 1) / 2;
  y.items = (y.M + 1) / 2 + (y.C1 + 1) / 2;
  // at most LS_ROWS_NI flat positions (c <= 1): each team's threads split
  // its lane's rows and keep every sum in registers
  y.rows = y.ni <= LS_ROWS_NI;
  if (y.items <= LS_THREADS) {
    // a power of two, each slice whole vectors of rows
    const int cap = LS_THREADS / y.items < TR / (16 / t)
                        ? LS_THREADS / y.items
                        : TR / (16 / t);
    y.slices = 1;
    while (2 * y.slices <= cap) y.slices *= 2;
    y.passes = 1;
  } else {
    y.slices = 1;
    y.passes = (y.items + LS_THREADS - 1) / LS_THREADS;
  }
  long o = 0;
  y.o_kind = ls_take(o, 4L * LS_LMAX);
  y.o_lane = ls_take(o, 4L * LS_LMAX);
  y.o_lam = ls_take(o, (long)t * LS_LMAX);
  y.o_aux = ls_take(o, (long)t * LS_LMAX);
  y.o_res = ls_take(o, 2L * t * LS_LMAX);
  y.o_lsc = ls_take(o, (long)LS_NSC * t * LS_LMAX);
  y.o_wred = ls_take(o, (long)t * LS_LMAX * (LS_THREADS / 32));
  y.o_u = ls_take(o, resident ? (long)n * y.C1 * tin
                              : y.rows ? 0 : 2L * TR * y.C1 * tin);
  if (y.rows) {
    // the threads' partial sums, reduced in thread order
    y.o_h = y.o_sc = y.o_hx = y.o_sl =
        ls_take(o, (long)LS_THREADS * LS_ROWS_NS * t);
  } else {
    // the lane scalars' tile slots are reduced where the weights were
    y.o_h = y.o_sc = ls_take(o, (long)L * LS_PMAX * TR * t);
    y.o_hx = ls_take(o, (long)L * LS_PMAX * TR * t);
    y.o_sl = ls_take(
        o, y.slices > 1 ? (long)y.slices * y.ni * L * LS_PMAX * t : 0);
  }
  y.ws_bytes = gt_r16(6L * y.ni * t) +
               (gram ? gt_r16((long)y.C1 * y.C1 * t) +
                           3 * gt_r16((long)y.C1 * t)
                     : 0);
  y.o_ws = ls_take(o, ws_smem ? L * y.ws_bytes : 0);
  y.bytes = o;
  return y;
}

// The launch's layout: UtWy resident where the block stays within
// LS_RESIDENT_MAX, else the largest tile (LS_TR, halved down to 8 rows)
// whose block fits the card's shared memory.
__host__ inline LsLayout ls_fit(int n_cvt, int n, int L, int tin, int t,
                                int gram, int ws_smem) {
  LsLayout y = ls_layout(n_cvt, n, L, LS_TR, tin, t, gram, ws_smem, 1);
  if (y.bytes <= LS_RESIDENT_MAX) return y;
  int TR = LS_TR;
  y = ls_layout(n_cvt, n, L, TR, tin, t, gram, ws_smem, 0);
  while (y.bytes > LS_SMEM_MAX && TR > 8) {
    TR /= 2;
    y = ls_layout(n_cvt, n, L, TR, tin, t, gram, ws_smem, 0);
  }
  return y;
}

// block barrier (not .aligned: the teams arrive from different places in
// their searches), team barrier, cp.async of one value
__device__ __forceinline__ void ls_bar() {
  asm volatile("barrier.sync 0;" ::: "memory");
}

template <int L>
__device__ __forceinline__ void ls_team_sync(int l) {
  if constexpr (L == LS_THREADS / 32)
    __syncwarp();
  else if constexpr (L == 1)
    ls_bar();
  else
    asm volatile("barrier.sync %0, %1;" ::"r"(1 + l), "n"(LS_THREADS / L)
                 : "memory");
}

template <typename U>
__device__ __forceinline__ void ls_cp(U* dst, const U* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src),
               "n"(sizeof(U))
               : "memory");
}
__device__ __forceinline__ void ls_cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void ls_cp_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// What a block's lanes have in common: the operands (lane s's UtWy and
// Utx at its stride, 0 = shared), the shape, its nl teams and where their
// working sets lie.  Where the lanes share their operands (L > 1) each
// team takes its lanes from the launch's counter, one after another;
// else the block's one team has lane `first`.
template <typename Tin, typename T>
struct LsCtx {
  const Tin* eval;
  const Tin* UtWy;
  const Tin* Utx;
  long ustride, xstride;
  PabTables t;
  int n_cvt, n, calc_null, reml;
  T logf_const;
  const double* iab;  // K7: the lanes' iab_logdiag (S, n_cvt + 1)
  int first, nl, dyn;
  long lane0;  // the block's first team within the launch (scratch slice)
  LsLayout y;
  unsigned char* sm;
  unsigned char* scratch;

  __device__ unsigned char* ws(int l) const {
    return scratch == nullptr ? sm + y.o_ws + (long)l * y.ws_bytes
                              : scratch + (lane0 + l) * y.ws_bytes;
  }
  // row `p` (order p + 1) of recurrence buffer `b` of lane l
  __device__ T* rows(int l, int b, int p) const {
    return reinterpret_cast<T*>(ws(l)) + (long)(b * 3 + p) * y.ni;
  }
  __device__ T* gram(int l) const {
    return reinterpret_cast<T*>(ws(l) + gt_r16(6L * y.ni * sizeof(T)));
  }
  // the diagonal of the factor, the solve's right-hand side, beta
  __device__ T* gvec(int l, int v) const {
    return reinterpret_cast<T*>(ws(l) +
                                gt_r16(6L * y.ni * sizeof(T)) +
                                gt_r16((long)y.C1 * y.C1 * sizeof(T)) +
                                v * gt_r16((long)y.C1 * sizeof(T)));
  }
  template <typename U>
  __device__ U* at(long off) const {
    return reinterpret_cast<U*>(sm + off);
  }
  // team l's current lane (ls_next keeps a lane of the launch there, its
  // complement once the team has none, so the rounds read valid rows)
  __device__ int lane(int l) const {
    if (!dyn) return first + l;
    const int v = reinterpret_cast<const int*>(sm + y.o_lane)[l];
    return v >= 0 ? v : ~v;
  }
  // UtWy depends on the lane only where L = 1
  __device__ const Tin* U(int l) const {
    return UtWy + (long)(first + l) * ustride;
  }
  __device__ const Tin* X(int l) const {
    return Utx + (long)lane(l) * xstride;
  }
};

// GetabIndex: the flat position of GEMMA labels a <= b (1..c covariates,
// c+1 x, c+2 y).
__host__ __device__ constexpr int ls_ab(int a, int b, int n_cvt) {
  return (2 * (n_cvt + 2) - a + 2) * (a - 1) / 2 + (b - a);
}

// A column of the sums: its flat position k and its UtWy columns (ca, cb)
// for a pair, (ca) for x with a UtWy column.
struct LsCol {
  int k, ca, cb;
};

// Item `it`'s columns: pairs 2j, 2j + 1 of UtWy columns (lexicographic
// over the labels without x) for it < (M + 1) / 2, else x with UtWy
// columns 2j, 2j + 1; *xcol says which, the return how many (1 or 2).
__device__ inline int ls_item(int it, int n_cvt, int M, LsCol* col,
                              bool* xcol) {
  const int np = (M + 1) / 2;
  const int C1 = n_cvt + 1;
  auto lab = [&](int u) { return u == n_cvt ? n_cvt + 2 : u + 1; };
  int cnt = 0;
  if (it < np) {
    *xcol = false;
    int m = 0;
    for (int ua = 0; ua < C1 && cnt < 2; ++ua)
      for (int ub = ua; ub < C1 && cnt < 2; ++ub, ++m)
        if (m == 2 * it || m == 2 * it + 1) {
          col[cnt].k = ls_ab(lab(ua), lab(ub), n_cvt);
          col[cnt].ca = ua;
          col[cnt].cb = ub;
          ++cnt;
        }
  } else {
    *xcol = true;
    for (int j = 2 * (it - np); j < C1 && cnt < 2; ++j, ++cnt) {
      const int lj = lab(j), xl = n_cvt + 1;
      col[cnt].k = lj < xl ? ls_ab(lj, xl, n_cvt) : ls_ab(xl, lj, n_cvt);
      col[cnt].ca = col[cnt].cb = j;
    }
  }
  return cnt;
}

template <typename T>
struct LsVec;
template <>
struct LsVec<float> {
  typedef float4 type;
  static constexpr int W = 4;
};
template <>
struct LsVec<double> {
  typedef double2 type;
  static constexpr int W = 2;
};

template <typename T>
__device__ __forceinline__ void ls_unpack(const typename LsVec<T>::type& v,
                                          T* out) {
  if constexpr (LsVec<T>::W == 4) {
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    out[0] = v.x;
    out[1] = v.y;
  }
}

// A column's value at a staged UtWy row: the pair product in the operand
// type (as wy_prod holds it; `exact`: in the working type, as
// logf_stable's Gram takes it), or the UtWy value for x's columns.
template <typename Tin, typename T>
__device__ __forceinline__ T ls_b(const Tin* ur, const LsCol& c, bool xcol,
                                  bool exact) {
  if (xcol) return (T)ur[c.ca];
  return exact ? (T)ur[c.ca] * (T)ur[c.cb] : (T)(Tin)(ur[c.ca] * ur[c.cb]);
}

// The thread's rows [r0, r1) of a tile for its item's NC (1 or 2)
// columns, every lane and order p < P: acc[w][l][p] += A[l][p][r] · b_w(r)
// in row order, the weights A read as vectors of rows.
template <typename Tin, typename T, int L, int P, int NC>
__device__ __forceinline__ void ls_cols(const T* A, const Tin* u, int C1,
                                        int TR, int r0, int r1,
                                        const LsCol* col, bool xcol,
                                        bool exact, int na,
                                        T (&acc)[2][L][LS_PMAX]) {
  typedef typename LsVec<T>::type V;
  constexpr int VW = LsVec<T>::W;
  int r = r0;
  for (; r + VW <= r1; r += VW) {
    T b[NC][VW];
#pragma unroll
    for (int v = 0; v < VW; ++v)
#pragma unroll
      for (int w = 0; w < NC; ++w)
        b[w][v] = ls_b<Tin, T>(u + (long)(r + v) * C1, col[w], xcol, exact);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (l >= na) break;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        T h[VW];
        ls_unpack<T>(*reinterpret_cast<const V*>(A + (l * LS_PMAX + p) * TR + r),
                     h);
#pragma unroll
        for (int v = 0; v < VW; ++v)
#pragma unroll
          for (int w = 0; w < NC; ++w)
            acc[w][l][p] = fma(h[v], b[w][v], acc[w][l][p]);
      }
    }
  }
  for (; r < r1; ++r) {
    T b[NC];
#pragma unroll
    for (int w = 0; w < NC; ++w)
      b[w] = ls_b<Tin, T>(u + (long)r * C1, col[w], xcol, exact);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (l >= na) break;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int w = 0; w < NC; ++w)
          acc[w][l][p] =
              fma(A[(l * LS_PMAX + p) * TR + r], b[w], acc[w][l][p]);
    }
  }
}

// Stage the UtWy rows [i0, i0 + rows) of the block (its first lane's:
// shared operands, or the one lane of a per-lane block) into `dst`.
template <typename Tin, typename T>
__device__ inline void ls_stage(const LsCtx<Tin, T>& c, int i0, int rows,
                                Tin* dst) {
  const Tin* src = c.U(0) + (long)i0 * c.y.C1;
  for (long e = threadIdx.x; e < (long)rows * c.y.C1; e += LS_THREADS)
    ls_cp(dst + e, src + e);
  ls_cp_commit();
}

// The block's UtWy rows into shared memory for the kernel's life, where
// the layout holds them (every thread calls it before the first round).
template <typename Tin, typename T>
__device__ inline void ls_begin(const LsCtx<Tin, T>& c) {
  if (c.y.resident) ls_stage(c, 0, c.n, c.template at<Tin>(c.y.o_u));
  ls_cp_wait();
  ls_bar();
}

// The sums of one round: the base rows at orders 1..P of every lane into
// its recurrence buffer 0, and Σ h, Σ h², Σ log v (where logv), Σ h^p x²
// into lsc.  Each tile: the slot threads (lane l, row r) turn eval and
// x, loaded a tile ahead into registers, into h^p and h^p·x (one
// division); then the item threads add their columns over their rows.
template <typename Tin, typename T, int L, int P>
__device__ void ls_sums(const LsCtx<Tin, T>& c, bool logv, bool exact) {
  const LsLayout& y = c.y;
  const int tid = threadIdx.x, TR = y.TR;
  const T* lam = c.template at<T>(y.o_lam);
  T* H = c.template at<T>(y.o_h);
  T* HX = c.template at<T>(y.o_hx);
  T* sc = c.template at<T>(y.o_sc);
  Tin* ub = c.template at<Tin>(y.o_u);
  const int ntiles = (c.n + TR - 1) / TR;
  constexpr int SPT = (LS_LMAX * LS_TR + LS_THREADS - 1) / LS_THREADS;
  // each tile slot's lane scalars, added over the tiles in registers
  T scal[SPT][LS_NSC];
#pragma unroll
  for (int j = 0; j < SPT; ++j)
#pragma unroll
    for (int q = 0; q < LS_NSC; ++q) scal[j][q] = T(0);
  const int rs = TR / y.slices;
  const int fold = max(1, LS_FOLD_ROWS / rs);
  // the lanes that asked for something, in lane order: slot j of the
  // weights and the accumulators is the j-th of them (`mask`'s bits)
  const int* kind = c.template at<int>(y.o_kind);
  unsigned mask = 0;
#pragma unroll
  for (int l = 0; l < L; ++l)
    if (l < c.nl && kind[l] != LS_NONE) mask |= 1u << l;
  const int na = __popc(mask);
  for (int g = 0; g < y.passes; ++g) {
    const int it = y.slices > 1 ? tid % y.items : g * LS_THREADS + tid;
    const int sl = y.slices > 1 ? tid / y.items : 0;
    const bool act = y.slices > 1 ? sl < y.slices : it < y.items;
    LsCol col[2] = {{0, 0, 0}, {0, 0, 0}};
    bool xcol = false;
    const int nc = act ? ls_item(it, c.n_cvt, y.M, col, &xcol) : 0;
    // where each column's running sums go: lane l, order p at
    // to[w] + l·lst + p·pst (the lanes' rows, or the slice's partials)
    T* to[2];
    long lst, pst;
    if (y.slices > 1) {
      T* base = c.template at<T>(y.o_sl) + (long)sl * y.ni * L * LS_PMAX;
      to[0] = base + (long)col[0].k * L * LS_PMAX;
      to[1] = base + (long)col[1].k * L * LS_PMAX;
      lst = LS_PMAX;
      pst = 1;
    } else {
      to[0] = c.rows(0, 0, 0) + col[0].k;
      to[1] = c.rows(0, 0, 0) + col[1].k;
      lst = y.ws_bytes / (long)sizeof(T);
      pst = y.ni;
    }
    T acc[2][L][LS_PMAX];
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int l = 0; l < L; ++l)
#pragma unroll
        for (int p = 0; p < LS_PMAX; ++p) acc[w][l][p] = T(0);
    Tin pe[SPT], px[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int e = tid + j * LS_THREADS, l = e / TR, r = e - l * TR;
      if (e < L * TR && l < c.nl && r < c.n) {
        pe[j] = c.eval[r];
        px[j] = c.X(l)[r];
      }
    }
    if (!y.resident) ls_stage(c, 0, min(TR, c.n), ub);
    for (int tile = 0; tile < ntiles; ++tile) {
      const int i0 = tile * TR, rv = min(TR, c.n - i0);
      ls_cp_wait();
      ls_bar();  // the stage visible; the last tile's columns done
      if (!y.resident && tile + 1 < ntiles)
        ls_stage(c, i0 + TR, min(TR, c.n - i0 - TR),
                 ub + (long)((tile + 1) & 1) * TR * y.C1);
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int e = tid + j * LS_THREADS, l = e / TR, r = e - l * TR;
        if (e >= L * TR || !(mask >> l & 1u) || r >= rv) continue;
        const T ev = (T)pe[j], x = (T)px[j];
        if (tile + 1 < ntiles && i0 + TR + r < c.n) {
          pe[j] = c.eval[i0 + TR + r];
          px[j] = c.X(l)[i0 + TR + r];
        }
        const T v = lam[l] * ev + T(1);
        const T h = T(1) / v;
        const T hx = h * x;
        const int slot = __popc(mask & ((1u << l) - 1u));
        T* hp = H + slot * LS_PMAX * TR + r;
        T* hxp = HX + slot * LS_PMAX * TR + r;
        hp[0] = h;
        hxp[0] = hx;
        if (P >= 2) {
          hp[TR] = h * h;
          hxp[TR] = hx * h;
        }
        if (P >= 3) {
          hp[2 * TR] = h * h * h;
          hxp[2 * TR] = hx * h * h;
        }
        if (g == 0) {
          T* se = scal[j];
          se[0] += h;
          se[1] += h * h;
          if (logv) se[2] += gt_log(gt_abs(v));
          se[3] += hx * x;
          if (P >= 2) se[4] += (hx * h) * x;
          if (P >= 3) se[5] += (hx * h * h) * x;
        }
      }
      ls_bar();  // the tile's weights visible
      if (nc > 0) {
        const Tin* u = y.resident ? ub + (long)i0 * y.C1
                                  : ub + (long)(tile & 1) * TR * y.C1;
        const int r0 = sl * rs, r1 = min(r0 + rs, rv);
        const T* A = xcol ? HX : H;
        if (nc == 2)
          ls_cols<Tin, T, L, P, 2>(A, u, y.C1, TR, r0, r1, col, xcol, exact,
                                   na, acc);
        else
          ls_cols<Tin, T, L, P, 1>(A, u, y.C1, TR, r0, r1, col, xcol, exact,
                                   na, acc);
      }
      // every `fold` tiles (LS_FOLD_ROWS of the thread's rows) the partial
      // into the column's running sum (the lane's row, or its slice's),
      // so that no sum runs over more rows than that in registers
      if (nc > 0 && ((tile + 1) % fold == 0 || tile + 1 == ntiles)) {
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          if (w >= nc) continue;
          unsigned m = mask;
#pragma unroll
          for (int j = 0; j < L; ++j) {
            const int l = __ffs(m) - 1;  // slot j's lane
            m &= m - 1u;
#pragma unroll
            for (int p = 0; p < P; ++p) {
              if (j < na) {
                T* t = to[w] + l * lst + p * pst;
                *t = tile < fold ? acc[w][j][p] : *t + acc[w][j][p];
              }
              acc[w][j][p] = T(0);
            }
          }
        }
      }
    }
    ls_bar();  // stage buffers and slices free for the next pass
  }
  // the tile slots' scalars in order: slot (l, r) at sc[(q·L + l)·TR + r]
  // (the weights' region, free after the last pass's barrier)
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int e = tid + j * LS_THREADS;
    if (e >= L * TR) continue;
#pragma unroll
    for (int q = 0; q < LS_NSC; ++q) sc[(long)q * L * TR + e] = scal[j][q];
  }
  ls_bar();
  const int kxx = ls_ab(c.n_cvt + 1, c.n_cvt + 1, c.n_cvt);
  if (y.slices > 1) {
    const T* sp = c.template at<T>(y.o_sl);
    for (int e = tid; e < y.ni * L * P; e += LS_THREADS) {
      const int k = e / (L * P), l = (e / P) % L, p = e % P;
      if (l >= c.nl || k == kxx) continue;
      T v = T(0);
      for (int s2 = 0; s2 < y.slices; ++s2)
        v += sp[((long)s2 * y.ni + k) * L * LS_PMAX + l * LS_PMAX + p];
      c.rows(l, 0, p)[k] = v;
    }
  }
  T* lsc = c.template at<T>(y.o_lsc);
  for (int e = tid; e < LS_NSC * L; e += LS_THREADS) {
    const int q = e / L, l = e - q * L;
    T v = T(0);
    for (int r = 0; r < TR; ++r) v += sc[(q * L + l) * TR + r];
    lsc[l * LS_NSC + q] = v;
    if (q >= 3 && q - 3 < P && l < c.nl) c.rows(l, 0, q - 3)[kxx] = v;
  }
  ls_bar();
}

// The sums of one round where the lanes have at most LS_ROWS_NI flat
// positions: team l's threads take lane l's rows i ≡ tt (mod team size),
// each keeps every base-row entry and lane scalar in registers (one
// division a row), and the team adds the threads' sums in thread order.
// UtWy comes from the resident rows, else from device memory.
template <typename Tin, typename T, int L, int P, int NCV>
__device__ void ls_sums_rows(const LsCtx<Tin, T>& c, bool logv, bool exact) {
  const LsLayout& y = c.y;
  constexpr int TS = LS_THREADS / L;
  constexpr int ni = gt_n_index(NCV), C1 = NCV + 1;
  constexpr int kxx = ls_ab(NCV + 1, NCV + 1, NCV);
  const int l = threadIdx.x / TS, tt = threadIdx.x % TS;
  // each flat position's column: 0 a pair (ca, cb), 1 x with ca, 2 x·x
  int kt[LS_ROWS_NI], ka[LS_ROWS_NI], kb[LS_ROWS_NI];
  {
    int k = 0;
    constexpr int xl = NCV + 1;
#pragma unroll
    for (int a = 1; a <= NCV + 2; ++a)
#pragma unroll
      for (int b = a; b <= NCV + 2; ++b, ++k) {
        const int ua = a == NCV + 2 ? NCV : a - 1;
        const int ub = b == NCV + 2 ? NCV : b - 1;
        kt[k] = a == xl && b == xl ? 2 : (a == xl || b == xl ? 1 : 0);
        ka[k] = a == xl ? ub : ua;
        kb[k] = ub;
      }
  }
  T acc[LS_PMAX][LS_ROWS_NI], sc[LS_NSC];
#pragma unroll
  for (int p = 0; p < LS_PMAX; ++p)
#pragma unroll
    for (int k = 0; k < LS_ROWS_NI; ++k) acc[p][k] = T(0);
#pragma unroll
  for (int q = 0; q < LS_NSC; ++q) sc[q] = T(0);
  if (l < c.nl && c.template at<int>(y.o_kind)[l] != LS_NONE) {
    const T lam = c.template at<T>(y.o_lam)[l];
    const Tin* U = y.resident ? c.template at<Tin>(y.o_u) : c.U(l);
    const Tin* X = c.X(l);
    const Tin* ev = c.eval;
    // blocks of LS_ROWS_BLOCK rows into the running sums, so that no sum
    // runs over more than a block's rows in registers
    T tot[LS_PMAX][LS_ROWS_NI], stot[LS_NSC];
#pragma unroll
    for (int p = 0; p < LS_PMAX; ++p)
#pragma unroll
      for (int k = 0; k < LS_ROWS_NI; ++k) tot[p][k] = T(0);
#pragma unroll
    for (int q = 0; q < LS_NSC; ++q) stot[q] = T(0);
    for (int i0 = tt; i0 < c.n; i0 += LS_ROWS_BLOCK * TS) {
#pragma unroll 4
    for (int i = i0; i < min(c.n, i0 + LS_ROWS_BLOCK * TS); i += TS) {
      const T x = (T)__ldg(X + i);
      const T v = lam * (T)__ldg(ev + i) + T(1);
      const T h = T(1) / v;
      const T hx = h * x;
      const T hp[LS_PMAX] = {h, h * h, h * h * h};
      const T hxp[LS_PMAX] = {hx, hx * h, hx * h * h};
      const Tin* ur = U + (long)i * C1;
#pragma unroll
      for (int k = 0; k < LS_ROWS_NI; ++k) {
        if (k >= ni || kt[k] == 2) continue;
        const T b = kt[k] == 1 ? (T)ur[ka[k]]
                    : exact    ? (T)ur[ka[k]] * (T)ur[kb[k]]
                               : (T)(Tin)(ur[ka[k]] * ur[kb[k]]);
#pragma unroll
        for (int p = 0; p < P; ++p)
          acc[p][k] = fma(kt[k] == 1 ? hxp[p] : hp[p], b, acc[p][k]);
      }
      sc[0] += h;
      sc[1] += h * h;
      if (logv) sc[2] += gt_log(gt_abs(v));
      sc[3] += hx * x;
      if (P >= 2) sc[4] += (hx * h) * x;
      if (P >= 3) sc[5] += (hx * h * h) * x;
    }
#pragma unroll
    for (int p = 0; p < LS_PMAX; ++p)
#pragma unroll
      for (int k = 0; k < LS_ROWS_NI; ++k) {
        tot[p][k] += acc[p][k];
        acc[p][k] = T(0);
      }
#pragma unroll
    for (int q = 0; q < LS_NSC; ++q) {
      stot[q] += sc[q];
      sc[q] = T(0);
    }
    }
#pragma unroll
    for (int p = 0; p < LS_PMAX; ++p)
#pragma unroll
      for (int k = 0; k < LS_ROWS_NI; ++k) acc[p][k] = tot[p][k];
#pragma unroll
    for (int q = 0; q < LS_NSC; ++q) sc[q] = stot[q];
  }
  T* part = c.template at<T>(y.o_sl) + (long)threadIdx.x * LS_ROWS_NS;
#pragma unroll
  for (int p = 0; p < LS_PMAX; ++p)
#pragma unroll
    for (int k = 0; k < LS_ROWS_NI; ++k) part[p * LS_ROWS_NI + k] = acc[p][k];
#pragma unroll
  for (int q = 0; q < LS_NSC; ++q) part[LS_PMAX * LS_ROWS_NI + q] = sc[q];
  ls_bar();
  if (l < c.nl) {
    const T* p0 = c.template at<T>(y.o_sl) + (long)l * TS * LS_ROWS_NS;
    T* lsc = c.template at<T>(y.o_lsc) + l * LS_NSC;
    for (int e = tt; e < LS_ROWS_NS; e += TS) {
      T v = T(0);
      for (int j = 0; j < TS; ++j) v += p0[(long)j * LS_ROWS_NS + e];
      if (e < LS_PMAX * LS_ROWS_NI) {
        const int p = e / LS_ROWS_NI, k = e - p * LS_ROWS_NI;
        if (p < P && k < ni && k != kxx) c.rows(l, 0, p)[k] = v;
      } else {
        const int q = e - LS_PMAX * LS_ROWS_NI;
        lsc[q] = v;
        if (q >= 3 && q - 3 < P) c.rows(l, 0, q - 3)[kxx] = v;
      }
    }
  }
  ls_bar();
}

// The recurrences of lane l over its base rows at orders 1..P; returns
// the buffer that holds the last step.  With `iab` (the Pab logf) it
// also forms Σ log P_p(w,w) − iab (logdet_hiw); with P = 2 or 3 the
// traces of dev1/dev2.
template <typename Tin, typename T, int L>
__device__ int ls_recur(const LsCtx<Tin, T>& c, int l, int P, T* trace_p,
                        T* trace_pp, T* logdet_hiw, const double* iab) {
  const int TS = LS_THREADS / L, tt = threadIdx.x % TS;
  const int ni = c.y.ni;
  const int nc_total = c.calc_null ? c.n_cvt : c.n_cvt + 1;
  int cur = 0;
  for (int p = 1; p <= nc_total; ++p) {
    const T* pab = c.rows(l, cur, 0);
    const T* ppab = c.rows(l, cur, 1);
    const T* pppab = c.rows(l, cur, 2);
    const int d = c.t.diag[p - 1];
    if (P >= 2) {
      const T ps_ww = pab[d], ps2_ww = ppab[d];
      *trace_p = *trace_p - ps2_ww / ps_ww;
      if (P == 3)
        *trace_pp = *trace_pp + ps2_ww * ps2_ww / (ps_ww * ps_ww) -
                    T(2) * pppab[d] / ps_ww;
    }
    if (iab != nullptr)
      *logdet_hiw = *logdet_hiw + gt_log(pab[d]) - (T)iab[p - 1];
    const int nxt = 1 - cur;
    gt_pab_step<T>(c.t, ni, p, P, pab, ppab, pppab, c.rows(l, nxt, 0),
                   c.rows(l, nxt, 1), c.rows(l, nxt, 2), tt, TS);
    ls_team_sync<L>(l);
    cur = nxt;
  }
  return cur;
}

// dev1 and (P = 3) dev2 of lane l from its base rows.
template <typename Tin, typename T, int L>
__device__ void ls_dev_finish(const LsCtx<Tin, T>& c, int l, int P, T lam,
                              T* d1, T* d2) {
  const T* lsc = c.template at<T>(c.y.o_lsc) + l * LS_NSC;
  const T trace_hi = lsc[0], trace_hihi = lsc[1];
  T trace_p = trace_hi, trace_pp = trace_hihi, unused = T(0);
  const int cur = ls_recur<Tin, T, L>(c, l, P, &trace_p, &trace_pp, &unused,
                                      nullptr);
  const int ni = c.y.ni;
  const T p_yy = c.rows(l, cur, 0)[ni - 1];
  const T pp_yy = c.rows(l, cur, 1)[ni - 1];
  const T ppp_yy = P == 3 ? c.rows(l, cur, 2)[ni - 1] : T(0);
  const T ypkpy = (p_yy - pp_yy) / lam;
  const T ypkpkpy = (p_yy + ppp_yy - T(2) * pp_yy) / (lam * lam);
  if (c.reml) {
    const T df = (T)(c.calc_null ? c.n - c.n_cvt : c.n - c.n_cvt - 1);
    const T trace_pk = (df - trace_p) / lam;
    const T trace_pkpk = (df + trace_pp - T(2) * trace_p) / (lam * lam);
    *d1 = T(-0.5) * trace_pk + T(0.5) * df * ypkpy / p_yy;
    *d2 = T(0.5) * trace_pkpk -
          T(0.5) * df * (T(2) * ypkpkpy * p_yy - ypkpy * ypkpy) /
              (p_yy * p_yy);
  } else {
    const T nf = (T)c.n;
    const T trace_hik = (nf - trace_hi) / lam;
    const T trace_hikhik = (nf + trace_hihi - T(2) * trace_hi) / (lam * lam);
    *d1 = T(-0.5) * trace_hik + T(0.5) * nf * ypkpy / p_yy;
    *d2 = T(0.5) * trace_hikhik -
          T(0.5) * nf * (T(2) * ypkpkpy * p_yy - ypkpy * ypkpy) /
              (p_yy * p_yy);
  }
}

// Pab-form (RE)ML logf of lane l (LogRL_f / LogL_f) from its order-1 row.
template <typename Tin, typename T, int L>
__device__ T ls_logf_pab(const LsCtx<Tin, T>& c, int l) {
  const T logdet_h = c.template at<T>(c.y.o_lsc)[l * LS_NSC + 2];
  T unused = T(0), logdet_hiw = T(0);
  const int cur =
      ls_recur<Tin, T, L>(c, l, 1, &unused, &unused, &logdet_hiw,
                          c.iab + (long)c.lane(l) * (c.n_cvt + 1));
  T p_yy = c.rows(l, cur, 0)[c.y.ni - 1];
  if (p_yy >= T(0) && p_yy < T(1e-8)) p_yy = T(1e-8);
  if (c.reml) {
    const T df = (T)(c.calc_null ? c.n - c.n_cvt : c.n - c.n_cvt - 1);
    return c.logf_const - T(0.5) * logdet_h - T(0.5) * logdet_hiw -
           T(0.5) * df * gt_log(p_yy);
  }
  return c.logf_const - T(0.5) * logdet_h - T(0.5) * (T)c.n * gt_log(p_yy);
}

// The CZ×CZ Gram of lane l's design [W, x] from its order-1 row, its
// Cholesky factor (right-looking, the team over the trailing rows) and,
// with `solve`, beta from the right-hand side Σ h z y by two triangular
// solves.  Returns 2·Σ log L_jj, NaN at a pivot that is not positive
// (beta NaN then), as the reference's cholesky.
template <typename Tin, typename T, int L>
__device__ T ls_gram(const LsCtx<Tin, T>& c, int l, bool solve) {
  const int TS = LS_THREADS / L, tt = threadIdx.x % TS;
  const int CZ = c.calc_null ? c.n_cvt : c.n_cvt + 1;
  const int cols = c.n_cvt + 2;
  const T* row = c.rows(l, 0, 0);
  T* G = c.gram(l);
  T* dg = c.gvec(l, 0);
  T* z = c.gvec(l, 1);
  T* beta = c.gvec(l, 2);
  // flat position of labels (a, b), a <= b (GetabIndex)
  auto ab = [&](int a, int b) { return (2 * cols - a + 2) * (a - 1) / 2 + (b - a); };
  for (int e = tt; e < CZ * CZ; e += TS) {
    const int i = e / CZ, j = e - i * CZ;
    G[e] = row[i <= j ? ab(i + 1, j + 1) : ab(j + 1, i + 1)];
  }
  for (int i = tt; i < CZ; i += TS) z[i] = row[ab(i + 1, cols)];
  ls_team_sync<L>(l);
  T ld = T(0);
  bool bad = false;
  for (int j = 0; j < CZ && !bad; ++j) {
    const T d = G[j * CZ + j];
    if (!(d > T(0))) {
      bad = true;
      break;
    }
    const T ljj = gt_sqrt(d);
    ld += gt_log(gt_abs(ljj));
    if (tt == 0) dg[j] = ljj;
    for (int i = j + 1 + tt; i < CZ; i += TS) G[i * CZ + j] /= ljj;
    ls_team_sync<L>(l);
    for (int i = j + 1 + tt; i < CZ; i += TS) {
      const T gij = G[i * CZ + j];
      for (int k = j + 1; k <= i; ++k) G[i * CZ + k] -= gij * G[k * CZ + j];
    }
    ls_team_sync<L>(l);
  }
  if (bad) {
    for (int i = tt; i < CZ; i += TS) beta[i] = T(NAN);
    ls_team_sync<L>(l);
    return T(NAN);
  }
  if (solve) {
    // L w = rhs (w into z), then L' beta = w
    for (int i = 0; i < CZ; ++i) {
      const T wi = z[i] / dg[i];
      ls_team_sync<L>(l);
      if (tt == 0) z[i] = wi;
      for (int k = i + 1 + tt; k < CZ; k += TS) z[k] -= G[k * CZ + i] * wi;
      ls_team_sync<L>(l);
    }
    for (int i = CZ - 1; i >= 0; --i) {
      const T bi = z[i] / dg[i];
      ls_team_sync<L>(l);
      if (tt == 0) beta[i] = bi;
      for (int k = tt; k < i; k += TS) z[k] -= G[i * CZ + k] * bi;
      ls_team_sync<L>(l);
    }
  }
  return T(2) * ld;
}

// Σ h r² of every lane that asked for logf_stable, r = y − W β_W − x β_x
// (the GLS residual at its beta), the block's threads over the rows; each
// lane's partials added in thread, then warp, order.
template <typename Tin, typename T, int L>
__device__ void ls_residual(const LsCtx<Tin, T>& c) {
  const LsLayout& y = c.y;
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const int* kind = c.template at<int>(y.o_kind);
  const T* lam = c.template at<T>(y.o_lam);
  T* wred = c.template at<T>(y.o_wred);
  const int nc = c.n_cvt, C1 = y.C1;
  T acc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) acc[l] = T(0);
  for (int i = tid; i < c.n; i += LS_THREADS) {
    const T e = (T)c.eval[i];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (l >= c.nl || kind[l] != LS_STABLE) continue;
      const Tin* u = c.U(l) + (long)i * C1;
      const T* beta = c.gvec(l, 2);
      const T hi = T(1) / (lam[l] * e + T(1));
      T wb = T(0);
      for (int a = 0; a < nc; ++a) wb += (T)u[a] * beta[a];
      T t = (T)u[nc] - wb;
      if (!c.calc_null) t = t - (T)c.X(l)[i] * beta[nc];
      acc[l] += hi * (t * t);
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const T v = gt_warp_sum(acc[l]);
    if (ln == 0) wred[warp * LS_LMAX + l] = v;
  }
  ls_bar();
}

// One round: every team has posted its lane's request (kind, lam, aux)
// or LS_NONE; all of the block's threads call it together.  Returns false
// when no lane asked for anything (the block is done).  Results: res[2l],
// res[2l + 1] of lane l (d1, d2; logf; log det).
template <typename Tin, typename T, int L, bool ROWS>
__device__ __noinline__ bool ls_round(const LsCtx<Tin, T>& c) {
  const LsLayout& y = c.y;
  const int* kind = c.template at<int>(y.o_kind);
  const T* lam = c.template at<T>(y.o_lam);
  const T* aux = c.template at<T>(y.o_aux);
  T* res = c.template at<T>(y.o_res);
  GT_PROF(GT_PH_CONTROL);
  ls_bar();  // the requests visible
  int P = 0, ndev = 0, nlogf = 0;
  bool logv = false, resid = false, exact = false;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int k = kind[l];
    P = max(P, ls_order(k));
    ndev += k == LS_DEV1 || k == LS_DEV12;
    nlogf += k >= LS_LOGF;
    logv = logv || k == LS_LOGF || k == LS_STABLE;
    resid = resid || k == LS_STABLE;
    exact = exact || k == LS_STABLE || k == LS_GRAM0;
  }
  if (P == 0) {
    ls_bar();  // every thread has read the requests
    return false;
  }
  GT_PROF_COUNT(GT_PC_STEPS, 1);
  GT_PROF_COUNT(GT_PC_DEV, ndev);
  GT_PROF_COUNT(GT_PC_LOGF, nlogf);
  if constexpr (ROWS) {
    // the row-split sums for the covariate count (0 or 1) at compile time
    auto rows = [&](auto ncv) {
      constexpr int NCV = decltype(ncv)::value;
      if (P == 3)
        ls_sums_rows<Tin, T, L, 3, NCV>(c, logv, exact);
      else if (P == 2)
        ls_sums_rows<Tin, T, L, 2, NCV>(c, logv, exact);
      else
        ls_sums_rows<Tin, T, L, 1, NCV>(c, logv, exact);
    };
    if (c.n_cvt == 0)
      rows(std::integral_constant<int, 0>());
    else
      rows(std::integral_constant<int, 1>());
  } else {
    if (P == 3)
      ls_sums<Tin, T, L, 3>(c, logv, exact);
    else if (P == 2)
      ls_sums<Tin, T, L, 2>(c, logv, exact);
    else
      ls_sums<Tin, T, L, 1>(c, logv, exact);
  }
  GT_PROF(GT_PH_SUMS);
  const int l = threadIdx.x / (LS_THREADS / L);
  const bool lead = threadIdx.x % (LS_THREADS / L) == 0;
  const int k = l < c.nl ? kind[l] : LS_NONE;
  if (k == LS_DEV1 || k == LS_DEV12) {
    T d1, d2;
    ls_dev_finish<Tin, T, L>(c, l, ls_order(k), lam[l], &d1, &d2);
    if (lead) {
      res[2 * l] = d1;
      res[2 * l + 1] = d2;
    }
  } else if (k == LS_LOGF) {
    const T lf = ls_logf_pab<Tin, T, L>(c, l);
    if (lead) res[2 * l] = lf;
  } else if (k == LS_STABLE || k == LS_GRAM0) {
    const T ld = ls_gram<Tin, T, L>(c, l, k == LS_STABLE);
    if (lead) res[2 * l] = ld;
  }
  ls_bar();
  GT_PROF(ndev > 0 ? GT_PH_RECUR : GT_PH_FACTOR);
  if (resid) {
    ls_residual<Tin, T, L>(c);
    if (k == LS_STABLE) {
      const T* wred = c.template at<T>(y.o_wred);
      T p_yy = T(0);
      for (int w = 0; w < LS_THREADS / 32; ++w) p_yy += wred[w * LS_LMAX + l];
      if (p_yy >= T(0) && p_yy < T(1e-8)) p_yy = T(1e-8);
      const T ld = res[2 * l];
      const T logdet_h = c.template at<T>(y.o_lsc)[l * LS_NSC + 2];
      T lf;
      if (c.reml) {
        const T df = (T)(c.calc_null ? c.n - c.n_cvt : c.n - c.n_cvt - 1);
        lf = c.logf_const - T(0.5) * logdet_h - T(0.5) * (ld - aux[l]) -
             T(0.5) * df * gt_log(p_yy);
      } else {
        lf = c.logf_const - T(0.5) * logdet_h -
             T(0.5) * (T)c.n * gt_log(p_yy);
      }
      ls_team_sync<L>(l);  // the team has read res[2l]
      if (lead) res[2 * l] = lf;
    }
    ls_bar();
    GT_PROF(GT_PH_SUMS);
  }
  ls_bar();  // results visible; the requests may be overwritten
  return true;
}

// Lane l's evaluation: post the request, take part in the round, read the
// results.  Every thread of the team calls it with the same values.
template <typename Tin, typename T, int L, bool ROWS>
__device__ __forceinline__ void ls_eval(const LsCtx<Tin, T>& c, int l,
                                        int kind, T lam, T aux, T* r0,
                                        T* r1) {
  const LsLayout& y = c.y;
  if (threadIdx.x % (LS_THREADS / L) == 0) {
    c.template at<int>(y.o_kind)[l] = kind;
    c.template at<T>(y.o_lam)[l] = lam;
    c.template at<T>(y.o_aux)[l] = aux;
  }
  ls_round<Tin, T, L, ROWS>(c);
  const T* res = c.template at<T>(y.o_res);
  *r0 = res[2 * l];
  if (r1 != nullptr) *r1 = res[2 * l + 1];
}

// Team l's next lane, -1 when there is none: with L = 1 the block's own
// lane once; else the next of the launch's lanes [s0, s0 + count) that
// the counter `next` hands out (`taken` counts the team's lanes).
template <typename Tin, typename T, int L>
__device__ __forceinline__ int ls_next(const LsCtx<Tin, T>& c, int l,
                                       int* next, int s0, int count,
                                       int& taken) {
  if (L == 1) return taken++ == 0 ? c.first : -1;
  int* lane = c.template at<int>(c.y.o_lane);
  if (threadIdx.x % (LS_THREADS / L) == 0) {
    const int s = s0 + atomicAdd(next, 1);
    lane[l] = s < s0 + count ? s : ~s0;
  }
  ls_team_sync<L>(l);
  const int s = lane[l];
  return s >= 0 ? s : -1;
}

// A team whose lane is done (or absent): post nothing and take part in
// the rounds until the block's last lane is done.
template <typename Tin, typename T, int L, bool ROWS>
__device__ __forceinline__ void ls_idle(const LsCtx<Tin, T>& c, int l) {
  if (threadIdx.x % (LS_THREADS / L) == 0)
    c.template at<int>(c.y.o_kind)[l] = LS_NONE;
  while (ls_round<Tin, T, L, ROWS>(c)) {
  }
}

// The block's context: lanes [first, first + nl) of the launch's
// [s0, s0 + count), L a block.
template <typename Tin, typename T>
__device__ inline LsCtx<Tin, T> ls_ctx(const Tin* eval, const Tin* UtWy,
                                       const Tin* Utx, int ustride,
                                       int xstride, const int* tab,
                                       int n_cvt, int n, int calc_null,
                                       int reml, T logf_const, int L, int TR,
                                       int resident, int gram, int s0,
                                       int count, unsigned char* scratch) {
  extern __shared__ __align__(16) unsigned char ls_smem[];
  LsCtx<Tin, T> c;
  c.eval = eval;
  c.UtWy = UtWy;
  c.Utx = Utx;
  c.ustride = ustride;
  c.xstride = xstride;
  c.t = gt_tables(tab, n_cvt);
  c.n_cvt = n_cvt;
  c.n = n;
  c.calc_null = calc_null;
  c.reml = reml;
  c.logf_const = logf_const;
  c.iab = nullptr;
  c.lane0 = (long)blockIdx.x * L;
  c.first = s0 + (int)c.lane0;
  c.nl = min(L, count - (int)c.lane0);
  c.dyn = L > 1;
  c.y = ls_layout(n_cvt, n, L, TR, sizeof(Tin), sizeof(T), gram,
                  scratch == nullptr, resident);
  c.sm = ls_smem;
  c.scratch = scratch;
  return c;
}
