// Shared device code of the mvLMM kernels K9 mph_em, K10 mph_calc_p and
// K11 mph_nr (and the small algebra K14 calc_crt borrows), float64
// arithmetic throughout; the operands eval (n), X0 (c0, n), Y (d, n) and
// the lane's own rows R (r, n) are read in the operand type T (float in
// the speed mode, double in the parity mode).
//
// Every per-lane quantity is a sum over the n individuals of a product of
// per-individual values: in the whitened basis of (Vg, Ve) (EigenProc,
// mvlmm.cpp:213-282), with A = UltVehi, z_k = A y_k and the weights w_kl
// = 1/(δ_k D_l + 1), the Gram blocks Σ_k w_kl x_k x_k', xHiy = Σ_k w_kl
// z_kl x_k, the EM's outer products and the Newton derivatives' traces.
// A pass's sums are lists of families (MvPass): sum r is the product of
// up to six staged rows (1, δ, δ², the design rows x_i, and up to five
// d-rows whose meaning the pass sets), named by its descriptor.
//
// A lane is fitted by a team of W warps (MvTeam): four when a launch has
// many lanes, up to a whole block of sixteen when it has few (the null
// fits, mph_initial's pairs, -pnr's refits; mv_geom).  A block
// holds L teams; each team takes its lanes from the launch's counter, so
// a team whose lane stops early takes the next.  eval, X0 and Y are
// staged once a block in shared memory where they fit.  A pass (mv_pass)
// hands each warp groups of 32 sums, a sum a lane, W groups at a time;
// the team stages NB individuals at a time (each thread its individuals'
// values, in the team's buffer), and every lane adds its sum's products
// over the chunk in increasing k into four partial sums by k mod 4,
// added as ((q0 + q1) + (q2 + q3)); where a pass has fewer groups than
// the team has warps, 2 or 4 warps share a group's partials.  So every
// sum is taken in one order whatever the team, the block or the launch:
// no atomics, and a lane's result does not depend on the geometry.  The small algebra is spread over the team: EigenProc's
// products and Jacobi's rotations entry by entry, the d GLS inverses one
// a thread, the M-step, the derivatives, the Hessian and its Gauss-Jordan
// inverse entry by entry with the pivot found by a fixed-order reduction;
// each entry computed as one thread would, so the team's algebra gives
// the same numbers as one thread's (tests/test_torch_mv_team.py emulates
// the order of the sums).
//
// The lane code is templated on (MD, MC), the bounds of d and c.
// (MV_MAX_D, MV_MAX_C) = (8, 10) is the fixed instantiation: a team's
// state, sums and temporaries in the block's shared memory, a thread's
// small arrays local.  (0, 0) is the form sized at run time for any d and
// c: the state, sums and temporaries live in a per-lane slice of global
// scratch (the wrapper splits a launch's lanes under a byte budget,
// kernels.launch_lanes).  The staging buffer is in shared memory in both.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "tails.cuh"

#define MV_MAX_D 8
#define MV_MAX_C 10
#define MV_TARGET_WARPS 2048  // lanes x warps a launch aims at (mv_geom)
#define MV_MIN_W 4            // warps of the smallest team
#define MV_MAX_W 16           // warps of the largest team
#define MV_BLOCK_WARPS 8      // warps of a block below MV_MAX_W
#define MV_BUF_SMEM (160 * 1024)    // bytes of a block's staging buffers
#define MV_SMEM_MAX (227 * 1024)    // dynamic shared bytes of a block
#define MV_CTL 32             // a team's control doubles (MvCtl)
#define MV_MAX_FAM 16
#define MV_MAX_ROW 1023       // staged rows a descriptor can name
#define MV_TINY 2.2250738585072014e-308
#define MV_LOG_2PI 1.8378770664093453
#define MV_JACOBI_SWEEPS 50
#define MV_JACOBI_TOL 1e-30


// Phase clocks of K9 and K11 (scripts/k9_k11_phase_profile.py builds
// them with -DGT_PROFILE, which declares common.cuh's gt_prof): a team's
// leader thread adds the clock64() cycles since its last mark to the
// phase it closes, in its own counters, and adds those and the lane's
// counts to gt_prof when the lane is done (flush).  Without GT_PROFILE
// every member is empty.
#define MV_PH_STAGE 0    // staging individuals' values
#define MV_PH_SUMS 1     // the sums over n
#define MV_PH_WAIT 2     // barriers and the team's reductions
#define MV_PH_EIGEN 3    // EigenProc (Jacobi at d >= 3), the PD tests
#define MV_PH_GLS 4      // GLS, logl, the exit tests
#define MV_PH_STEP 5     // K9's M-step; K11's step and halving control
#define MV_PH_DERIV 6    // K11: gradient, trace tables, the Hessian
#define MV_PH_INV 7      // K11: the Hessian's inverse
#define MV_NPH 8
#define MV_PC_LANES 12   // lanes
#define MV_PC_ITERS 13   // EM / Newton iterations
#define MV_PC_LIK 14     // likelihood passes (K9's pass A, K11's halvings)
#define MV_PC_DER 15     // K9's pass B, K11's derivative passes
struct MvProf {
#ifdef GT_PROFILE
  long long t;
  unsigned long long a[16];
  bool on;
  __device__ void start(bool leader) {
    on = leader;
    for (int k = 0; k < 16; ++k) a[k] = 0;
    if (on) t = clock64();
  }
  __device__ void mark(int k) {
    if (on) {
      const long long now = clock64();
      a[k] += (unsigned long long)(now - t);
      t = now;
    }
  }
  __device__ void count(int k, long long v) {
    if (on) a[k] += (unsigned long long)v;
  }
  __device__ void flush() {
    if (on)
      for (int k = 0; k < 16; ++k)
        if (a[k]) {
          atomicAdd(&gt_prof[k], a[k]);
          a[k] = 0;
        }
  }
#else
  __device__ void start(bool) {}
  __device__ void mark(int) {}
  __device__ void count(int, long long) {}
  __device__ void flush() {}
#endif
};


// ---------------------------------------------------------------------------
// index helpers

__host__ __device__ inline int mv_tri(int c) { return c * (c + 1) / 2; }

// whether (d, c) takes the run-time-sized form
__host__ __device__ inline bool mv_dyn(int d, int c) {
  return d > MV_MAX_D || c > MV_MAX_C;
}

// staged rows of a lane: 1, δ, δ², the c design rows and five d-rows
__host__ __device__ inline int mv_nrow(int d, int c) { return 3 + c + 5 * d; }

// fixed instantiation's size N, or (N == 0) the next n values of the
// thread's frame `fr` in global scratch, which take() advances.
template <typename U, int N>
struct MvTmp {
  U a[N];
  __device__ __forceinline__ U* take(double*&, int) { return a; }
};
template <typename U>
struct MvTmp<U, 0> {
  __device__ __forceinline__ U* take(double*& fr, int n) {
    U* p = reinterpret_cast<U*>(fr);
    fr += ((long)n * sizeof(U) + 7) / 8;
    return p;
  }
};

// (i, j), i <= j, in row-major upper-triangle order
__host__ __device__ inline int mv_ti(int i, int j, int c) {
  if (j < i) {
    const int t = i;
    i = j;
    j = t;
  }
  return i * c - i * (i - 1) / 2 + (j - i);
}

__device__ inline void mv_tri_decode(int idx, int c, int& i, int& j) {
  i = 0;
  while (idx >= c - i) {
    idx -= c - i;
    ++i;
  }
  j = i + idx;
}

// GEMMA GetIndex pairs: parameter a < d(d+1)/2 ↔ (i, j), i <= j
__device__ inline void mv_vech_pair(int a, int d, int& i, int& j) {
  mv_tri_decode(a, d, i, j);
}

// ---------------------------------------------------------------------------
// families of sums and the passes built from them.  A family's sums are
// products of staged rows: t is the power of δ (row t: 1, δ, δ²), X(i)
// the design rows, W(l) the weights, Z(l), R3(l), R4(l), R5(l) the d-rows
// the pass stages.

enum {
  F_XX,    // (i <= j)            x_i x_j
  F_Q,     // (l; i <= j)         δ^t x_i x_j w_l
  F_XWZ,   // (l; i)              x_i w_l z_l
  F_QUAD,  // (l)                 z_l z_l w_l
  F_R3,    // (l)                 r3_l
  F_W,     // (l)                 δ^t w_l
  F_S1,    // (l; i)              r5_l x_i
  F_GG,    // (l <= m)            δ^t r4_l r4_m
  F_ZZ,    // (l <= m)            δ^t z_l z_m
  F_WWH,   // (l)                 δ^t w_l w_l r3_l
  F_WW,    // (l <= m)            δ^t w_l w_m
  F_N,     // (l <= m; i <= j)    δ^t x_i x_j w_l w_m
  F_K,     // (l; m <= q)         δ^t w_l z_m z_q
  F_F,     // (l; m; i)           δ^t x_i w_l z_m
  F_MTR    // (l; m)              δ^t w_l w_l r3_l w_m
};

__host__ __device__ inline int mv_fam_count(int kind, int d, int c) {
  switch (kind) {
    case F_XX: return mv_tri(c);
    case F_Q: return d * mv_tri(c);
    case F_XWZ:
    case F_S1: return d * c;
    case F_QUAD:
    case F_R3:
    case F_W:
    case F_WWH: return d;
    case F_GG:
    case F_ZZ:
    case F_WW: return mv_tri(d);
    case F_N: return mv_tri(d) * mv_tri(c);
    case F_K: return d * mv_tri(d);
    case F_F: return d * d * c;
    case F_MTR: return d * d;
  }
  return 0;
}

struct MvPass {
  int nf, d, c;
  int kind[MV_MAX_FAM];
  int t[MV_MAX_FAM];
  int base[MV_MAX_FAM + 1];
};

__host__ __device__ inline void mv_pass_begin(MvPass& P, int d, int c) {
  P.nf = 0;
  P.d = d;
  P.c = c;
  P.base[0] = 0;
}

// appends a family; returns its index in the pass
__host__ __device__ inline int mv_pass_add(MvPass& P, int kind, int t = 0) {
  P.kind[P.nf] = kind;
  P.t[P.nf] = t;
  P.base[P.nf + 1] = P.base[P.nf] + mv_fam_count(kind, P.d, P.c);
  return P.nf++;
}

__host__ __device__ inline int mv_pass_size(const MvPass& P) {
  return P.base[P.nf];
}

// the core of every likelihood pass, families 0-3: Q, XWZ, QUAD, R3 (log v)
enum { FC_Q = 0, FC_XWZ = 1, FC_QUAD = 2, FC_LOGV = 3 };

__host__ __device__ inline void mv_pass_core(MvPass& P, int d, int c) {
  mv_pass_begin(P, d, c);
  mv_pass_add(P, F_Q, 0);
  mv_pass_add(P, F_XWZ);
  mv_pass_add(P, F_QUAD);
  mv_pass_add(P, F_R3);
}

// staged rows
struct MvRows {
  int c, d;
  __device__ int X(int i) const { return 3 + i; }
  __device__ int W(int l) const { return 3 + c + l; }
  __device__ int Z(int l) const { return 3 + c + d + l; }
  __device__ int R3(int l) const { return 3 + c + 2 * d + l; }
  __device__ int R4(int l) const { return 3 + c + 3 * d + l; }
  __device__ int R5(int l) const { return 3 + c + 4 * d + l; }
};

// A sum's descriptor: the count of its factors other than the constant
// row 0 (bits 0-2) and their row indices, 10 bits each from bit 4.
__device__ __forceinline__ int mv_drow(unsigned long long desc, int k) {
  return (int)((desc >> (4 + 10 * k)) & 0x3ff);
}

// descriptor of sum r of pass P: its rows but row 0 (all ones)
__device__ inline unsigned long long mv_desc(const MvPass& P, int r) {
  int f = 0;
  while (r >= P.base[f + 1]) ++f;
  const int loc = r - P.base[f];
  const int t = P.t[f], d = P.d, c = P.c;
  const MvRows R{c, d};
  int i, j, l, m, q;
  int row[6] = {0, 0, 0, 0, 0, 0};
  switch (P.kind[f]) {
    case F_XX:
      mv_tri_decode(loc, c, i, j);
      row[0] = R.X(i), row[1] = R.X(j);
      break;
    case F_Q:
      l = loc / mv_tri(c);
      mv_tri_decode(loc % mv_tri(c), c, i, j);
      row[0] = t, row[1] = R.X(i), row[2] = R.X(j), row[3] = R.W(l);
      break;
    case F_XWZ:
      l = loc / c;
      i = loc % c;
      row[0] = R.X(i), row[1] = R.W(l), row[2] = R.Z(l);
      break;
    case F_QUAD:
      row[0] = R.Z(loc), row[1] = R.Z(loc), row[2] = R.W(loc);
      break;
    case F_R3:
      row[0] = R.R3(loc);
      break;
    case F_W:
      row[0] = t, row[1] = R.W(loc);
      break;
    case F_S1:
      l = loc / c;
      i = loc % c;
      row[0] = R.R5(l), row[1] = R.X(i);
      break;
    case F_GG:
      mv_tri_decode(loc, d, l, m);
      row[0] = t, row[1] = R.R4(l), row[2] = R.R4(m);
      break;
    case F_ZZ:
      mv_tri_decode(loc, d, l, m);
      row[0] = t, row[1] = R.Z(l), row[2] = R.Z(m);
      break;
    case F_WWH:
      row[0] = t, row[1] = R.W(loc), row[2] = R.W(loc), row[3] = R.R3(loc);
      break;
    case F_WW:
      mv_tri_decode(loc, d, l, m);
      row[0] = t, row[1] = R.W(l), row[2] = R.W(m);
      break;
    case F_N:
      mv_tri_decode(loc / mv_tri(c), d, l, m);
      mv_tri_decode(loc % mv_tri(c), c, i, j);
      row[0] = t, row[1] = R.X(i), row[2] = R.X(j), row[3] = R.W(l),
      row[4] = R.W(m);
      break;
    case F_K:
      l = loc / mv_tri(d);
      mv_tri_decode(loc % mv_tri(d), d, m, q);
      row[0] = t, row[1] = R.W(l), row[2] = R.Z(m), row[3] = R.Z(q);
      break;
    case F_F:
      l = loc / (d * c);
      m = (loc / c) % d;
      i = loc % c;
      row[0] = t, row[1] = R.X(i), row[2] = R.W(l), row[3] = R.Z(m);
      break;
    case F_MTR:
      l = loc / d;
      m = loc % d;
      row[0] = t, row[1] = R.W(l), row[2] = R.W(l), row[3] = R.R3(l),
      row[4] = R.W(m);
      break;
  }
  unsigned long long desc = 0;
  int nf = 0;
  for (int k = 0; k < 6; ++k)
    if (row[k] != 0)
      desc |= (unsigned long long)row[k] << (4 + 10 * nf++);
  return desc | (unsigned long long)nf;
}


// accessors into a pass's accumulator
__device__ inline double mv_at(const double* acc, const MvPass& P, int f,
                               int loc) {
  return acc[P.base[f] + loc];
}
// F_Q / F_N blocks as full symmetric c×c
__device__ inline double mv_q(const double* acc, const MvPass& P, int f,
                              int l, int i, int j) {
  return acc[P.base[f] + l * mv_tri(P.c) + mv_ti(i, j, P.c)];
}
// F_ZZ / F_GG / F_WW as full symmetric d×d
__device__ inline double mv_dd(const double* acc, const MvPass& P, int f,
                               int l, int m) {
  return acc[P.base[f] + mv_ti(l, m, P.d)];
}

// ---------------------------------------------------------------------------
// the lane: operands and the per-lane state the stagers read

template <typename T>
struct MvLane {
  const T* eval;
  const T* X0;
  const T* Y;
  const T* R;     // the lane's rows
  int n, d, c0, r, c;
  __device__ double x(int i, int k) const {
    return i < c0 ? (double)X0[(long)i * n + k]
                  : (double)R[(long)(i - c0) * n + k];
  }
};

// per-lane small matrices, row-major, compact (d×d at stride d): in
// arrays of the fixed instantiation's size (K14's lanes), or
template <int MD, int MC>
struct MvState {
  double Vg[MD * MD], Ve[MD * MD];
  double D[MD];
  double A[MD * MD];    // UltVehi
  double Uh[MD * MD];   // UltVeh
  double Ul[MD * MD];   // eigenvectors of Ve^-1/2 Vg Ve^-1/2
  double Qi[MD * MC * MC];  // d inverse Gram blocks
  double beta[MD * MC];  // GLS coefficients, whitened (d, c)
  double Bc[MD * MC];    // ML: the carried UltVehiB (d, c)
  double Bn[MD * MC];    // ML: this iteration's UltVehiB
  double logdet_Ve, logl;
  int flag;
};

// the same matrices where pointers place them: K14's run-time-sized form
// and every K9-K11 team (the state itself, pointers and scalars, stays in
// shared memory)
template <>
struct MvState<0, 0> {
  double *Vg, *Ve, *D, *A, *Uh, *Ul, *Qi, *beta, *Bc, *Bn;
  double logdet_Ve, logl;
  int flag;
};

// doubles of a run-time-sized state's matrices
__host__ __device__ inline long mv_state_len(int d, int c) {
  return 5L * d * d + d + (long)d * c * c + 3L * d * c;
}

// points the pointer-form state into `w` (one thread, before a barrier);
// returns the first double after it.  The fixed state needs nothing.
template <int MD, int MC>
__device__ inline double* mv_state_bind(MvState<MD, MC>& s, double* w, int d,
                                        int c) {
  if constexpr (MD == 0) {
    const long dd = (long)d * d, dc = (long)d * c;
    s.Vg = w;
    s.Ve = s.Vg + dd;
    s.A = s.Ve + dd;
    s.Uh = s.A + dd;
    s.Ul = s.Uh + dd;
    s.D = s.Ul + dd;
    s.Qi = s.D + d;
    s.beta = s.Qi + dc * c;
    s.Bc = s.beta + dc;
    s.Bn = s.Bc + dc;
    return s.Bn + dc;
  }
  return w;
}

// doubles of thread 0's frame in K14's run-time-sized form: the deepest
// chain of temporaries of the lane code (EigenProc and its eigh; a c×c
// inverse beside two c×c blocks) and of each kernel's own
__host__ __device__ inline long mv_frame_len(int d, int c) {
  const long dd = (long)d * d, cc = (long)c * c;
  return 12 * dd + 4 * cc + 8L * d + 4L * c + (long)d * (d + 1) + 16;
}


// ---------------------------------------------------------------------------
// teams, their geometry and the pass over n

// A team: W warps fitting one lane.  Its barrier is the block's (one team
// a block) or a named barrier of its own: W >= MV_MIN_W, so a block holds
// at most two teams.
struct MvTeam {
  int W, id, rank, size, warp, lane;
  bool whole;   // the team is the block
  __device__ void sync() const {
    if (whole)
      __syncthreads();
    else if (id == 0)   // immediate ids: a register id reserves all 16
      asm volatile("bar.sync 1, %0;" ::"r"(size) : "memory");
    else
      asm volatile("bar.sync 2, %0;" ::"r"(size) : "memory");
  }
  __device__ bool leader() const { return rank == 0; }
};
static_assert(MV_BLOCK_WARPS / MV_MIN_W <= 2, "MvTeam::sync names two barriers");

// team-strided loop over [0, n)
#define MV_TFOR(tm, i, n) for (int i = (tm).rank; i < (n); i += (tm).size)

// a team's control block in shared memory: the lane's state (pointers and
// scalars) and what its threads decide together
template <typename S>
struct MvCtl {
  S s;
  double logl, logl_prev, logl_const, ldq, lnew;
  int lane, flag, done, iters, piv, accepted, pd;
};
static_assert(sizeof(MvCtl<MvState<0, 0>>) <= MV_CTL * sizeof(double),
              "MvCtl outgrows MV_CTL");

// a team's buffer: the staged rows at a stride of NB + 1 doubles, then
// the partial sums of the groups a round shares between warps
__host__ __device__ inline int mv_stride(int NB) { return NB + 1; }

__host__ __device__ inline long mv_team_buf(int nrow, int NB, int W) {
  return (long)nrow * mv_stride(NB) + 64L * W;
}

// The launch geometry of `count` lanes at (n, d, c0 + r = c) with
// operands of isz bytes; `state`: doubles of a team's state when it is in
// shared memory (the fixed instantiation), else 0.  W follows the count
// (four warps a lane above 256 lanes, eight above 128, sixteen at 128 and
// fewer: a lane's latency bounds a block whose longest lane runs a
// hundred times the median's iterations), a block holds L teams, and a
// team stages NB individuals a chunk.
struct MvGeom {
  int W, L, NB, common;
  long team, bytes;
};

__host__ __device__ inline long mv_common_bytes(int n, int d, int c0,
                                                int isz) {
  return ((long)(1 + c0 + d) * n * isz + 15) / 16 * 16;
}

__host__ __device__ inline MvGeom mv_geom(int count, int n, int d, int c0,
                                          int c, int isz, long state) {
  MvGeom g;
  const int want = MV_TARGET_WARPS / (count > 1 ? count : 1);
  g.W = MV_MIN_W;
  while (g.W * 2 <= want && g.W < MV_MAX_W) g.W *= 2;
  g.L = (g.W > MV_BLOCK_WARPS ? g.W : MV_BLOCK_WARPS) / g.W;   // 1 or 2
  g.NB = 32 * g.W;
  const long nrow = mv_nrow(d, c);
  while (g.NB > 32 && (long)g.L * nrow * (g.NB + 1) * 8 > MV_BUF_SMEM)
    g.NB /= 2;
  g.team = mv_team_buf(nrow, g.NB, g.W) + MV_CTL + state;
  while (g.L > 1 && (long)g.L * g.team * 8 > MV_SMEM_MAX) --g.L;
  const long cb = mv_common_bytes(n, d, c0, isz);
  g.common = (long)g.L * g.team * 8 + cb <= MV_SMEM_MAX;
  g.bytes = (long)g.L * g.team * 8 + (g.common ? cb : 0);
  return g;
}

// one field of the geometry (the kernels' <name>_geometry)
__host__ inline long mv_geom_field(const MvGeom& g, int what) {
  switch (what) {
    case 0: return g.W;
    case 1: return g.L;
    case 2: return g.NB;
    case 3: return g.common;
    case 4: return g.team;
  }
  return g.bytes;
}

// whether a launch at this geometry fits the card's block limits
__host__ inline bool mv_geom_ok(const MvGeom& g, int d, int c) {
  return g.bytes <= MV_SMEM_MAX && mv_nrow(d, c) <= MV_MAX_ROW;
}

// what a pass stages in its five d-rows
enum {
  STAGE_X,    // only 1, δ, δ², x
  STAGE_Z,    // w, z, log v
  STAGE_ML,   // STAGE_Z and g = w (z - Bc x), e0 = z - δ D g
  STAGE_PY,   // w, py = w (z - beta x), h = x' Qi_l x
  STAGE_E     // E = e0 - Bn x
};

// individual k's rows into col[row * NB] for a pass that stages MODE;
// the design rows read back from their staged rows.  The state and the
// operands go through local restrict pointers: the stores to col alias
// none of them.
template <typename T, int MODE>
__device__ __forceinline__ void mv_stage(const MvLane<T>& L,
                                         const MvState<0, 0>& s, int k,
                                         double* __restrict__ col, int NB) {
  const int d = L.d, c = L.c, n = L.n, c0 = L.c0;
  const MvRows R{c, d};
  const T* __restrict__ X0 = L.X0;
  const T* __restrict__ Rw = L.R;
  const T* __restrict__ Y = L.Y;
  const double* __restrict__ D = s.D;
  const double* __restrict__ A = s.A;
  const double dl = (double)L.eval[k];
  col[0] = 1.0;
  col[NB] = dl;
  col[2 * NB] = dl * dl;
  double* __restrict__ xc = col + R.X(0) * NB;
  for (int i = 0; i < c0; ++i) xc[i * NB] = (double)X0[(long)i * n + k];
  for (int i = c0; i < c; ++i)
    xc[i * NB] = (double)Rw[(long)(i - c0) * n + k];
  if constexpr (MODE == STAGE_X) return;
  for (int l = 0; l < d; ++l) {
    const double v = D[l] * dl + 1.0;
    const double w = 1.0 / v;
    double z = 0.0;
    for (int m = 0; m < d; ++m) z += A[l * d + m] * (double)Y[(long)m * n + k];
    col[R.W(l) * NB] = w;
    if constexpr (MODE == STAGE_Z || MODE == STAGE_ML) {
      col[R.Z(l) * NB] = z;
      col[R.R3(l) * NB] = log(v);
      if constexpr (MODE == STAGE_ML) {
        const double* __restrict__ Bc = s.Bc + l * c;
        double bx = 0.0;
        for (int i = 0; i < c; ++i) bx += Bc[i] * xc[i * NB];
        const double g = w * (z - bx);
        col[R.R4(l) * NB] = g;
        col[R.R5(l) * NB] = z - dl * D[l] * g;
      }
    } else if constexpr (MODE == STAGE_PY) {
      const double* __restrict__ be = s.beta + l * c;
      double bx = 0.0;
      for (int i = 0; i < c; ++i) bx += be[i] * xc[i * NB];
      col[R.Z(l) * NB] = w * (z - bx);
      const double* __restrict__ Qi = s.Qi + l * c * c;
      double h = 0.0;
      for (int i = 0; i < c; ++i) {
        double qx = 0.0;
        for (int j = 0; j < c; ++j) qx += Qi[i * c + j] * xc[j * NB];
        h += xc[i * NB] * qx;
      }
      col[R.R3(l) * NB] = h;
    } else {  // STAGE_E
      const double* __restrict__ Bc = s.Bc + l * c;
      const double* __restrict__ Bn = s.Bn + l * c;
      double bx = 0.0, bn = 0.0;
      for (int i = 0; i < c; ++i) {
        bx += Bc[i] * xc[i * NB];
        bn += Bn[i] * xc[i * NB];
      }
      const double g = w * (z - bx);
      col[R.Z(l) * NB] = (z - dl * D[l] * g) - bn;
    }
  }
}

// One pass: acc[r] = Σ_k Π (the rows of sum r), every sum of P, on the
// team.  Lane l of a warp owns sum 32 g + l of group g; a sum is four
// partial sums, q_j over the individuals k ≡ j (mod 4) in increasing k,
// and ends as ((q0 + q1) + (q2 + q3)), whatever the team, block or
// launch.  Where the pass has at least W groups a warp takes a group's
// four partials, W groups a round; with fewer, 2 or 4 warps share a group
// (two or one partials each), added through `pq`.  For each chunk of NB
// individuals their rows go to `buf` (nrow rows at stride NB + 1: the
// lanes' rows fall in different banks) — staged by each warp for its own
// partials where a round holds one group, else by the whole team — and
// every lane adds its partials' products over the chunk (mv_acc); the
// lanes of a warp read one individual at a time, rows that several sums
// share broadcast.  Each product has as many factors as the warp's
// longest sum, a shorter sum's last ones row 0 (all ones, an exact
// factor).  Ends with the team's barrier.
#define MV_SL 4

// a lane's partials j0 .. j0 + PW - 1 over a chunk of nb individuals:
// q[i] += Π_{f < NF} row f at k, k ≡ j0 + i (mod 4), k increasing
template <int NF, int PW>
__device__ __forceinline__ void mv_acc(const double* __restrict__ buf,
                                       const int (&off)[6], int nb, int j0,
                                       double (&q)[MV_SL]) {
  auto prod = [&](int k) {
    double p = buf[off[0] + k];
#pragma unroll
    for (int f = 1; f < NF; ++f) p *= buf[off[f] + k];
    return p;
  };
  int k = 0;
  for (; k + MV_SL <= nb; k += MV_SL) {
#pragma unroll
    for (int i = 0; i < PW; ++i) q[i] += prod(k + j0 + i);
  }
#pragma unroll
  for (int i = 0; i < PW; ++i)
    if (k + j0 + i < nb) q[i] += prod(k + j0 + i);
}

template <int PW>
__device__ __forceinline__ void mv_acc_nf(int nfa, const double* buf,
                                          const int (&off)[6], int nb, int j0,
                                          double (&q)[MV_SL]) {
  switch (nfa) {        // the same in the whole warp
    case 1: mv_acc<1, PW>(buf, off, nb, j0, q); break;
    case 2: mv_acc<2, PW>(buf, off, nb, j0, q); break;
    case 3: mv_acc<3, PW>(buf, off, nb, j0, q); break;
    case 4: mv_acc<4, PW>(buf, off, nb, j0, q); break;
    case 5: mv_acc<5, PW>(buf, off, nb, j0, q); break;
    default: mv_acc<6, PW>(buf, off, nb, j0, q);
  }
}

template <typename T, int MODE>
__device__ __noinline__ void mv_pass(const MvTeam& tm, const MvLane<T> L,
                                     const MvState<0, 0>& sm, const MvPass& P,
                                     double* buf, int NB, double* acc,
                                     MvProf& pf) {
  const MvState<0, 0> s = sm;   // the pointers, read once from shared
  const int total = mv_pass_size(P);
  const int NBs = mv_stride(NB);
  const int ngr = (total + 32 - 1) / 32;
  // warps a group: 1, or where the groups are fewer than the warps 2 or 4
  int wpg = 1;
  while (wpg < MV_SL && ngr * wpg * 2 <= tm.W) wpg *= 2;
  const int pw = MV_SL / wpg, gpr = tm.W / wpg;
  const int gi = tm.warp / wpg, j0 = (tm.warp % wpg) * pw;
  double* pq = buf + (long)mv_nrow(L.d, L.c) * NBs;
  for (int g0 = 0; g0 < ngr; g0 += gpr) {
    const int g = g0 + gi, r = g * 32 + tm.lane;
    const bool has = g < ngr && r < total;
    const unsigned long long ds = has ? mv_desc(P, r) : 0ull;
    const int nf = (int)(ds & 7);
    const int nfa = __reduce_max_sync(0xffffffffu, nf);
    int off[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) off[f] = f < nf ? mv_drow(ds, f) * NBs : 0;
    double q[MV_SL];
#pragma unroll
    for (int j = 0; j < MV_SL; ++j) q[j] = 0.0;
    pf.mark(MV_PH_SUMS);
    for (int k0 = 0; k0 < L.n; k0 += NB) {
      const int nb = min(NB, L.n - k0);
      if (gpr == 1) {
        // one group a round: each warp stages just the individuals its
        // partials read, and no barrier but the warp's is needed
        const int items = (nb + MV_SL - 1) / MV_SL * pw;
        for (int e = tm.lane; e < items; e += 32) {
          const int kk = e / pw * MV_SL + j0 + e % pw;
          if (kk < nb) mv_stage<T, MODE>(L, s, k0 + kk, buf + kk, NBs);
        }
        pf.mark(MV_PH_STAGE);
        __syncwarp();
      } else {
        for (int j = tm.rank; j < nb; j += tm.size)
          mv_stage<T, MODE>(L, s, k0 + j, buf + j, NBs);
        pf.mark(MV_PH_STAGE);
        tm.sync();
      }
      pf.mark(MV_PH_WAIT);
      if (has) {
        if (pw == 4) mv_acc_nf<4>(nfa, buf, off, nb, j0, q);
        else if (pw == 2) mv_acc_nf<2>(nfa, buf, off, nb, j0, q);
        else mv_acc_nf<1>(nfa, buf, off, nb, j0, q);
      }
      pf.mark(MV_PH_SUMS);
      if (gpr == 1)
        __syncwarp();
      else
        tm.sync();
      pf.mark(MV_PH_WAIT);
    }
    if (wpg == 1) {
      if (has) acc[r] = (q[0] + q[1]) + (q[2] + q[3]);
    } else {
      double* p = pq + (long)gi * MV_SL * 32 + tm.lane;
      if (has)
        for (int i = 0; i < pw; ++i) p[(j0 + i) * 32] = q[i];
      tm.sync();
      if (has && j0 == 0) acc[r] = (p[0] + p[32]) + (p[64] + p[96]);
      tm.sync();
    }
  }
  tm.sync();
  pf.mark(MV_PH_WAIT);
}

// ---------------------------------------------------------------------------
// small algebra, one thread (K14, and the team's leader)

// the reference's closed-form 2×2 eigh (_eigh2x2, mvlmm_core.py:59-95)
__device__ inline void mv_eigh2(const double* M, double* w, double* V) {
  const double a = M[0], b = M[1], dd = M[3];
  const double t = 0.5 * (a + dd);
  const double h2 = (0.5 * (a - dd)) * (0.5 * (a - dd)) + b * b;
  const double r = sqrt(fmax(h2, MV_TINY));
  const double w1 = t - r, w2 = t + r;
  const bool use1 = fabs(w2 - a) >= fabs(w2 - dd);
  double vx = use1 ? b : w2 - dd;
  double vy = use1 ? w2 - a : b;
  if (fabs(b) <= MV_TINY * 8) {
    const bool big_is_a = a >= dd;
    vx = big_is_a ? 1.0 : 0.0;
    vy = big_is_a ? 0.0 : 1.0;
  }
  double nrm = sqrt(vx * vx + vy * vy);
  if (nrm == 0.0) nrm = 1.0;
  vx /= nrm;
  vy /= nrm;
  w[0] = w1;
  w[1] = w2;
  // columns v(w1) = (-vy, vx), v(w2) = (vx, vy)
  V[0] = -vy;
  V[1] = vx;
  V[2] = vx;
  V[3] = vy;
}

// symmetric d×d eigh: the closed form at d = 2; cyclic Jacobi above, then
// eigenvalues ascending and each eigenvector signed to agree with prev (a
// non-negative dot product) or, without it, with its largest-magnitude
// component positive.  M is overwritten.
template <int MD>
__device__ inline void mv_eigh(int d, double* M, double* w, double* V,
                               const double* prev, double* fr) {
  if (d == 2) {
    mv_eigh2(M, w, V);
    return;
  }
  for (int i = 0; i < d * d; ++i) V[i] = 0.0;
  for (int i = 0; i < d; ++i) V[i * d + i] = 1.0;
  for (int sweep = 0; sweep < MV_JACOBI_SWEEPS; ++sweep) {
    double off = 0.0, dg = 0.0;
    for (int p = 0; p < d; ++p) {
      dg += M[p * d + p] * M[p * d + p];
      for (int q = p + 1; q < d; ++q) off += M[p * d + q] * M[p * d + q];
    }
    if (!(off > MV_JACOBI_TOL * dg)) break;
    for (int p = 0; p < d - 1; ++p) {
      for (int q = p + 1; q < d; ++q) {
        const double apq = M[p * d + q];
        if (apq == 0.0) continue;
        const double theta = (M[q * d + q] - M[p * d + p]) / (2.0 * apq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                         (fabs(theta) + sqrt(theta * theta + 1.0));
        const double cs = 1.0 / sqrt(t * t + 1.0), sn = t * cs;
        for (int k = 0; k < d; ++k) {
          const double mp = M[k * d + p], mq = M[k * d + q];
          M[k * d + p] = cs * mp - sn * mq;
          M[k * d + q] = sn * mp + cs * mq;
        }
        for (int k = 0; k < d; ++k) {
          const double mp = M[p * d + k], mq = M[q * d + k];
          M[p * d + k] = cs * mp - sn * mq;
          M[q * d + k] = sn * mp + cs * mq;
        }
        for (int k = 0; k < d; ++k) {
          const double vp = V[k * d + p], vq = V[k * d + q];
          V[k * d + p] = cs * vp - sn * vq;
          V[k * d + q] = sn * vp + cs * vq;
        }
      }
    }
  }
  // ascending, stable
  MvTmp<int, MD> tord;
  int* ord = tord.take(fr, d);
  for (int i = 0; i < d; ++i) ord[i] = i;
  for (int i = 1; i < d; ++i) {
    const int o = ord[i];
    int j = i;
    while (j > 0 && M[ord[j - 1] * d + ord[j - 1]] > M[o * d + o]) {
      ord[j] = ord[j - 1];
      --j;
    }
    ord[j] = o;
  }
  MvTmp<double, MD * MD> tVs;
  double* Vs = tVs.take(fr, d * d);
  for (int j = 0; j < d; ++j) {
    w[j] = M[ord[j] * d + ord[j]];
    for (int i = 0; i < d; ++i) Vs[i * d + j] = V[i * d + ord[j]];
  }
  for (int j = 0; j < d; ++j) {
    bool neg;
    if (prev != nullptr) {
      double dot = 0.0;
      for (int i = 0; i < d; ++i) dot += Vs[i * d + j] * prev[i * d + j];
      neg = dot < 0.0;
    } else {
      int big = 0;
      for (int i = 1; i < d; ++i)
        if (fabs(Vs[i * d + j]) > fabs(Vs[big * d + j])) big = i;
      neg = Vs[big * d + j] < 0.0;
    }
    for (int i = 0; i < d; ++i) V[i * d + j] = neg ? -Vs[i * d + j] : Vs[i * d + j];
  }
}

// EigenProc (mvlmm_core.py:106-128) into s: D, Uh = Ul'Veh, A = Ul'Vehi,
// Ul, logdet_Ve; Ul's signs follow prev where given
template <int MD, int MC>
__device__ inline void mv_eigen_proc(int d, const double* Vg,
                                     const double* Ve, MvState<MD, MC>& s,
                                     const double* prev, double* fr) {
  MvTmp<double, MD * MD> tM, tUv, tVeh, tVehi, tT;
  MvTmp<double, MD> tev, tsq, tisq;
  double* M = tM.take(fr, d * d);
  double* ev = tev.take(fr, d);
  double* Uv = tUv.take(fr, d * d);
  for (int i = 0; i < d * d; ++i) M[i] = Ve[i];
  mv_eigh<MD>(d, M, ev, Uv, nullptr, fr);
  double* sq = tsq.take(fr, d);
  double* isq = tisq.take(fr, d);
  double ld = 0.0;
  for (int k = 0; k < d; ++k) {
    const bool pos = ev[k] > 0.0;
    const double r = sqrt(pos ? ev[k] : 1.0);
    sq[k] = pos ? r : 0.0;
    isq[k] = pos ? 1.0 / r : 0.0;
    if (pos) ld += log(ev[k]);
  }
  s.logdet_Ve = ld;
  double* Veh = tVeh.take(fr, d * d);
  double* Vehi = tVehi.take(fr, d * d);
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j) {
      double a = 0.0, b = 0.0;
      for (int k = 0; k < d; ++k) {
        a += Uv[i * d + k] * sq[k] * Uv[j * d + k];
        b += Uv[i * d + k] * isq[k] * Uv[j * d + k];
      }
      Veh[i * d + j] = a;
      Vehi[i * d + j] = b;
    }
  double* T = tT.take(fr, d * d);
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j) {
      double a = 0.0;
      for (int k = 0; k < d; ++k) a += Vehi[i * d + k] * Vg[k * d + j];
      T[i * d + j] = a;
    }
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j) {
      double a = 0.0;
      for (int k = 0; k < d; ++k) a += T[i * d + k] * Vehi[k * d + j];
      M[i * d + j] = a;
    }
  mv_eigh<MD>(d, M, s.D, s.Ul, prev, fr);
  for (int l = 0; l < d; ++l)
    if (s.D[l] < 0.0) s.D[l] = 0.0;
  for (int l = 0; l < d; ++l)
    for (int j = 0; j < d; ++j) {
      double a = 0.0, b = 0.0;
      for (int k = 0; k < d; ++k) {
        a += s.Ul[k * d + l] * Veh[k * d + j];
        b += s.Ul[k * d + l] * Vehi[k * d + j];
      }
      s.Uh[l * d + j] = a;
      s.A[l * d + j] = b;
    }
}

// inverse and log|det| of a c×c matrix: the adjugate at c <= 2 (as the
// reference), Gauss-Jordan with partial pivoting above
template <int MC>
__device__ inline void mv_inv_logdet(int c, const double* M, double* Mi,
                                     double& logdet, double* fr) {
  if (c == 1) {
    Mi[0] = 1.0 / M[0];
    logdet = log(fabs(M[0]));
    return;
  }
  if (c == 2) {
    const double a = M[0], b = M[1], e = M[2], f = M[3];
    const double det = a * f - b * e;
    Mi[0] = f / det;
    Mi[1] = -b / det;
    Mi[2] = -e / det;
    Mi[3] = a / det;
    logdet = log(fabs(det));
    return;
  }
  MvTmp<double, MC * MC> tW;
  double* W = tW.take(fr, c * c);
  for (int i = 0; i < c * c; ++i) {
    W[i] = M[i];
    Mi[i] = 0.0;
  }
  for (int i = 0; i < c; ++i) Mi[i * c + i] = 1.0;
  logdet = 0.0;
  for (int col = 0; col < c; ++col) {
    int piv = col;
    for (int i = col + 1; i < c; ++i)
      if (fabs(W[i * c + col]) > fabs(W[piv * c + col])) piv = i;
    if (piv != col)
      for (int j = 0; j < c; ++j) {
        double t = W[col * c + j];
        W[col * c + j] = W[piv * c + j];
        W[piv * c + j] = t;
        t = Mi[col * c + j];
        Mi[col * c + j] = Mi[piv * c + j];
        Mi[piv * c + j] = t;
      }
    const double p = W[col * c + col];
    logdet += log(fabs(p));
    for (int j = 0; j < c; ++j) {
      W[col * c + j] /= p;
      Mi[col * c + j] /= p;
    }
    for (int i = 0; i < c; ++i) {
      if (i == col) continue;
      const double f = W[i * c + col];
      if (f == 0.0) continue;
      for (int j = 0; j < c; ++j) {
        W[i * c + j] -= f * W[col * c + j];
        Mi[i * c + j] -= f * Mi[col * c + j];
      }
    }
  }
}

// Gauss-Jordan inverse of an n×n matrix in place (K11's Hessian), one
// thread; singular input gives inf/NaN as LU would
__device__ inline void mv_invert(int n, double* M, double* Mi) {
  for (int i = 0; i < n * n; ++i) Mi[i] = 0.0;
  for (int i = 0; i < n; ++i) Mi[i * n + i] = 1.0;
  for (int col = 0; col < n; ++col) {
    int piv = col;
    for (int i = col + 1; i < n; ++i)
      if (fabs(M[i * n + col]) > fabs(M[piv * n + col])) piv = i;
    if (piv != col)
      for (int j = 0; j < n; ++j) {
        double t = M[col * n + j];
        M[col * n + j] = M[piv * n + j];
        M[piv * n + j] = t;
        t = Mi[col * n + j];
        Mi[col * n + j] = Mi[piv * n + j];
        Mi[piv * n + j] = t;
      }
    const double p = M[col * n + col];
    for (int j = 0; j < n; ++j) {
      M[col * n + j] /= p;
      Mi[col * n + j] /= p;
    }
    for (int i = 0; i < n; ++i) {
      if (i == col) continue;
      const double f = M[i * n + col];
      if (f == 0.0) continue;
      for (int j = 0; j < n; ++j) {
        M[i * n + j] -= f * M[col * n + j];
        Mi[i * n + j] -= f * Mi[col * n + j];
      }
    }
  }
}

// the Gram blocks of a core pass → s.Qi, s.beta; returns Σ log|Q_l|
// ---------------------------------------------------------------------------
// small algebra on the team: each entry computed as one thread computes it
// (the serial helpers above), so the numbers are one thread's

// doubles of a team's temporaries (team-shared): EigenProc with its eigh,
// the d GLS inverses beside their blocks, the M-step's U and E, the PD
// tests, XX' and its inverse, K10's per-phenotype arrays
__host__ __device__ inline long mv_tframe_len(int d, int c) {
  const long dd = (long)d * d, cc = (long)c * c;
  return 8 * dd + 2L * d * cc + 3 * cc + 8L * d + 4L * c + 16;
}

// symmetric d×d eigh on the team, as mv_eigh: the closed form at d = 2 on
// the leader; above, cyclic Jacobi on the team's first warp, each
// rotation's updates one index a lane, every value from the entries
// before the rotation as one thread's column-then-row updates compute it
// (above d = 32 the columns, then the rows); the order and signs on the
// leader.  M is
// overwritten; `fr` holds d² + d doubles.
__device__ inline void mv_t_eigh(const MvTeam& tm, int d, double* M,
                                 double* w, double* V, const double* prev,
                                 double* fr) {
  if (d == 2) {
    if (tm.leader()) mv_eigh2(M, w, V);
    tm.sync();
    return;
  }
  if (tm.warp == 0) {
    const int ln = tm.lane;
    for (int i = ln; i < d * d; i += 32) V[i] = i % (d + 1) == 0 ? 1.0 : 0.0;
    __syncwarp();
    for (int sweep = 0; sweep < MV_JACOBI_SWEEPS; ++sweep) {
      double off = 0.0, dg = 0.0;
      for (int p = 0; p < d; ++p) {
        dg += M[p * d + p] * M[p * d + p];
        for (int q = p + 1; q < d; ++q) off += M[p * d + q] * M[p * d + q];
      }
      if (!(off > MV_JACOBI_TOL * dg)) break;
      for (int p = 0; p < d - 1; ++p) {
        for (int q = p + 1; q < d; ++q) {
          const double apq = M[p * d + q];
          if (apq == 0.0) continue;
          const double theta = (M[q * d + q] - M[p * d + p]) / (2.0 * apq);
          const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                           (fabs(theta) + sqrt(theta * theta + 1.0));
          const double cs = 1.0 / sqrt(t * t + 1.0), sn = t * cs;
          if (d > 32) {          // columns, then rows, a lane an index
            __syncwarp();
            for (int k = ln; k < d; k += 32) {
              const double mp = M[k * d + p], mq = M[k * d + q];
              M[k * d + p] = cs * mp - sn * mq;
              M[k * d + q] = sn * mp + cs * mq;
              const double vp = V[k * d + p], vq = V[k * d + q];
              V[k * d + p] = cs * vp - sn * vq;
              V[k * d + q] = sn * vp + cs * vq;
            }
            __syncwarp();
            for (int k = ln; k < d; k += 32) {
              const double mp = M[p * d + k], mq = M[q * d + k];
              M[p * d + k] = cs * mp - sn * mq;
              M[q * d + k] = sn * mp + cs * mq;
            }
            __syncwarp();
            continue;
          }
          // lane k: row k's columns p, q and column k's rows p, q; lane
          // p the 2×2 block (columns first, then rows, as one thread)
          double r[4];
          const int k0 = ln < d ? ln : 0;
          if (k0 != p && k0 != q) {
            const double mp = M[k0 * d + p], mq = M[k0 * d + q];
            const double np = M[p * d + k0], nq = M[q * d + k0];
            r[0] = cs * mp - sn * mq;
            r[1] = sn * mp + cs * mq;
            r[2] = cs * np - sn * nq;
            r[3] = sn * np + cs * nq;
          } else {
            const double pp = M[p * d + p], pq = M[p * d + q];
            const double qp = M[q * d + p], qq = M[q * d + q];
            const double a = cs * pp - sn * pq, b = sn * pp + cs * pq;
            const double e = cs * qp - sn * qq, f = sn * qp + cs * qq;
            r[0] = cs * a - sn * e;   // (p, p)
            r[1] = sn * a + cs * e;   // (q, p)
            r[2] = cs * b - sn * f;   // (p, q)
            r[3] = sn * b + cs * f;   // (q, q)
          }
          __syncwarp();
          for (int k = ln; k < d; k += 32) {
            if (k != p && k != q) {
              M[k * d + p] = r[0];
              M[k * d + q] = r[1];
              M[p * d + k] = r[2];
              M[q * d + k] = r[3];
            } else if (k == p) {
              M[p * d + p] = r[0];
              M[q * d + p] = r[1];
              M[p * d + q] = r[2];
              M[q * d + q] = r[3];
            }
            const double vp = V[k * d + p], vq = V[k * d + q];
            V[k * d + p] = cs * vp - sn * vq;
            V[k * d + q] = sn * vp + cs * vq;
          }
          __syncwarp();
        }
      }
    }
    if (ln == 0) {
      // ascending, stable; then each eigenvector's sign
      int* ord = reinterpret_cast<int*>(fr + d * d);
      double* Vs = fr;
      for (int i = 0; i < d; ++i) ord[i] = i;
      for (int i = 1; i < d; ++i) {
        const int o = ord[i];
        int j = i;
        while (j > 0 && M[ord[j - 1] * d + ord[j - 1]] > M[o * d + o]) {
          ord[j] = ord[j - 1];
          --j;
        }
        ord[j] = o;
      }
      for (int j = 0; j < d; ++j) {
        w[j] = M[ord[j] * d + ord[j]];
        for (int i = 0; i < d; ++i) Vs[i * d + j] = V[i * d + ord[j]];
      }
      for (int j = 0; j < d; ++j) {
        bool neg;
        if (prev != nullptr) {
          double dot = 0.0;
          for (int i = 0; i < d; ++i) dot += Vs[i * d + j] * prev[i * d + j];
          neg = dot < 0.0;
        } else {
          int big = 0;
          for (int i = 1; i < d; ++i)
            if (fabs(Vs[i * d + j]) > fabs(Vs[big * d + j])) big = i;
          neg = Vs[big * d + j] < 0.0;
        }
        for (int i = 0; i < d; ++i)
          V[i * d + j] = neg ? -Vs[i * d + j] : Vs[i * d + j];
      }
    }
  }
  tm.sync();
}

// EigenProc (mvlmm_core.py:106-128) on the team into s: D, Uh = Ul'Veh,
// A = Ul'Vehi, Ul, logdet_Ve (through `ctl_logdet`); Ul's signs follow
// prev where given.  `fr`: 7 d² + 4 d doubles.
__device__ inline void mv_t_eigen_proc(const MvTeam& tm, int d,
                                       const double* Vg, const double* Ve,
                                       const MvState<0, 0>& s,
                                       double* logdet, const double* prev,
                                       double* fr) {
  const int dd = d * d;
  double* M = fr;
  double* ev = M + dd;
  double* Uv = ev + d;
  double* sq = Uv + dd;
  double* isq = sq + d;
  double* Veh = isq + d;
  double* Vehi = Veh + dd;
  double* T = Vehi + dd;
  double* et = T + dd;     // eigh's d² + d
  MV_TFOR(tm, i, dd) M[i] = Ve[i];
  tm.sync();
  mv_t_eigh(tm, d, M, ev, Uv, nullptr, et);
  if (tm.leader()) {
    double ld = 0.0;
    for (int k = 0; k < d; ++k) {
      const bool pos = ev[k] > 0.0;
      const double r = sqrt(pos ? ev[k] : 1.0);
      sq[k] = pos ? r : 0.0;
      isq[k] = pos ? 1.0 / r : 0.0;
      if (pos) ld += log(ev[k]);
    }
    *logdet = ld;
  }
  tm.sync();
  MV_TFOR(tm, e, dd) {
    const int i = e / d, j = e % d;
    double a = 0.0, b = 0.0;
    for (int k = 0; k < d; ++k) {
      a += Uv[i * d + k] * sq[k] * Uv[j * d + k];
      b += Uv[i * d + k] * isq[k] * Uv[j * d + k];
    }
    Veh[e] = a;
    Vehi[e] = b;
  }
  tm.sync();
  MV_TFOR(tm, e, dd) {
    const int i = e / d, j = e % d;
    double a = 0.0;
    for (int k = 0; k < d; ++k) a += Vehi[i * d + k] * Vg[k * d + j];
    T[e] = a;
  }
  tm.sync();
  MV_TFOR(tm, e, dd) {
    const int i = e / d, j = e % d;
    double a = 0.0;
    for (int k = 0; k < d; ++k) a += T[i * d + k] * Vehi[k * d + j];
    M[e] = a;
  }
  tm.sync();
  mv_t_eigh(tm, d, M, s.D, s.Ul, prev, et);
  MV_TFOR(tm, l, d) if (s.D[l] < 0.0) s.D[l] = 0.0;
  MV_TFOR(tm, e, dd) {
    const int l = e / d, j = e % d;
    double a = 0.0, b = 0.0;
    for (int k = 0; k < d; ++k) {
      a += s.Ul[k * d + l] * Veh[k * d + j];
      b += s.Ul[k * d + l] * Vehi[k * d + j];
    }
    s.Uh[e] = a;
    s.A[e] = b;
  }
  tm.sync();
}

// whether a symmetric d×d matrix is positive definite (its eigh on the
// team); every thread returns the answer.  `fr`: 3 d² + 2 d doubles.
__device__ inline bool mv_t_is_pd(const MvTeam& tm, int d, const double* M,
                                  double* fr) {
  double* W = fr;
  double* w = W + d * d;
  double* V = w + d;
  MV_TFOR(tm, i, d * d) W[i] = M[i];
  tm.sync();
  mv_t_eigh(tm, d, W, w, V, nullptr, V + d * d);
  bool pd = true;
  for (int i = 0; i < d; ++i) pd = pd && w[i] > 0.0;
  tm.sync();
  return pd;
}

// The inverse and log|det| of a c×c matrix W (overwritten) into Mi on
// one warp, as mv_inv_logdet's Gauss-Jordan (c > 2): the pivot the first
// largest |entry| below the diagonal, by a fixed-order reduction; row
// swaps and scaling a column a lane, the elimination an entry a lane
// (each entry as one thread computes it); `f` c doubles; lane 0 returns
// the log|det|, summed column by column.
__device__ inline double mv_w_inv_logdet(int lane, int c, double* W,
                                         double* Mi, double* f) {
  for (int e = lane; e < c * c; e += 32) Mi[e] = e / c == e % c ? 1.0 : 0.0;
  double logdet = 0.0;
  for (int col = 0; col < c; ++col) {
    double bv = -1.0;
    int bi = 0x7fffffff;
    for (int i = col + 1 + lane; i < c; i += 32) {
      const double a = fabs(W[i * c + col]);
      if (a > bv) {
        bv = a;
        bi = i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int piv = bv > fabs(W[col * c + col]) ? bi : col;
    __syncwarp();
    if (piv != col)
      for (int j = lane; j < c; j += 32) {
        double t = W[col * c + j];
        W[col * c + j] = W[piv * c + j];
        W[piv * c + j] = t;
        t = Mi[col * c + j];
        Mi[col * c + j] = Mi[piv * c + j];
        Mi[piv * c + j] = t;
      }
    __syncwarp();
    const double p = W[col * c + col];
    logdet += log(fabs(p));
    __syncwarp();
    for (int j = lane; j < c; j += 32) {
      W[col * c + j] /= p;
      Mi[col * c + j] /= p;
    }
    __syncwarp();
    for (int i = lane; i < c; i += 32) f[i] = W[i * c + col];
    __syncwarp();
    for (int e = lane; e < c * c; e += 32) {
      const int i = e / c, j = e % c;
      const double fi = f[i];
      if (i != col && fi != 0.0) {
        W[i * c + j] -= fi * W[col * c + j];
        Mi[i * c + j] -= fi * Mi[col * c + j];
      }
    }
    __syncwarp();
  }
  return logdet;
}

// the Gram blocks of a core pass → s.Qi, s.beta on the team; every
// thread returns Σ log|Q_l|.  At c <= 2 block l's inverse (the adjugate)
// on thread l, above on warp l mod W (mv_w_inv_logdet).  `fr`: d + 2 d c²
// doubles.
template <int MC>
__device__ inline double mv_t_gls(const MvTeam& tm, const double* acc,
                                  const MvPass& P, const MvState<0, 0>& s,
                                  double* fr) {
  const int d = P.d, c = P.c, cc = c * c;
  double* ldl = fr;
  MV_TFOR(tm, e, d * cc) {
    const int l = e / cc, i = (e % cc) / c, j = e % c;
    fr[d + 2L * l * cc + i * c + j] = mv_q(acc, P, FC_Q, l, i, j);
  }
  tm.sync();
  if (c <= 2) {
    MV_TFOR(tm, l, d) {
      double* Q = fr + d + 2L * l * cc;
      mv_inv_logdet<MC>(c, Q, s.Qi + l * cc, ldl[l], Q + cc);
    }
  } else {
    for (int l = tm.warp; l < d; l += tm.W) {
      double* Q = fr + d + 2L * l * cc;
      const double ld = mv_w_inv_logdet(tm.lane, c, Q, s.Qi + l * cc, Q + cc);
      if (tm.lane == 0) ldl[l] = ld;
    }
  }
  tm.sync();
  MV_TFOR(tm, e, d * c) {
    const int l = e / c, i = e % c;
    double b = 0.0;
    for (int j = 0; j < c; ++j)
      b += s.Qi[l * cc + i * c + j] * mv_at(acc, P, FC_XWZ, l * c + j);
    s.beta[e] = b;
  }
  double ldq = 0.0;
  for (int l = 0; l < d; ++l) ldq += ldl[l];
  tm.sync();
  return ldq;
}

// Gauss-Jordan inverse of an n×n matrix in place (K11's Hessian), as
// mv_invert, on the team: the pivot of each column found on the first
// warp by a fixed-order reduction (the first largest |entry| below the
// diagonal, as one thread's scan), the row swap, scaling and elimination
// entry by entry; `piv` a team-shared int, `f` n doubles.  A singular
// input gives inf/NaN, as LU would.
__device__ inline void mv_t_invert(const MvTeam& tm, int n, double* M,
                                   double* Mi, int* piv, double* f) {
  MV_TFOR(tm, e, n * n) Mi[e] = e / n == e % n ? 1.0 : 0.0;
  for (int col = 0; col < n; ++col) {
    if (tm.warp == 0) {
      double bv = -1.0;
      int bi = 0x7fffffff;
      for (int i = col + 1 + tm.lane; i < n; i += 32) {
        const double a = fabs(M[i * n + col]);
        if (a > bv) {
          bv = a;
          bi = i;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const double ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (tm.lane == 0) *piv = bv > fabs(M[col * n + col]) ? bi : col;
    }
    tm.sync();
    const int pv = *piv;
    if (pv != col)
      MV_TFOR(tm, j, n) {
        double t = M[col * n + j];
        M[col * n + j] = M[pv * n + j];
        M[pv * n + j] = t;
        t = Mi[col * n + j];
        Mi[col * n + j] = Mi[pv * n + j];
        Mi[pv * n + j] = t;
      }
    tm.sync();
    const double p = M[col * n + col];
    tm.sync();
    MV_TFOR(tm, j, n) {
      M[col * n + j] /= p;
      Mi[col * n + j] /= p;
    }
    tm.sync();
    MV_TFOR(tm, i, n) f[i] = M[i * n + col];
    tm.sync();
    MV_TFOR(tm, e, n * n) {
      const int i = e / n, j = e % n;
      const double fi = f[i];
      if (i != col && fi != 0.0) {
        M[i * n + j] -= fi * M[col * n + j];
        Mi[i * n + j] -= fi * Mi[col * n + j];
      }
    }
    tm.sync();
  }
}


template <int MD, int MC>
__device__ inline double mv_logl(const double* acc, const MvPass& P,
                                 const MvState<MD, MC>& s, double ldq,
                                 int reml,
                                 double logl_const, int n) {
  const int d = P.d, c = P.c;
  double quad = 0.0, logd = 0.0, qQq = 0.0;
  for (int l = 0; l < d; ++l) {
    quad += mv_at(acc, P, FC_QUAD, l);
    logd += mv_at(acc, P, FC_LOGV, l);
    for (int i = 0; i < c; ++i)
      qQq += mv_at(acc, P, FC_XWZ, l * c + i) * s.beta[l * c + i];
  }
  double logl = logl_const - 0.5 * (quad + logd - qQq) - 0.5 * n * s.logdet_Ve;
  if (reml) logl -= 0.5 * (ldq - c * s.logdet_Ve);
  return logl;
}

// the REML constant -(n-c)d/2 log 2π + d/2 log|XX'| (or the ML one), and
// (XX')^-1 where Xi is given; thread 0 after an F_XX pass
template <int MC>
__device__ inline double mv_logl_const(const double* acc, const MvPass& P,
                                       int reml, int n, double* Xi,
                                       double* fr) {
  const int d = P.d, c = P.c;
  MvTmp<double, MC * MC> tM, tMi;
  double* M = tM.take(fr, c * c);
  double* Mi = tMi.take(fr, c * c);
  double ld;
  for (int i = 0; i < c; ++i)
    for (int j = 0; j < c; ++j) M[i * c + j] = acc[mv_ti(i, j, c)];
  mv_inv_logdet<MC>(c, M, Xi != nullptr ? Xi : Mi, ld, fr);
  if (reml) return -0.5 * (n - c) * d * MV_LOG_2PI + 0.5 * d * ld;
  return -0.5 * n * d * MV_LOG_2PI;
}

// the lane's operand pointers
template <typename T>
__device__ inline MvLane<T> mv_lane(const T* eval, const T* X0, const T* Y,
                                    const T* R, int n, int d, int c0, int r,
                                    int s) {
  MvLane<T> L;
  L.eval = eval;
  L.X0 = X0;
  L.Y = Y;
  L.R = R + (long)s * r * n;
  L.n = n;
  L.d = d;
  L.c0 = c0;
  L.r = r;
  L.c = c0 + r;
  return L;
}

