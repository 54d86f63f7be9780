// K12 — the BSLMM Metropolis-Hastings chain: a whole segment of
// iterations in one thread-block cluster (bslmm_chain_launch, float32
// operands; bslmm_chain_f64_launch, float64 operands; float64 arithmetic
// in both).
//
// Replaces the reference package's device program
//   gemma_tpu/models/bslmm.py:121 make_mcmc_step (calc_posterior :144,
//   sample_new_rank :202, propose_gamma :227, propose_h_rho_pi :289,
//   mh_step :315, iteration :353) and :421 run_mcmc (the jitted
//   fori_loop :461-463).
// Its plain version is gemma_torch/models/bslmm.py (bslmm_chain_plain),
// and both draw from the counter-based Philox stream of philox.cuh /
// ops/philox.py, so the two take the same draws at the same counters.
//
// Bound: operations, per posterior about n n_gamma² (Omega) + n_gamma³/3
// (Cholesky) + 20 n float64 operations, bytes n n_gamma (the active rows)
// + 10 n words; the probit step adds 2 n² values of U.  The chain is
// sequential (iteration t + 1 starts from t's state), so a chain can use
// only the SMs of one cluster, and at the mouse shapes (n_gamma ~ 16) a
// posterior is a chain of dependent steps whose latency, not its work,
// sets the time.  The design:
//   * one cluster of BS_CLUSTER_WIDE CTAs where the card schedules it,
//     else BS_CLUSTER (the portable size), launched by cudaLaunchKernelEx;
//     the kernel writes the size it ran at to ints[3];
//   * every CTA holds the same copy of the chain's state in shared memory
//     and draws the same proposals: the MH step's draws (a new rank's
//     first candidate by binary search of the float64 cumulative p_gamma
//     through a shared index) by BS_MAX_REPEAT threads at once, then
//     thread 0 proposes (h, rho, log pi) by reflected steps and gamma by
//     add/remove/swap with the reference's corrections, with explicitly
//     rounded operations in the plain version's order, keeping the active
//     ranks' p_gamma beside them; no proposal crosses the cluster;
//   * each CTA owns the contiguous slice [r n / cs, (r + 1) n / cs) of the
//     individuals (models/bslmm.py chain_slices) in every pass over n:
//     H's weights, log|H| and y'H^-1y; (n_gamma <= 32) Omega's partial
//     X'WX and X'H^-1y, from the slice's rows staged in shared memory
//     where they fit; UtXb, alpha and Utu; the probit step's rows of
//     U (UtXb + Utu) and columns of U'(z - mean);
//   * values cross the cluster by stores into the other CTAs' shared
//     memory before a cluster barrier, read locally after it, so no
//     remote load waits on the critical path: each CTA's a1/a2, a3/a4 and
//     probit sums to every CTA (added there in rank order: no atomics,
//     deterministic, the same sums in every CTA), its partial X'WX to an
//     inbox in rank 0, rank 0's beta, tau, log|Omega| and quadratic form
//     to every CTA;
//   * Omega (packed lower triangle), its factor and the small vectors
//     live in rank 0's shared memory while they fit, Omega distributed
//     over the CTAs' shared memory beyond that (BsView: the packed rows
//     cut into cs chunks, each row in the chunk where it starts), and in
//     global scratch only beyond that;
//   * at most 32 active ranks (one panel) rank 0's warp 0 factors Omega
//     and solves without a block barrier;
//   * above 32 every warp of the cluster computes 8 x 32 blocks of Omega
//     over all n on the FP64 tensor cores (mma.sync m8n8k4), and the
//     Cholesky is blocked left-looking with 32-wide panels: the cluster
//     updates a panel from the columns left of it on the tensor cores,
//     every CTA's warp 0 factors its diagonal block, the cluster solves
//     the rows below it, two cluster barriers a panel; the forward and
//     the two backward solves (beta_hat, L^-T z) run by panel on rank 0;
//   * the proposal goes to the second of two state slots, and an
//     accepted one swaps them; every r_pace-th iteration after burn-in
//     rank 0 records the hyper-parameters and ranks and every CTA adds
//     its slice to the running sums.
#include <cooperative_groups.h>

#include "common.cuh"
#include "philox.cuh"

namespace cg = cooperative_groups;

#define BS_THREADS 256
#define BS_WARPS (BS_THREADS / 32)
#define BS_CLUSTER 8         // the portable cluster size
#define BS_CLUSTER_WIDE 16   // where cudaOccupancyMaxActiveClusters allows
#define BS_PANEL 32          // the factor's panel width; at most this many
                             // active ranks take the one-warp factor
#define BS_TRI (BS_PANEL * (BS_PANEL + 1) / 2)
#define BS_PART (BS_TRI + BS_PANEL)  // a CTA's partial X'WX and X'H^-1y
#define BS_MAX_REPEAT 20     // proposal repeats at most (1 + 20 u)
#define BS_STAGE_LOADS 8     // a thread's loads in flight when staging
// bytes of shared memory the per-CTA vectors (three rank lists, their
// p_gamma, beta and rank 0's X'H^-1y, beta_hat and z: BS_VEC_WORDS bytes
// an s_max) may take; beyond it they live in global scratch
#define BS_VEC_SMEM (110 * 1024)
#define BS_VEC_WORDS 68
// entries of the shared index into cum_p (the last value of each of as
// many segments) that narrows a rank's binary search
#define BS_CUM_IDX 512

// draw purposes within an MH step: the counter's stream word is
// mh * BS_STRIDE + purpose (models/bslmm.py)
#define P_JUMP 1
#define P_H 2
#define P_LOGP 3
#define P_FLAG 4
#define P_ADD 5
#define P_UTU 6
#define P_TAU 7
#define P_Z 8
#define P_ACC 9
#define P_TZ 10
#define P_MZ 11
#define BS_REFRESH 16
#define BS_STRIDE 64

// cfg: trace_G, h_min, h_max, rho_min, rho_max, logp_min, logp_max, d_h,
// d_rho, d_logp
#define C_TRACE 0
#define C_HMIN 1
#define C_HMAX 2
#define C_RMIN 3
#define C_RMAX 4
#define C_PMIN 5
#define C_PMAX 6
#define C_DH 7
#define C_DR 8
#define C_DP 9

__host__ __device__ inline long bs_tri(long i) { return i * (i + 1) / 2; }

// Omega's packed lower triangle: row i starts at word tri(i) of the
// whole, which lies in chunk tri(i) / q at base[chunk] + tri(i) % q (one
// chunk where Omega sits in one place)
struct BsView {
  double* base[BS_CLUSTER_WIDE];
  long q;
  __device__ double* row(int i) const {
    const long e = bs_tri(i);
    if (e < q) return base[0] + e;
    const long c = e / q;
    return base[c] + (e - c * q);
  }
};

// the fixed part of a CTA's shared memory; the vectors and Omega's
// region follow it (bslmm_chain_kernel)
struct BsShared {
  double red[BS_WARPS][2];
  double in1[BS_CLUSTER_WIDE][2];  // every rank's a1, a2
  double in2[BS_CLUSTER_WIDE][2];  // every rank's a3, a4
  double inz[BS_CLUSTER_WIDE];     // every rank's sum of the liabilities
  double gdraw;                    // rank 0: the posterior's gamma(n/2)
  double tau, logdet_O, quad;      // from rank 0
  double dinv[BS_PANEL];           // 1 / the diagonal of l11
  double lcol[BS_PANEL];           // the column of l11 being factored
  double cum_idx[BS_CUM_IDX];      // cum_p at the end of each segment
  // the MH step's draws
  double2 dr_jump;
  double2 dr_h[BS_MAX_REPEAT];
  double dr_lp[BS_MAX_REPEAT];
  double2 dr_flag[BS_MAX_REPEAT];
  double dr_pg[BS_MAX_REPEAT];
  int dr_rank[BS_MAX_REPEAT];
  double l11[BS_PANEL][BS_PANEL + 1];  // a diagonal block of the factor
  double zc[BS_WARPS][4 * 32];    // the probit step's column sums
  double* om_rank[BS_CLUSTER_WIDE];  // each rank's Omega region
  double* inbox;  // rank 0's inbox of the CTAs' partials, BS_PART each
  BsView view;
  int* rk;       // the state's active ranks (first ng), sorted
  int* rk_new;   // the proposal's, unsorted
  int* rk_eval;  // the proposal's, sorted
  double* pg;    // p_gamma of rk, rk_new and rk_eval, entry by entry
  double* pg_new;
  double* pg_eval;
  double* beta;  // beta of the posterior being evaluated
  double* b;     // rank 0: X'H^-1 y
  double* x;     // rank 0: beta_hat, then beta
  double* z;     // rank 0: z, then L^-T z
  double* b0;    // rank 0's b as this CTA addresses it
  int cs, rank, i0, i1, cum_seg, cum_k;
  // state
  double h, rho, logp, logpost, pve, pge, mean_z, acc_mean_z;
  int ng, n_accept, w, cur;
  // proposal and posterior
  double h_n, rho_n, logp_n, lr;
  int ng_new, accept;
  double post_logpost, post_pve, post_pge;
  double logdet_H, hi_yy0, mean_new;
};

template <typename T>
struct BsChain {
  int n, p, s_max, s_min, n_mh, a_mode, w_step, r_pace, n_rec;
  long omw;         // words of each CTA's Omega region in shared memory
  int vec_smem;     // the vectors in shared memory (else global scratch)
  PhiloxKey key;
  const double* cfg;
  const T* UtXT;
  const T* eval;
  const double* cum_p;
  const double* p_gamma;
  const T* U;
  const T* ylab;
  double* Utz;
  double* slot[2];  // alpha (n) | Utu (n) | UtXb (n) | beta (s_max)
  double* w_hi;
  double* zv;
  double* vv;
  double* Om;       // Omega's packed lower triangle beyond shared memory
  double* vecg;     // b | x | z (3 s_max) beyond shared memory
  double* pgg;      // each rank's 3 s_max p_gamma lists beyond it
  int* rkg;         // each rank's 3 s_max rank lists beyond it
};

__device__ __forceinline__ double bs_warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sums of a and b, the warps added in order (every thread
// gets them)
__device__ double2 bs_block_sum2(double a, double b, BsShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = bs_warp_sum(a);
  b = bs_warp_sum(b);
  if (lane == 0) {
    sh.red[warp][0] = a;
    sh.red[warp][1] = b;
  }
  __syncthreads();
  double2 r = make_double2(0.0, 0.0);
  for (int w = 0; w < BS_WARPS; ++w) {
    r.x += sh.red[w][0];
    r.y += sh.red[w][1];
  }
  __syncthreads();
  return r;
}

// store v into `local`'s place in every CTA of the cluster (one thread)
__device__ void bs_push(cg::cluster_group& cl, int cs, double* local,
                        const double* v, int k) {
  for (int q = 0; q < cs; ++q) {
    double* d = cl.map_shared_rank(local, q);
    for (int i = 0; i < k; ++i) d[i] = v[i];
  }
}

// the row j of the packed lower triangle that holds word e
__device__ __forceinline__ int bs_tri_row(int e) {
  int j = (int)((sqrt(8.0 * e + 1.0) - 1.0) * 0.5);
  while (bs_tri(j + 1) <= e) ++j;
  while (bs_tri(j) > e) --j;
  return j;
}

__device__ __forceinline__ double bs_reflect(double x, double lo, double hi) {
  if (x < lo) x = __dsub_rn(__dmul_rn(2.0, lo), x);
  if (x > hi) x = __dsub_rn(__dmul_rn(2.0, hi), x);
  return x;
}

// the first position whose cum_p reaches u (p where none does): the
// first segment whose last value reaches u, then within it
template <typename T>
__device__ int bs_search(const BsChain<T>& C, const BsShared& sh, double u) {
  int lo = 0, hi = sh.cum_k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sh.cum_idx[mid] < u)
      lo = mid + 1;
    else
      hi = mid;
  }
  hi = min((lo + 1) * sh.cum_seg, C.p);
  lo = min(lo * sh.cum_seg, C.p);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (C.cum_p[mid] < u)
      lo = mid + 1;
    else
      hi = mid;
  }
  return min(lo, C.p - 1);
}

// the MH step's draws for each repeat i < BS_MAX_REPEAT (a thread each):
// (h, rho) and log pi steps, the move's flag, and the first candidate of
// a new rank with its p_gamma
template <typename T>
__device__ void bs_draws(const BsChain<T>& C, BsShared& sh, unsigned t,
                         unsigned st) {
  const int i = threadIdx.x;
  if (i < BS_MAX_REPEAT) {
    sh.dr_h[i] = philox_unit2(C.key, t, st + P_H, i, 0);
    sh.dr_lp[i] = philox_unit2(C.key, t, st + P_LOGP, i, 0).x;
    sh.dr_flag[i] = philox_unit2(C.key, t, st + P_FLAG, i, 0);
    const int r =
        bs_search(C, sh, philox_unit2(C.key, t, st + P_ADD, i, 0).x);
    sh.dr_rank[i] = r;
    sh.dr_pg[i] = C.p_gamma[r];
  } else if (i == 32) {
    sh.dr_jump = philox_unit2(C.key, t, st + P_JUMP, 0, 0);
  }
}

// (h, rho, log pi) moved `repeat` times (thread 0)
template <typename T>
__device__ void bs_propose_hrp(const BsChain<T>& C, BsShared& sh,
                               int repeat) {
  double h = sh.h, rho = sh.rho, logp = sh.logp, lr = 0.0;
  for (int i = 0; i < repeat; ++i) {
    const double2 u = sh.dr_h[i];
    const double ul = sh.dr_lp[i];
    const double h2 = bs_reflect(
        __dadd_rn(h, __dmul_rn(__dsub_rn(u.x, 0.5), C.cfg[C_DH])),
        C.cfg[C_HMIN], C.cfg[C_HMAX]);
    const double rho2 = bs_reflect(
        __dadd_rn(rho, __dmul_rn(__dsub_rn(u.y, 0.5), C.cfg[C_DR])),
        C.cfg[C_RMIN], C.cfg[C_RMAX]);
    const double logp2 = bs_reflect(
        __dadd_rn(logp, __dmul_rn(__dsub_rn(ul, 0.5), C.cfg[C_DP])),
        C.cfg[C_PMIN], C.cfg[C_PMAX]);
    lr = __dadd_rn(lr, __dsub_rn(logp2, logp));
    h = h2;
    rho = rho2;
    logp = logp2;
  }
  sh.h_n = h;
  sh.rho_n = rho;
  sh.logp_n = logp;
  sh.lr = lr;
}

// a rank from p_gamma not among rk[0..ng) (thread 0): attempt 0's
// candidate is drawn already, later attempts here
template <typename T>
__device__ int bs_new_rank(const BsChain<T>& C, const BsShared& sh,
                           const int* rk, int ng, unsigned t, unsigned st,
                           int i) {
  int r = sh.dr_rank[i];
  for (unsigned k = 1;; ++k) {
    bool present = false;
    for (int j = 0; j < ng; ++j) present |= rk[j] == r;
    if (!present) return r;
    r = bs_search(C, sh, philox_unit2(C.key, t, st + P_ADD, i, k).x);
  }
}

// add/remove/swap `repeat` times into rk_new (thread 0); returns log q
template <typename T>
__device__ double bs_propose_gamma(const BsChain<T>& C, BsShared& sh,
                                   unsigned t, unsigned st, int repeat) {
  int* rk = sh.rk_new;
  double* pl = sh.pg_new;
  int ng = sh.ng;
  for (int j = 0; j < ng; ++j) {
    rk[j] = sh.rk[j];
    pl[j] = sh.pg[j];
  }
  double logmh = 0.0;
  for (int i = 0; i < repeat; ++i) {
    const double2 u = sh.dr_flag[i];
    int flag;
    if (u.x < 0.40 && ng < C.s_max)
      flag = 1;
    else if (u.x >= 0.40 && u.x < 0.80 && ng > C.s_min)
      flag = 2;
    else if (u.x >= 0.80 && ng > 0 && ng < C.p)
      flag = 3;
    else
      continue;
    double prob_act = 0.0;
    for (int j = 0; j < ng; ++j) prob_act = __dadd_rn(prob_act, pl[j]);
    int r_add = 0, col = 0;
    double pg_add = 0.0, pg_rem = 0.0;
    if (flag != 2) {
      r_add = bs_new_rank(C, sh, rk, ng, t, st, i);
      pg_add = r_add == sh.dr_rank[i] ? sh.dr_pg[i] : C.p_gamma[r_add];
    }
    if (flag != 1) {
      col = (int)(u.y * (double)ng);
      pg_rem = pl[col];
    }
    if (flag == 1) {
      const double tot = __dsub_rn(1.0, prob_act);
      logmh = __dadd_rn(logmh, __dsub_rn(-log(pg_add / tot),
                                         log((double)ng + 1.0)));
      rk[ng] = r_add;
      pl[ng++] = pg_add;
    } else if (flag == 2) {
      const double tot = __dadd_rn(__dsub_rn(1.0, prob_act), pg_rem);
      logmh = __dadd_rn(logmh, __dadd_rn(log(pg_rem / tot),
                                         log(fmax((double)ng, 1.0))));
      rk[col] = rk[ng - 1];
      pl[col] = pl[ng - 1];
      --ng;
    } else {
      const double tot = __dsub_rn(1.0, prob_act);
      logmh = __dadd_rn(
          logmh, __dsub_rn(log(pg_rem / __dsub_rn(__dadd_rn(tot, pg_rem),
                                                  pg_add)),
                           log(pg_add / tot)));
      rk[col] = r_add;
      pl[col] = pg_add;
    }
  }
  sh.ng_new = ng;
  return logmh;
}

// rk_eval = rk_new[0..ng_new) sorted ascending, with their p_gamma (the
// block; ranks are distinct)
__device__ void bs_sort_new(BsShared& sh) {
  const int ng = sh.ng_new;
  for (int j = threadIdx.x; j < ng; j += BS_THREADS) {
    const int r = sh.rk_new[j];
    int pos = 0;
    for (int i = 0; i < ng; ++i) pos += sh.rk_new[i] < r;
    sh.rk_eval[pos] = r;
    sh.pg_eval[pos] = sh.pg_new[j];
  }
  __syncthreads();
}

// Omega's place for ng > 32 active ranks (every CTA builds the same view
// of it): rank 0's region while the triangle fits, else cut over the
// cluster's regions while a chunk and a row fit each, else global
__device__ void bs_place(long omw, double* Om, BsShared& sh, int ng) {
  const long T = bs_tri(ng);
  BsView& v = sh.view;
  if (T <= omw) {
    v.q = T;
    v.base[0] = sh.om_rank[0];
  } else if ((T + sh.cs - 1) / sh.cs + ng <= omw) {
    v.q = (T + sh.cs - 1) / sh.cs;
    for (int r = 0; r < sh.cs; ++r) v.base[r] = sh.om_rank[r];
  } else {
    v.q = T;
    v.base[0] = Om;
  }
}

// Cholesky of the wdt <= 32 rows of l11 (lower part) in place by one
// warp, lane i updating row i from column k's copy in lcol (apart from
// l11, so a lane's updates do not wait on one another); dinv gets the
// inverse diagonal
__device__ void bs_factor_l11(int wdt, BsShared& sh) {
  const int lane = threadIdx.x & 31;
  double(*l)[BS_PANEL + 1] = sh.l11;
  const bool below = lane < wdt;
  for (int k = 0; k < wdt; ++k) {
    const double d = l[k][k];
    const double inv = rsqrt(d);
    const double lik = below && lane > k ? l[lane][k] * inv : 0.0;
    if (below && lane > k) {
      l[lane][k] = lik;
      sh.lcol[lane] = lik;
    }
    __syncwarp();
    // every lane has read the diagonal
    if (lane == k) {
      l[k][k] = d * inv;
      sh.dinv[k] = inv;
    }
    if (below && lane > k)
      for (int j = k + 1; j <= lane; ++j) l[lane][j] -= lik * sh.lcol[j];
    __syncwarp();
  }
}

// L11 y = r in place on r (lane c holds r_c; one warp)
__device__ double bs_solve_lower(double r, int wdt, const BsShared& sh) {
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < wdt; ++c) {
    const double yc = __shfl_sync(0xffffffffu, r, c) * sh.dinv[c];
    if (lane > c) r -= sh.l11[lane][c] * yc;
    if (lane == c) r = yc;
  }
  return r;
}

// L11' x = r in place for two right-hand sides (one warp)
__device__ void bs_solve_upper2(double& r, double& s, int wdt,
                                const BsShared& sh) {
  const int lane = threadIdx.x & 31;
  for (int c = wdt - 1; c >= 0; --c) {
    const double d = sh.dinv[c];
    const double xc = __shfl_sync(0xffffffffu, r, c) * d;
    const double zc = __shfl_sync(0xffffffffu, s, c) * d;
    if (lane < c) {
      r -= sh.l11[c][lane] * xc;
      s -= sh.l11[c][lane] * zc;
    }
    if (lane == c) {
      r = xc;
      s = zc;
    }
  }
}

// copy the view's diagonal block at k0 into l11 and its inverse
// diagonal into dinv (one warp)
__device__ void bs_load_block(const BsView& v, int k0, int wdt,
                              BsShared& sh) {
  const int lane = threadIdx.x & 31;
  const double* rl = lane < wdt ? v.row(k0 + lane) + k0 : nullptr;
  for (int j = 0; j < BS_PANEL; ++j)
    sh.l11[lane][j] = lane < wdt && j <= lane ? rl[j] : 0.0;
  if (lane < wdt) sh.dinv[lane] = 1.0 / rl[lane];
  __syncwarp();
}

// write l11 (wdt rows) back to the view at k0 (one warp)
__device__ void bs_store_block(const BsView& v, int k0, int wdt,
                               const BsShared& sh) {
  const int lane = threadIdx.x & 31;
  if (lane < wdt) {
    double* rl = v.row(k0 + lane) + k0;
    for (int j = 0; j <= lane; ++j) rl[j] = sh.l11[lane][j];
  }
}

// C (8 x 8, two a lane) += A (8 x 4, one a lane) B (4 x 8, one a lane) on
// the FP64 tensor cores: lane 4 g + t holds A[g][t], B[t][g] and C[g][2t],
// C[g][2t + 1]
__device__ __forceinline__ void bs_dmma(double& c0, double& c1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// acc[c][h] += Σ_k a_row[k] (w[k]) b_row[c][k] over k < len, for the
// warp's 8 rows (lane 4 g + t reads row g's a_row) and 4 x 8 columns
// (b_row[c] row g): an 8 x 32 block of a product of rows (one warp)
template <typename T>
__device__ void bs_mma_rows(const T* a_row, const T* const* b_row,
                            const double* w, int len, double (*acc)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll 2
  for (int k = 0; k < len; k += 4) {
    const int kk = k + t;
    const bool in = kk < len;
    const double a = in ? (double)a_row[kk] * (w ? w[kk] : 1.0) : 0.0;
    double b[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = in ? (double)b_row[c][kk] : 0.0;
#pragma unroll
    for (int c = 0; c < 4; ++c) bs_dmma(acc[c][0], acc[c][1], a, b[c]);
  }
}

// the Cholesky of Omega in the view, blocked left-looking by 32-wide
// panels over the cluster (ng > BS_PANEL)
__device__ void bs_cholesky_cluster(cg::cluster_group& cl, BsShared& sh,
                                    int ng) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int gw = sh.rank * BS_WARPS + warp, W = sh.cs * BS_WARPS;
  const BsView& v = sh.view;
  const int P = (ng + BS_PANEL - 1) / BS_PANEL;
  for (int p = 0; p < P; ++p) {
    const int k0 = p * BS_PANEL, wdt = min(BS_PANEL, ng - k0);
    if (p > 0) {
      // the previous diagonal block, factored in every CTA, goes back
      // to the factor now: every CTA has read its unfactored values
      if (sh.rank == 0 && warp == 0)
        bs_store_block(v, k0 - BS_PANEL, BS_PANEL, sh);
      // the panel's columns from all columns left of it, 8 rows a warp
      // on the tensor cores
      for (int i0 = k0 + 8 * gw; i0 < ng; i0 += 8 * W) {
        const double* a_row = v.row(min(i0 + g, ng - 1));
        const double* b_row[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          b_row[c] = v.row(min(k0 + c * 8 + g, ng - 1));
        double acc[4][2] = {};
        bs_mma_rows(a_row, b_row, nullptr, k0, acc);
        const int i = i0 + g;
        if (i < ng) {
          double* ri = v.row(i);
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = k0 + c * 8 + 2 * t + h;
              if (col < k0 + wdt && col <= i) ri[col] -= acc[c][h];
            }
        }
      }
      cl.sync();
    }
    if (warp == 0) {
      bs_load_block(v, k0, wdt, sh);
      bs_factor_l11(wdt, sh);
    }
    __syncthreads();
    // the rows below the block: L21 = A21 L11^-T
    for (int i = k0 + wdt + gw; i < ng; i += W) {
      double* ri = v.row(i) + k0;
      double r = lane < wdt ? ri[lane] : 0.0;
      r = bs_solve_lower(r, wdt, sh);
      if (lane < wdt) ri[lane] = r;
    }
    cl.sync();
  }
  if (sh.rank == 0 && warp == 0)
    bs_store_block(v, (P - 1) * BS_PANEL, ng - (P - 1) * BS_PANEL, sh);
  __syncthreads();
}

// tau from the quadratic form (rank 0)
__device__ double bs_tau(const BsShared& sh, bool use_x, bool probit,
                         double quad) {
  const double P_yy = use_x ? sh.hi_yy0 - quad : sh.hi_yy0;
  return probit ? 1.0 : sh.gdraw * (2.0 / P_yy);
}

// rank 0: tau, log|Omega| and the quadratic form to every CTA (one
// thread)
__device__ void bs_push_post(cg::cluster_group& cl, BsShared& sh,
                             double tau, double logdet_O, double quad) {
  const double v[3] = {tau, logdet_O, quad};
  for (int q = 0; q < sh.cs; ++q) {
    BsShared* d = cl.map_shared_rank(&sh, q);
    d->tau = v[0];
    d->logdet_O = v[1];
    d->quad = v[2];
  }
}

// rank 0: beta_j to every CTA's beta (where the vectors are in shared
// memory; else every CTA reads rank 0's x in global scratch)
__device__ void bs_push_beta(cg::cluster_group& cl, const BsShared& sh,
                             int j, double bj, int vec_smem) {
  if (vec_smem)
    for (int q = 0; q < sh.cs; ++q) cl.map_shared_rank(sh.beta, q)[j] = bj;
}

// at most 32 active ranks, rank 0's warp 0: Omega (in l11) factored;
// beta_hat = sa2 Omega^-1 X'H^-1y, beta = beta_hat + sqrt(sa2 / tau)
// L^-T z, log|Omega|, the quadratic form and tau, each lane an entry
__device__ void bs_small_solve(cg::cluster_group& cl, BsShared& sh, int ng,
                               double sa2, bool use_x, bool probit,
                               double* beta_g, int s_max, int vec_smem) {
  const int lane = threadIdx.x & 31;
  bs_factor_l11(ng, sh);
  const bool on = lane < ng;
  const double bj = on ? sh.b[lane] : 0.0;
  double x = bs_solve_lower(bj, ng, sh);
  double z = on ? sh.z[lane] : 0.0;
  bs_solve_upper2(x, z, ng, sh);
  x *= sa2;
  const double ld = bs_warp_sum(on ? log(sh.l11[lane][lane]) : 0.0);
  const double qd = bs_warp_sum(bj * x);
  double tau = 0.0;
  if (lane == 0) {
    tau = bs_tau(sh, use_x, probit, qd);
    bs_push_post(cl, sh, tau, 2.0 * ld, qd);
  }
  tau = __shfl_sync(0xffffffffu, tau, 0);
  const double beta = z * sqrt(sa2 / tau) + x;
  if (on) {
    sh.x[lane] = beta;
    bs_push_beta(cl, sh, lane, beta, vec_smem);
  }
  for (int j = lane; j < s_max; j += 32) beta_g[j] = j < ng ? beta : 0.0;
}

// above 32 active ranks, rank 0: the same by panels of the factor in the
// view (the block)
__device__ void bs_solves(cg::cluster_group& cl, BsShared& sh, int ng,
                          double sa2, bool use_x, bool probit,
                          double* beta_g, int s_max, int vec_smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const BsView& v = sh.view;
  double* x = sh.x;
  double* z = sh.z;
  const int P = (ng + BS_PANEL - 1) / BS_PANEL;
  for (int j = tid; j < ng; j += BS_THREADS) x[j] = sh.b[j];
  __syncthreads();
  // forward: L y = b
  for (int p = 0; p < P; ++p) {
    const int k0 = p * BS_PANEL, wdt = min(BS_PANEL, ng - k0);
    for (int c = k0 + warp; c < k0 + wdt && k0 > 0; c += BS_WARPS) {
      const double* rc = v.row(c);
      double acc = 0.0;
      for (int k = lane; k < k0; k += 32) acc += rc[k] * x[k];
      acc = bs_warp_sum(acc);
      if (lane == 0) x[c] -= acc;
    }
    __syncthreads();
    if (warp == 0) {
      bs_load_block(v, k0, wdt, sh);
      double r = lane < wdt ? x[k0 + lane] : 0.0;
      r = bs_solve_lower(r, wdt, sh);
      if (lane < wdt) x[k0 + lane] = r;
    }
    __syncthreads();
  }
  // backward: L' x = y and L' z' = z, by columns
  for (int p = P - 1; p >= 0; --p) {
    const int k0 = p * BS_PANEL, wdt = min(BS_PANEL, ng - k0);
    if (warp == 0) {
      bs_load_block(v, k0, wdt, sh);
      double r = lane < wdt ? x[k0 + lane] : 0.0;
      double s = lane < wdt ? z[k0 + lane] : 0.0;
      bs_solve_upper2(r, s, wdt, sh);
      if (lane < wdt) {
        x[k0 + lane] = r;
        z[k0 + lane] = s;
      }
    }
    __syncthreads();
    for (int c = tid; c < k0; c += BS_THREADS) {
      double ax = 0.0, az = 0.0;
      for (int k = k0; k < k0 + wdt; ++k) {
        const double l = v.row(k)[c];
        ax += l * x[k];
        az += l * z[k];
      }
      x[c] -= ax;
      z[c] -= az;
    }
    __syncthreads();
  }
  double ld = 0.0, qd = 0.0;
  for (int j = tid; j < ng; j += BS_THREADS) {
    const double xj = x[j] * sa2;
    x[j] = xj;
    ld += log(v.row(j)[j]);
    qd += sh.b[j] * xj;
  }
  const double2 s = bs_block_sum2(ld, qd, sh);
  const double tau = bs_tau(sh, use_x, probit, s.y);
  if (tid == 0) bs_push_post(cl, sh, tau, 2.0 * s.x, s.y);
  const double sc = sqrt(sa2 / tau);
  for (int j = tid; j < s_max; j += BS_THREADS) {
    const double bj = j < ng ? z[j] * sc + x[j] : 0.0;
    if (j < ng) {
      x[j] = bj;
      bs_push_beta(cl, sh, j, bj, vec_smem);
    }
    beta_g[j] = bj;
  }
}

// the slice's X_gamma rows, weights, working response and normals in
// the CTA's Omega region (at most 32 active ranks, where they fit)
struct BsStage {
  double* X;   // ng x len
  double* w;
  double* uz;
  double* ur;
  int len;
};

// the marginal posterior at (rk[0..ng), h, rho, logp) with draws at
// (t, stream); writes the slot `out` (each CTA its slice, rank 0 beta)
// and sh.post_* in every CTA (the cluster)
template <typename T>
__device__ __noinline__ void bs_posterior(
    cg::cluster_group& cl, const BsChain<T>& C, BsShared& sh, const int* rk,
    int ng, double h, double rho, double logp, unsigned t, unsigned stream,
    double* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = C.n, i0 = sh.i0, i1 = sh.i1, rank = sh.rank, cs = sh.cs;
  const bool probit = C.a_mode == 13;
  const bool small = ng <= BS_PANEL;
  double* alpha = out;
  double* Utu = out + n;
  double* UtXb = out + 2 * n;
  const double trace_G = C.cfg[C_TRACE];
  const double sb2 = h * (1.0 - rho) / (trace_G * (1.0 - h));
  const double sa2 =
      h * rho / (trace_G * (1.0 - h) * exp(logp) * (double)C.p);
  const bool use_x = ng > 0 && rho != 0.0;
  // at most 32 active ranks the slice is staged where it fits beside
  // rank 0's inbox at the end of the region
  BsStage stg;
  stg.len = i1 - i0;
  const bool staged =
      small && (long)(ng + 3) * stg.len + (long)cs * BS_PART <= C.omw;
  stg.X = sh.om_rank[rank];
  stg.w = stg.X + (size_t)ng * stg.len;
  stg.uz = stg.w + stg.len;
  stg.ur = stg.uz + stg.len;
  double* slot = sh.inbox + rank * BS_PART;

  // the draws that wait for nothing: rank 0's z and gamma(n/2)
  if (rank == 0) {
    for (int j = tid; j < ng; j += BS_THREADS)
      sh.z[j] = philox_normal(C.key, t, stream + P_Z, j, 0);
    if (tid == BS_THREADS - 1 && !probit)
      sh.gdraw = philox_gamma(C.key, t, stream + P_TAU, 0, n / 2.0);
  }
  if (tid == 0 && !small) bs_place(C.omw, C.Om, sh, ng);
  // H's weights, log|H| and y'H^-1y over the slice
  double a1 = 0.0, a2 = 0.0;
  for (int i = i0 + tid; i < i1; i += BS_THREADS) {
    const double w = 1.0 / ((double)C.eval[i] * sb2 + 1.0);
    const double u = C.Utz[i];
    if (staged) {
      stg.w[i - i0] = w;
      stg.uz[i - i0] = u;
      stg.ur[i - i0] = philox_normal(C.key, t, stream + P_UTU, i, 0);
    } else {
      C.w_hi[i] = w;
    }
    a1 += log(w);
    a2 += w * u * u;
  }
  if (staged) {
    // BS_STAGE_LOADS loads in flight a thread before their stores
    const int all = ng * stg.len;
    for (int e0 = tid; e0 < all; e0 += BS_STAGE_LOADS * BS_THREADS) {
      double v[BS_STAGE_LOADS];
#pragma unroll
      for (int u = 0; u < BS_STAGE_LOADS; ++u) {
        const int e = e0 + u * BS_THREADS, j = e / stg.len;
        v[u] = e < all ? (double)C.UtXT[(size_t)rk[j] * n + i0 + e -
                                        j * stg.len]
                       : 0.0;
      }
#pragma unroll
      for (int u = 0; u < BS_STAGE_LOADS; ++u)
        if (e0 + u * BS_THREADS < all) stg.X[e0 + u * BS_THREADS] = v[u];
    }
  }
  const double2 s12 = bs_block_sum2(a1, a2, sh);
  if (tid == 0) {
    const double v[2] = {s12.x, s12.y};
    bs_push(cl, cs, sh.in1[rank], v, 2);
  }
  // at most 32 active ranks: the slice's partial X'WX (lower triangle)
  // and X'H^-1 y into rank 0's inbox, a thread an entry from the staged
  // slice, or else a warp an entry from global memory
  if (small) {
    const int T_ = (int)bs_tri(ng);
    if (staged) {
      for (int e = tid; e < T_ + ng; e += BS_THREADS) {
        const int j = e < T_ ? bs_tri_row(e) : e - T_;
        const double* xj = stg.X + (size_t)j * stg.len;
        const double* xk =
            e < T_ ? stg.X + (size_t)(e - bs_tri(j)) * stg.len : stg.uz;
        // four running sums, added at the end
        double acc[4] = {0.0, 0.0, 0.0, 0.0};
        int ii = 0;
        for (; ii + 4 <= stg.len; ii += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[u] += xj[ii + u] * stg.w[ii + u] * xk[ii + u];
        for (; ii < stg.len; ++ii) acc[0] += xj[ii] * stg.w[ii] * xk[ii];
        slot[e < T_ ? e : BS_TRI + j] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
    } else {
      for (int e = warp; e < T_ + ng; e += BS_WARPS) {
        const int j = e < T_ ? bs_tri_row(e) : e - T_;
        const T* xj = C.UtXT + (size_t)rk[j] * n;
        const T* xk = e < T_ ? C.UtXT + (size_t)rk[e - bs_tri(j)] * n
                             : nullptr;
        double acc = 0.0;
        for (int i = i0 + lane; i < i1; i += 32)
          acc += (double)xj[i] * C.w_hi[i] *
                 (xk ? (double)xk[i] : C.Utz[i]);
        acc = bs_warp_sum(acc);
        if (lane == 0) slot[e < T_ ? e : BS_TRI + j] = acc;
      }
    }
  }
  cl.sync();

  if (tid == 0) {
    double s1 = 0.0, s2 = 0.0;
    for (int q = 0; q < cs; ++q) {
      s1 += sh.in1[q][0];
      s2 += sh.in1[q][1];
    }
    sh.logdet_H = -s1;
    sh.hi_yy0 = s2;
  }
  if (ng > 0 && small) {
    // rank 0 adds the slices' partials in rank order into l11 and b, and
    // its warp 0 factors and solves
    if (rank == 0) {
      const int T_ = (int)bs_tri(ng);
      for (int e = tid; e < T_ + ng; e += BS_THREADS) {
        const int at = e < T_ ? e : BS_TRI + (e - T_);
        double v = 0.0;
        for (int q = 0; q < cs; ++q) v += sh.inbox[q * BS_PART + at];
        if (e < T_) {
          const int j = bs_tri_row(e), k = e - (int)bs_tri(j);
          sh.l11[j][k] = sa2 * v + (j == k ? 1.0 : 0.0);
        } else {
          sh.b[e - T_] = v;
        }
      }
      __syncthreads();
      if (warp == 0)
        bs_small_solve(cl, sh, ng, sa2, use_x, probit, out + 3 * n,
                       C.s_max, C.vec_smem);
    }
  } else if (ng > 0) {
    // every warp of the cluster: 8 x 32 blocks of Omega over all n on the
    // tensor cores, then a warp a row of X'H^-1 y
    const int g = lane >> 2, tq = lane & 3;
    const int gw = rank * BS_WARPS + warp, W = cs * BS_WARPS;
    const int RB = (ng + 7) >> 3;
    for (int J = 0, e = 0; J < RB; ++J) {
      const int kb = (J * 8 + 7) / 32 + 1;
      for (int K = 0; K < kb; ++K, ++e) {
        if (e % W != gw) continue;
        const T* a_row = C.UtXT + (size_t)rk[min(J * 8 + g, ng - 1)] * n;
        const T* b_row[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          b_row[c] =
              C.UtXT + (size_t)rk[min(K * 32 + c * 8 + g, ng - 1)] * n;
        double acc[4][2] = {};
        bs_mma_rows(a_row, b_row, C.w_hi, n, acc);
        const int j = J * 8 + g;
        if (j < ng) {
          double* oj = sh.view.row(j);
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int k = K * 32 + c * 8 + 2 * tq + hh;
              if (k <= j) oj[k] = sa2 * acc[c][hh] + (j == k ? 1.0 : 0.0);
            }
        }
      }
    }
    for (int j = gw; j < ng; j += W) {
      const T* xj = C.UtXT + (size_t)rk[j] * n;
      double acc = 0.0;
      for (int i = lane; i < n; i += 32)
        acc += (double)xj[i] * C.w_hi[i] * C.Utz[i];
      acc = bs_warp_sum(acc);
      if (lane == 0) sh.b0[j] = acc;
    }
    cl.sync();
    bs_cholesky_cluster(cl, sh, ng);
    if (rank == 0)
      bs_solves(cl, sh, ng, sa2, use_x, probit, out + 3 * n, C.s_max,
                C.vec_smem);
  } else if (rank == 0) {
    if (tid == 0) bs_push_post(cl, sh, bs_tau(sh, use_x, probit, 0.0), 0.0,
                               0.0);
    for (int j = tid; j < C.s_max; j += BS_THREADS) out[3 * n + j] = 0.0;
  }
  cl.sync();

  // UtXb, alpha and Utu over the slice
  const double tau = sh.tau;
  const double scale_u = probit ? 1.0 : sqrt(1.0 / tau);
  double a3 = 0.0, a4 = 0.0;
  for (int i = i0 + tid; i < i1; i += BS_THREADS) {
    const int ii = i - i0;
    double xb = 0.0;
    if (use_x) {
      if (staged) {
        for (int j = 0; j < ng; ++j)
          xb += sh.beta[j] * stg.X[j * stg.len + ii];
      } else {
#pragma unroll 4
        for (int j = 0; j < ng; ++j)
          xb += sh.beta[j] * (double)C.UtXT[(size_t)rk[j] * n + i];
      }
    }
    const double ev = (double)C.eval[i];
    const double d = ev * sb2;
    const double w = staged ? stg.w[ii] : C.w_hi[i];
    const double uz = staged ? stg.uz[ii] : C.Utz[i];
    const double e = staged ? stg.ur[ii]
                            : philox_normal(C.key, t, stream + P_UTU, i, 0);
    const double al = (uz - xb) * w * sb2;
    const double u = al * ev + e * sqrt(d * w) * scale_u;
    UtXb[i] = xb;
    alpha[i] = al;
    Utu[i] = u;
    a3 += xb * xb;
    a4 += u * u;
  }
  const double2 s34 = bs_block_sum2(a3, a4, sh);
  if (tid == 0) {
    const double v[2] = {s34.x, s34.y};
    bs_push(cl, cs, sh.in2[rank], v, 2);
  }
  cl.sync();
  if (tid == 0) {
    double s3 = 0.0, s4 = 0.0;
    for (int q = 0; q < cs; ++q) {
      s3 += sh.in2[q][0];
      s4 += sh.in2[q][1];
    }
    const double pge_raw = s3 / n, uu = s4 / n;
    const double P_yy = use_x ? sh.hi_yy0 - sh.quad : sh.hi_yy0;
    double pve = use_x ? pge_raw + uu : uu;
    sh.post_pge = use_x && pve != 0.0 ? pge_raw / fmax(pve, 1e-300) : 0.0;
    sh.post_pve = pve / (pve + 1.0 / tau);
    double lp = -0.5 * sh.logdet_H - (use_x ? 0.5 * sh.logdet_O : 0.0);
    lp -= probit ? 0.5 * P_yy : 0.5 * n * log(P_yy);
    lp += (ng - 1.0) * logp + (double)(C.p - ng) * log(1.0 - exp(logp));
    sh.post_logpost = lp;
  }
  __syncthreads();
}

// -bslmm 3: resample the liabilities and refresh the posterior
template <typename T>
__device__ void bs_probit_refresh(cg::cluster_group& cl, const BsChain<T>& C,
                                  BsShared& sh, unsigned t) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = C.n, i0 = sh.i0, i1 = sh.i1;
  const double* cs = C.slot[sh.cur];
  for (int i = i0 + tid; i < i1; i += BS_THREADS)
    C.vv[i] = cs[2 * n + i] + cs[n + i];
  cl.sync();
  // z_hat = U (UtXb + Utu) + mean_z on the slice's rows, a warp per row,
  // then the truncated normals
  const double mz = sh.mean_z;
  double s = 0.0;
  for (int i = i0 + warp; i < i1; i += BS_WARPS) {
    const T* Ui = C.U + (size_t)i * n;
    double acc = 0.0;
#pragma unroll 4
    for (int j = lane; j < n; j += 32) acc += (double)Ui[j] * C.vv[j];
    acc = bs_warp_sum(acc);
    if (lane == 0) {
      const double zh = acc + mz;
      const bool is_case = (double)C.ylab[i] > 0.0;
      const double x = philox_truncnorm_above(C.key, t, P_TZ, i,
                                              is_case ? -zh : zh);
      const double z = zh + (is_case ? x : -x);
      C.zv[i] = z;
      s += z;
    }
  }
  const double2 sz = bs_block_sum2(s, 0.0, sh);
  if (tid == 0) bs_push(cl, sh.cs, &sh.inz[sh.rank], &sz.x, 1);
  cl.sync();
  if (tid == 0) {
    double tot = 0.0;
    for (int q = 0; q < sh.cs; ++q) tot += sh.inz[q];
    sh.mean_new = tot / n;
  }
  __syncthreads();
  const double mean = sh.mean_new;
  // Utz = U'(z - mean) on the slice's columns: warp w takes the rows
  // i = w mod BS_WARPS, a lane 4 columns of each 128, and the warps'
  // sums meet in shared memory in order
  for (int c0 = i0; c0 < i1; c0 += 4 * 32) {
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 2
    for (int i = warp; i < n; i += BS_WARPS) {
      const double zc = C.zv[i] - mean;
      const T* Ui = C.U + (size_t)i * n;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = c0 + u * 32 + lane;
        if (j < i1) acc[u] += (double)Ui[j] * zc;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) sh.zc[warp][u * 32 + lane] = acc[u];
    __syncthreads();
    for (int k = tid; k < 4 * 32; k += BS_THREADS) {
      if (c0 + k < i1) {
        double v = 0.0;
        for (int w = 0; w < BS_WARPS; ++w) v += sh.zc[w][k];
        C.Utz[c0 + k] = v;
      }
    }
    __syncthreads();
  }
  if (tid == 0) sh.mean_z = mean;
  __syncthreads();
  bs_posterior(cl, C, sh, sh.rk, sh.ng, sh.h, sh.rho, sh.logp, t,
               BS_REFRESH, C.slot[1 - sh.cur]);
  if (tid == 0) {
    sh.cur = 1 - sh.cur;
    sh.logpost = sh.post_logpost;
    sh.pve = sh.post_pve;
    sh.pge = sh.post_pge;
  }
  __syncthreads();
}

template <typename T>
__device__ void bs_mh_step(cg::cluster_group& cl, const BsChain<T>& C,
                           BsShared& sh, unsigned t, int m) {
  const unsigned st = (unsigned)m * BS_STRIDE;
  bs_draws(C, sh, t, st);
  __syncthreads();
  if (threadIdx.x == 0) {
    const double2 uj = sh.dr_jump;
    const int repeat = uj.x < 0.33 ? 1 + (int)(uj.y * 20.0) : 1;
    bs_propose_hrp(C, sh, repeat);
    sh.lr = __dadd_rn(sh.lr, bs_propose_gamma(C, sh, t, st, repeat));
  }
  __syncthreads();
  bs_sort_new(sh);
  bs_posterior(cl, C, sh, sh.rk_eval, sh.ng_new, sh.h_n, sh.rho_n,
               sh.logp_n, t, st, C.slot[1 - sh.cur]);
  if (threadIdx.x == 0) {
    const double logmh =
        __dsub_rn(__dadd_rn(sh.lr, sh.post_logpost), sh.logpost);
    const double ua = philox_unit2(C.key, t, st + P_ACC, 0, 0).x;
    const bool acc = logmh > 0.0 || log(ua) < logmh;
    sh.accept = acc;
    if (acc) {
      sh.h = sh.h_n;
      sh.rho = sh.rho_n;
      sh.logp = sh.logp_n;
      sh.logpost = sh.post_logpost;
      sh.pve = sh.post_pve;
      sh.pge = sh.post_pge;
      sh.ng = sh.ng_new;
      sh.cur = 1 - sh.cur;
      sh.n_accept += 1;
    }
  }
  __syncthreads();
  if (sh.accept)
    for (int j = threadIdx.x; j < sh.ng; j += BS_THREADS) {
      sh.rk[j] = sh.rk_eval[j];
      sh.pg[j] = sh.pg_eval[j];
    }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(BS_THREADS, 1)
bslmm_chain_kernel(int t0, int t1, BsChain<T> C, double* scal, int* ints,
                   int* ranks, double* beta, double* alpha, double* Utu,
                   double* UtXb, double* acc_alpha, double* acc_Utu,
                   double* acc_beta, double* acc_betacnt, double* rec_hyp,
                   int* rec_gamma) {
  extern __shared__ __align__(16) unsigned char bs_smem[];
  cg::cluster_group cl = cg::this_cluster();
  BsShared& sh = *reinterpret_cast<BsShared*>(bs_smem);
  const int tid = threadIdx.x, n = C.n, S = C.s_max;
  if (tid == 0) {
    sh.cs = (int)cl.num_blocks();
    sh.rank = (int)cl.block_rank();
    sh.i0 = (int)((long)sh.rank * n / sh.cs);
    sh.i1 = (int)((long)(sh.rank + 1) * n / sh.cs);
    // the vectors and Omega's region after the fixed part
    unsigned char* p = bs_smem + gt_r16(sizeof(BsShared));
    if (C.vec_smem) {
      sh.beta = reinterpret_cast<double*>(p);
      sh.b = sh.beta + S;
      sh.x = sh.b + S;
      sh.z = sh.x + S;
      sh.pg = sh.z + S;
      sh.rk = reinterpret_cast<int*>(sh.pg + 3 * S);
      p += gt_r16((long)BS_VEC_WORDS * S);
      sh.b0 = cl.map_shared_rank(sh.b, 0);
    } else {
      sh.b = sh.b0 = C.vecg;
      sh.x = sh.beta = C.vecg + S;
      sh.z = C.vecg + 2 * S;
      sh.pg = C.pgg + (size_t)sh.rank * 3 * S;
      sh.rk = C.rkg + (size_t)sh.rank * 3 * S;
    }
    sh.pg_new = sh.pg + S;
    sh.pg_eval = sh.pg + 2 * S;
    sh.rk_new = sh.rk + S;
    sh.rk_eval = sh.rk + 2 * S;
    // this CTA's own region by its local address, the others' through
    // the cluster's window
    for (int r = 0; r < sh.cs; ++r)
      sh.om_rank[r] = r == sh.rank ? reinterpret_cast<double*>(p)
                                   : cl.map_shared_rank(
                                         reinterpret_cast<double*>(p), r);
    sh.cum_seg = (C.p + BS_CUM_IDX - 1) / BS_CUM_IDX;
    sh.cum_k = (C.p + sh.cum_seg - 1) / sh.cum_seg;
    double* inbox =
        reinterpret_cast<double*>(p) + C.omw - (long)sh.cs * BS_PART;
    sh.inbox = sh.rank == 0 ? inbox : cl.map_shared_rank(inbox, 0);
    sh.h = scal[0];
    sh.rho = scal[1];
    sh.logp = scal[2];
    sh.logpost = scal[3];
    sh.pve = scal[4];
    sh.pge = scal[5];
    sh.mean_z = scal[6];
    sh.acc_mean_z = scal[7];
    sh.ng = ints[0];
    sh.n_accept = ints[1];
    sh.w = ints[2];
    sh.cur = 0;
  }
  __syncthreads();
  const int rank = sh.rank, i0 = sh.i0, i1 = sh.i1;
  for (int j = tid; j < S; j += BS_THREADS) sh.rk[j] = ranks[j];
  for (int j = tid; j < sh.ng; j += BS_THREADS) sh.pg[j] = C.p_gamma[ranks[j]];
  for (int k = tid; k < sh.cum_k; k += BS_THREADS)
    sh.cum_idx[k] = C.cum_p[min((k + 1) * sh.cum_seg, C.p) - 1];
  if (rank == 0)
    for (int j = tid; j < S; j += BS_THREADS) C.slot[0][3 * n + j] = beta[j];
  for (int i = i0 + tid; i < i1; i += BS_THREADS) {
    C.slot[0][i] = alpha[i];
    C.slot[0][n + i] = Utu[i];
    C.slot[0][2 * n + i] = UtXb[i];
  }
  // every CTA has started before any reads another's shared memory
  cl.sync();

  for (int t = t0; t < t1; ++t) {
    if (C.a_mode == 13) bs_probit_refresh(cl, C, sh, (unsigned)t);
    for (int m = 0; m < C.n_mh; ++m) bs_mh_step(cl, C, sh, (unsigned)t, m);
    if (C.a_mode == 13 && tid == 0)
      sh.mean_z = __dadd_rn(
          sh.mean_z, __dmul_rn(philox_normal(C.key, t, P_MZ, 0, 0),
                               sqrt(1.0 / n)));
    // record every r_pace steps after burn-in (bslmm.cpp:1110-1149), and
    // never past the n_rec rows of the buffers
    if (t >= C.w_step && t % C.r_pace == 0 && sh.w < C.n_rec) {
      const double* cs = C.slot[sh.cur];
      const int ng = sh.ng, w = sh.w;
      for (int i = i0 + tid; i < i1; i += BS_THREADS) {
        acc_alpha[i] += cs[i];
        acc_Utu[i] += cs[n + i];
      }
      if (rank == 0) {
        for (int j = tid; j < ng; j += BS_THREADS) {
          const int r = sh.rk[j];
          acc_beta[r] += cs[3 * n + j];
          acc_betacnt[r] += 1.0;
          rec_gamma[(size_t)w * S + j] = r + 1;
        }
        if (tid == 0) {
          double* row = rec_hyp + (size_t)w * 6;
          row[0] = sh.h;
          row[1] = sh.pve;
          row[2] = sh.rho;
          row[3] = sh.pge;
          row[4] = sh.logp;
          row[5] = (double)ng;
        }
      }
      __syncthreads();
      if (tid == 0) {
        sh.acc_mean_z += sh.mean_z;
        sh.w = w + 1;
      }
    }
    __syncthreads();
  }

  const double* cs = C.slot[sh.cur];
  if (rank == 0) {
    for (int j = tid; j < S; j += BS_THREADS) {
      ranks[j] = j < sh.ng ? sh.rk[j] : C.p;
      beta[j] = cs[3 * n + j];
    }
    if (tid == 0) {
      scal[0] = sh.h;
      scal[1] = sh.rho;
      scal[2] = sh.logp;
      scal[3] = sh.logpost;
      scal[4] = sh.pve;
      scal[5] = sh.pge;
      scal[6] = sh.mean_z;
      scal[7] = sh.acc_mean_z;
      ints[0] = sh.ng;
      ints[1] = sh.n_accept;
      ints[2] = sh.w;
      ints[3] = sh.cs;
    }
  }
  for (int i = i0 + tid; i < i1; i += BS_THREADS) {
    alpha[i] = cs[i];
    Utu[i] = cs[n + i];
    UtXb[i] = cs[2 * n + i];
  }
  // no CTA leaves while another may still read its shared memory
  cl.sync();
}

// the scratch layout of models/bslmm.py chain_scratch (float64 words)
template <typename T>
static void bs_carve(BsChain<T>& C, void* work, int n, int s_max, int cs) {
  double* wk = (double*)work;
  C.slot[0] = wk;
  C.slot[1] = wk + 3 * n + s_max;
  wk += 2 * (3L * n + s_max);
  C.w_hi = wk;
  C.zv = wk + n;
  C.vv = wk + 2 * n;
  wk += 3L * n;
  C.Om = wk;
  wk += bs_tri(s_max);
  C.vecg = wk;
  wk += 3L * s_max;
  C.pgg = wk;
  wk += 3L * s_max * cs;
  C.rkg = (int*)wk;
}

// bytes of shared memory each CTA takes: all that a block may opt in to
static int bs_smem_bytes() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

template <typename T>
static int bslmm_chain_run(int t0, int t1, int n, int p, int s_max, int s_min,
                           int n_mh, int a_mode, int w_step, int r_pace,
                           unsigned long long seed, const void* cfg,
                           const void* UtXT, const void* eval,
                           const void* cum_p, const void* p_gamma,
                           const void* U, const void* ylab, void* scal,
                           void* ints, void* ranks, void* beta, void* alpha,
                           void* Utu, void* UtXb, void* Utz, void* acc_alpha,
                           void* acc_Utu, void* acc_beta, void* acc_betacnt,
                           void* rec_hyp, void* rec_gamma, int n_rec,
                           void* work, void* stream) {
  BsChain<T> C;
  C.n_rec = n_rec;
  C.n = n;
  C.p = p;
  C.s_max = s_max;
  C.s_min = s_min;
  C.n_mh = n_mh;
  C.a_mode = a_mode;
  C.w_step = w_step;
  C.r_pace = r_pace;
  C.key.k0 = (unsigned)(seed & 0xFFFFFFFFull);
  C.key.k1 = (unsigned)(seed >> 32);
  C.cfg = (const double*)cfg;
  C.UtXT = (const T*)UtXT;
  C.eval = (const T*)eval;
  C.cum_p = (const double*)cum_p;
  C.p_gamma = (const double*)p_gamma;
  C.U = (const T*)U;
  C.ylab = (const T*)ylab;
  C.Utz = (double*)Utz;
  const int smem = bs_smem_bytes();
  const long fixed = gt_r16(sizeof(BsShared));
  C.vec_smem = (long)BS_VEC_WORDS * s_max <= BS_VEC_SMEM;
  const long vec = C.vec_smem ? gt_r16((long)BS_VEC_WORDS * s_max) : 0;
  C.omw = (smem - fixed - vec) / 8;
  // the Omega region holds rank 0's inbox and one panel beside it
  if (C.omw < (long)BS_CLUSTER_WIDE * BS_PART + BS_TRI)
    return (int)cudaErrorInvalidValue;

  auto kern = bslmm_chain_kernel<T>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                       1);
  cudaLaunchConfig_t lc = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.blockDim = dim3(BS_THREADS);
  lc.dynamicSmemBytes = smem;
  lc.stream = (cudaStream_t)stream;
  lc.attrs = attr;
  lc.numAttrs = 1;
  // the widest cluster the card schedules with this shared memory
  int cs = BS_CLUSTER_WIDE, nc = 0;
  attr[0].val.clusterDim.x = cs;
  lc.gridDim = dim3(cs);
  if (cudaOccupancyMaxActiveClusters(&nc, kern, &lc) != cudaSuccess ||
      nc < 1) {
    cudaGetLastError();
    cs = BS_CLUSTER;
    attr[0].val.clusterDim.x = cs;
    lc.gridDim = dim3(cs);
  }
  bs_carve(C, work, n, s_max, BS_CLUSTER_WIDE);
  return (int)cudaLaunchKernelEx(
      &lc, kern, t0, t1, C, (double*)scal, (int*)ints, (int*)ranks,
      (double*)beta, (double*)alpha, (double*)Utu, (double*)UtXb,
      (double*)acc_alpha, (double*)acc_Utu, (double*)acc_beta,
      (double*)acc_betacnt, (double*)rec_hyp, (int*)rec_gamma);
}

#define BS_ENTRY(name, T)                                                    \
  extern "C" int name(                                                       \
      int t0, int t1, int n, int p, int s_max, int s_min, int n_mh,          \
      int a_mode, int w_step, int r_pace, unsigned long long seed,           \
      const void* cfg, const void* UtXT, const void* eval,                   \
      const void* cum_p, const void* p_gamma, const void* U,                 \
      const void* ylab, void* scal, void* ints, void* ranks, void* beta,     \
      void* alpha, void* Utu, void* UtXb, void* Utz, void* acc_alpha,        \
      void* acc_Utu, void* acc_beta, void* acc_betacnt, void* rec_hyp,       \
      void* rec_gamma, int n_rec, void* work, void* stream) {                \
    return bslmm_chain_run<T>(t0, t1, n, p, s_max, s_min, n_mh, a_mode,      \
                              w_step, r_pace, seed, cfg, UtXT, eval, cum_p,  \
                              p_gamma, U, ylab, scal, ints, ranks, beta,     \
                              alpha, Utu, UtXb, Utz, acc_alpha, acc_Utu,     \
                              acc_beta, acc_betacnt, rec_hyp, rec_gamma,     \
                              n_rec, work, stream);                          \
  }

BS_ENTRY(bslmm_chain_launch, float)
BS_ENTRY(bslmm_chain_f64_launch, double)
GT_ERROR_FN(bslmm_chain)
