// K12 — the BSLMM Metropolis-Hastings chain: a whole segment of
// iterations in one thread block (bslmm_chain_launch, float32 operands;
// bslmm_chain_f64_launch, float64 operands; float64 arithmetic in both).
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
// The chain is sequential: iteration t + 1 starts from t's state.  One
// block of BS_THREADS threads runs iterations [t0, t1) with the state in
// shared memory (scalars, the active ranks) and in the block's own global
// buffers (the n- and s_max-vectors, L2-resident):
//   * thread 0 draws the proposals — (h, rho, log pi) by reflected steps,
//     gamma by add/remove/swap with the reference's corrections, a new
//     rank by binary search of the float64 cumulative p_gamma and
//     rejection against the active set — with explicitly rounded
//     operations in the plain version's order, so the two propose
//     alike;
//   * the block sorts the proposed ranks (each thread counts the smaller
//     ones: ranks are distinct) and evaluates the posterior: one pass over
//     n for H's weights, log|H| and y'H^-1y; Omega = sigma_a2 X'WX + I and
//     X'Wy by a warp per row over n, eight columns a pass (UtXT holds a
//     rank's row contiguously); a right-looking Cholesky of the n_gamma x
//     n_gamma Omega in global scratch (the reference pads to s_max with
//     an identity block, which adds nothing); the triangular solves by
//     warp 0; UtXb, alpha and Utu, one thread per individual;
//   * the proposal goes to the second of two state slots, and an
//     accepted one swaps them;
//   * -bslmm 3 (a_mode 13) first resamples the latent liabilities:
//     z_hat = U (UtXb + Utu) + mean_z by a warp per row, truncated normals
//     (philox.cuh), Utz = U'(z - mean) by a thread per column (2 n²
//     multiply-adds an iteration, U read from L2), then refreshes the
//     posterior;
//   * every r_pace-th iteration after burn-in the block records the
//     hyper-parameters, the ranks and the running sums.
// Bound: operations, per iteration about n n_gamma² (Omega) + n_gamma³/3
// (Cholesky) + 20 n float64 operations, bytes n n_gamma (the active rows)
// + 10 n words; a chain is sequential and fills one SM, so it sits far
// above a whole-card bound.  Several chains or several blocks per
// iteration are later work.
#include "common.cuh"
#include "philox.cuh"

#define BS_THREADS 512
#define BS_WARPS (BS_THREADS / 32)
#define BS_MAX_S 1024   // largest s_max (kernels.MAX_S_MAX)
#define BS_TILE 8       // Omega columns a warp sums in one pass over n

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

struct BsShared {
  int rk[BS_MAX_S];      // the state's active ranks (first ng), sorted
  int rk_new[BS_MAX_S];  // the proposal's
  int rk_tmp[BS_MAX_S];
  double red[BS_WARPS + 1];
  // state
  double h, rho, logp, logpost, pve, pge, mean_z, acc_mean_z;
  int ng, n_accept, w, cur;
  // proposal and posterior
  double h_n, rho_n, logp_n, lr;
  int ng_new, accept;
  double post_logpost, post_pve, post_pge;
  double tau, logdet_O, quad;
};

template <typename T>
struct BsChain {
  int n, p, s_max, s_min, n_mh, a_mode, w_step, r_pace, n_rec;
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
  double* Om;       // s_max x s_max, row-major
  double* b;        // X'H^-1 y
  double* bh;       // beta_hat
  double* zz;
};

__device__ __forceinline__ double bs_warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sum of v (every thread gets it)
__device__ double bs_block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = bs_warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < BS_WARPS ? red[lane] : 0.0;
    v = bs_warp_sum(v);
    if (lane == 0) red[BS_WARPS] = v;
  }
  __syncthreads();
  const double r = red[BS_WARPS];
  __syncthreads();
  return r;
}

__device__ __forceinline__ double bs_reflect(double x, double lo, double hi) {
  if (x < lo) x = __dsub_rn(__dmul_rn(2.0, lo), x);
  if (x > hi) x = __dsub_rn(__dmul_rn(2.0, hi), x);
  return x;
}

// (h, rho, log pi) moved `repeat` times (thread 0)
template <typename T>
__device__ void bs_propose_hrp(const BsChain<T>& C, BsShared& sh, unsigned t,
                               unsigned st, int repeat) {
  double h = sh.h, rho = sh.rho, logp = sh.logp, lr = 0.0;
  for (int i = 0; i < repeat; ++i) {
    const double2 u = philox_unit2(C.key, t, st + P_H, i, 0);
    const double ul = philox_unit2(C.key, t, st + P_LOGP, i, 0).x;
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

// a rank from p_gamma not among rk[0..ng) (thread 0)
template <typename T>
__device__ int bs_new_rank(const BsChain<T>& C, const int* rk, int ng,
                           unsigned t, unsigned st, int i) {
  for (unsigned k = 0;; ++k) {
    const double u = philox_unit2(C.key, t, st + P_ADD, i, k).x;
    int lo = 0, hi = C.p;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (C.cum_p[mid] < u)
        lo = mid + 1;
      else
        hi = mid;
    }
    const int r = min(lo, C.p - 1);
    bool present = false;
    for (int j = 0; j < ng; ++j) present |= rk[j] == r;
    if (!present) return r;
  }
}

// add/remove/swap `repeat` times into rk_new (thread 0); returns log q
template <typename T>
__device__ double bs_propose_gamma(const BsChain<T>& C, BsShared& sh,
                                   unsigned t, unsigned st, int repeat) {
  int* rk = sh.rk_new;
  int ng = sh.ng;
  for (int j = 0; j < ng; ++j) rk[j] = sh.rk[j];
  const double* pg = C.p_gamma;
  double logmh = 0.0;
  for (int i = 0; i < repeat; ++i) {
    const double2 u = philox_unit2(C.key, t, st + P_FLAG, i, 0);
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
    for (int j = 0; j < ng; ++j) prob_act = __dadd_rn(prob_act, pg[rk[j]]);
    int r_add = 0, col = 0, r_rem = 0;
    if (flag != 2) r_add = bs_new_rank(C, rk, ng, t, st, i);
    if (flag != 1) {
      col = (int)(u.y * (double)ng);
      r_rem = rk[col];
    }
    if (flag == 1) {
      const double tot = __dsub_rn(1.0, prob_act);
      logmh = __dadd_rn(logmh, __dsub_rn(-log(pg[r_add] / tot),
                                         log((double)ng + 1.0)));
      rk[ng++] = r_add;
    } else if (flag == 2) {
      const double tot = __dadd_rn(__dsub_rn(1.0, prob_act), pg[r_rem]);
      logmh = __dadd_rn(logmh, __dadd_rn(log(pg[r_rem] / tot),
                                         log(fmax((double)ng, 1.0))));
      rk[col] = rk[ng - 1];
      --ng;
    } else {
      const double tot = __dsub_rn(1.0, prob_act);
      logmh = __dadd_rn(
          logmh,
          __dsub_rn(log(pg[r_rem] /
                        __dsub_rn(__dadd_rn(tot, pg[r_rem]), pg[r_add])),
                    log(pg[r_add] / tot)));
      rk[col] = r_add;
    }
  }
  sh.ng_new = ng;
  return logmh;
}

// sort rk_new[0..ng_new) ascending (the block; ranks are distinct)
__device__ void bs_sort_new(BsShared& sh) {
  const int ng = sh.ng_new;
  for (int j = threadIdx.x; j < ng; j += BS_THREADS) {
    const int r = sh.rk_new[j];
    int pos = 0;
    for (int i = 0; i < ng; ++i) pos += sh.rk_new[i] < r;
    sh.rk_tmp[pos] = r;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ng; j += BS_THREADS) sh.rk_new[j] = sh.rk_tmp[j];
  __syncthreads();
}

// the marginal posterior at (rk[0..ng), h, rho, logp) with draws at
// (t, stream); writes the slot `out` and sh.post_*, sh.tau (the block)
template <typename T>
__device__ void bs_posterior(const BsChain<T>& C, BsShared& sh, const int* rk,
                             int ng, double h, double rho, double logp,
                             unsigned t, unsigned stream, double* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = C.n, S = C.s_max;
  const bool probit = C.a_mode == 13;
  double* alpha = out;
  double* Utu = out + n;
  double* UtXb = out + 2 * n;
  double* beta = out + 3 * n;
  double* Om = C.Om;
  const double trace_G = C.cfg[C_TRACE];
  const double sb2 = h * (1.0 - rho) / (trace_G * (1.0 - h));
  const double sa2 =
      h * rho / (trace_G * (1.0 - h) * exp(logp) * (double)C.p);
  const bool use_x = ng > 0 && rho != 0.0;

  double a1 = 0.0, a2 = 0.0;
  for (int i = tid; i < n; i += BS_THREADS) {
    const double w = 1.0 / ((double)C.eval[i] * sb2 + 1.0);
    C.w_hi[i] = w;
    const double u = C.Utz[i];
    a1 += log(w);
    a2 += w * u * u;
  }
  const double logdet_H = -bs_block_sum(a1, sh.red);
  const double hi_yy0 = bs_block_sum(a2, sh.red);

  // Omega's lower triangle (j >= k), a warp per row j and BS_TILE
  // columns at a time (one pass over n reads x_j once for the tile), and
  // X'H^-1 y, a warp per entry
  for (int j = warp; j < ng; j += BS_WARPS) {
    const T* xj = C.UtXT + (size_t)rk[j] * n;
    for (int k0 = 0; k0 <= j; k0 += BS_TILE) {
      const int kn = min(BS_TILE, j + 1 - k0);
      const T* xk[BS_TILE];
#pragma unroll
      for (int c = 0; c < BS_TILE; ++c)
        xk[c] = C.UtXT + (size_t)rk[k0 + (c < kn ? c : 0)] * n;
      double acc[BS_TILE];
#pragma unroll
      for (int c = 0; c < BS_TILE; ++c) acc[c] = 0.0;
      for (int i = lane; i < n; i += 32) {
        const double xw = (double)xj[i] * C.w_hi[i];
#pragma unroll
        for (int c = 0; c < BS_TILE; ++c)
          if (c < kn) acc[c] += xw * (double)xk[c][i];
      }
#pragma unroll
      for (int c = 0; c < BS_TILE; ++c) {
        const double v = bs_warp_sum(acc[c]);
        if (lane == 0 && c < kn)
          Om[j * S + k0 + c] = sa2 * v + (j == k0 + c ? 1.0 : 0.0);
      }
    }
    double acc = 0.0;
    for (int i = lane; i < n; i += 32)
      acc += (double)xj[i] * C.w_hi[i] * C.Utz[i];
    acc = bs_warp_sum(acc);
    if (lane == 0) {
      C.b[j] = acc;
      C.bh[j] = acc;
    }
  }
  __syncthreads();

  // Cholesky of Omega in place (lower), right-looking
  for (int k = 0; k < ng; ++k) {
    if (tid == 0) Om[k * S + k] = sqrt(Om[k * S + k]);
    __syncthreads();
    const double dkk = Om[k * S + k];
    for (int i = k + 1 + tid; i < ng; i += BS_THREADS) Om[i * S + k] /= dkk;
    __syncthreads();
    const int m = ng - k - 1;
    for (int e = tid; e < m * m; e += BS_THREADS) {
      const int i = k + 1 + e / m, j = k + 1 + e % m;
      if (j <= i) Om[i * S + j] -= Om[i * S + k] * Om[j * S + k];
    }
    __syncthreads();
  }

  // beta_hat = sa2 Omega^-1 X'H^-1 y, log|Omega| and the quadratic form
  if (warp == 0) {
    double* x = C.bh;
    for (int k = 0; k < ng; ++k) {
      const double yk = x[k] / Om[k * S + k];
      __syncwarp();
      if (lane == 0) x[k] = yk;
      for (int i = k + 1 + lane; i < ng; i += 32) x[i] -= Om[i * S + k] * yk;
      __syncwarp();
    }
    for (int k = ng - 1; k >= 0; --k) {
      const double xk = x[k] / Om[k * S + k];
      __syncwarp();
      if (lane == 0) x[k] = xk;
      for (int i = lane; i < k; i += 32) x[i] -= Om[k * S + i] * xk;
      __syncwarp();
    }
    double ld = 0.0, qd = 0.0;
    for (int j = lane; j < ng; j += 32) {
      x[j] *= sa2;
      ld += log(Om[j * S + j]);
      qd += C.b[j] * x[j];
    }
    ld = bs_warp_sum(ld);
    qd = bs_warp_sum(qd);
    if (lane == 0) {
      sh.logdet_O = 2.0 * ld;
      sh.quad = qd;
      const double P_yy = use_x ? hi_yy0 - qd : hi_yy0;
      sh.tau = probit ? 1.0
                      : philox_gamma(C.key, t, stream + P_TAU, 0, n / 2.0) *
                            (2.0 / P_yy);
    }
    __syncwarp();
    // beta = beta_hat + sqrt(sa2 / tau) L^-T z
    double* z = C.zz;
    for (int j = lane; j < ng; j += 32)
      z[j] = philox_normal(C.key, t, stream + P_Z, j, 0);
    __syncwarp();
    for (int k = ng - 1; k >= 0; --k) {
      const double xk = z[k] / Om[k * S + k];
      __syncwarp();
      if (lane == 0) z[k] = xk;
      for (int i = lane; i < k; i += 32) z[i] -= Om[k * S + i] * xk;
      __syncwarp();
    }
    const double sc = sqrt(sa2 / sh.tau);
    for (int j = lane; j < S; j += 32)
      beta[j] = j < ng ? z[j] * sc + x[j] : 0.0;
  }
  __syncthreads();

  const double tau = sh.tau;
  const double scale_u = probit ? 1.0 : sqrt(1.0 / tau);
  double a3 = 0.0, a4 = 0.0;
  for (int i = tid; i < n; i += BS_THREADS) {
    double xb = 0.0;
    if (use_x) {
#pragma unroll 4
      for (int j = 0; j < ng; ++j)
        xb += beta[j] * (double)C.UtXT[(size_t)rk[j] * n + i];
    }
    const double ev = (double)C.eval[i];
    const double d = ev * sb2, w = C.w_hi[i];
    const double al = (C.Utz[i] - xb) * w * sb2;
    const double ur =
        philox_normal(C.key, t, stream + P_UTU, i, 0) * sqrt(d * w);
    const double u = al * ev + ur * scale_u;
    UtXb[i] = xb;
    alpha[i] = al;
    Utu[i] = u;
    a3 += xb * xb;
    a4 += u * u;
  }
  const double pge_raw = bs_block_sum(a3, sh.red) / n;
  const double uu = bs_block_sum(a4, sh.red) / n;
  if (tid == 0) {
    const double P_yy = use_x ? hi_yy0 - sh.quad : hi_yy0;
    double pve = use_x ? pge_raw + uu : uu;
    sh.post_pge = use_x && pve != 0.0 ? pge_raw / fmax(pve, 1e-300) : 0.0;
    sh.post_pve = pve / (pve + 1.0 / tau);
    double lp = -0.5 * logdet_H - (use_x ? 0.5 * sh.logdet_O : 0.0);
    lp -= probit ? 0.5 * P_yy : 0.5 * n * log(P_yy);
    lp += (ng - 1.0) * logp + (double)(C.p - ng) * log(1.0 - exp(logp));
    sh.post_logpost = lp;
  }
  __syncthreads();
}

// -bslmm 3: resample the liabilities and refresh the posterior
template <typename T>
__device__ void bs_probit_refresh(const BsChain<T>& C, BsShared& sh,
                                  unsigned t) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = C.n;
  const double* cs = C.slot[sh.cur];
  for (int i = tid; i < n; i += BS_THREADS) C.vv[i] = cs[2 * n + i] + cs[n + i];
  __syncthreads();
  const double mz = sh.mean_z;
  for (int i = warp; i < n; i += BS_WARPS) {
    const T* Ui = C.U + (size_t)i * n;
    double acc = 0.0;
    for (int j = lane; j < n; j += 32) acc += (double)Ui[j] * C.vv[j];
    acc = bs_warp_sum(acc);
    if (lane == 0) C.zv[i] = acc + mz;
  }
  __syncthreads();
  double s = 0.0;
  for (int i = tid; i < n; i += BS_THREADS) {
    const double zh = C.zv[i];
    const bool is_case = (double)C.ylab[i] > 0.0;
    const double x = philox_truncnorm_above(C.key, t, P_TZ, i,
                                            is_case ? -zh : zh);
    const double z = zh + (is_case ? x : -x);
    C.zv[i] = z;
    s += z;
  }
  const double mean = bs_block_sum(s, sh.red) / n;
  for (int j = tid; j < n; j += BS_THREADS) {
    double acc = 0.0;
    for (int i = 0; i < n; ++i)
      acc += (double)C.U[(size_t)i * n + j] * (C.zv[i] - mean);
    C.Utz[j] = acc;
  }
  if (tid == 0) sh.mean_z = mean;
  __syncthreads();
  bs_posterior(C, sh, sh.rk, sh.ng, sh.h, sh.rho, sh.logp, t, BS_REFRESH,
               C.slot[1 - sh.cur]);
  if (tid == 0) {
    sh.cur = 1 - sh.cur;
    sh.logpost = sh.post_logpost;
    sh.pve = sh.post_pve;
    sh.pge = sh.post_pge;
  }
  __syncthreads();
}

template <typename T>
__device__ void bs_mh_step(const BsChain<T>& C, BsShared& sh, unsigned t,
                           int m) {
  const unsigned st = (unsigned)m * BS_STRIDE;
  if (threadIdx.x == 0) {
    const double2 uj = philox_unit2(C.key, t, st + P_JUMP, 0, 0);
    const int repeat = uj.x < 0.33 ? 1 + (int)(uj.y * 20.0) : 1;
    bs_propose_hrp(C, sh, t, st, repeat);
    sh.lr = __dadd_rn(sh.lr, bs_propose_gamma(C, sh, t, st, repeat));
  }
  __syncthreads();
  bs_sort_new(sh);
  bs_posterior(C, sh, sh.rk_new, sh.ng_new, sh.h_n, sh.rho_n, sh.logp_n, t,
               st, C.slot[1 - sh.cur]);
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
    for (int j = threadIdx.x; j < sh.ng; j += BS_THREADS)
      sh.rk[j] = sh.rk_new[j];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(BS_THREADS)
bslmm_chain_kernel(int t0, int t1, BsChain<T> C, double* scal, int* ints,
                   int* ranks, double* beta, double* alpha, double* Utu,
                   double* UtXb, double* acc_alpha, double* acc_Utu,
                   double* acc_beta, double* acc_betacnt, double* rec_hyp,
                   int* rec_gamma) {
  __shared__ BsShared sh;
  const int tid = threadIdx.x, n = C.n, S = C.s_max;
  if (tid == 0) {
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
  for (int j = tid; j < S; j += BS_THREADS) {
    sh.rk[j] = ranks[j];
    C.slot[0][3 * n + j] = beta[j];
  }
  for (int i = tid; i < n; i += BS_THREADS) {
    C.slot[0][i] = alpha[i];
    C.slot[0][n + i] = Utu[i];
    C.slot[0][2 * n + i] = UtXb[i];
  }
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    if (C.a_mode == 13) bs_probit_refresh(C, sh, (unsigned)t);
    for (int m = 0; m < C.n_mh; ++m) bs_mh_step(C, sh, (unsigned)t, m);
    if (C.a_mode == 13 && tid == 0)
      sh.mean_z = __dadd_rn(
          sh.mean_z, __dmul_rn(philox_normal(C.key, t, P_MZ, 0, 0),
                               sqrt(1.0 / n)));
    // record every r_pace steps after burn-in (bslmm.cpp:1110-1149), and
    // never past the n_rec rows of the buffers
    if (t >= C.w_step && t % C.r_pace == 0 && sh.w < C.n_rec) {
      const double* cs = C.slot[sh.cur];
      const int ng = sh.ng, w = sh.w;
      for (int i = tid; i < n; i += BS_THREADS) {
        acc_alpha[i] += cs[i];
        acc_Utu[i] += cs[n + i];
      }
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
        sh.acc_mean_z += sh.mean_z;
      }
      __syncthreads();
      if (tid == 0) sh.w = w + 1;
    }
    __syncthreads();
  }

  const double* cs = C.slot[sh.cur];
  for (int j = tid; j < S; j += BS_THREADS) {
    ranks[j] = j < sh.ng ? sh.rk[j] : C.p;
    beta[j] = cs[3 * n + j];
  }
  for (int i = tid; i < n; i += BS_THREADS) {
    alpha[i] = cs[i];
    Utu[i] = cs[n + i];
    UtXb[i] = cs[2 * n + i];
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
  }
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
  if (s_max > BS_MAX_S) return (int)cudaErrorInvalidValue;
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
  // the scratch layout of models/bslmm.py chain_scratch
  double* wk = (double*)work;
  C.slot[0] = wk;
  C.slot[1] = wk + 3 * n + s_max;
  wk += 2 * (3 * n + s_max);
  C.w_hi = wk;
  C.zv = wk + n;
  C.vv = wk + 2 * n;
  wk += 3 * n;
  C.Om = wk;
  wk += (size_t)s_max * s_max;
  C.b = wk;
  C.bh = wk + s_max;
  C.zz = wk + 2 * s_max;
  bslmm_chain_kernel<T><<<1, BS_THREADS, 0, (cudaStream_t)stream>>>(
      t0, t1, C, (double*)scal, (int*)ints, (int*)ranks, (double*)beta,
      (double*)alpha, (double*)Utu, (double*)UtXb, (double*)acc_alpha,
      (double*)acc_Utu, (double*)acc_beta, (double*)acc_betacnt,
      (double*)rec_hyp, (int*)rec_gamma);
  return (int)cudaGetLastError();
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
