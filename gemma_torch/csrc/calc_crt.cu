// K14 — the mvLMM small-sample (Edgeworth) correction factors of -crt.
//
// Replaces the reference package's device program
//   gemma_tpu/models/mvlmm_core.py:681 calc_crt (a vmap of _calc_crt_one
//   :561, CalcCRT mvlmm.cpp:2054-2330), called from
//   gemma_tpu/models/mvlmm.py:322 _crt_block on the lanes -pnr refines.
// Its plain version is gemma_torch/models/mvlmm_core.py (_crt_lanes).
//
// Each lane sits at its Newton optimum (Vg, Ve) with Hvar = -H^-1 from
// K11.  The reference forms the (v, cd, cd) stacks of first- and
// second-derivative sandwiches and takes whole (cd, cd) products; every
// trace it needs reads only the SNP block's rows s of Q^-1, so with Qs =
// Qi[s, :], R_k = Qs (x_k ⊗ I), P_k = R_k Hi_k, Z = (Qi_ss)^-1 and F_k =
// P_k' Z P_k the kernel needs over the n individuals only three weighted
// products (δ_k^p the weights, D_v the vech basis):
//   G_p = P' diag(δ^p) P over the rows vec(P_k)        p = 0, 1 (d² × d²),
//       whence SS_p[v] = Σ_k δ_k^p P_k D_v P_k'
//   T_p = Hi' diag(δ^p) F over the vech rows of Hi_k, F_k   p = 0, 1, 2
//   L_p = X' diag(δ^p) W over the rows W_k[v] = P_k D_v Hi_k  p = 0, 1
//       (c × v d², i.e. L_p[v] = Σ_k δ_k^p x_k' ⊗ (P_k D_v Hi_k))
// and then, per lane, C_p[v] = SS_p[v] Z, Y_p[v] = Qi (L_p[v]' Z) and the
// traces of each pair v1 <= v2: tr(L_1 Y_2), tr(D_1 Hi D_2 F) from T and
// tr(C_1 C_2).  GEMMA's quirks stay: MM_ge in the single product order
// with trB_ge's 2x, and the v1 != v2 terms doubled with the same h
// (one thread sums the pairs in the reference's order).
//
// Bound: operations, most of them the products.  The design spreads a
// lane over the card in six stages, each a launch over (lane, part), all
// on the caller's stream:
//  1 prologue (a block a lane): EigenProc on the block (Jacobi on a warp),
//    the d whitened Gram blocks a warp a sum, their c×c inverses a warp
//    each (the adjugate on a thread at c <= 2), Qi, its rows Qs and Z;
//    its work in shared memory where it fits, else in the lane's scratch.
//  2 build (lane, chunk of individuals): Hi_k, P_k and F_k of each
//    individual, once, into the lane's scratch.
//  3 products (lane, 32 × 32 tile of one family): each family's rows
//    (δ^p folded in: 2c of X, 2d² of P, 3v of Hi's vech) against its
//    columns (v d² of W, d² of P, v of F's vech), both padded to whole
//    tiles, so a block runs one family's gathers without divergence.  A
//    stage of CRT_KC individuals is gathered into shared memory, a lane a
//    row or column within an individual's contiguous P_k, Hi_k, F_k (X's
//    rows a lane an individual), W_k's entries built there from P_k and
//    Hi_k (each once a lane where 2c <= 32), then multiplied on the FP64
//    tensor cores: mma.sync m8n8k4 (DMMA), four warps of 2 × 2 m8n8
//    tiles, IEEE float64 products and sums.
//  4 C and Y (lane, a run of (p, v)): SS_p[v] from G_p, C = SS Z (kept
//    also transposed), LZ = L_p[v]' Z once, then Y = Qi LZ, stored
//    transposed.
//  5 pair traces (lane, CRT_PAIRS pairs): a warp a pair, tr(L_1 Y_2) and
//    tr(C_1 C_2) as lane-strided dot products of contiguous arrays (the
//    four (p1, p2) in one pass), reduced by a fixed butterfly.
//  6 the correction factors (a block a lane): the pairs staged in shared
//    memory a chunk at a time, one thread summing them in order.
// Every output's sum runs in one fixed order that depends on (n, d, c)
// alone, so a call split into launches equals the unsplit call bit for
// bit.  float64 operands and arithmetic: -crt runs in float64 (ROADMAP
// §C18).  A singular Qi_ss gives inf/NaN, as the reference's LU inverse:
// nothing is clamped.
//
// Lanes [s0, s0 + count) of a launch; the scratch holds `count` lanes
// (calc_crt_lane_bytes a lane; the wrapper splits a block's lanes under a
// byte budget).
#include "mvlmm_lane.cuh"

#define CRT_THREADS 128
#define CRT_WARPS (CRT_THREADS / 32)
#define CRT_TILE 32        // rows and columns of a product tile
#define CRT_KC 32          // individuals a product stage
#define CRT_PAD 4          // staged rows CRT_TILE + 4 doubles apart
#define CRT_BUILD 1024     // doubles of one staged array of a build block
#define CRT_PAIRS 16       // pairs a block of the trace stage
#define CRT_CY_WORK 65536  // multiply-adds of a block of the C and Y stage
#define CRT_FIN 256        // pairs a chunk of the last stage
#define CRT_SMEM_MAX (227 * 1024)
#define CRT_STATIC_SMEM (48 * 1024)

// phase marks (scripts/k2_k14_phase_profile.py, -DGT_PROFILE): thread 0
// of each block of each stage
#define CRT_PH_ALG 0     // the lane's serial algebra: EigenProc, inverses, Z
#define CRT_PH_SETUP 1   // the Gram blocks, Qi and Qs on the block
#define CRT_PH_BUILD 2   // building each individual's operands
#define CRT_PH_SUMS 3    // the products over n
#define CRT_PH_CY 4      // C = SS Z and Y = Qi (L' Z)
#define CRT_PH_PAIR 5    // the pair traces
#define CRT_PH_FINAL 6   // the sums over the pairs

// one lane's shapes and the offsets (doubles) of its scratch, computed on
// the host and passed to every stage
struct CrtLay {
  int n, d, c, vs, dd, cd, tc, kb, nchunk, npv, pro_smem;
  long npair, nt, pro_len;
  // the product families (L, SS, T): rows, columns and 32 × 32 tiles
  int fr[3], fc[3], ft[3];
  long pro, AD, Wt, Qi, Qs, Z, P, H, F, G, T, L, C, Ct, LZ, Y, pair, tmp,
      len;
  __host__ __device__ CrtLay(int n_, int d_, int c_) {
    n = n_;
    d = d_;
    c = c_;
    vs = d * (d + 1) / 2;
    dd = d * d;
    cd = c * d;
    tc = c * (c + 1) / 2;
    npair = (long)vs * (vs + 1) / 2;
    // individuals of a build block: four staged d×d arrays of kb each
    kb = CRT_BUILD / dd < 1 ? 1 : CRT_BUILD / dd;
    nchunk = (n + kb - 1) / kb;
    // (p, v) of a block of the C and Y stage: Y's cd² d multiply-adds each
    npv = (int)(CRT_CY_WORK / ((long)cd * cd * d));
    npv = npv < 1 ? 1 : (npv > 2 * vs ? 2 * vs : npv);
    fr[0] = 2 * c;          // δ^p x_b
    fc[0] = vs * dd;        // W_k[v][a][e]
    fr[1] = 2 * dd;         // δ^p P[a][i]
    fc[1] = dd;             // P[b][j]
    fr[2] = 3 * vs;         // δ^p Hi vech
    fc[2] = vs;             // F vech
    nt = 0;
    for (int f = 0; f < 3; ++f) {
      ft[f] = ((fr[f] + CRT_TILE - 1) / CRT_TILE) *
              ((fc[f] + CRT_TILE - 1) / CRT_TILE);
      nt += ft[f];
    }
    // the prologue's work: the state's matrices, the team frame of
    // EigenProc, the Gram blocks, a warp's inverse work, Qi_ss
    pro_len = mv_state_len(d, c) + 8L * dd + 5L * d + (long)d * tc +
              (long)CRT_WARPS * (c * c + c) + dd;
    pro_smem = 8 * pro_len <= CRT_SMEM_MAX;
    pro = 0;
    AD = pro + pro_len;
    Wt = AD + dd + d;              // the weights 1 / (D_l δ_k + 1), (d, n)
    Qi = Wt + (long)d * n;
    Qs = Qi + (long)cd * cd;
    Z = Qs + (long)d * cd;
    P = Z + dd;
    H = P + (long)n * dd;
    F = H + (long)n * dd;
    G = F + (long)n * dd;
    T = G + 2L * dd * dd;
    L = T + 3L * vs * vs;
    C = L + 2L * vs * d * cd;
    Ct = C + 2L * vs * dd;         // C_p[v] transposed
    LZ = Ct + 2L * vs * dd;
    Y = LZ + 2L * vs * cd * d;
    pair = Y + 2L * vs * cd * d;
    tmp = pair + 6 * npair;
    len = tmp + (build_smem() ? 0 : build_len() * nchunk);
  }
  // doubles of a build block's staged arrays: Hi, R, P, Z P and the
  // weights 1 / (D_l δ_k + 1); whether they fit shared memory
  __host__ __device__ long build_len() const {
    return 4L * kb * dd + (long)kb * d;
  }
  __host__ __device__ bool build_smem() const {
    return 8 * build_len() <= CRT_SMEM_MAX;
  }
};

struct CrtArgs {
  int S, n, d, c0, r, s0;
  const double *eval, *X0, *R, *Vg, *Ve, *Hvar;
  double *scratch, *out;
  CrtLay ly;
};

__device__ __forceinline__ void crt_dmma(double& c0, double& c1, double a,
                                         double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// 1. the prologue: a block a lane
__global__ void __launch_bounds__(CRT_THREADS)
crt_prologue(const __grid_constant__ CrtArgs a) {
  __shared__ MvState<0, 0> st;
  __shared__ double ldv;
  extern __shared__ __align__(16) double crt_dyn[];
  const int n = a.n, d = a.d, c = a.c0 + a.r, tid = threadIdx.x;
  const CrtLay& Ly = a.ly;
  const int dd = Ly.dd, cd = Ly.cd, tc = Ly.tc;
  const int lane = a.s0 + blockIdx.x;
  double* sc = a.scratch + (long)blockIdx.x * Ly.len;
  double* w = Ly.pro_smem ? crt_dyn : sc + Ly.pro;
  double* fr = w + mv_state_len(d, c);       // EigenProc's team frame
  double* gram = fr + 8 * dd + 5 * d;
  double* wk = gram + (long)d * tc;          // the warps' inverse work
  double* Mz = wk + CRT_WARPS * (c * c + c);
  double* Qi = sc + Ly.Qi;
  double* Qs = sc + Ly.Qs;
  const MvLane<double> Ln =
      mv_lane<double>(a.eval, a.X0, nullptr, a.R, n, d, a.c0, a.r, lane);
  MvTeam tm;
  tm.W = CRT_WARPS;
  tm.id = 0;
  tm.rank = tid;
  tm.size = CRT_THREADS;
  tm.warp = tid >> 5;
  tm.lane = tid & 31;
  tm.whole = true;
  GT_PROF_START();
  GT_PROF_COUNT(GT_PC_LANES, 1);
  if (tid == 0) mv_state_bind(st, w, d, c);
  __syncthreads();
  for (int i = tid; i < dd; i += CRT_THREADS) {
    st.Vg[i] = a.Vg[(long)lane * dd + i];
    st.Ve[i] = a.Ve[(long)lane * dd + i];
  }
  __syncthreads();
  mv_t_eigen_proc(tm, d, st.Vg, st.Ve, st, &ldv, nullptr, fr);
  GT_PROF(CRT_PH_ALG);
  // the whitened Gram blocks Σ_k w_kl x_i x_j (l; i <= j), a warp a sum,
  // from the weights w_kl = 1 / (D_l δ_k + 1)
  double* wt = sc + Ly.Wt;
  for (int e = tid; e < d * n; e += CRT_THREADS)
    wt[e] = 1.0 / (st.D[e / n] * a.eval[e % n] + 1.0);
  __syncthreads();
  for (int e = tm.warp; e < d * tc; e += CRT_WARPS) {
    const int l = e / tc;
    int i, j;
    mv_tri_decode(e % tc, c, i, j);
    double s = 0.0;
    for (int k = tm.lane; k < n; k += 32)
      s += Ln.x(i, k) * Ln.x(j, k) * wt[(long)l * n + k];
    s = gt_warp_sum(s);
    if (tm.lane == 0) gram[e] = s;
  }
  __syncthreads();
  GT_PROF(CRT_PH_SETUP);
  // their inverses: the adjugate on a thread each at c <= 2, a warp each
  // above
  if (c <= 2) {
    for (int l = tid; l < d; l += CRT_THREADS) {
      double Q[4], ld;
      for (int i = 0; i < c; ++i)
        for (int j = 0; j < c; ++j)
          Q[i * c + j] = gram[l * tc + mv_ti(i, j, c)];
      mv_inv_logdet<0>(c, Q, st.Qi + l * c * c, ld, nullptr);
    }
  } else {
    double* W = wk + tm.warp * (c * c + c);
    for (int l = tm.warp; l < d; l += CRT_WARPS) {
      for (int e = tm.lane; e < c * c; e += 32)
        W[e] = gram[l * tc + mv_ti(e / c, e % c, c)];
      __syncwarp();
      mv_w_inv_logdet(tm.lane, c, W, st.Qi + l * c * c, W + c * c);
      __syncwarp();
    }
  }
  __syncthreads();
  GT_PROF(CRT_PH_ALG);
  // Qi = (I ⊗ UltVeh') Qi_white (I ⊗ UltVeh), whole; its SNP rows Qs[i][m]
  // = Qi[s0 + i][m]; A and D for the build
  const int s0 = (c - 1) * d;
  for (int e = tid; e < cd * cd; e += CRT_THREADS) {
    const int row = e / cd, col = e % cd;
    const int ra = row / d, i = row % d, b = col / d, j = col % d;
    double v = 0.0;
    for (int l = 0; l < d; ++l)
      v += st.Uh[l * d + i] * st.Qi[l * c * c + ra * c + b] * st.Uh[l * d + j];
    Qi[e] = v;
    if (row >= s0) Qs[(long)(row - s0) * cd + col] = v;
  }
  for (int e = tid; e < dd; e += CRT_THREADS) sc[Ly.AD + e] = st.A[e];
  for (int e = tid; e < d; e += CRT_THREADS) sc[Ly.AD + dd + e] = st.D[e];
  __syncthreads();
  GT_PROF(CRT_PH_SETUP);
  // Z = (Qi_ss)^-1
  if (tid == 0) {
    for (int i = 0; i < d; ++i)
      for (int j = 0; j < d; ++j) Mz[i * d + j] = Qs[(long)i * cd + s0 + j];
    mv_invert(d, Mz, sc + Ly.Z);
  }
  GT_PROF(CRT_PH_ALG);
}

// A thread's entries (k, i, j) of a kn × d × d array, e = (k d + i) d + j
// from threadIdx.x in steps of CRT_THREADS, carried digit by digit (no
// division an entry)
struct CrtEnt {
  int k, i, j, sk, si, sj, d;
  __device__ explicit CrtEnt(int d_) {
    d = d_;
    const int t = threadIdx.x, dd = d * d;
    k = t / dd;
    i = (t / d) % d;
    j = t % d;
    sk = CRT_THREADS / dd;
    si = (CRT_THREADS / d) % d;
    sj = CRT_THREADS % d;
  }
  __device__ void next() {
    j += sj;
    if (j >= d) {
      j -= d;
      ++i;
    }
    i += si;
    if (i >= d) {
      i -= d;
      ++k;
    }
    k += sk;
  }
  __device__ int e() const { return (k * d + i) * d + j; }
};

// A thread's entries (hi, lo) of a grid with `base` columns, e = hi base +
// lo from threadIdx.x in steps of CRT_THREADS, carried without a division
struct CrtIt2 {
  int hi, lo, shi, slo, base;
  __device__ explicit CrtIt2(int base_) {
    base = base_;
    hi = threadIdx.x / base;
    lo = threadIdx.x % base;
    shi = CRT_THREADS / base;
    slo = CRT_THREADS % base;
  }
  __device__ void next() {
    lo += slo;
    if (lo >= base) {
      lo -= base;
      ++hi;
    }
    hi += shi;
  }
};

// 2. build: Hi_k = A' diag(w_k) A, R_k = Σ_b x_bk Qs[:, b, :], P_k = R_k
// Hi_k and F_k = P_k' Z P_k of the block's kb individuals
__global__ void __launch_bounds__(CRT_THREADS)
crt_build(const __grid_constant__ CrtArgs a) {
  extern __shared__ __align__(16) double crt_dyn[];
  const int n = a.n, d = a.d, c = a.c0 + a.r, tid = threadIdx.x;
  const CrtLay& Ly = a.ly;
  const int dd = Ly.dd, cd = Ly.cd, kb = Ly.kb;
  const int lane = a.s0 + blockIdx.x;
  const int k0 = blockIdx.y * kb, kn = min(kb, n - k0);
  double* sc = a.scratch + (long)blockIdx.x * Ly.len;
  double* sm = Ly.build_smem()
                   ? crt_dyn
                   : sc + Ly.tmp + (long)blockIdx.y * Ly.build_len();
  double* sHi = sm;
  double* sR = sHi + kb * dd;
  double* sP = sR + kb * dd;
  double* sZP = sP + kb * dd;
  double* sw = sZP + kb * dd;
  const double* A = sc + Ly.AD;
  const double* Dv = A + dd;
  const double* Qs = sc + Ly.Qs;
  const double* Z = sc + Ly.Z;
  const MvLane<double> Ln =
      mv_lane<double>(a.eval, a.X0, nullptr, a.R, n, d, a.c0, a.r, lane);
  GT_PROF_START();
  for (int e = tid; e < kn * d; e += CRT_THREADS)
    sw[e] = 1.0 / (Dv[e % d] * a.eval[k0 + e / d] + 1.0);
  __syncthreads();
  for (CrtEnt q(d); q.k < kn; q.next()) {
    const int k = q.k, i = q.i, j = q.j, e = q.e();
    double h = 0.0, rk = 0.0;
    for (int l = 0; l < d; ++l)
      h += A[l * d + i] * sw[k * d + l] * A[l * d + j];
    for (int b = 0; b < c; ++b) rk += Ln.x(b, k0 + k) * Qs[i * cd + b * d + j];
    sHi[e] = h;
    sR[e] = rk;
    sc[Ly.H + (long)k0 * dd + e] = h;
  }
  __syncthreads();
  for (CrtEnt q(d); q.k < kn; q.next()) {                // P = R Hi
    const int k = q.k, i = q.i, j = q.j, e = q.e();
    double v = 0.0;
    for (int m = 0; m < d; ++m)
      v += sR[k * dd + i * d + m] * sHi[k * dd + m * d + j];
    sP[e] = v;
    sc[Ly.P + (long)k0 * dd + e] = v;
  }
  __syncthreads();
  for (CrtEnt q(d); q.k < kn; q.next()) {                // Z P
    const int k = q.k, i = q.i, j = q.j, e = q.e();
    double v = 0.0;
    for (int m = 0; m < d; ++m) v += Z[i * d + m] * sP[k * dd + m * d + j];
    sZP[e] = v;
  }
  __syncthreads();
  for (CrtEnt q(d); q.k < kn; q.next()) {                // F = P' Z P
    const int k = q.k, i = q.i, j = q.j, e = q.e();
    double v = 0.0;
    for (int m = 0; m < d; ++m)
      v += sP[k * dd + m * d + i] * sZP[k * dd + m * d + j];
    sc[Ly.F + (long)k0 * dd + e] = v;
  }
  GT_PROF(CRT_PH_BUILD);
}

// 3. products: the lane's tile blockIdx.y, of one family
__global__ void __launch_bounds__(CRT_THREADS)
crt_products(const __grid_constant__ CrtArgs a) {
  // a stage, individual-major: As[k][i] the tile's row i, Bs[k][j] its
  // column j (rows CRT_TILE + 4 apart: the DMMA loads meet no conflict)
  __shared__ __align__(16) double As[CRT_KC][CRT_TILE + CRT_PAD];
  __shared__ __align__(16) double Bs[CRT_KC][CRT_TILE + CRT_PAD];
  __shared__ int rp[CRT_TILE], ri[CRT_TILE];
  __shared__ int co1[CRT_TILE], co2[CRT_TILE], co3[CRT_TILE], co4[CRT_TILE];
  const int n = a.n, d = a.d, c = a.c0 + a.r, tid = threadIdx.x;
  const CrtLay& Ly = a.ly;
  const int dd = Ly.dd, vs = Ly.vs, cd = Ly.cd;
  const int lane = a.s0 + blockIdx.x;
  double* sc = a.scratch + (long)blockIdx.x * Ly.len;
  const double* __restrict__ P = sc + Ly.P;
  const double* __restrict__ H = sc + Ly.H;
  const double* __restrict__ F = sc + Ly.F;
  const MvLane<double> Ln =
      mv_lane<double>(a.eval, a.X0, nullptr, a.R, n, d, a.c0, a.r, lane);
  GT_PROF_START();
  // the tile: family f (0 L, 1 SS, 2 T), row tile ti, column tile tj
  int f = 0, t0 = blockIdx.y;
  while (t0 >= Ly.ft[f]) t0 -= Ly.ft[f++];
  const int ct = (Ly.fc[f] + CRT_TILE - 1) / CRT_TILE;
  const int r0 = t0 / ct * CRT_TILE, q0 = t0 % ct * CRT_TILE;
  const int nra = min(CRT_TILE, Ly.fr[f] - r0);
  const int ncb = min(CRT_TILE, Ly.fc[f] - q0);
  // each row's power of δ and operand; each column's operand offsets
  if (tid < nra) {
    const int r = r0 + tid;
    int p, o;
    if (f == 0) {                               // δ^p x_b, r = p c + b
      p = r / c;
      o = r % c;
    } else if (f == 1) {                        // δ^p P[a][i], r = p d² + a i
      p = r / dd;
      o = r % dd;
    } else {                                    // δ^p Hi[b][c], r = p v + vech
      int b, cc;
      p = r / vs;
      mv_vech_pair(r % vs, d, b, cc);
      o = b * d + cc;
    }
    rp[tid] = p;
    ri[tid] = o;
  } else if (tid >= CRT_TILE && tid - CRT_TILE < ncb) {
    const int t = tid - CRT_TILE, q = q0 + t;
    int o1, o2 = 0, o3 = -1, o4 = 0;
    if (f == 0) {                               // W[v][a][e], q = v d² + a d + e
      int i, j;
      const int aa = (q % dd) / d, e = q % d;
      mv_vech_pair(q / dd, d, i, j);
      o1 = aa * d + i;                          // P
      o2 = j * d + e;                           // Hi
      o3 = i != j ? aa * d + j : -1;
      o4 = i * d + e;
    } else if (f == 1) {                        // P[b][j]
      o1 = q;
    } else {                                    // F[e][a], q = vech(e, a)
      int e, aa;
      mv_vech_pair(q, d, e, aa);
      o1 = e * d + aa;
    }
    co1[t] = o1;
    co2[t] = o2;
    co3[t] = o3;
    co4[t] = o4;
  }
  for (int e = tid; e < CRT_KC * (CRT_TILE + CRT_PAD); e += CRT_THREADS) {
    (&As[0][0])[e] = 0.0;
    (&Bs[0][0])[e] = 0.0;
  }
  __syncthreads();

  const int lanew = tid & 31, warp = tid >> 5;
  const int wr = (warp >> 1) * 16, wc = (warp & 1) * 16;
  const int g = lanew >> 2, t = lanew & 3;
  double acc[2][2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = 0.0;
  // δ^p of individual k
  auto ep = [&](int p, int k) -> double {
    const double dl = a.eval[k];
    return p == 0 ? 1.0 : (p == 1 ? dl : dl * dl);
  };
  for (int k0 = 0; k0 < n; k0 += CRT_KC) {
    const int kn = min(CRT_KC, n - k0);
    // the rows: X's a lane an individual (X is individual-major), P's and
    // Hi's a lane a row (an individual's row is contiguous)
    if (f == 0)
      for (int e = tid; e < nra * CRT_KC; e += CRT_THREADS) {
        const int i = e / CRT_KC, kk = e % CRT_KC;
        As[kk][i] = kk < kn ? ep(rp[i], k0 + kk) * Ln.x(ri[i], k0 + kk) : 0.0;
      }
    else
      for (CrtIt2 q(nra); q.hi < CRT_KC; q.next()) {
        const int kk = q.hi, i = q.lo;
        const double* src = (f == 1 ? P : H) + (long)(k0 + kk) * dd;
        As[kk][i] = kk < kn ? ep(rp[i], k0 + kk) * src[ri[i]] : 0.0;
      }
    // the columns, a lane a column
    for (CrtIt2 q(ncb); q.hi < CRT_KC; q.next()) {
      const int kk = q.hi, j = q.lo;
      double v = 0.0;
      if (kk < kn) {
        const long o = (long)(k0 + kk) * dd;
        if (f == 0) {
          v = P[o + co1[j]] * H[o + co2[j]];
          if (co3[j] >= 0) v += P[o + co3[j]] * H[o + co4[j]];
        } else {
          v = (f == 1 ? P : F)[o + co1[j]];
        }
      }
      Bs[kk][j] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < CRT_KC; kk += 4) {
      double av[2], bv[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) av[mi] = As[kk + t][wr + mi * 8 + g];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) bv[ni] = Bs[kk + t][wc + ni * 8 + g];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          crt_dmma(acc[mi][ni][0], acc[mi][ni][1], av[mi], bv[ni]);
    }
    __syncthreads();
  }
  // the m8n8 accumulator: row g, columns 2t and 2t + 1
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wr + mi * 8 + g, col = wc + ni * 8 + 2 * t + h;
        if (row >= nra || col >= ncb) continue;
        const long r = r0 + row, q = q0 + col;
        long o;
        if (f == 0)          // L_p[v][a][b d + e], q = (v d + a) d + e
          o = Ly.L + ((long)rp[row] * vs * d + q / d) * cd + ri[row] * d +
              q % d;
        else if (f == 1)     // G_p[a i][b j]
          o = Ly.G + r * dd + q;
        else                 // T_p[vech(b, c)][vech(e, a)]
          o = Ly.T + r * vs + q;
        sc[o] = acc[mi][ni][h];
      }
  GT_PROF(CRT_PH_SUMS);
}

// 4. C_p[v] = SS_p[v] Z (and its transpose), LZ = L_p[v]' Z and Y_p[v] =
// Qi LZ (stored transposed); block (lane, a run of npv (p, v))
__global__ void __launch_bounds__(CRT_THREADS)
crt_cy(const __grid_constant__ CrtArgs a) {
  const int d = a.d, tid = threadIdx.x;
  const CrtLay& Ly = a.ly;
  const int dd = Ly.dd, vs = Ly.vs, cd = Ly.cd;
  double* sc = a.scratch + (long)blockIdx.x * Ly.len;
  const double* Z = sc + Ly.Z;
  const double* Qi = sc + Ly.Qi;
  GT_PROF_START();
  const int pv0 = blockIdx.y * Ly.npv, pv1 = min(2 * vs, pv0 + Ly.npv);
  // SS_p[v][a][b] = G_p[a i][b j] + (i != j) G_p[a j][b i], C = SS Z
  for (int e = tid; e < (pv1 - pv0) * dd; e += CRT_THREADS) {
    const int pv = pv0 + e / dd, ra = (e % dd) / d, cj = e % d;
    const double* G = sc + Ly.G + (long)(pv / vs) * dd * dd;
    int i, j;
    mv_vech_pair(pv % vs, d, i, j);
    double v = 0.0;
    for (int m = 0; m < d; ++m) {
      double ss = G[(long)(ra * d + i) * dd + m * d + j];
      if (i != j) ss += G[(long)(ra * d + j) * dd + m * d + i];
      v += ss * Z[m * d + cj];
    }
    sc[Ly.C + (long)pv * dd + e % dd] = v;
    sc[Ly.Ct + (long)pv * dd + cj * d + ra] = v;
  }
  // LZ[m2][a] = Σ_b L_p[v][b][m2] Z[b][a], L_p[v] (d, cd), LZ (cd, d)
  for (int e = tid; e < (pv1 - pv0) * cd * d; e += CRT_THREADS) {
    const int pv = pv0 + e / (cd * d), m2 = (e % (cd * d)) / d, ca = e % d;
    const double* L = sc + Ly.L + (long)pv * d * cd;
    double lz = 0.0;
    for (int b = 0; b < d; ++b) lz += L[(long)b * cd + m2] * Z[b * d + ca];
    sc[Ly.LZ + (long)pv0 * cd * d + e] = lz;
  }
  __syncthreads();
  // Y[m][a] = Σ_m2 Qi[m][m2] LZ[m2][a], stored transposed (d, cd)
  for (int e = tid; e < (pv1 - pv0) * cd * d; e += CRT_THREADS) {
    const int pv = pv0 + e / (cd * d), m = (e % (cd * d)) / d, ca = e % d;
    const double* LZ = sc + Ly.LZ + (long)pv * cd * d;
    double v = 0.0;
    for (int m2 = 0; m2 < cd; ++m2)
      v += Qi[(long)m * cd + m2] * LZ[m2 * d + ca];
    sc[Ly.Y + ((long)pv * d + ca) * cd + m] = v;
  }
  GT_PROF(CRT_PH_CY);
}

// 5. the traces of each pair v1 <= v2: a warp a pair
__global__ void __launch_bounds__(CRT_THREADS)
crt_pairs(const __grid_constant__ CrtArgs a) {
  const int d = a.d, tid = threadIdx.x;
  const CrtLay& Ly = a.ly;
  const int dd = Ly.dd, vs = Ly.vs, cd = Ly.cd;
  const long np = Ly.npair;
  double* sc = a.scratch + (long)blockIdx.x * Ly.len;
  const double* Lp = sc + Ly.L;
  const double* Yt = sc + Ly.Y;
  const double* Cp = sc + Ly.C;
  const double* Ct = sc + Ly.Ct;
  const double* Tt = sc + Ly.T;
  double* pr = sc + Ly.pair;
  const int lanew = tid & 31, warp = tid >> 5;
  GT_PROF_START();
  const long e1 = min(np, (long)(blockIdx.y + 1) * CRT_PAIRS);
  for (long e = (long)blockIdx.y * CRT_PAIRS + warp; e < e1; e += CRT_WARPS) {
    int v1, v2;
    mv_tri_decode((int)e, vs, v1, v2);
    // tr(L_1 Y_2) = Σ L_1[a][m] Y_2[m][a] and tr(C_1 C_2) as dot products
    // of L_1 with Y_2' and of C_1 with C_2', the four (p1, p2) at once
    double tt[2][2] = {{0.0, 0.0}, {0.0, 0.0}}, cc[2][2] = {{0.0, 0.0},
                                                            {0.0, 0.0}};
    const long nl = (long)d * cd;
    const double* L0 = Lp + (long)v1 * nl;
    const double* L1 = Lp + ((long)vs + v1) * nl;
    const double* Y0 = Yt + (long)v2 * nl;
    const double* Y1 = Yt + ((long)vs + v2) * nl;
    for (long q = lanew; q < nl; q += 32) {
      const double l0 = L0[q], l1 = L1[q], y0 = Y0[q], y1 = Y1[q];
      tt[0][0] += l0 * y0;
      tt[0][1] += l0 * y1;
      tt[1][0] += l1 * y0;
      tt[1][1] += l1 * y1;
    }
    const double* C0 = Cp + (long)v1 * dd;
    const double* C1 = Cp + ((long)vs + v1) * dd;
    const double* D0 = Ct + (long)v2 * dd;
    const double* D1 = Ct + ((long)vs + v2) * dd;
    for (int q = lanew; q < dd; q += 32) {
      const double c0 = C0[q], c1 = C1[q], e0 = D0[q], e1 = D1[q];
      cc[0][0] += c0 * e0;
      cc[0][1] += c0 * e1;
      cc[1][0] += c1 * e0;
      cc[1][1] += c1 * e1;
    }
    for (int p1 = 0; p1 < 2; ++p1)
      for (int p2 = 0; p2 < 2; ++p2) {
        tt[p1][p2] = gt_warp_sum(tt[p1][p2]);
        cc[p1][p2] = gt_warp_sum(cc[p1][p2]);
      }
    if (lanew == 0) {
      // tr(D_1 Hi D_2 F) = Σ over D_1's entries (a, b) and D_2's (c, e) of
      // T[vech(b, c)][vech(e, a)]
      double mm[3];
      int i1, j1, i2, j2;
      mv_vech_pair(v1, d, i1, j1);
      mv_vech_pair(v2, d, i2, j2);
      const int n1 = i1 != j1 ? 2 : 1, n2 = i2 != j2 ? 2 : 1;
      for (int p = 0; p < 3; ++p) {
        const double* Tp = Tt + (long)p * vs * vs;
        double v = 0.0;
        for (int u = 0; u < n1; ++u) {
          const int ea = u ? j1 : i1, eb = u ? i1 : j1;
          for (int w = 0; w < n2; ++w) {
            const int c2 = w ? j2 : i2, e2 = w ? i2 : j2;
            v += Tp[(long)mv_ti(eb, c2, d) * vs + mv_ti(e2, ea, d)];
          }
        }
        mm[p] = v;
      }
      pr[0 * np + e] = -tt[1][1] + mm[2];                      // trB_gg
      pr[1 * np + e] = -(tt[1][0] + tt[0][1]) + 2.0 * mm[1];   // trB_ge
      pr[2 * np + e] = -tt[0][0] + mm[0];                      // trB_ee
      pr[3 * np + e] = cc[1][1];                               // trCC_gg
      pr[4 * np + e] = cc[1][0] + cc[0][1];                    // trCC_ge
      pr[5 * np + e] = cc[0][0];                               // trCC_ee
    }
  }
  GT_PROF(CRT_PH_PAIR);
}

// 6. the factors: a block a lane; chunks of CRT_FIN pairs staged in
// shared memory, thread 0 summing them in the reference's order
__global__ void __launch_bounds__(CRT_THREADS)
crt_final(const __grid_constant__ CrtArgs a) {
  __shared__ double sv[14][CRT_FIN];   // a chunk's traces, h, trC's, mult
  const int d = a.d, tid = threadIdx.x;
  const CrtLay& Ly = a.ly;
  const int dd = Ly.dd, vs = Ly.vs, p2 = 2 * Ly.vs;
  const long np = Ly.npair;
  const int lane = a.s0 + blockIdx.x;
  double* sc = a.scratch + (long)blockIdx.x * Ly.len;
  const double* Cp = sc + Ly.C;
  const double* pr = sc + Ly.pair;
  const double* H = a.Hvar + (long)lane * p2 * p2;
  double* trCg = sc + Ly.pro;       // the prologue's work is free again
  double* trCe = trCg + vs;
  GT_PROF_START();
  for (int v = tid; v < vs; v += CRT_THREADS) {
    double g = 0.0, e = 0.0;
    for (int q = 0; q < d; ++q) {
      g += Cp[((long)vs + v) * dd + q * d + q];
      e += Cp[(long)v * dd + q * d + q];
    }
    trCg[v] = -g;
    trCe[v] = -e;
  }
  __syncthreads();
  double B = 0.0, C = 0.0, D = 0.0;
  for (long e0 = 0; e0 < np; e0 += CRT_FIN) {
    const int m = (int)min((long)CRT_FIN, np - e0);
    for (int t = tid; t < m; t += CRT_THREADS) {
      int v1, v2;
      mv_tri_decode((int)(e0 + t), vs, v1, v2);
      for (int q = 0; q < 6; ++q) sv[q][t] = pr[q * np + e0 + t];
      sv[6][t] = H[v1 * p2 + v2];
      sv[7][t] = H[v1 * p2 + vs + v2];
      sv[8][t] = H[(vs + v1) * p2 + vs + v2];
      sv[9][t] = trCg[v1];
      sv[10][t] = trCg[v2];
      sv[11][t] = trCe[v1];
      sv[12][t] = trCe[v2];
      sv[13][t] = v1 == v2 ? 1.0 : 2.0;
    }
    __syncthreads();
    if (tid == 0)
      for (int t = 0; t < m; ++t) {
        const double trB_gg = sv[0][t], trB_ge = sv[1][t],
                     trB_ee = sv[2][t], trCC_gg = sv[3][t],
                     trCC_ge = sv[4][t], trCC_ee = sv[5][t];
        const double mult = sv[13][t];
        const double hg = sv[6][t], he = sv[7][t], hx = sv[8][t];
        const double g1 = sv[9][t], g2 = sv[10][t], e1 = sv[11][t],
                     e2 = sv[12][t];
        B = B + mult * (hg * trB_gg + he * trB_ge + hx * trB_ee);
        C = C + mult * (hg * (trCC_gg + 0.5 * g1 * g2) +
                        he * (trCC_ge + 0.5 * g1 * e2 + 0.5 * e1 * g2) +
                        hx * (trCC_ee + 0.5 * e1 * e2));
        D = D + mult * (hg * (trCC_gg + 0.5 * (2.0 * trB_gg)) +
                        he * (trCC_ge + 0.5 * (2.0 * trB_ge)) +
                        hx * (trCC_ee + 0.5 * (2.0 * trB_ee)));
      }
    __syncthreads();
  }
  if (tid == 0) {
    a.out[lane] = 2.0 * D - C;
    a.out[a.S + lane] = 2.0 * B;
    a.out[2 * a.S + lane] = C;
  }
  GT_PROF(CRT_PH_FINAL);
}

// dynamic shared memory of a launch of `kern` (0 past CRT_SMEM_MAX: the
// work then lives in the scratch); raises the kernel's limit to it first
template <typename K>
static int crt_smem(K kern, long bytes) {
  if (bytes > CRT_SMEM_MAX) return 0;
  if (bytes > CRT_STATIC_SMEM)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  return (int)bytes;
}

extern "C" int calc_crt_launch(int S, int n, int d, int c0, int r,
                               const void* eval, const void* X0,
                               const void* R, const void* Vg, const void* Ve,
                               const void* Hvar, void* out, int s0, int count,
                               void* scratch, void* stream) {
  if (count <= 0) return (int)cudaGetLastError();
  const CrtArgs a{S, n, d, c0, r, s0,
                  (const double*)eval, (const double*)X0, (const double*)R,
                  (const double*)Vg, (const double*)Ve, (const double*)Hvar,
                  (double*)scratch, (double*)out, CrtLay(n, d, c0 + r)};
  const CrtLay& Ly = a.ly;
  cudaStream_t st = (cudaStream_t)stream;
  crt_prologue<<<count, CRT_THREADS,
                 Ly.pro_smem ? crt_smem(crt_prologue, 8 * Ly.pro_len) : 0,
                 st>>>(a);
  crt_build<<<dim3(count, Ly.nchunk), CRT_THREADS,
              Ly.build_smem() ? crt_smem(crt_build, 8 * Ly.build_len()) : 0,
              st>>>(a);
  crt_products<<<dim3(count, (unsigned)Ly.nt), CRT_THREADS, 0, st>>>(a);
  crt_cy<<<dim3(count, (2 * Ly.vs + Ly.npv - 1) / Ly.npv), CRT_THREADS, 0,
           st>>>(a);
  crt_pairs<<<dim3(count, (unsigned)((Ly.npair + CRT_PAIRS - 1) / CRT_PAIRS)),
              CRT_THREADS, 0, st>>>(a);
  crt_final<<<count, CRT_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// bytes of a lane's scratch
extern "C" long calc_crt_lane_bytes(int d, int c, int n) {
  return 8 * CrtLay(n, d, c).len;
}

GT_ERROR_FN(calc_crt)
