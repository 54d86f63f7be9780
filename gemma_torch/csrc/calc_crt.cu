// K14 — the mvLMM small-sample (Edgeworth) correction factors of -crt.
//
// Replaces the reference package's device program
//   gemma_tpu/models/mvlmm_core.py:681 calc_crt (a vmap of _calc_crt_one
//   :561, CalcCRT mvlmm.cpp:2054-2330), called from
//   gemma_tpu/models/mvlmm.py:322 _crt_block on the lanes -pnr refines.
// Its plain version is gemma_torch/models/mvlmm_core.py (_crt_lanes).
//
// One thread block per lane, at the lane's Newton optimum (Vg, Ve) with
// Hvar = -H^-1 from K11.  The reference forms the (v, cd, cd) stacks of
// first- and second-derivative sandwiches and takes whole (cd, cd)
// products; every trace it needs reads only the SNP block's rows s of
// Q^-1, so with Qs = Qi[s, :], R_k = Qs (x_k ⊗ I), P_k = R_k Hi_k, Z =
// (Qi_ss)^-1 and F_k = P_k' Z P_k the kernel accumulates over the n
// individuals only
//   SS_p[v] = Σ_k δ_k^p P_k D_v P_k'               p = 0, 1   (v d² each)
//   T_p     = Σ_k δ_k^p Hi_k ⊗ F_k (vech × vech)   p = 0, 1, 2 (v² each)
//   L_p[v]  = Σ_k δ_k^p x_k' ⊗ (P_k D_v Hi_k)      p = 0, 1   (v d cd each)
// and then, per lane, C_p[v] = SS_p[v] Z, Y_p[v] = Qi L_p[v]' Z and the
// traces of each pair v1 <= v2: tr(L_1 Y_2), tr(D_1 Hi D_2 F) from T and
// tr(C_1 C_2).  That is about v² d³ + v cd d multiply-adds an individual,
// not the reference's v² (cd)².  GEMMA's quirks stay: MM_ge in the single
// product order with trB_ge's 2x, and the v1 != v2 terms doubled with the
// same h (thread 0 sums the pairs in the reference's order).
//
// A pass over n stages a chunk of individuals in shared memory (x, δ^p,
// Hi_k, P_k, F_k, built by the block) and each thread owns up to CRT_Q
// sums; groups of sums beyond CRT_THREADS x CRT_Q stage the chunks again.
// The sums, Qi and the pair traces live in a per-lane float64 scratch the
// wrapper sizes (mvlmm_core.crt_scratch).  float64 operands and
// arithmetic: -crt runs in float64 (ROADMAP §C18).  A singular Qi_ss gives
// inf/NaN, as the reference's LU inverse: nothing is clamped.
//
// Bound: operations — the pass's sums, S n (5 v² + 4 v d cd + ...)
// float64 multiply-adds; the operands are read once (r n values a lane).
#include "mvlmm_lane.cuh"

#define CRT_THREADS 128
#define CRT_Q 4
#define CRT_STAGE 512      // doubles of one staged per-individual d×d array
#define CRT_CH_MAX 32
#define CRT_MAX_V (MV_MAX_D * (MV_MAX_D + 1) / 2)

// doubles of a lane's scratch (mvlmm_core.crt_scratch)
__host__ __device__ inline long crt_scratch(int d, int c) {
  const long vs = d * (d + 1) / 2, cd = (long)c * d;
  return cd * cd + 2 * vs * d * d + 3 * vs * vs + 2 * vs * d * cd +
         2 * vs * d * d + 2 * vs * cd * d + 6 * (vs * (vs + 1) / 2);
}

// offsets into a lane's scratch
struct CrtLayout {
  int d, c, vs, cd, dd;
  long nSS, nT, nL;     // sums of one SS_p, T_p, L_p
  long Qi, SS, T, L, C, Y, pair, nacc, npair;
  __device__ CrtLayout(int d_, int c_) {
    d = d_;
    c = c_;
    vs = d * (d + 1) / 2;
    cd = c * d;
    dd = d * d;
    nSS = (long)vs * dd;
    nT = (long)vs * vs;
    nL = (long)vs * d * cd;
    npair = (long)vs * (vs + 1) / 2;
    Qi = 0;
    SS = Qi + (long)cd * cd;
    T = SS + 2 * nSS;
    L = T + 3 * nT;
    nacc = 2 * nSS + 3 * nT + 2 * nL;
    C = SS + nacc;
    Y = C + 2 * nSS;
    pair = Y + 2 * (long)vs * cd * d;
  }
};

// one sum of the pass: its family, power of δ and staged offsets
struct CrtSum {
  int kind;   // 0 SS, 1 T, 2 L, -1 none
  int p, o1, o2, o3, o4, xb, two;
};

__device__ inline CrtSum crt_sum(const CrtLayout& Ly, long r) {
  CrtSum s;
  s.kind = -1;
  s.p = s.o1 = s.o2 = s.o3 = s.o4 = s.xb = s.two = 0;
  if (r >= Ly.nacc) return s;
  const int d = Ly.d;
  int i, j;
  if (r < 2 * Ly.nSS) {                       // SS_p[v][a][b]
    s.kind = 0;
    s.p = (int)(r / Ly.nSS);
    const long loc = r % Ly.nSS;
    const int v = (int)(loc / Ly.dd), a = (int)(loc / d) % d,
              b = (int)(loc % d);
    mv_vech_pair(v, d, i, j);
    s.o1 = a * d + i;
    s.o2 = b * d + j;
    s.o3 = a * d + j;
    s.o4 = b * d + i;
    s.two = i != j;
    return s;
  }
  r -= 2 * Ly.nSS;
  if (r < 3 * Ly.nT) {                        // T_p[vech(b,c)][vech(e,a)]
    s.kind = 1;
    s.p = (int)(r / Ly.nT);
    const long loc = r % Ly.nT;
    int b, c, e, a;
    mv_vech_pair((int)(loc / Ly.vs), d, b, c);
    mv_vech_pair((int)(loc % Ly.vs), d, e, a);
    s.o1 = b * d + c;                         // Hi
    s.o2 = e * d + a;                         // F
    return s;
  }
  r -= 3 * Ly.nT;                             // L_p[v][a][b d + e]
  s.kind = 2;
  s.p = (int)(r / Ly.nL);
  const long loc = r % Ly.nL;
  const int v = (int)(loc / ((long)d * Ly.cd));
  const int a = (int)(loc / Ly.cd) % d, m = (int)(loc % Ly.cd);
  const int e = m % d;
  s.xb = m / d;
  mv_vech_pair(v, d, i, j);
  s.o1 = a * d + i;                           // P
  s.o2 = j * d + e;                           // Hi
  s.o3 = a * d + j;
  s.o4 = i * d + e;
  s.two = i != j;
  return s;
}

__global__ void __launch_bounds__(CRT_THREADS)
calc_crt_kernel(int S, int n, int d, int c0, int r,
                const double* __restrict__ eval,
                const double* __restrict__ X0, const double* __restrict__ R,
                const double* __restrict__ Vg, const double* __restrict__ Ve,
                const double* __restrict__ Hvar, double* scratch,
                double* out) {
  __shared__ MvState st;
  __shared__ double sQ[MV_MAX_D * MV_MAX_C * (MV_MAX_C + 1) / 2];
  __shared__ double sQs[MV_MAX_D * MV_MAX_C * MV_MAX_D];
  __shared__ double sZ[MV_MAX_D * MV_MAX_D];
  __shared__ double sx[CRT_CH_MAX * MV_MAX_C];
  __shared__ double sE[3][CRT_CH_MAX];
  __shared__ double sHi[CRT_STAGE], sR[CRT_STAGE], sP[CRT_STAGE],
      sF[CRT_STAGE];
  const int lane = blockIdx.x, tid = threadIdx.x;
  const MvLane<double> Ln =
      mv_lane<double>(eval, X0, nullptr, R, n, d, c0, r, lane);
  const int c = Ln.c, dd = d * d, tc = mv_tri(c);
  const CrtLayout Ly(d, c);
  const int vs = Ly.vs, cd = Ly.cd;
  double* sc = scratch + (long)lane * crt_scratch(d, c);
  double* Qi = sc + Ly.Qi;
  double* acc = sc + Ly.SS;
  const int ch = min(CRT_CH_MAX, CRT_STAGE / dd);

  // EigenProc of (Vg, Ve)
  if (tid == 0) {
    for (int i = 0; i < dd; ++i) {
      st.Vg[i] = Vg[(long)lane * dd + i];
      st.Ve[i] = Ve[(long)lane * dd + i];
    }
    mv_eigen_proc(d, st.Vg, st.Ve, st, nullptr);
  }
  __syncthreads();
  // the whitened Gram blocks Σ_k w_kl x_i x_j (l; i <= j)
  for (int e = tid; e < d * tc; e += CRT_THREADS) {
    const int l = e / tc;
    int i, j;
    mv_tri_decode(e % tc, c, i, j);
    double a = 0.0;
    for (int k = 0; k < n; ++k)
      a += Ln.x(i, k) * Ln.x(j, k) / (st.D[l] * eval[k] + 1.0);
    sQ[e] = a;
  }
  __syncthreads();
  if (tid == 0) {
    for (int l = 0; l < d; ++l) {
      double Q[MV_MAX_C * MV_MAX_C], ld;
      for (int i = 0; i < c; ++i)
        for (int j = 0; j < c; ++j) Q[i * c + j] = sQ[l * tc + mv_ti(i, j, c)];
      mv_inv_logdet(c, Q, st.Qi + l * c * c, ld);
    }
  }
  __syncthreads();
  // Qi = (I ⊗ UltVeh') Qi_white (I ⊗ UltVeh), whole, into the scratch
  for (int e = tid; e < cd * cd; e += CRT_THREADS) {
    const int row = e / cd, col = e % cd;
    const int a = row / d, i = row % d, b = col / d, j = col % d;
    double v = 0.0;
    for (int l = 0; l < d; ++l)
      v += st.Uh[l * d + i] * st.Qi[l * c * c + a * c + b] * st.Uh[l * d + j];
    Qi[e] = v;
  }
  __syncthreads();
  // its SNP rows Qs[i][a][j] = Qi[s0 + i][a d + j], and Z = (Qi_ss)^-1
  const int s0 = (c - 1) * d;
  for (int e = tid; e < d * cd; e += CRT_THREADS)
    sQs[e] = Qi[(long)(s0 + e / cd) * cd + e % cd];
  __syncthreads();
  if (tid == 0) {
    double M[MV_MAX_D * MV_MAX_D];
    for (int i = 0; i < d; ++i)
      for (int j = 0; j < d; ++j) M[i * d + j] = sQs[i * cd + s0 + j];
    mv_invert(d, M, sZ);
  }
  __syncthreads();

  // the pass over n: each thread's CRT_Q sums, group by group
  for (long g0 = 0; g0 < Ly.nacc; g0 += (long)CRT_THREADS * CRT_Q) {
    CrtSum sum[CRT_Q];
    double a[CRT_Q];
#pragma unroll
    for (int q = 0; q < CRT_Q; ++q) {
      sum[q] = crt_sum(Ly, g0 + (long)q * CRT_THREADS + tid);
      a[q] = 0.0;
    }
    for (int k0 = 0; k0 < n; k0 += ch) {
      const int kn = min(ch, n - k0);
      __syncthreads();
      for (int e = tid; e < kn * (c + 1); e += CRT_THREADS) {
        const int k = e / (c + 1), col = e % (c + 1);
        if (col < c) {
          sx[k * MV_MAX_C + col] = Ln.x(col, k0 + k);
        } else {
          const double dl = eval[k0 + k];
          sE[0][k] = 1.0;
          sE[1][k] = dl;
          sE[2][k] = dl * dl;
        }
      }
      __syncthreads();
      // Hi_k = A' diag(w_k) A and R_k = Σ_a x_ak Qs[:, a, :]
      for (int e = tid; e < kn * dd; e += CRT_THREADS) {
        const int k = e / dd, i = (e / d) % d, j = e % d;
        const double dl = sE[1][k];
        double h = 0.0, rk = 0.0;
        for (int l = 0; l < d; ++l)
          h += st.A[l * d + i] * (1.0 / (st.D[l] * dl + 1.0)) * st.A[l * d + j];
        for (int b = 0; b < c; ++b)
          rk += sx[k * MV_MAX_C + b] * sQs[i * cd + b * d + j];
        sHi[e] = h;
        sR[e] = rk;
      }
      __syncthreads();
      for (int e = tid; e < kn * dd; e += CRT_THREADS) {   // P = R Hi
        const int k = e / dd, i = (e / d) % d, j = e % d;
        double v = 0.0;
        for (int m = 0; m < d; ++m)
          v += sR[k * dd + i * d + m] * sHi[k * dd + m * d + j];
        sP[e] = v;
      }
      __syncthreads();
      for (int e = tid; e < kn * dd; e += CRT_THREADS) {   // Z P into sR
        const int k = e / dd, i = (e / d) % d, j = e % d;
        double v = 0.0;
        for (int m = 0; m < d; ++m)
          v += sZ[i * d + m] * sP[k * dd + m * d + j];
        sR[e] = v;
      }
      __syncthreads();
      for (int e = tid; e < kn * dd; e += CRT_THREADS) {   // F = P' Z P
        const int k = e / dd, i = (e / d) % d, j = e % d;
        double v = 0.0;
        for (int m = 0; m < d; ++m)
          v += sP[k * dd + m * d + i] * sR[k * dd + m * d + j];
        sF[e] = v;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < CRT_Q; ++q) {
        const CrtSum& s = sum[q];
        if (s.kind < 0) continue;
        const double* ep = sE[s.p];
        double v = a[q];
        if (s.kind == 0) {
          for (int k = 0; k < kn; ++k) {
            const double* P = sP + k * dd;
            double t = P[s.o1] * P[s.o2];
            if (s.two) t += P[s.o3] * P[s.o4];
            v += ep[k] * t;
          }
        } else if (s.kind == 1) {
          for (int k = 0; k < kn; ++k)
            v += ep[k] * (sHi[k * dd + s.o1] * sF[k * dd + s.o2]);
        } else {
          for (int k = 0; k < kn; ++k) {
            const double* P = sP + k * dd;
            const double* H = sHi + k * dd;
            double t = P[s.o1] * H[s.o2];
            if (s.two) t += P[s.o3] * H[s.o4];
            v += ep[k] * (sx[k * MV_MAX_C + s.xb] * t);
          }
        }
        a[q] = v;
      }
    }
#pragma unroll
    for (int q = 0; q < CRT_Q; ++q) {
      const long rr = g0 + (long)q * CRT_THREADS + tid;
      if (rr < Ly.nacc) acc[rr] = a[q];
    }
  }
  __syncthreads();

  // C_p[v] = SS_p[v] Z and Y_p[v] = Qi L_p[v]' Z
  const double* SS = sc + Ly.SS;
  const double* Tt = sc + Ly.T;
  const double* Lp = sc + Ly.L;
  double* Cp = sc + Ly.C;
  double* Yp = sc + Ly.Y;
  for (long e = tid; e < 2 * Ly.nSS; e += CRT_THREADS) {
    const long vm = e / dd;                   // p v + v
    const int i = (int)(e / d) % d, j = (int)(e % d);
    double v = 0.0;
    for (int m = 0; m < d; ++m) v += SS[vm * dd + i * d + m] * sZ[m * d + j];
    Cp[e] = v;
  }
  const long nY = (long)vs * cd * d;
  for (long e = tid; e < 2 * nY; e += CRT_THREADS) {
    const long pv = e / ((long)cd * d);       // p vs + v
    const int m = (int)(e / d) % cd, a = (int)(e % d);
    const double* L = Lp + pv * d * cd;       // (d, cd)
    double v = 0.0;
    for (int m2 = 0; m2 < cd; ++m2) {
      double lz = 0.0;
      for (int b = 0; b < d; ++b) lz += L[b * cd + m2] * sZ[b * d + a];
      v += Qi[(long)m * cd + m2] * lz;
    }
    Yp[e] = v;
  }
  __syncthreads();
  // the traces of each pair v1 <= v2
  double* pr = sc + Ly.pair;
  const long np = Ly.npair;
  for (long e = tid; e < np; e += CRT_THREADS) {
    int v1, v2;
    mv_tri_decode((int)e, vs, v1, v2);
    double tt[2][2], mm[3], cc[2][2];
    for (int p1 = 0; p1 < 2; ++p1)
      for (int p2 = 0; p2 < 2; ++p2) {
        const double* L1 = Lp + ((long)p1 * vs + v1) * d * cd;
        const double* Y2 = Yp + ((long)p2 * vs + v2) * cd * d;
        double v = 0.0;
        for (int a = 0; a < d; ++a)
          for (int m = 0; m < cd; ++m) v += L1[a * cd + m] * Y2[m * d + a];
        tt[p1][p2] = v;
        const double* C1 = Cp + ((long)p1 * vs + v1) * dd;
        const double* C2 = Cp + ((long)p2 * vs + v2) * dd;
        double w = 0.0;
        for (int a = 0; a < d; ++a)
          for (int b = 0; b < d; ++b) w += C1[a * d + b] * C2[b * d + a];
        cc[p1][p2] = w;
      }
    // tr(D_1 Hi D_2 F) = Σ over D_1's entries (a, b) and D_2's (c, e) of
    // T[vech(b, c)][vech(e, a)]
    int i1, j1, i2, j2;
    mv_vech_pair(v1, d, i1, j1);
    mv_vech_pair(v2, d, i2, j2);
    const int n1 = i1 != j1 ? 2 : 1, n2 = i2 != j2 ? 2 : 1;
    for (int p = 0; p < 3; ++p) {
      const double* Tp = Tt + (long)p * Ly.nT;
      double v = 0.0;
      for (int u = 0; u < n1; ++u) {
        const int a = u ? j1 : i1, b = u ? i1 : j1;
        for (int w = 0; w < n2; ++w) {
          const int cc2 = w ? j2 : i2, e2 = w ? i2 : j2;
          v += Tp[(long)mv_ti(b, cc2, d) * vs + mv_ti(e2, a, d)];
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
  __syncthreads();
  if (tid == 0) {
    double trCg[CRT_MAX_V], trCe[CRT_MAX_V];
    for (int v = 0; v < vs; ++v) {
      double g = 0.0, e = 0.0;
      for (int a = 0; a < d; ++a) {
        g += Cp[((long)vs + v) * dd + a * d + a];
        e += Cp[(long)v * dd + a * d + a];
      }
      trCg[v] = -g;
      trCe[v] = -e;
    }
    const int p2 = 2 * vs;
    const double* H = Hvar + (long)lane * p2 * p2;
    double B = 0.0, C = 0.0, D = 0.0;
    for (int v1 = 0; v1 < vs; ++v1)
      for (int v2 = v1; v2 < vs; ++v2) {
        const long e = mv_ti(v1, v2, vs);
        const double trB_gg = pr[e], trB_ge = pr[np + e],
                     trB_ee = pr[2 * np + e], trCC_gg = pr[3 * np + e],
                     trCC_ge = pr[4 * np + e], trCC_ee = pr[5 * np + e];
        const double mult = v1 == v2 ? 1.0 : 2.0;
        const double hg = H[v1 * p2 + v2], he = H[v1 * p2 + vs + v2],
                     hx = H[(vs + v1) * p2 + vs + v2];
        B = B + mult * (hg * trB_gg + he * trB_ge + hx * trB_ee);
        C = C + mult * (hg * (trCC_gg + 0.5 * trCg[v1] * trCg[v2]) +
                        he * (trCC_ge + 0.5 * trCg[v1] * trCe[v2] +
                              0.5 * trCe[v1] * trCg[v2]) +
                        hx * (trCC_ee + 0.5 * trCe[v1] * trCe[v2]));
        D = D + mult * (hg * (trCC_gg + 0.5 * (2.0 * trB_gg)) +
                        he * (trCC_ge + 0.5 * (2.0 * trB_ge)) +
                        hx * (trCC_ee + 0.5 * (2.0 * trB_ee)));
      }
    out[lane] = 2.0 * D - C;
    out[S + lane] = 2.0 * B;
    out[2 * S + lane] = C;
  }
}

extern "C" int calc_crt_launch(int S, int n, int d, int c0, int r,
                               const void* eval, const void* X0,
                               const void* R, const void* Vg, const void* Ve,
                               const void* Hvar, void* scratch, void* out,
                               void* stream) {
  if (S > 0)
    calc_crt_kernel<<<S, CRT_THREADS, 0, (cudaStream_t)stream>>>(
        S, n, d, c0, r, (const double*)eval, (const double*)X0,
        (const double*)R, (const double*)Vg, (const double*)Ve,
        (const double*)Hvar, (double*)scratch, (double*)out);
  return (int)cudaGetLastError();
}

GT_ERROR_FN(calc_crt)
