// K15 — the column sums of every pair's Hadamard product over two stacks
// of n×n matrices: out[i, j, t] = Σ_s A_i[s, t] B_j[s, t], float64 sums
// (pair_colsum_launch, float operands; pair_colsum_f64_launch, double).
//
// Replaces the Hadamard pair reductions of the reference package's
// device programs
//   gemma_tpu/models/vc.py:50 _he_core (S = einsum("mij,kij->mk"), :74),
//   :135 _reml_dev12 (tr(P K_i) = einsum("ij,mij->m"), :154) and
//   :262 _acl_moments (n1 = einsum("ita,jta->ija") - 1, :285);
// the sums over t of out are HE's tr(K_i K_j) and REML's tr(P K_i) (the
// kinships are symmetric).  Its plain version is
// gemma_torch/models/vc.py (pair_colsum_plain).
//
// Bound: bytes — (ma + mb) n² operand values read once (ma n² where B is
// A); 2 ma mb n² float64 operations are far below the card's rate.  At
// n = 1,940 a grid of one block per column tile has too few blocks (61
// on 132 SMs) and too few bytes in flight to stream the operands, so the
// grid splits the rows as well:
//   * block (x, y) takes a tile of 32 V columns and the y-th slice of
//     `rows` rows; the wrapper (models/vc.py pc_launches) sizes the
//     slices so that every SM gets several blocks;
//   * a thread reads V neighbouring columns of a row of every A_i and
//     B_j in one load (16 bytes: double2, float4; narrower where the
//     products of a larger stack would not fit the registers, and V = 1
//     where n or an operand's address is not a multiple of the vector),
//     PC_UNROLL rows of loads in flight before their products, and
//     forms all ma x mb products in registers, so each matrix is read
//     once for all its pairs (where B is A, `same`, B's values are A's);
//   * the 8 warps' sums meet in shared memory in a fixed order and each
//     block writes its slice's partial sums to `part`, (ns, ma, mb, n);
//   * a second, small kernel adds the ns slices of each output in slice
//     order.  No atomics: the sums are deterministic.
// Up to PC_MAX_M matrices a stack per launch; the wrapper launches per
// pair of chunks above that.
#include "common.cuh"

#define PC_MAX_M 8
#define PC_WARPS 8
#define PC_THREADS (32 * PC_WARPS)
#define PC_SUM_THREADS 256

template <typename T, int V>
struct PcVec;
template <typename T>
struct PcVec<T, 1> {
  __device__ static void load(const T* p, T (&v)[1]) { v[0] = *p; }
};
template <>
struct PcVec<double, 2> {
  __device__ static void load(const double* p, double (&v)[2]) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  }
};
template <>
struct PcVec<float, 2> {
  __device__ static void load(const float* p, float (&v)[2]) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  }
};
template <>
struct PcVec<float, 4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

// rows of loads a thread keeps in flight before their products
template <int M>
struct PcUnroll {
  static constexpr int U = M <= 2 ? 4 : (M == 4 ? 2 : 1);
};

// M: the stacks' size rounded up to 1, 2, 4 or 8, so the products of the
// pairs a launch lacks are not formed; V: columns a thread reads at once
template <typename T, int M, int V>
__global__ void __launch_bounds__(PC_THREADS)
pair_colsum_kernel(int ma, int mb, int n, int same, int rows,
                   const T* __restrict__ A, const T* __restrict__ B,
                   double* __restrict__ part) {
  constexpr int U = PcUnroll<M>::U;
  __shared__ double red[PC_WARPS][32 * V];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = (blockIdx.x * 32 + lane) * V;
  const int s0 = blockIdx.y * rows, s1 = min(n, s0 + rows);
  const long nn = (long)n * n;
  double acc[M][M][V];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][j][v] = 0.0;
  // V divides n, so a thread's first column inside n means all V are
  if (t < n) {
    for (int s = s0 + warp; s < s1; s += PC_WARPS * U) {
      T a[U][M][V], b[U][M][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = s + u * PC_WARPS;
        const long off = (long)r * n + t;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (r < s1 && i < ma)
            PcVec<T, V>::load(A + i * nn + off, a[u][i]);
          else
#pragma unroll
            for (int v = 0; v < V; ++v) a[u][i][v] = T(0);
          if (!same) {
            if (r < s1 && i < mb)
              PcVec<T, V>::load(B + i * nn + off, b[u][i]);
            else
#pragma unroll
              for (int v = 0; v < V; ++v) b[u][i][v] = T(0);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[i][j][v] += (double)a[u][i][v] *
                              (double)(same ? a[u][j][v] : b[u][j][v]);
    }
  }
  double* slice = part + (long)blockIdx.y * ma * mb * n;
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (i >= ma || j >= mb) continue;
#pragma unroll
      for (int v = 0; v < V; ++v) red[warp][lane * V + v] = acc[i][j][v];
      __syncthreads();
      if (warp == 0 && t < n) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          double x = red[0][lane * V + v];
          for (int g = 1; g < PC_WARPS; ++g) x += red[g][lane * V + v];
          slice[((long)i * mb + j) * n + t + v] = x;
        }
      }
      __syncthreads();
    }
}

// out[i, j, t] = Σ_k part[k, i, j, t], k in slice order
__global__ void __launch_bounds__(PC_SUM_THREADS)
pair_colsum_sum(int ma, int mb, int n, int ns, int ldm,
                const double* __restrict__ part, double* __restrict__ out) {
  const long e = (long)blockIdx.x * PC_SUM_THREADS + threadIdx.x;
  const long per = (long)ma * mb * n;
  if (e >= per) return;
  const int t = (int)(e % n);
  const long ij = e / n;
  const int i = (int)(ij / mb), j = (int)(ij % mb);
  double v = 0.0;
  for (int k = 0; k < ns; ++k) v += part[k * per + e];
  out[((long)i * ldm + j) * n + t] = v;
}

template <typename T, int M, int V>
static void pair_colsum_run(int ma, int mb, int n, int same, int rows,
                            int ns, const void* A, const void* B,
                            void* part, void* stream) {
  const dim3 grid((n + 32 * V - 1) / (32 * V), ns);
  pair_colsum_kernel<T, M, V>
      <<<grid, PC_THREADS, 0, (cudaStream_t)stream>>>(
          ma, mb, n, same, rows, (const T*)A, (const T*)B, (double*)part);
}

// the vectors a launch may take: V = 1 for every M; otherwise 16 bytes
// (double2, float4), narrower for the float stacks of 4 and none at 8,
// whose products would not fit the registers (models/vc.py
// pc_cols_per_thread)
template <typename T, int M>
static int pair_colsum_vec(int vec, int ma, int mb, int n, int same,
                           int rows, int ns, const void* A, const void* B,
                           void* part, void* stream) {
  constexpr int V16 = 16 / sizeof(T);
  constexpr int VM = M <= 2 ? V16 : (M == 4 ? 2 : 1);
  if (vec == 1)
    pair_colsum_run<T, M, 1>(ma, mb, n, same, rows, ns, A, B, part, stream);
  else if (vec == VM && VM > 1)
    pair_colsum_run<T, M, (VM > 1 ? VM : 1)>(ma, mb, n, same, rows, ns, A,
                                             B, part, stream);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
static int pair_colsum_entry(int ma, int mb, int n, int same, int rows,
                             int ns, int vec, const void* A, const void* B,
                             int ldm, void* part, void* out, void* stream) {
  if (ma > PC_MAX_M || mb > PC_MAX_M || (same && ma != mb) || rows < 1 ||
      ns < 1 || (long)rows * ns < n || (long)rows * (ns - 1) >= n ||
      vec < 1 || n % vec != 0 ||
      (((unsigned long)A | (unsigned long)B) % (sizeof(T) * vec)) != 0)
    return (int)cudaErrorInvalidValue;
  if (ma <= 0 || mb <= 0 || n <= 0) return (int)cudaGetLastError();
  const int m = ma > mb ? ma : mb;
  int rc;
  if (m <= 1)
    rc = pair_colsum_vec<T, 1>(vec, ma, mb, n, same, rows, ns, A, B, part,
                               stream);
  else if (m <= 2)
    rc = pair_colsum_vec<T, 2>(vec, ma, mb, n, same, rows, ns, A, B, part,
                               stream);
  else if (m <= 4)
    rc = pair_colsum_vec<T, 4>(vec, ma, mb, n, same, rows, ns, A, B, part,
                               stream);
  else
    rc = pair_colsum_vec<T, 8>(vec, ma, mb, n, same, rows, ns, A, B, part,
                               stream);
  if (rc) return rc;
  const long per = (long)ma * mb * n;
  pair_colsum_sum<<<(unsigned)((per + PC_SUM_THREADS - 1) / PC_SUM_THREADS),
                    PC_SUM_THREADS, 0, (cudaStream_t)stream>>>(
      ma, mb, n, ns, ldm, (const double*)part, (double*)out);
  return (int)cudaGetLastError();
}

#define PAIR_COLSUM_LAUNCH(name, T)                                          \
  extern "C" int name##_launch(int ma, int mb, int n, int same, int rows,    \
                               int ns, int vec, const void* A,               \
                               const void* B, int ldm, void* part,           \
                               void* out, void* stream) {                    \
    return pair_colsum_entry<T>(ma, mb, n, same, rows, ns, vec, A, B, ldm,   \
                                part, out, stream);                          \
  }

PAIR_COLSUM_LAUNCH(pair_colsum, float)
PAIR_COLSUM_LAUNCH(pair_colsum_f64, double)

GT_ERROR_FN(pair_colsum)
