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
// One block per 32 columns t and all rows: 32 x 8 threads, a warp reads
// 32 neighbouring columns of one row of every A_i and B_j (coalesced) and
// each thread forms all ma x mb products in registers, so each matrix is
// read once for all its pairs (where B is A, `same`, B's values are A's).
// The 8 row groups are summed in a fixed order through shared memory:
// every column belongs to one block, so no atomics and the sums are
// deterministic.  Up to PC_MAX_M matrices a stack per launch; the wrapper
// launches per pair of chunks above that.
// Bound: bytes — (ma + mb) n² operand values read once (ma n² where B is
// A); 2 ma mb n² float64 operations are far below the card's rate.
#include "common.cuh"

#define PC_MAX_M 8
#define PC_TX 32
#define PC_TY 8

// M: the stacks' size rounded up to 1, 2, 4 or 8, so the products of the
// pairs a launch lacks are not formed
template <typename T, int M>
__global__ void __launch_bounds__(PC_TX * PC_TY)
pair_colsum_kernel(int ma, int mb, int n, int same, const T* __restrict__ A,
                   const T* __restrict__ B, int ldm, double* out) {
  __shared__ double red[PC_TY][PC_TX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = blockIdx.x * PC_TX + tx;
  const long nn = (long)n * n;
  double acc[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) acc[i][j] = 0.0;
  if (t < n) {
#pragma unroll 4
    for (int s = ty; s < n; s += PC_TY) {
      const long off = (long)s * n + t;
      double a[M], b[M];
#pragma unroll
      for (int i = 0; i < M; ++i)
        a[i] = i < ma ? (double)A[i * nn + off] : 0.0;
#pragma unroll
      for (int j = 0; j < M; ++j)
        b[j] = same ? a[j] : (j < mb ? (double)B[j * nn + off] : 0.0);
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j) acc[i][j] += a[i] * b[j];
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (i >= ma || j >= mb) continue;
      red[ty][tx] = acc[i][j];
      __syncthreads();
      if (ty == 0 && t < n) {
        double v = red[0][tx];
        for (int g = 1; g < PC_TY; ++g) v += red[g][tx];
        out[((long)i * ldm + j) * n + t] = v;
      }
      __syncthreads();
    }
}

template <typename T, int M>
static void pair_colsum_run(int ma, int mb, int n, int same, const void* A,
                            const void* B, int ldm, void* out,
                            void* stream) {
  const dim3 grid((n + PC_TX - 1) / PC_TX), block(PC_TX, PC_TY);
  pair_colsum_kernel<T, M><<<grid, block, 0, (cudaStream_t)stream>>>(
      ma, mb, n, same, (const T*)A, (const T*)B, ldm, (double*)out);
}

#define PAIR_COLSUM_LAUNCH(name, T)                                         \
  extern "C" int name##_launch(int ma, int mb, int n, int same,             \
                               const void* A, const void* B, int ldm,       \
                               void* out, void* stream) {                   \
    if (ma > PC_MAX_M || mb > PC_MAX_M || (same && ma != mb))               \
      return (int)cudaErrorInvalidValue;                                    \
    const int m = ma > mb ? ma : mb;                                        \
    if (ma > 0 && mb > 0 && n > 0) {                                        \
      if (m <= 1)                                                           \
        pair_colsum_run<T, 1>(ma, mb, n, same, A, B, ldm, out, stream);     \
      else if (m <= 2)                                                      \
        pair_colsum_run<T, 2>(ma, mb, n, same, A, B, ldm, out, stream);     \
      else if (m <= 4)                                                      \
        pair_colsum_run<T, 4>(ma, mb, n, same, A, B, ldm, out, stream);     \
      else                                                                  \
        pair_colsum_run<T, 8>(ma, mb, n, same, A, B, ldm, out, stream);     \
    }                                                                       \
    return (int)cudaGetLastError();                                         \
  }

PAIR_COLSUM_LAUNCH(pair_colsum, float)
PAIR_COLSUM_LAUNCH(pair_colsum_f64, double)

GT_ERROR_FN(pair_colsum)
