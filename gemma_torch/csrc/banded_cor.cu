// K16 — the band of SNP-SNP correlations of -calccor / -gw:
// out[i, j] = <x_i, x_{i+j+1}> for i < S and j < bw over unit-normalised
// rows X (R, n), 0 where i + j + 1 >= R (banded_cor_launch, float
// operands and sums; banded_cor_f64_launch, double).
//
// Replaces the reference package's device program
//   gemma_tpu/models/varcov.py:51 _banded_cor, which forms the whole
//   (S, S + bw) product and keeps bw diagonals (varcov.py:58-60).
// Its plain version is gemma_torch/models/varcov.py (banded_cor_plain).
//
// Only the band is computed: S bw n multiply-adds, not S (S + bw) n.  A
// block owns a tile of BC_TI rows i and BC_TJ offsets j; the rows it needs
// are its BC_TI rows and the BC_TI + BC_TJ - 1 rows from i0 + j0 + 1 on.
// It stages BC_KC columns of both in shared memory at a time (one padded
// row per row, loads coalesced along n), and each of its 256 threads sums
// four (i, j) of the tile, reading its row of the first tile once for the
// four.  CUDA cores, no tensor cores; the order of each sum is fixed.
// Bound: operations — 2 S bw n (bytes: R n values read once, S bw
// written).
#include "common.cuh"

#define BC_TI 32
#define BC_TJ 32
#define BC_KC 32
#define BC_THREADS 256
#define BC_PER (BC_TI * BC_TJ / BC_THREADS)

template <typename T>
__global__ void __launch_bounds__(BC_THREADS)
banded_cor_kernel(int R, int n, int S, int bw, const T* __restrict__ X,
                  T* __restrict__ out) {
  __shared__ T As[BC_TI][BC_KC + 1];
  __shared__ T Bs[BC_TI + BC_TJ - 1][BC_KC + 1];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * BC_TI, j0 = blockIdx.y * BC_TJ;
  const int b0 = i0 + j0 + 1;            // first row of the second tile
  const int jj = tid % BC_TJ, ig = tid / BC_TJ;
  T acc[BC_PER];
#pragma unroll
  for (int q = 0; q < BC_PER; ++q) acc[q] = (T)0;
  for (int k0 = 0; k0 < n; k0 += BC_KC) {
    for (int e = tid; e < BC_TI * BC_KC; e += BC_THREADS) {
      const int row = e / BC_KC, k = e % BC_KC;
      const int gr = i0 + row, gk = k0 + k;
      As[row][k] = (gr < R && gk < n) ? X[(long)gr * n + gk] : (T)0;
    }
    for (int e = tid; e < (BC_TI + BC_TJ - 1) * BC_KC; e += BC_THREADS) {
      const int row = e / BC_KC, k = e % BC_KC;
      const int gr = b0 + row, gk = k0 + k;
      Bs[row][k] = (gr < R && gk < n) ? X[(long)gr * n + gk] : (T)0;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < BC_PER; ++q) {
      const int ii = ig + q * (BC_THREADS / BC_TJ);
      T a = acc[q];
#pragma unroll 8
      for (int k = 0; k < BC_KC; ++k) a += As[ii][k] * Bs[ii + jj][k];
      acc[q] = a;
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < BC_PER; ++q) {
    const int i = i0 + ig + q * (BC_THREADS / BC_TJ), j = j0 + jj;
    if (i < S && j < bw)
      out[(long)i * bw + j] = i + j + 1 < R ? acc[q] : (T)0;
  }
}

#define BANDED_COR_LAUNCH(name, T)                                          \
  extern "C" int name##_launch(int R, int n, int S, int bw, const void* X,  \
                               void* out, void* stream) {                   \
    if (S > 0 && bw > 0) {                                                  \
      const dim3 grid((S + BC_TI - 1) / BC_TI, (bw + BC_TJ - 1) / BC_TJ);   \
      banded_cor_kernel<T><<<grid, BC_THREADS, 0, (cudaStream_t)stream>>>(  \
          R, n, S, bw, (const T*)X, (T*)out);                               \
    }                                                                       \
    return (int)cudaGetLastError();                                         \
  }

BANDED_COR_LAUNCH(banded_cor, float)
BANDED_COR_LAUNCH(banded_cor_f64, double)

GT_ERROR_FN(banded_cor)
