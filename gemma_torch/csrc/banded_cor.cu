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
// Bound: operations — 2 S bw n (bytes: R n values read once, S bw
// written).  The band's shape: for a tile of BC_TI rows i0.., the partner
// rows b = i + j + 1 form one contiguous range, i0 + 1 .. i0 + BC_TI - 1
// + bw.  A block takes its row tile against one BC_TB-row tile of that
// range, a dense BC_TI x BC_TB product, and writes the entries that fall
// in the band (0 <= b - i - 1 < bw); the tiles cover the range, so each
// (i, j) is written by exactly one block.  At bw = 333 the row tile meets
// 7 partner tiles (448 rows for its 396), so 26% of the products fall
// outside the band; in float64 a warp skips the products of its 32 x 32
// sub-tile where none is in the band, which leaves about 20%.
//
// Both precisions stage BC_KC columns of the row tile and the partner
// tile per step in shared memory with cp.async, double-buffered, so the
// next step's loads run under this step's products (rows past R load as
// zeros: their products are the 0 the band needs there).
// * float64 runs on the FP64 tensor cores: mma.sync m8n8k4 (DMMA), IEEE
//   float64 products and sums.  Four warps, each a 32 x 32 sub-tile of
//   4 x 4 m8n8 tiles: per k4 step a thread loads 4 A and 4 B values from
//   shared memory for 16 DMMAs.
// * float32 runs on the CUDA cores (TF32 stays off): 64 threads, each an
//   8 x 8 register tile of outputs; per column k it loads 8 + 8 values
//   (two float4 each) from the transposed stage for 64 FMAs.
// Each output's sum runs over k in one fixed order (DMMA's k4 groups in
// order; float32 k by k), so results are deterministic.
#include "common.cuh"

#define BC_TI 64        // rows i of a block
#define BC_TB 64        // partner rows b of a block
#define BC_KC 16        // columns of n a stage
#define BC_F64_THREADS 128
#define BC_F32_THREADS 64
#define BC_PAD64 4      // double stage rows BC_KC + 4 apart: 2-way at most

__device__ __forceinline__ unsigned bc_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// one element from global to shared memory, zero-filled where !valid
template <typename T>
__device__ __forceinline__ void bc_cp(T* dst, const T* src, bool valid) {
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     bc_smem(dst)),
                 "l"(src), "r"(valid ? 8 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     bc_smem(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void bc_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void bc_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// the entry (r, c) of the block's dense tile, rows i0 + r and partner
// b0 + c: its place in the band, or -1 outside it
__device__ __forceinline__ long bc_slot(int i0, int b0, int r, int c, int S,
                                        int bw) {
  const int i = i0 + r, j = b0 + c - i - 1;
  return (i < S && j >= 0 && j < bw) ? (long)i * bw + j : -1;
}

__device__ __forceinline__ void bc_dmma(double& c0, double& c1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

__global__ void __launch_bounds__(BC_F64_THREADS)
banded_cor_f64_kernel(int R, int n, int S, int bw,
                      const double* __restrict__ X,
                      double* __restrict__ out) {
  // stage s: rows of the row tile, then of the partner tile
  __shared__ __align__(16) double Xs[2][BC_TI + BC_TB][BC_KC + BC_PAD64];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * BC_TI;
  const int b0 = i0 + 1 + blockIdx.y * BC_TB;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;  // sub-tile
  const int g = lane >> 2, t = lane & 3;
  // does the warp's sub-tile meet the band (j = b - i - 1 in [0, bw))?
  const int jmin = (b0 + wc) - (i0 + wr + 31) - 1;
  const int jmax = (b0 + wc + 31) - (i0 + wr) - 1;
  const bool live = jmax >= 0 && jmin < bw && i0 + wr < S;

  auto stage = [&](int buf, int k0) {
    for (int e = tid; e < (BC_TI + BC_TB) * BC_KC; e += BC_F64_THREADS) {
      const int row = e / BC_KC, k = e % BC_KC;
      const int gr = row < BC_TI ? i0 + row : b0 + row - BC_TI;
      const bool ok = gr < R && k0 + k < n;
      bc_cp(&Xs[buf][row][k], ok ? X + (long)gr * n + k0 + k : X, ok);
    }
  };

  double acc[4][4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = 0.0;

  const int steps = (n + BC_KC - 1) / BC_KC;
  stage(0, 0);
  bc_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) stage((s + 1) & 1, (s + 1) * BC_KC);
    bc_commit();
    bc_wait_1();
    __syncthreads();
    const int buf = s & 1;
    if (live) {
#pragma unroll
      for (int kk = 0; kk < BC_KC; kk += 4) {
        double a[4], b[4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          a[mi] = Xs[buf][wr + mi * 8 + g][kk + t];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          b[ni] = Xs[buf][BC_TI + wc + ni * 8 + g][kk + t];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            bc_dmma(acc[mi][ni][0], acc[mi][ni][1], a[mi], b[ni]);
      }
    }
    __syncthreads();
  }
  if (!live) return;
  // the m8n8 accumulator: row g, columns 2t and 2t + 1
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long o = bc_slot(i0, b0, wr + mi * 8 + g, wc + ni * 8 + 2 * t + h,
                               S, bw);
        if (o >= 0) out[o] = acc[mi][ni][h];
      }
}

__global__ void __launch_bounds__(BC_F32_THREADS)
banded_cor_f32_kernel(int R, int n, int S, int bw,
                      const float* __restrict__ X, float* __restrict__ out) {
  // stage s, transposed: column k of the row tile, then of the partner
  // tile, so a thread's 8 rows are two float4 loads
  __shared__ __align__(16) float Xt[2][BC_KC][BC_TI + BC_TB];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * BC_TI;
  const int b0 = i0 + 1 + blockIdx.y * BC_TB;
  const int tr = (tid >> 3) * 8, tc = (tid & 7) * 8;  // the thread's tile

  // neighbouring threads take neighbouring rows, so that their stores
  // into the transposed stage fall in distinct banks (each row's sector
  // is read from L1 again for its next columns)
  auto stage = [&](int buf, int k0) {
    for (int e = tid; e < (BC_TI + BC_TB) * BC_KC; e += BC_F32_THREADS) {
      const int row = e % (BC_TI + BC_TB), k = e / (BC_TI + BC_TB);
      const int gr = row < BC_TI ? i0 + row : b0 + row - BC_TI;
      const bool ok = gr < R && k0 + k < n;
      bc_cp(&Xt[buf][k][row], ok ? X + (long)gr * n + k0 + k : X, ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  const int steps = (n + BC_KC - 1) / BC_KC;
  stage(0, 0);
  bc_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) stage((s + 1) & 1, (s + 1) * BC_KC);
    bc_commit();
    bc_wait_1();
    __syncthreads();
    const int buf = s & 1;
#pragma unroll
    for (int k = 0; k < BC_KC; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xt[buf][k][tr]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Xt[buf][k][tr + 4]);
      const float4 c0 =
          *reinterpret_cast<const float4*>(&Xt[buf][k][BC_TI + tc]);
      const float4 c1 =
          *reinterpret_cast<const float4*>(&Xt[buf][k][BC_TI + tc + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const long o = bc_slot(i0, b0, tr + r, tc + c, S, bw);
      if (o >= 0) out[o] = acc[r][c];
    }
}

// the grid: row tiles x the partner tiles that cover BC_TI - 1 + bw rows
static dim3 bc_grid(int S, int bw) {
  return dim3((S + BC_TI - 1) / BC_TI, (BC_TI - 1 + bw + BC_TB - 1) / BC_TB);
}

extern "C" int banded_cor_launch(int R, int n, int S, int bw, const void* X,
                                 void* out, void* stream) {
  if (S > 0 && bw > 0)
    banded_cor_f32_kernel<<<bc_grid(S, bw), BC_F32_THREADS, 0,
                            (cudaStream_t)stream>>>(
        R, n, S, bw, (const float*)X, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int banded_cor_f64_launch(int R, int n, int S, int bw,
                                     const void* X, void* out,
                                     void* stream) {
  if (S > 0 && bw > 0)
    banded_cor_f64_kernel<<<bc_grid(S, bw), BC_F64_THREADS, 0,
                            (cudaStream_t)stream>>>(
        R, n, S, bw, (const double*)X, (double*)out);
  return (int)cudaGetLastError();
}

GT_ERROR_FN(banded_cor)
