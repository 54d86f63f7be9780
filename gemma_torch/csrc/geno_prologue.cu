// K1 — genotype prologue: decode, per-SNP moments, GEMM operand, in
// float32 (speed mode) and float64 (parity mode, entry point
// geno_prologue_f64_launch).
//
// Replaces the reference package's device programs
//   gemma_tpu/ops/pack2.py:56 unpack_bed (2-bit .bed decode),
//   gemma_tpu/parallel/shard.py:41 impute_rows (association operand),
//   gemma_tpu/ops/kinship.py:32 center_genotype_block (kinship operand).
//
// One thread block per SNP row.  Pass 1 decodes the row and block-reduces
// the observed count, the sum and the sum of squares; pass 2 decodes the
// row again and writes the operand:
//   mode 0 (impute): missing -> row mean, others as is (lmm.cpp:1589-1618);
//   mode 1 (centre): missing -> 0, others g - mean, times 1/sqrt(var) when
//     `scale` (-gk 2) with GEMMA's var = (sum g^2 + mean^2 n_miss)/n_total
//     - mean^2 and no scaling where var <= 0 (gemma_io.cpp:1487-1538).
// Wires: 0 = 2-bit packed .bed codes (S, ceil(n/4)) uint8, code 0 -> 2,
// 1 -> missing, 2 -> 1, 3 -> 0 (0x55 pad rows are all missing); 1 = int8
// with -1 missing; 2 = float32 and 3 = float64 with NaN missing.  All-
// missing rows come out as zeros.  The moments are summed in the
// operand's type.
//
// Bound: bytes.  Per SNP it reads ceil(n/4) bytes (packed) and writes
// 4n (8n) bytes; the second read of the row hits L1/L2 (a row is <= a few
// KB), so device-memory traffic is one read and one write.  The design
// keeps the decode in registers and never materialises the int8 dosages
// that the reference's decode-then-impute pair writes between its two
// programs.
#include "common.cuh"

template <typename T>
__device__ __forceinline__ T gt_decode_code(unsigned code) {
  // code -> dosage; NaN marks missing
  return code == 0u ? T(2) : code == 2u ? T(1) : code == 3u ? T(0) : T(NAN);
}

template <typename T>
__device__ __forceinline__ T gt_load(const void* raw, int wire, long row,
                                     int nb, int j) {
  if (wire == 0) {
    const uint8_t b = ((const uint8_t*)raw)[row * nb + (j >> 2)];
    return gt_decode_code<T>((b >> (2 * (j & 3))) & 3u);
  }
  if (wire == 1) {
    const int8_t v = ((const int8_t*)raw)[row * nb + j];
    return v < 0 ? T(NAN) : (T)v;
  }
  if (wire == 2) return (T)((const float*)raw)[row * nb + j];
  return (T)((const double*)raw)[row * nb + j];
}

template <typename T>
__global__ void geno_prologue_kernel(const void* raw, int wire, int n,
                                     int nb, int mode, int scale,
                                     int n_total, T* out) {
  __shared__ T red[GT_WARPS * 8];
  __shared__ T sums[3];
  const long row = blockIdx.x;
  auto f = [&](int q, int j) -> T {
    const T g = gt_load<T>(raw, wire, row, nb, j);
    const bool miss = isnan(g);
    if (q == 0) return miss ? T(0) : T(1);
    if (q == 1) return miss ? T(0) : g;
    return miss ? T(0) : g * g;
  };
  gt_block_sums(f, 3, n, sums, red);
  const T cnt = sums[0];
  const T mean = sums[1] / gt_max(cnt, T(1));
  T inv = T(1);
  if (mode == 1 && scale) {
    const T n_miss = (T)n_total - cnt;
    const T var = (sums[2] + mean * mean * n_miss) / (T)n_total - mean * mean;
    inv = var > T(0) ? T(1) / gt_sqrt(var) : T(1);
  }
  T* dst = out + row * (long)n;
  for (int j = threadIdx.x; j < n; j += GT_THREADS) {
    const T g = gt_load<T>(raw, wire, row, nb, j);
    const bool miss = isnan(g);
    T v;
    if (mode == 0)
      v = miss ? mean : g;
    else
      v = miss ? T(0) : (g - mean) * inv;
    dst[j] = v;
  }
}

template <typename T>
static int geno_prologue_run(const void* raw, int wire, int S, int n, int nb,
                             int mode, int scale, int n_total, void* out,
                             void* stream) {
  if (S > 0)
    geno_prologue_kernel<T><<<S, GT_THREADS, 0, (cudaStream_t)stream>>>(
        raw, wire, n, nb, mode, scale, n_total, (T*)out);
  return (int)cudaGetLastError();
}

extern "C" int geno_prologue_launch(const void* raw, int wire, int S, int n,
                                    int nb, int mode, int scale, int n_total,
                                    void* out, void* stream) {
  return geno_prologue_run<float>(raw, wire, S, n, nb, mode, scale, n_total,
                                  out, stream);
}

extern "C" int geno_prologue_f64_launch(const void* raw, int wire, int S,
                                        int n, int nb, int mode, int scale,
                                        int n_total, void* out,
                                        void* stream) {
  return geno_prologue_run<double>(raw, wire, S, n, nb, mode, scale, n_total,
                                   out, stream);
}

GT_ERROR_FN(geno_prologue)
