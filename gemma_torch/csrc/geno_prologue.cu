// K1 — genotype prologue: decode, per-SNP moments, GEMM operand, in
// float32 (speed mode) and float64 (parity mode, entry point
// geno_prologue_f64_launch).
//
// Replaces the reference package's device programs
//   gemma_tpu/ops/pack2.py:56 unpack_bed (2-bit .bed decode),
//   gemma_tpu/parallel/shard.py:41 impute_rows (association operand),
//   gemma_tpu/ops/kinship.py:32 center_genotype_block (kinship operand).
//
// Per SNP row: the observed count, the sum and the sum of squares, then
// the operand:
//   mode 0 (impute): missing -> row mean, others as is (lmm.cpp:1589-1618);
//   mode 1 (centre): missing -> 0, others g - mean, times 1/sqrt(var) when
//     `scale` (-gk 2) with GEMMA's var = (sum g^2 + mean^2 n_miss)/n_total
//     - mean^2 and no scaling where var <= 0 (gemma_io.cpp:1487-1538).
// Wires: 0 = 2-bit packed .bed codes (S, ceil(n/4)) uint8, code 0 -> 2,
// 1 -> missing, 2 -> 1, 3 -> 0 (0x55 pad rows are all missing; slots past
// n in a row's last byte are ignored); 1 = int8 dosages 0..127 with -1
// missing; 2 = float32 and 3 = float64 with NaN missing.  All-missing rows
// come out as zeros.
//
// Bound: bytes.  Per SNP it reads the row once (ceil(n/4) bytes packed,
// n int8, 4n or 8n float) and writes 4n (8n) bytes.  The design:
// * the wire is a template parameter (a kernel per wire and precision),
//   so no element branches on it;
// * a row's bytes are read from device memory once: a block's rows are
//   one contiguous range, staged into shared memory by 16-byte cp.async
//   (its unaligned head and tail by plain loads), and both passes read
//   them there.  Up to K1_WARP_N individuals a warp takes a row and a
//   block several consecutive rows (up to K1_ROWS_SMEM bytes of them);
//   above, a block takes a row, staged where it fits K1_SMEM_MAX (packed
//   and int8 rows up to n = 200,000), else read from device memory by
//   each pass (a float row past 50,000 individuals: the second read
//   mostly from L2);
// * the hard-call wires sum their moments in 32-bit integers, a packed
//   byte's four codes at once by bit arithmetic (popc of the code
//   classes), so the sums are exact and mean = sum / cnt is the IEEE
//   quotient prologue_plain forms: the IMPUTE operand equals it bit for
//   bit.  The float wires sum in the operand's type;
// * the variance is formed with explicitly rounded products and sums
//   (no contraction into fused multiply-adds), as prologue_plain;
// * stores are 16 bytes (float4 / double2, streaming: the next GEMM reads
//   the operand after other traffic) from each row's first aligned
//   element, scalars at its head and tail.
#include "common.cuh"

#define K1_WARPS 8
#define K1_THREADS (32 * K1_WARPS)
#define K1_WARP_N 8192               // a warp a row up to this n
#define K1_ROWS_SMEM (64 * 1024)     // the warp form's staged rows, at most
#define K1_SMEM_MAX (200 * 1024)     // the block form stages a row up to this
// a block may take this much shared memory, static and dynamic together,
// without opting in to more; k1_row's reduction arrays are the static
// part, at most K1_RED_SMEM bytes
#define K1_DEFAULT_SMEM (48 * 1024)
#define K1_RED_SMEM 256

// the launch geometry for a row of nb wire elements: form 0 (a warp a
// row, `rows` rows a block), 1 (a block a row, staged) or 2 (a block a
// row from device memory); smem: dynamic shared memory bytes
struct K1Geom {
  int form, rows;
  long rowbytes, smem;
};

__host__ __device__ inline int k1_esize(int wire) {
  return wire == 2 ? 4 : wire == 3 ? 8 : 1;
}

__host__ __device__ inline K1Geom k1_geom(int wire, int n, int nb) {
  K1Geom g;
  g.rowbytes = (long)nb * k1_esize(wire);
  if (n <= K1_WARP_N) {
    const long r = K1_ROWS_SMEM / g.rowbytes;
    g.form = 0;
    g.rows = (int)(r < 1 ? 1 : r > K1_WARPS ? K1_WARPS : r);
  } else {
    g.form = g.rowbytes <= K1_SMEM_MAX ? 1 : 2;
    g.rows = 1;
  }
  // the staged range starts up to 15 bytes into its first 16-byte chunk
  g.smem = g.form == 2 ? 0 : gt_r16(g.rows * g.rowbytes + 15);
  return g;
}

__device__ __forceinline__ void k1_cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Stage the bytes [g, g + len) into `s`, which stands for the 16-byte
// aligned address at or below g: the whole 16-byte chunks inside the
// range by cp.async, the head before the first and the tail after the
// last by plain loads (all plain where the range holds no whole chunk).
// Every thread of the block calls it; returns where g's byte lies in s.
__device__ __forceinline__ const unsigned char* k1_stage(
    const unsigned char* g, long len, unsigned char* s) {
  const unsigned long a = reinterpret_cast<unsigned long>(g);
  const unsigned long base = a & ~15ul, end = a + len;
  unsigned long lo = (a + 15) & ~15ul, hi = end & ~15ul;
  if (lo >= hi) lo = hi = end;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (long c = tid; c < (long)(hi - lo) / 16; c += nt)
    k1_cp16(s + (lo - base) + 16 * c,
            reinterpret_cast<const void*>(lo + 16 * c));
  asm volatile("cp.async.commit_group;\n" ::);
  for (long i = tid; i < (long)(lo - a); i += nt) s[a - base + i] = g[i];
  for (long i = tid; i < (long)(end - hi); i += nt)
    s[hi - base + i] = reinterpret_cast<const unsigned char*>(hi)[i];
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  return s + (a - base);
}

// rounded arithmetic without contraction (prologue_plain's order)
__device__ __forceinline__ float k1_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double k1_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float k1_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double k1_add(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
struct K1Vec;
template <>
struct K1Vec<float> {
  static constexpr int V = 4;
  __device__ static void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <>
struct K1Vec<double> {
  static constexpr int V = 2;
  __device__ static void store(double* p, const double* v) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  }
};

// the float wire of T: float32 for float, float64 for double
template <int WIRE>
struct K1Float {
  using W = float;
};
template <>
struct K1Float<3> {
  using W = double;
};

// One row: src holds its wire bytes (shared or device memory), dst its n
// outputs; the TEAM threads t = 0..TEAM-1 of a warp (TEAM 32) or of the
// block (TEAM K1_THREADS, every thread of the block calls it).
template <typename T, int WIRE, int TEAM>
__device__ __forceinline__ void k1_row(const unsigned char* src, int n,
                                       int mode, int scale, int n_total,
                                       T* dst, int t) {
  __shared__ unsigned ired[TEAM == 32 ? 1 : K1_WARPS][3];
  __shared__ T fred[TEAM == 32 ? 1 : K1_WARPS][2];
  static_assert(sizeof(ired) + sizeof(fred) + alignof(T) <= K1_RED_SMEM,
                "k1_smem_attr's reserve is too small");
  constexpr bool HARD = WIRE <= 1;
  using W = typename K1Float<WIRE>::W;
  unsigned cnt = 0, isum = 0, isq = 0;
  T fsum = T(0), fsq = T(0);
  if constexpr (WIRE == 0) {
    const int nb = (n + 3) >> 2, tail = n & 3;
    for (int k = t; k < nb; k += TEAM) {
      unsigned b = src[k];
      if (tail && k == nb - 1) {
        // slots past n read as missing (code 1)
        const unsigned keep = (1u << (2 * tail)) - 1u;
        b = (b & keep) | (0x55u & ~keep);
      }
      const unsigned lo = b & 0x55u, hi = (b >> 1) & 0x55u;
      const unsigned c0 = __popc(~(lo | hi) & 0x55u);   // dosage 2
      const unsigned c2 = __popc(hi & ~lo);             // dosage 1
      const unsigned c3 = __popc(hi & lo);              // dosage 0
      cnt += c0 + c2 + c3;
      isum += 2u * c0 + c2;
      isq += 4u * c0 + c2;
    }
  } else if constexpr (WIRE == 1) {
    for (int j = t; j < n; j += TEAM) {
      const int v = (signed char)src[j];
      if (v >= 0) {
        cnt += 1u;
        isum += (unsigned)v;
        isq += (unsigned)(v * v);
      }
    }
  } else {
    const W* row = reinterpret_cast<const W*>(src);
    for (int j = t; j < n; j += TEAM) {
      const T g = (T)row[j];
      if (!isnan(g)) {
        cnt += 1u;
        fsum += g;
        fsq += g * g;
      }
    }
  }
  // team sums: per warp by the reduce instruction (integers) or shuffles;
  // across the block's warps in 64 bits (integers)
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if constexpr (HARD) {
    isum = __reduce_add_sync(0xffffffffu, isum);
    isq = __reduce_add_sync(0xffffffffu, isq);
  } else {
    fsum = gt_warp_sum(fsum);
    fsq = gt_warp_sum(fsq);
  }
  unsigned long long tcnt = cnt, tsum = isum, tsq = isq;
  if constexpr (TEAM != 32) {
    const int warp = t >> 5;
    if ((t & 31) == 0) {
      ired[warp][0] = cnt;
      ired[warp][1] = isum;
      ired[warp][2] = isq;
      fred[warp][0] = fsum;
      fred[warp][1] = fsq;
    }
    __syncthreads();
    tcnt = tsum = tsq = 0;
    fsum = fsq = T(0);
#pragma unroll
    for (int w = 0; w < K1_WARPS; ++w) {
      tcnt += ired[w][0];
      tsum += ired[w][1];
      tsq += ired[w][2];
      fsum += fred[w][0];
      fsq += fred[w][1];
    }
  }
  const T cntT = (T)tcnt;
  const T sum = HARD ? (T)tsum : fsum;
  const T sq = HARD ? (T)tsq : fsq;
  const T mean = sum / gt_max(cntT, T(1));
  T inv = T(1);
  if (mode == 1 && scale) {
    const T n_miss = (T)((long long)n_total - (long long)tcnt);
    const T mm = k1_mul(mean, mean);
    const T var = k1_add(k1_add(sq, k1_mul(mm, n_miss)) / (T)n_total, -mm);
    inv = var > T(0) ? T(1) / gt_sqrt(var) : T(1);
  }
  const bool centre = mode == 1, scaled = centre && scale;
  const T missv = centre ? T(0) : mean;
  auto out = [&](T g) -> T {
    if (!centre) return g;
    const T c = g - mean;
    return scaled ? c * inv : c;
  };
  // the packed codes' values: code 0 -> 2, 1 -> missing, 2 -> 1, 3 -> 0
  const T v0 = out(T(2)), v2 = out(T(1)), v3 = out(T(0));
  auto code_val = [&](unsigned c) -> T {
    return c == 0u ? v0 : c == 1u ? missv : c == 2u ? v2 : v3;
  };
  auto elem = [&](int j) -> T {
    if constexpr (WIRE == 0) {
      return code_val((src[j >> 2] >> (2 * (j & 3))) & 3u);
    } else if constexpr (WIRE == 1) {
      const int v = (signed char)src[j];
      return v < 0 ? missv : out((T)v);
    } else {
      const T g = (T)reinterpret_cast<const W*>(src)[j];
      return isnan(g) ? missv : out(g);
    }
  };
  constexpr int V = K1Vec<T>::V;
  const unsigned long addr = reinterpret_cast<unsigned long>(dst);
  const int head = min(n, (int)(((16 - (addr & 15)) & 15) / sizeof(T)));
  const int groups = (n - head) / V, rest = head + groups * V;
  for (int j = t; j < head; j += TEAM) __stcs(dst + j, elem(j));
  for (int q = t; q < groups; q += TEAM) {
    const int j0 = head + q * V;
    T v[V];
    if constexpr (WIRE == 0) {
      // the group's codes from the one or two bytes that hold them
      const unsigned bits = ((unsigned)src[j0 >> 2] |
                             ((unsigned)src[(j0 + V - 1) >> 2] << 8)) >>
                            (2 * (j0 & 3));
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = code_val((bits >> (2 * e)) & 3u);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = elem(j0 + e);
    }
    K1Vec<T>::store(dst + j0, v);
  }
  for (int j = rest + t; j < n; j += TEAM) __stcs(dst + j, elem(j));
}

// a warp a row, the block's rows staged together
template <typename T, int WIRE>
__global__ void __launch_bounds__(K1_THREADS)
    geno_prologue_warp(const unsigned char* __restrict__ raw, int S, int n,
                       long rowbytes, int mode, int scale, int n_total,
                       T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char k1_smem[];
  const int R = blockDim.x >> 5;
  const long r0 = (long)blockIdx.x * R;
  const int rows = (int)min((long)R, S - r0);
  const unsigned char* s = k1_stage(raw + r0 * rowbytes, rows * rowbytes,
                                    k1_smem);
  const int warp = threadIdx.x >> 5;
  if (warp >= rows) return;
  k1_row<T, WIRE, 32>(s + warp * rowbytes, n, mode, scale, n_total,
                      out + (r0 + warp) * (long)n, threadIdx.x & 31);
}

// a block a row, staged (STAGED) or read from device memory by both passes
template <typename T, int WIRE, bool STAGED>
__global__ void __launch_bounds__(K1_THREADS)
    geno_prologue_block(const unsigned char* __restrict__ raw, int n,
                        long rowbytes, int mode, int scale, int n_total,
                        T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char k1_smem[];
  const long row = blockIdx.x;
  const unsigned char* src = raw + row * rowbytes;
  if constexpr (STAGED) src = k1_stage(src, rowbytes, k1_smem);
  k1_row<T, WIRE, K1_THREADS>(src, n, mode, scale, n_total,
                              out + row * (long)n, threadIdx.x);
}

// opt in to smem dynamic bytes where they and the static reduction
// arrays pass the default
template <typename K>
static void k1_smem_attr(K kern, long smem) {
  if (smem + K1_RED_SMEM > K1_DEFAULT_SMEM)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
}

template <typename T, int WIRE>
static void k1_launch(const void* raw, int S, int n, int nb, int mode,
                      int scale, int n_total, T* out, cudaStream_t st) {
  const K1Geom g = k1_geom(WIRE, n, nb);
  const unsigned char* r = (const unsigned char*)raw;
  if (g.form == 0) {
    k1_smem_attr(geno_prologue_warp<T, WIRE>, g.smem);
    geno_prologue_warp<T, WIRE><<<(S + g.rows - 1) / g.rows, 32 * g.rows,
                                  g.smem, st>>>(r, S, n, g.rowbytes, mode,
                                                scale, n_total, out);
  } else if (g.form == 1) {
    k1_smem_attr(geno_prologue_block<T, WIRE, true>, g.smem);
    geno_prologue_block<T, WIRE, true><<<S, K1_THREADS, g.smem, st>>>(
        r, n, g.rowbytes, mode, scale, n_total, out);
  } else {
    geno_prologue_block<T, WIRE, false><<<S, K1_THREADS, 0, st>>>(
        r, n, g.rowbytes, mode, scale, n_total, out);
  }
}

// the float32 kernel reads wires 0-2, the float64 one wires 0, 1 and 3
template <typename T>
static int geno_prologue_run(const void* raw, int wire, int S, int n, int nb,
                             int mode, int scale, int n_total, void* out,
                             void* stream) {
  constexpr int FW = sizeof(T) == 4 ? 2 : 3;
  if (wire != 0 && wire != 1 && wire != FW) return (int)cudaErrorInvalidValue;
  if (S > 0 && n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (wire == 0)
      k1_launch<T, 0>(raw, S, n, nb, mode, scale, n_total, (T*)out, st);
    else if (wire == 1)
      k1_launch<T, 1>(raw, S, n, nb, mode, scale, n_total, (T*)out, st);
    else
      k1_launch<T, FW>(raw, S, n, nb, mode, scale, n_total, (T*)out, st);
  }
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

// the geometry's fields for a row of nb wire elements: 0 form, 1 rows a
// block, 2 dynamic shared memory bytes (chip_smoke.k1_geometry mirrors it)
extern "C" long geno_prologue_geometry(int wire, int n, int nb, int field) {
  const K1Geom g = k1_geom(wire, n, nb);
  return field == 0 ? g.form : field == 1 ? g.rows : g.smem;
}

GT_ERROR_FN(geno_prologue)
