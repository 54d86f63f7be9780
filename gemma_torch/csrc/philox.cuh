// Philox4x32-10 (Salmon et al. 2011; Random123, cuRAND) and the draws the
// BSLMM chain takes from it: the device side of gemma_torch/ops/philox.py,
// which is its plain version and documents the counter layout
// (index, sub, stream, t) under the key (seed low, seed high).  Integer
// arithmetic only, so kernel and plain version get the same bits; the
// float64 conversions use the same operations in the same order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define PHILOX_TWO_PI 6.283185307179586
#define PHILOX_GAMMA_BOOST_SUB 0xFFFFFFFFu

struct PhiloxKey {
  unsigned k0, k1;
};

__device__ __forceinline__ uint4 philox4x32_10(unsigned c0, unsigned c1,
                                               unsigned c2, unsigned c3,
                                               PhiloxKey key) {
  unsigned k0 = key.k0, k1 = key.k1;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const unsigned n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// two uniforms in (0, 1): (k + 1/2) 2^-52 from 26 bits of each of two
// words, exact in float64
__device__ __forceinline__ double2 philox_unit2(PhiloxKey key, unsigned t,
                                                unsigned stream,
                                                unsigned index,
                                                unsigned sub) {
  const uint4 o = philox4x32_10(index, sub, stream, t, key);
  const unsigned long long ka =
      ((unsigned long long)(o.x >> 6) << 26) | (o.y >> 6);
  const unsigned long long kb =
      ((unsigned long long)(o.z >> 6) << 26) | (o.w >> 6);
  return make_double2(((double)ka + 0.5) * 0x1p-52,
                      ((double)kb + 0.5) * 0x1p-52);
}

// Box-Muller, the cosine branch
__device__ __forceinline__ double philox_normal(PhiloxKey key, unsigned t,
                                                unsigned stream,
                                                unsigned index,
                                                unsigned sub) {
  const double2 u = philox_unit2(key, t, stream, index, sub);
  return sqrt(-2.0 * log(u.x)) * cos(PHILOX_TWO_PI * u.y);
}

// gamma(a, 1) by Marsaglia-Tsang: attempt k takes the normal of sub 2k and
// the uniform of sub 2k + 1; below a = 1 the draw of a + 1 times U^(1/a).
// The explicitly rounded operations keep the plain version's order.
__device__ inline double philox_gamma(PhiloxKey key, unsigned t,
                                      unsigned stream, unsigned index,
                                      double a) {
  double boost = 1.0;
  if (a < 1.0) {
    const double ub =
        philox_unit2(key, t, stream, index, PHILOX_GAMMA_BOOST_SUB).x;
    boost = pow(ub, 1.0 / a);
    a = a + 1.0;
  }
  const double d = a - 1.0 / 3.0, c = 1.0 / sqrt(9.0 * d);
  for (unsigned k = 0;; ++k) {
    const double x = philox_normal(key, t, stream, index, 2 * k);
    const double v = __dadd_rn(1.0, __dmul_rn(c, x));
    if (v > 0.0) {
      const double v3 = __dmul_rn(__dmul_rn(v, v), v);
      const double u = philox_unit2(key, t, stream, index, 2 * k + 1).x;
      const double rhs = __dadd_rn(
          __dsub_rn(__dadd_rn(__dmul_rn(__dmul_rn(0.5, x), x), d),
                    __dmul_rn(d, v3)),
          __dmul_rn(d, log(v3)));
      if (log(u) < rhs) return __dmul_rn(__dmul_rn(d, v3), boost);
    }
  }
}

// X ~ N(0, 1) conditioned on X > a: rejection from N(0, 1) where a < 0
// (acceptance >= 1/2), Robert's (1995) shifted exponential where a >= 0
// (acceptance >= 0.76, exact however far out a lies).  Attempt k takes
// sub k.  A NaN bound gives NaN.
__device__ inline double philox_truncnorm_above(PhiloxKey key, unsigned t,
                                                unsigned stream,
                                                unsigned index, double a) {
  if (isnan(a)) return a;
  const double alpha = 0.5 * (a + sqrt(a * a + 4.0));
  for (unsigned k = 0;; ++k) {
    const double2 u = philox_unit2(key, t, stream, index, k);
    if (a >= 0.0) {
      const double x = a - log(u.x) / alpha;
      const double e = x - alpha;
      if (u.y <= exp(-0.5 * e * e)) return x;
    } else {
      const double x = sqrt(-2.0 * log(u.x)) * cos(PHILOX_TWO_PI * u.y);
      if (x > a) return x;
    }
  }
}
