// K4 — Wald statistics and the F(1, df) tail, in float32 (speed mode)
// and float64 (parity mode, entry point wald_tail_f64_launch).
//
// Replaces the reference package's device programs
//   gemma_tpu/models/lmm/likelihood.py:488 wald_stats and
//   gemma_tpu/ops/stats.py:21 f_sf
// (CalcRLWald, lmm.cpp:1125-1161, with gsl_cdf_fdist_Q).
//
// One thread block per SNP at the lane's REML λ; the kernel and its
// bound are in test_tail.cuh, which K5 shares.
#include "test_tail.cuh"

GT_TEST_TAIL_ENTRY(wald_tail_launch, float, false)
GT_TEST_TAIL_ENTRY(wald_tail_f64_launch, double, false)
GT_ERROR_FN(wald_tail)
