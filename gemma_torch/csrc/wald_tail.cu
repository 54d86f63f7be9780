// K4 — Wald statistics and the F(1, df) tail, in float32 (speed mode)
// and float64 (parity mode, entry point wald_tail_f64_launch).
//
// Replaces the reference package's device programs
//   gemma_tpu/models/lmm/likelihood.py:488 wald_stats and
//   gemma_tpu/ops/stats.py:21 f_sf
// (CalcRLWald, lmm.cpp:1125-1161, with gsl_cdf_fdist_Q).
//
// At each lane's REML λ; the kernel, its design (the sums of
// test_sums.cuh, the recurrence on a warp, the tails a thread a lane) and
// its bound are in test_tail.cuh, which K5 shares.
#include "test_tail.cuh"

GT_TEST_TAIL_ENTRY(wald_tail, float, false)
GT_TEST_TAIL_ENTRY(wald_tail_f64, double, false)
GT_ERROR_FN(wald_tail)
