// K5 — score statistics and the F(1, df) tail, in float32 (speed mode)
// and float64 (parity mode, entry point score_tail_f64_launch).
//
// Replaces the reference package's device programs
//   gemma_tpu/models/lmm/likelihood.py:519 score_stats and
//   gemma_tpu/ops/stats.py:21 f_sf
// (CalcRLScore, lmm.cpp:1163-1198, with gsl_cdf_fdist_Q).
//
// K4's kernel (test_tail.cuh) at the null model's ML λ, which all lanes
// share and which the kernel reads from device memory (the caller never
// waits on it), with the score statistic f = n p_xy²/(p_yy p_xx).
#include "test_tail.cuh"

GT_TEST_TAIL_ENTRY(score_tail, float, true)
GT_TEST_TAIL_ENTRY(score_tail_f64, double, true)
GT_ERROR_FN(score_tail)
