#!/usr/bin/env python3
"""Smoke run of gemma_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the kernels from gemma_torch/csrc (one nvcc per source, all at
   once) into build/gemma_torch/.
2. Drives the port's paths through `gemma_torch.run.batch_run` on the
   card, on a mouse_hs1940-scale BIMBAM file (n = 1940, p = 12,226, 3%
   missing, seed 0) and a small PLINK set (n = 400, p = 2,000, three
   covariates):
     main path    `-gk` then `-k K.cXX.txt -lmm 1`;
     PLINK path   `-gk 2`, then `-c` `-lmm 1`;
     (a) lmm4     `-lmm 4` at full width (speed mode, float32);
     (b) lmm4_f64 `-precision float64` `-gk` and `-lmm 4` (parity mode);
     (c) modes    PLINK `-eigen`, `-u/-d -lmm 9` beside `-k -lmm 9`,
                  `-lmm 5`, `-widv -lmm 2`;
     (e) slice 3  on the mouse set: `-gk -loco 1 -a` then `-lmm 1 -loco
                  1 -a` (19 chromosomes, as the PLINK .bim), `-lmm 4
                  -gxe` (a binary environment) and `-lmm 4 -gene` (2,048
                  genes) in float32 and float64, `-lm 4` with and
                  without `-gene` and in float64;
     (f) mvLMM    at the releases.org protocol shape (n = 757, p =
                  10,775, 3% missing, two traits with h² 0.4, genetic
                  correlation 0.5, environmental 0.3, 8 causal SNPs):
                  `-gk`, `-lmm 1 -n 1 2` cold and warm (SNPs/s), `-lmm
                  4 -n 1 2` and `-lmm 4 -n 1 2 -gxe` in float32 and
                  float64, `-lmm 1 -n 1 2 3 4 5` on the first 1,024 SNPs,
                  and `-lmm 4 -n 1 2 -crt -pnr 0.9` in both precisions and
                  `-lmm 1 -n 1 2 3 4 5 -crt -pnr 0.9` on 1,024 SNPs;
     (g) BSLMM    on the mouse genotypes, a phenotype of 10 causal SNPs
                  (25% of the variance), a polygenic part (25%) and 10%
                  NA, and its binary form: `-bslmm 1 -w 10000 -s
                  100000` (a tenth of GEMMA's default chain), `-bslmm 1`
                  in float64 (-w 1000 -s 4000), `-bslmm 2`, `-bslmm 3 -w
                  1000 -s 10000`, `-bslmm 4` in both precisions and with
                  rho fixed at 1, `-bslmm 5` from the card's Bayes
                  factors, `-predict 1/2` from the card's -bslmm 1 files
                  and `-predict 3`;
     (h) VC/cor   on the mouse genotypes, a phenotype with a polygenic
                  part (h² 0.5), an annotation over two chromosomes with
                  positions 3 kb apart and two kinships from `-gk -snps`
                  on the two halves of the SNPs: `-vc 1/2/3` with `-k`
                  and with `-mk` of both, `-calccor` and `-gw`, in float32
                  and float64;
     (i) cvt24    `-lmm 4` and `-lm 4` on the mouse set with `-c` of an
                  intercept and 23 seeded normal columns, and `-lmm 4
                  -gxe` with the first 22 of them (24 with env and x)
                  (K2-K8's second instantiation, above 16 covariates), in
                  float32 and float64;
     (j) MQS      on phase (h)'s genotypes and phenotype: marginal
                  z-scores in a `-beta` file, four `-cat` categories (the
                  quarters of the SNPs), seeded `-wsnp` weights, `-wcat`
                  per-category LD scores from phase (h)'s correlations;
                  `-gq`, `-gs`, `-vc 1 -beta -wsnp`, `-vc 2 -beta -wcat`,
                  `-vc 1 -study/-ref` and `-ci 1/2` (`-pve` from the
                  card's float64 `-vc 1`), in float32 and float64;
     (k) wide     every shape past a bound the kernels once had, at full
                  width in float32 and float64: on phase (f)'s genotypes
                  ten traits made as (f)'s two, `-c` an intercept and 11
                  seeded normal columns, `-lmm 4 -n 1 ... 10` (13 design
                  rows) with `-crt -pnr 0.9` on the first 256 SNPs (K14
                  at d = 10), `-lmm 4 -n 1 2 -gxe` with the first 10
                  columns (14 rows a lane) and `-lmm 4 -n 1 2 -crt -pnr
                  0.9` (K14 at c = 13) on the first 1,024; on
                  phase (g)'s data `-bslmm 1 -smin 1100 -smax 2048 -w 5
                  -s 20` and `-bslmm 1 -smin 200 -smax 300 -w 5 -s 20`
                  (GEMMA's default s_max) in float32 and float64; on the
                  mouse set's first 1,024 SNPs `-lmm 4`
                  and `-lm 4` with `-c` of an intercept and 39 seeded
                  normal columns, `-lmm 4 -gxe` with 38 (40 a lane);
                  and it prints the lane splits of each path and phase
                  (h)'s `-calccor`/`-gw` load/opt/write times.
   Every kernel's launch count is set to 0 just before each path and
   read just after; each kernel of the path must have launched.
3. Checks the output against the port's own float64 path on the CPU on
   the same K file, first 1024 SNPs: the main path's p_wald and (a)'s
   p_wald/p_lrt/p_score within 1e-3 (the speed-mode contract), >= 97%
   finite; (b)'s within 1e-6 with the same NaN lanes on >= 99.9% of
   SNPs, and its kinship within 1e-9 (relative to the largest entry) of
   the CPU's float64 `-gk`; (c)'s `-u/-d` p-values within 1e-3 of the
   `-k` run's; (e)'s against the port's float64 CPU run on the same
   files, first 1024 SNPs or genes: within 1e-3 in float32, >= 97%
   finite and no NaN p_lrt in gene mode, within 1e-6 in float64 with
   >= 99.9% the same NaN lanes; its float64 LOCO kinship within 1e-9 of
   the CPU's; (f)'s against the port's float64 CPU run, first 256 SNPs:
   within 1e-3 in float32 (>= 97% finite), within 1e-6 in float64 on
   every lane whose K9 iteration count equals the CPU's (>= 99% of
   lanes) and 1e-3 on all; -n 1 2 3 4 5: >= 97% finite p-values; (g)'s
   against the port's float64 CPU runs: -bslmm 2's alpha and bv rel
   1e-4, -bslmm 4's log BF on the first 1024 SNPs within 1e-3 (float32)
   and 1e-8 (float64), -bslmm 5 and -predict 1/2/3 from the same files
   rel 1e-8, -bslmm 1's initial values rel 1e-4 with the same |gamma|;
   its mean pve within 0.1 of the simulated 0.5, >= 8 of the 10 causal
   SNPs among the 20 of highest inclusion, and its predictions of the
   held-out individuals correlated >= 0.3 with their genetic values;
   (f)'s -crt runs float32 against float64 within 1e-3; (h)'s float64
   -vc estimates against the port's float64 CPU runs rel 1e-8, its
   float32 pve within 1e-3 of float64, REML's total pve within 3 se of
   the simulated 0.5, its float32 correlations within 1e-5 of float64
   and -gw's equal to -calccor's; (i)'s against the port's float64 CPU
   run on the first 1024 SNPs (32 for -gxe): within 1e-3 in float32 (>=
   97% finite), within 1e-6 in float64 with >= 99.9% the same NaN lanes;
   (j)'s float64 -gs S and Svar (relative to each matrix's largest entry)
   and every estimate of -vc/-ci against the port's float64 CPU runs rel
   1e-8, float32 pve and se_pve within 1e-3 of float64, and the MQS total
   pve within 0.15 of (h)'s HE total pve (-vc 1 -mk) and within 3 se of
   the simulated 0.5; (k)'s -gxe and -crt at d = 2 against the port's
   float64 CPU run on the first 16 SNPs as (f)'s; its ten-trait run
   (float64, ROADMAP §C20) launching no float32 mvLMM kernel, >= 97%
   finite p-values in [0, 1], and against the CPU's float64 on every lane
   of the first 16 SNPs within D10_LIM (§C20; that CPU run goes on in a
   process of its own and is compared after the holds);
   every -smin 1100 chain's n_gamma >= 1,100 and every -smin 200 chain's
   >= 200; its c = 40 paths against
   the port's float64 CPU run on the first 128 SNPs (16 for -gxe) as
   (i)'s.
4. Holds each kernel against its plain PyTorch version on the card, on
   the same inputs, at the main path's shapes (n = 1940, S = the run's
   block, c = 1, and c = 3 for K2-K7; the per-lane forms of K2-K7 at the
   GxE shapes, c = 1 plus env and x, and at the gene shapes, 2,048
   genes; K8 on SNP rows and gene rows; K9-K11 on the whole mvLMM
   protocol block, its GxE form and the five-trait block, the last at
   the float64 tolerances; K12 for 2,000 iterations from -bslmm 1's
   state in each precision and 100 of -bslmm 3's, K13 on -bslmm 4's
   products; K14 on the lanes the -crt paths refine, at their Newton
   optima, protocol block and five-trait block; K15 on the -vc paths'
   own stacks (HE's against itself, REML's P against the stack, -k and
   -mk) and on three random symmetric 8,192² matrices made on the card,
   K16 on the whole band of phase (h)'s rows and on the path's first and
   last blocks; K2-K8 at c = 24, phase (i)'s covariates, on the first
   2,048 lanes of the main path's block (K8 on the whole block), and
   K2-K7's per-lane forms on the first 1,024 lanes of phase (i)'s -gxe
   block; K15 on the MQS paths' stacks (A = K, and -vc 2's weighted A
   against K) and K1's standardised form on the -ci paths' first block;
   phase (k)'s forms: K2-K8 at c = 40 on 128 lanes of the main block
   (K8 on all of it) and K2-K7's per-lane forms on 128 lanes of its -gxe
   block, K9-K11 on 64 seeded ten-trait lanes at 13 design rows (n =
   757; phase (k)'s equicorrelated traits part the kernel from its
   plain version, ROADMAP §C20) and on the first 64 lanes of the -gxe
   block, in both operand types, K14 on up to 32 lanes the c = 13 -crt
   path refined and on 32 seeded ten-trait lanes, K12 for 5 iterations
   from each -smin 1100 chain's state and 20 from each -smin 200 chain's;
   K12's records carry its cluster's size and the chain's mean n_gamma;
   K3 and K7 also on seeded blocks that mix the searches' exits in each
   block of lanes, at 1, L - 1, L + 1 and 3L + 3 lanes (_hold_mixed), at
   c = 40 split into launches of three lanes, and their launch layout's
   Python mirror against the kernels' size functions; their records
   carry `evals`, the evaluations the plain search made, and
   `ms_per_eval`), with the tolerances below, and times both (CUDA events, median after
   warm-up, L2 flushed between runs; the plain mvLMM loops once, on the
   call compared; K15 and torch.einsum also on the card's clock alone,
   the host's enqueue hidden behind a sleep on the card, as device_ms).
5. Prints the card's name and power limit, the kernels line and, last,
   {"ok": true, "device": {...}}; the whole report is also written to
   build/chip_smoke.out.

Any failed phase raises, and the script exits non-zero without the last
line.  Without a CUDA device it exits non-zero at once.  Imports nothing
of JAX or of the reference package.
"""

import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPORT = os.path.join(HERE, "build", "chip_smoke.out")

# memory rate, float32 and float64 (non-tensor) rates of one H100 SXM
# (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12
# the FP64 tensor cores (DMMA, the data sheet's "FP64 Tensor Core"):
# K16's float64 form and K14's products run there; every other float64
# bound is the CUDA cores' 34 TFLOP/s
PEAK_F64_TC_PER_S = 67e12
L2_FLUSH_BYTES = 64 << 20        # more than the H100's 50 MB L2
# about 0.2 ms of the card's clock, which _time_device_ms checks is longer
# than the host takes to enqueue a wrapper's launches
DEVICE_SLEEP_CYCLES = 400_000
# every phase and kernel line of the report carries t_s, the seconds
# since the script started
T_START = time.time()

# kernel vs plain version on the same inputs (float32 on the card: the
# two sum in different orders and the kernels contract to FMA; float64:
# the same, at float64 rounding)
TOL = {
    # operand values are O(1); the row mean is a float32 sum of <= 1940
    # integers, exact, divided once
    "geno_prologue": "|x - x_plain| <= 1e-5",
    # dev1 = -(df - trace_p)/(2λ) + ...: df and trace_p cancel, so one
    # float32 rounding of ~n is amplified by 1/λ (λ down to 1e-5)
    "lambda_grid": "|d1 - d1_plain| <= 1e-5 max|d1_plain| + 8 n eps32 / λ_g",
    # Newton stops within 5e-4 relative of the root, and where the
    # likelihood is flat two float32 evaluations may pick different
    # near-tied candidates: compare what λ feeds through the same (plain)
    # tail — p_wald for the REML fit, p_lrt for the ML fit — at the
    # speed-mode contract, and logf tightly
    "lambda_solve": "|p(λ) - p(λ_plain)| <= 1e-3 (p_wald of REML λ, "
                    "p_lrt of ML λ), |logf - logf_plain| <= 1e-4 "
                    "|logf_plain|, same finite lanes",
    "wald_tail": "|p - p_plain| <= 1e-5, |beta - beta_plain| <= 1e-3 se",
    "score_tail": "|p - p_plain| <= 1e-5, |beta - beta_plain| <= 1e-3 se",
    # float64 sums of float32 operands in both: logl agrees to float64
    # rounding of n terms; p = Q(1/2, Δ) has slope ~1/sqrt(πΔ) at small
    # Δ, so a 1e-12 difference in Δ moves p by up to ~1e-6
    "lrt_tail": "|logl - logl_plain| <= 1e-12 |logl_plain|, "
                "|p - p_plain| <= 1e-6 (tail only, parity: <= 1e-12)",
    # float64: λ through the same Wald tail; a Newton exit test at its
    # 1e-5 boundary may keep a neighbouring iterate, and a lane at the
    # NaN-poisoning edge may flip
    "lambda_solve_f64": "|p_wald(λ) - p_wald(λ_plain)| <= 1e-6, "
                        "|logf - logf_plain| <= 1e-9 |logf_plain|, "
                        ">= 99.9% same NaN lanes",
    "geno_prologue_f64": "|x - x_plain| <= 1e-12",
    "wald_tail_f64": "|p - p_plain| <= 1e-10, |beta - beta_plain| <= 1e-8 se",
    "score_tail_f64": "|p - p_plain| <= 1e-10, "
                      "|beta - beta_plain| <= 1e-8 se",
    # both sum in float64 from the same operands, in another order
    "lm_tail": "|p - p_plain| <= 1e-6, |beta - beta_plain| <= 1e-5 se",
    "lm_tail_f64": "|p - p_plain| <= 1e-12, "
                   "|beta - beta_plain| <= 1e-10 se",
    # K9-K11 compute in float64 from the same operands in both; the EM's
    # exit test |Δlogl| < 1e-3 may flip at its boundary on a rounding
    # difference, so the converged form compares p on the lanes that
    # left at the same iteration (float64) or at the speed-mode contract
    "mph_em": "capped (50 iterations, prec 0): Vg, Ve, logl rel <= 1e-6; "
              "converged (-lmm 1's form): |p_wald - p_wald_plain| <= 1e-3 "
              "through the same (plain) tail",
    "mph_em_f64": "capped: Vg, Ve, logl rel <= 1e-10; converged: "
                  "|p_wald - p_wald_plain| <= 1e-6 on lanes with the same "
                  "iteration count (>= 99% of lanes), every lane <= 1e-3",
    "mph_calc_p": "|p - p_plain| <= 1e-5, |beta - beta_plain| <= 1e-3 se",
    "mph_calc_p_f64": "|p - p_plain| <= 1e-10, "
                      "|beta - beta_plain| <= 1e-8 se",
    "mph_nr": "logl rel <= 1e-10, Hvar rel <= 1e-8",
    "mph_nr_f64": "logl rel <= 1e-10, Hvar rel <= 1e-8",
    # K12 and its plain version take the same Philox draws and compute in
    # float64; sums in another order move logpost by ~1e-13, which flips
    # an accept decision only if log u lands that close to log(MH ratio)
    "bslmm_chain": "every iteration recorded: the same accept decisions "
                   "and ranks, hyperparameter rows rel <= 1e-9, up to the "
                   "first divergence, which comes after iteration 1,000 "
                   "(the probit form: after its 100) or never",
    "bslmm_chain_f64": "as bslmm_chain",
    # float64 epilogue in both from the same products
    "dap_bf": "|BF - BF_plain| <= 1e-6 |BF_plain|, the same finite entries",
    "dap_bf_f64": "|BF - BF_plain| <= 1e-10 |BF_plain|, the same finite "
                  "entries",
    # float64 sums of the same operands in another order (the plain version
    # takes every trace by batched einsum)
    "calc_crt": "crt_a, crt_b, crt_c each: max |k - p| <= 1e-9 max |p| over "
                "the lanes finite in both, the same finite lanes",
    # both form the products in float64 (exact for float32 operands) and
    # sum them in another order
    "pair_colsum": "max |k - p| <= 1e-12 max |p|",
    "pair_colsum_f64": "max |k - p| <= 1e-12 max |p|",
    # float32: sums of n <= 1940 products of unit-norm rows in another
    # order; float64 the same at float64 rounding
    "banded_cor": "|cor - cor_plain| <= 1e-5",
    "banded_cor_f64": "max |k - p| <= 1e-12 max |p|",
}
# the per-lane forms of K2-K7 (GxE, gene mode) and the c = 24 forms of
# K2-K8 are held to their shared forms' tolerances, but for the float32
# tests: at GxE's 3 covariates (1 + env + x) four columns are eliminated
# in float32, at c = 24 twenty-five, and the shared c = 3 form already
# reached 9.9e-6 (PERF.md) when the two summed their float32 base rows in
# different orders (both now round float64 sums)
TOL_LANE = {
    "wald_tail": "|p - p_plain| <= 3e-5, |beta - beta_plain| <= 1e-3 se",
    "score_tail": "|p - p_plain| <= 3e-5, |beta - beta_plain| <= 1e-3 se",
}

GENES, GENE_SIGNAL = 2048, 8

MOUSE_N, MOUSE_P = 1940, 12226
PLINK_N, PLINK_P, PLINK_COV = 400, 2000, 2
CHECK_SNPS = 1024
P_COLS = ("p_wald", "p_lrt", "p_score")
# phase (f): the releases.org mvLMM protocol shape (bench.py:78)
MV_N, MV_P, MV_TRAITS, MV_CAUSAL, MV_CHECK = 757, 10775, 5, 8, 256
# phase (g): BSLMM on the mouse genotypes
BSLMM_CAUSAL, BSLMM_HELD, BSLMM_SEED = 10, 0.10, 1
# -bslmm 1's chain: a tenth of GEMMA's default -w 100000 -s 1000000
BSLMM_W, BSLMM_S = 10000, 100000
# the chain held against its plain version; K12 and the plain loop are
# both timed on these iterations
HOLD_ITERS = 2000
# phase (h): variance components and correlations on the mouse genotypes;
# K15 held on random symmetric operands at this n and stack
VC_H2, VC_SEED, PC_N, PC_M = 0.5, 6, 8192, 3
# phase (i): an intercept and CVT_N - 1 seeded normal covariates (a human
# GWAS's sex, age, batch and principal components); K2-K8's c = 24 forms
# held on the first CVT_LANES lanes of the main path's block, the
# per-lane forms on the first CVT_GXE_LANES of the -gxe block; the -gxe
# run checked on its first CVT_GXE_CHECK SNPs (the CPU's per-lane search
# at c = 24 takes about a second a SNP at n = 1940)
CVT_N, CVT_SEED, CVT_LANES = 24, 24, 2048
CVT_GXE_LANES, CVT_GXE_CHECK = 1024, 32
# phase (j): MQS on phase (h)'s genotypes and phenotype, MQS_CATS -cat
# categories (the quarters of the SNPs)
MQS_CATS, MQS_SEED = 4, 8
# phase (k): shapes past the kernels' old bounds.  The mvLMM on phase
# (f)'s genotypes with WIDE_TRAITS traits and an intercept plus
# WIDE_MV_COV - 1 seeded normal covariates (c = 13 with the SNP), with
# -crt -pnr 0.9, on the first 256 SNPs; -gxe with the first
# WIDE_MV_COV - 1 covariates (14 rows a lane with env, x and x∘env) and
# -crt at d = 2 (c = 13) on the first 1,024; each against the CPU's
# float64 on the first WIDE_MV_CHECK SNPs; K9 and K10 held on the first
# WIDE_MV_HOLD lanes, K11 on the first WIDE_NR_HOLD of the ten-trait
# run's, K14 on up to WIDE_CRT_HOLD refined lanes.  BSLMM on phase (g)'s
# data with -smin/-smax WIDE_SMIN/WIDE_SMAX and a chain of WIDE_W + WIDE_S
# iterations, K12 held for WIDE_HOLD_ITERS.  K2-K8 with CVT40_N
# covariates (an intercept and seeded normal columns; -gxe with the first
# CVT40_N - 2) on the mouse set's first CVT40_SNPS SNPs, checked on the
# first CVT40_CHECK (CVT40_GXE_CHECK for -gxe), held on CVT40_LANES
# (CVT40_GXE_LANES) lanes.
WIDE_TRAITS, WIDE_MV_COV, WIDE_MV_CHECK = 10, 12, 16
WIDE_MV_HOLD, WIDE_CRT_HOLD, WIDE_NR_HOLD = 64, 32, 16
WIDE_SMIN, WIDE_SMAX, WIDE_W, WIDE_S, WIDE_HOLD_ITERS = 1100, 2048, 5, 20, 5
# BSLMM at GEMMA's default s_max, with s_min 200 (phase (k)): Omega of
# 200-300 active ranks sits in rank 0's shared memory or across the
# cluster's (K12's BsView), held for S300_HOLD_ITERS iterations
S300_SMIN, S300_SMAX, S300_HOLD_ITERS = 200, 300, 20
# s_min of a K12 hold from that chain's operands above which Omega
# (n_gamma (n_gamma + 1) / 2 words) outgrows rank 0's shared memory at
# s_max 300 on an H100 (the last n_gamma there is 216) and is cut over
# the cluster's
S300_DIST = 224
CVT40_N, CVT40_SEED, CVT40_SNPS, CVT40_CHECK = 40, 40, 1024, 128
CVT40_GXE_CHECK, CVT40_LANES, CVT40_GXE_LANES = 16, 128, 128
# K2's warp form past its shared memory, where no path of this run takes
# it: GRID_WIDE_N covariates (an intercept and seeded normal columns) on
# the main block's first GRID_WIDE_LANES SNPs at every GRID_WIDE_STEP-th
# grid point; its rows live in global scratch above 194 covariates, and
# above 338 it reads the pivots' indices from the tables, not its labels
GRID_WIDE_N, GRID_WIDE_LANES, GRID_WIDE_STEP = (200, 340), 2, 10
# K4-K6 past the shapes the paths give them: TAIL_WIDE_N covariates (an
# intercept and seeded normal columns) on the main block's first
# TAIL_WIDE_LANES SNPs (a tile of 8 lanes and part of another), and as
# a -gxe block (TAIL_WIDE_N - 2 columns, env and x) on the first
# TAIL_WIDE_GXE_LANES, at seeded λ.  There K4/K5 stage each chunk's
# columns of a pass at a stride (float64 past ~69 covariates, float32
# past ~100) and read the recurrence's pivots from the tables (past ~88);
# At TAIL_WIDE_LRT_N (K6 alone, shared operands) K6 keeps each lane's
# solution in its scratch and its residual pass reads [W, y] from device
# memory, past the 319 covariates whose chunks it stages.
TAIL_WIDE_N, TAIL_WIDE_LANES, TAIL_WIDE_GXE_LANES = (120, 200), 10, 3
TAIL_WIDE_LRT_N = 400
# The ten-trait run's lanes: its null fits lie on the boundary (Vg of
# rank 7-8; the ML Ve's two least eigenvalues ~1e-7, and the per-SNP REML
# fits keep them), where the mvLMM's iterates amplify rounding (ROADMAP
# §C20).  K9-K11 and K14 are held there beside two witnesses of that
# amplification measured on the same lanes in the same run: the plain
# version on the CPU, and (K9 capped at D10_CAP iterations) on the card
# from Y moved by one ulp.  Each limit is about ten times the kernel's and
# the CPU witness's readings (the larger), which agreed within 2x on an
# H100 (PERF.md §6): K9 capped Vg, Ve 1.1e-8 (CPU 1.1e-8)
# and logl 1.8e-6 (1.5e-6); converged p 1.9e-5 (1.9e-5) on lanes that
# left at the same iteration, 1.4e-3 (2.3e-3) on all; K10 p 2.1e-4
# (2.5e-4), beta 5.6e-4 se (6.9e-4); K11 logl 1.1e-6 (1.2e-6), Hvar
# 1.7e-2 (3.3e-2, Hvar = H^-1 on a near-singular H: 0.1, three times
# the CPU's); K14 8.0e-10 (4.7e-9).  The run itself is held against the
# CPU's float64 on every lane of its first WIDE_MV_CHECK SNPs: p_wald and
# p_score at 1e-3; p_lrt, whose ML fits stop on a flat likelihood at the
# boundary after Newton (read 7.1e-3), at 2e-2.
D10_CAP = 3
D10_LIM = {"em_capped_VgVe": 1e-7, "em_capped_logl": 1e-5,
           "em_p_same": 1e-4, "em_p_all": 1e-2,
           "calc_p": 2e-3, "calc_p_se": 5e-3,
           "nr_logl": 1e-5, "nr_Hvar": 0.1, "crt": 1e-8,
           "path": {"p_wald": 1e-3, "p_lrt": 2e-2, "p_score": 1e-3}}
TOL_D10 = {
    "mph_em": (f"capped ({D10_CAP} iterations, prec 0), REML and ML: Vg, "
               f"Ve rel <= {D10_LIM['em_capped_VgVe']:g}, logl rel <= "
               f"{D10_LIM['em_capped_logl']:g}; converged: |p_wald - "
               f"p_wald_plain| <= {D10_LIM['em_p_same']:g} on lanes with "
               f"the same iteration count, every lane <= "
               f"{D10_LIM['em_p_all']:g}; seeded lanes capped at 30: rel "
               "<= 1e-10; a split call equal to one call (ROADMAP §C20)"),
    "mph_calc_p": (f"|p - p_plain| <= {D10_LIM['calc_p']:g}, |beta - "
                   f"beta_plain| <= {D10_LIM['calc_p_se']:g} se "
                   "(ROADMAP §C20)"),
    "mph_nr": (f"logl rel <= {D10_LIM['nr_logl']:g}, Hvar rel <= "
               f"{D10_LIM['nr_Hvar']:g}; a split call equal to one call "
               "(ROADMAP §C20)"),
    "calc_crt": (f"crt_a, crt_b, crt_c each: max |k - p| <= "
                 f"{D10_LIM['crt']:g} max |p|, the same finite lanes; a "
                 "split call equal to one call (ROADMAP §C20)"),
}
RESULTS = {}             # -o tag → what batch_run returned
PC_OPERANDS = {}         # K15's operands on the -vc paths, by form
MQS_PC = {}              # K15's operands on the MQS paths, by form
CI_RAW = {}              # K1's first raw block on the -ci paths, by type


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _mouse_blocks(rng, n=MOUSE_N, p=MOUSE_P, block=1024):
    """The mouse genotypes in blocks of SNPs: (first SNP, dosages (k, n)
    int8, missing (k, n) bool), 3% missing."""
    for s in range(0, p, block):
        k = min(block, p - s)
        maf = rng.uniform(0.05, 0.5, k)
        X = rng.binomial(2, maf[:, None], size=(k, n)).astype(np.int8)
        yield s, X, rng.random((k, n)) < 0.03


def _synth_mouse(td, n=MOUSE_N, p=MOUSE_P, seed=0):
    """mouse_hs1940-scale BIMBAM gz + pheno (3% missing dosages), the
    same recipe as the reference package's bench."""
    rng = np.random.default_rng(seed)
    geno = os.path.join(td, "geno.txt.gz")
    pheno = os.path.join(td, "pheno.txt")
    with gzip.open(geno, "wt", compresslevel=1) as fh:
        for s, X, miss in _mouse_blocks(rng, n, p):
            for j in range(X.shape[0]):
                vals = np.char.mod("%d", X[j]).astype(object)
                vals[miss[j]] = "NA"
                fh.write(f"rs{s + j}, A, T, " + ", ".join(vals) + "\n")
    with open(pheno, "w") as fh:
        for v in rng.normal(size=n):
            fh.write(f"{v:.6f}\n")
    return geno, pheno


def _synth_bslmm(td, n=MOUSE_N, p=MOUSE_P, seed=5):
    """Phase (g)'s phenotypes on the mouse genotypes (replayed from
    _synth_mouse's stream): BSLMM_CAUSAL SNPs with 25% of the variance
    (about 2.5% each), a polygenic part (every SNP) with 25%, noise 50%,
    and BSLMM_HELD of the
    individuals NA; its binary form (above the median) for -bslmm 3; the
    first CHECK_SNPS SNPs' names.  Returns the causal SNPs, the genetic
    values and the held-out individuals."""
    X = _mouse_rows(n, p)
    mean = np.nanmean(X, axis=1, keepdims=True)
    X = np.where(np.isnan(X), mean, X) - mean
    rng = np.random.default_rng(seed)
    causal = np.sort(rng.choice(p, BSLMM_CAUSAL, replace=False))
    # each causal SNP about a tenth of the sparse part (random signs); the
    # polygenic part with iid effects on the centred genotypes, the prior
    # of GEMMA's kinship
    Xs = X[causal] / X[causal].std(axis=1, keepdims=True)
    gc = rng.choice([-1.0, 1.0], BSLMM_CAUSAL) @ Xs.astype(np.float64)
    gp = (rng.normal(size=p).astype(np.float32) @ X).astype(np.float64)
    e = rng.normal(size=n)
    gc, gp, e = (v / v.std() * np.sqrt(f) for v, f in
                 ((gc, 0.25), (gp, 0.25), (e, 0.5)))
    g = gc + gp
    y = g + e
    held = rng.random(n) < BSLMM_HELD
    for name, v in (("bs_pheno", y), ("bs_binary",
                                     (y > np.median(y)).astype(float))):
        with open(os.path.join(td, f"{name}.txt"), "w") as fh:
            fh.write("".join("NA\n" if h else f"{x:.6f}\n"
                             for x, h in zip(v, held)))
    return causal, g, held


def _mouse_rows(n=MOUSE_N, p=MOUSE_P):
    """The mouse genotypes (replayed from _synth_mouse's stream), (p, n)
    float32 with NaN where missing."""
    X = np.empty((p, n), np.float32)
    for s, Xb, miss in _mouse_blocks(np.random.default_rng(0), n, p):
        Xb = Xb.astype(np.float32)
        Xb[miss] = np.nan
        X[s:s + Xb.shape[0]] = Xb
    return X


def _synth_vc(td, n=MOUSE_N, p=MOUSE_P, seed=VC_SEED):
    """Phase (h)'s inputs on the mouse genotypes: an annotation over two
    chromosomes with positions 3 kb apart (the default 1 Mb window holds
    333 SNPs, as on a human imputed panel), a phenotype with a polygenic
    part of h² VC_H2 (iid effects on every centred genotype, the prior of
    GEMMA's kinship), the SNP lists of the two halves and the -mk file of
    their kinships.  Returns the unit-normalised rows (p, n) float64 that
    -calccor correlates."""
    X = _mouse_rows(n, p)
    mean = np.nanmean(X, axis=1, keepdims=True)
    Xc = np.where(np.isnan(X), mean, X).astype(np.float64) - mean
    rng = np.random.default_rng(seed)
    g = rng.normal(size=p) @ Xc
    e = rng.normal(size=n)
    y = g / g.std() * np.sqrt(VC_H2) + e / e.std() * np.sqrt(1 - VC_H2)
    np.savetxt(f"{td}/vc_pheno.txt", y, fmt="%.6f")
    half = p // 2
    with open(f"{td}/vc_anno.txt", "w") as fh:
        fh.write("".join(f"rs{j}\t{3000 * (j % half) + 1000}\t"
                         f"{1 + j // half}\n" for j in range(p)))
    for i, (a, b) in enumerate(((0, half), (half, p))):
        with open(f"{td}/vc_half{i}.snps", "w") as fh:
            fh.write("".join(f"rs{j}\n" for j in range(a, b)))
    with open(f"{td}/vc_mk.txt", "w") as fh:
        fh.write(f"{td}/VK0.cXX.txt\n{td}/VK1.cXX.txt\n")
    ss = np.einsum("ij,ij->i", Xc, Xc)
    return Xc / np.sqrt(np.where(ss > 0, ss, 1.0))[:, None]


def _synth_plink(td, n=PLINK_N, p=PLINK_P, n_cov=PLINK_COV, seed=1):
    """PLINK .bed/.bim/.fam (3% missing, heritable phenotype) and a
    covariate file: intercept + n_cov columns."""
    rng = np.random.default_rng(seed)
    maf = rng.uniform(0.05, 0.5, p)
    X = rng.binomial(2, maf[:, None], size=(p, n)).astype(np.int8)
    X[rng.random((p, n)) < 0.03] = -1
    codes = np.array([3, 2, 0, 1], np.uint8)[X]
    nb = (n + 3) // 4
    codes = np.concatenate([codes, np.ones((p, 4 * nb - n), np.uint8)], 1)
    codes = codes.reshape(p, nb, 4)
    packed = (codes[:, :, 0] | (codes[:, :, 1] << 2) | (codes[:, :, 2] << 4)
              | (codes[:, :, 3] << 6)).astype(np.uint8)
    prefix = os.path.join(td, "plink")
    with open(prefix + ".bed", "wb") as fh:
        fh.write(bytes([0x6C, 0x1B, 0x01]) + packed.tobytes())
    with open(prefix + ".bim", "w") as fh:
        for j in range(p):
            fh.write(f"{j % 19 + 1}\trs{j}\t0\t{100 * j}\tA\tT\n")
    Xf = np.where(X < 0, 0.0, X.astype(float))
    g = rng.normal(size=p) @ (Xf - Xf.mean(1, keepdims=True))
    y = g / g.std() * 0.7 + rng.normal(size=n) * 0.7
    with open(prefix + ".fam", "w") as fh:
        for i in range(n):
            fh.write(f"F{i}\tI{i}\t0\t0\t0\t{y[i]:.6f}\n")
    cov = os.path.join(td, "cov.txt")
    C = np.column_stack([np.ones(n), rng.normal(size=(n, n_cov))])
    np.savetxt(cov, C, fmt="%.6f", delimiter="\t")
    return prefix, cov


def _synth_slice3(td, pheno, n=MOUSE_N, p=MOUSE_P, seed=3):
    """Annotation (chromosome j % 19 + 1 as in _synth_plink's .bim), a
    binary environment, and GENES expression rows with the first
    GENE_SIGNAL tied to the phenotype (plus the first CHECK_SNPS rows
    alone, for the CPU check)."""
    rng = np.random.default_rng(seed)
    with open(f"{td}/anno.txt", "w") as fh:
        fh.write("".join(f"rs{j}\t{100 * j}\t{j % 19 + 1}\n"
                         for j in range(p)))
    env = rng.integers(0, 2, n)
    np.savetxt(f"{td}/env.txt", env, fmt="%d")
    y = np.loadtxt(pheno)
    E = rng.normal(size=(GENES, n))
    E[:GENE_SIGNAL] += 0.4 * y
    head = "geneID " + " ".join(f"I{i}" for i in range(n)) + "\n"
    for name, rows in (("expr", E), ("expr_check", E[:CHECK_SNPS])):
        with open(f"{td}/{name}.txt", "w") as fh:
            fh.write(head)
            for g, e in enumerate(rows):
                fh.write(f"g{g} " + " ".join(np.char.mod("%.6f", e)) + "\n")
    return env, E


def _synth_mv(td, n=MV_N, p=MV_P, seed=4):
    """The mvLMM set at the releases.org protocol shape (BIMBAM gz, 3%
    missing): MV_TRAITS traits with h² = 0.4, genetic correlation 0.5 and
    environmental 0.3 between every pair, MV_CAUSAL SNPs with effects on
    the first two; a binary environment; the first MV_CHECK and 1,024
    SNPs' names."""
    rng = np.random.default_rng(seed)
    geno = os.path.join(td, "mv_geno.txt.gz")
    maf = rng.uniform(0.05, 0.5, p)
    X = rng.binomial(2, maf[:, None], size=(p, n)).astype(np.int8)
    miss = rng.random((p, n)) < 0.03
    with gzip.open(geno, "wt", compresslevel=1) as fh:
        for j in range(p):
            vals = np.char.mod("%d", X[j]).astype(object)
            vals[miss[j]] = "NA"
            fh.write(f"rs{j}, A, T, " + ", ".join(vals) + "\n")
    Xs = (X - X.mean(1, keepdims=True)) / (X.std(1, keepdims=True) + 1e-12)
    k = MV_TRAITS

    def corr(r):
        return np.linalg.cholesky(np.full((k, k), r) + (1 - r) * np.eye(k))

    G = Xs.T @ (rng.normal(size=(p, k)) @ corr(0.5).T)
    E = rng.normal(size=(n, k)) @ corr(0.3).T
    Y = (G / G.std(0) * np.sqrt(0.4) + E / E.std(0) * np.sqrt(0.6))
    causal = np.arange(MV_CAUSAL) * (p // MV_CAUSAL) + 7
    Y[:, :2] += Xs[causal].T @ rng.uniform(0.15, 0.3, (MV_CAUSAL, 2))
    pheno = os.path.join(td, "mv_pheno.txt")
    np.savetxt(pheno, Y, fmt="%.6f", delimiter="\t")
    np.savetxt(os.path.join(td, "mv_env.txt"), rng.integers(0, 2, n),
               fmt="%d")
    # phase (k): WIDE_TRAITS traits made the same way from a stream of
    # their own, and WIDE_MV_COV covariates
    rw, kw = np.random.default_rng(seed + 1000), WIDE_TRAITS

    def corr_w(r):
        return np.linalg.cholesky(np.full((kw, kw), r) + (1 - r) * np.eye(kw))

    G = Xs.T @ (rw.normal(size=(p, kw)) @ corr_w(0.5).T)
    E = rw.normal(size=(n, kw)) @ corr_w(0.3).T
    Y = (G / G.std(0) * np.sqrt(0.4) + E / E.std(0) * np.sqrt(0.6))
    Y[:, :2] += Xs[causal].T @ rw.uniform(0.15, 0.3, (MV_CAUSAL, 2))
    np.savetxt(os.path.join(td, "mv_pheno10.txt"), Y, fmt="%.6f",
               delimiter="\t")
    W = np.column_stack([np.ones(n), rw.normal(size=(n, WIDE_MV_COV - 1))])
    np.savetxt(os.path.join(td, "mv_cov12.txt"), W, fmt="%.6f")
    np.savetxt(os.path.join(td, "mv_cov11.txt"), W[:, :-1], fmt="%.6f")
    for name, m in (("mv_first.snps", MV_CHECK), ("mv_1024.snps", 1024),
                    ("mv_256.snps", 256),
                    ("mv_wide_first.snps", WIDE_MV_CHECK)):
        with open(os.path.join(td, name), "w") as fh:
            fh.write("\n".join(f"rs{j}" for j in range(m)) + "\n")
    return geno, pheno, causal


def _mv_close(got, ref, tol, min_finite, cols, match=None, tol_all=1e-3):
    """|Δp| of a card result against the CPU's on the CPU's SNPs, for the
    p columns `cols` the card's mode writes.  With `match` (float64):
    within `tol` on lanes whose K9 iteration count in the column's fit
    equals the CPU's (p_score has no fit), >= `match` of lanes agreeing
    in count, and every lane within tol_all."""
    pos = {s: i for i, s in enumerate(got["snp_indices"])}
    rows = np.array([pos[s] for s in ref["snp_indices"]])
    out = {}
    for col, fit in (("p_wald", 1), ("p_lrt", 0), ("p_score", None)):
        if col not in cols:
            continue
        g, r = got["stats"][col][rows], ref["stats"][col]
        if not np.any(r):
            raise RuntimeError(f"mvLMM {col}: the float64 CPU run wrote none")
        both = np.isfinite(g) & np.isfinite(r)
        err = np.abs(g - r)
        same = np.ones(len(r), bool)
        if match is not None and fit is not None:
            same = (got["stats"]["em_iters"][rows, fit]
                    == ref["stats"]["em_iters"][:, fit])
        sel = both & same
        e = float(err[sel].max()) if sel.any() else 0.0
        e_all = float(err[both].max()) if both.any() else 0.0
        out[col] = {"max_abs": e, "max_abs_all": e_all,
                    "finite": float(both.mean()),
                    "same_iters": float(same.mean())}
        bad = both.mean() < min_finite or e > tol
        if match is not None:
            bad = bad or same.mean() < match or e_all > tol_all
        if bad:
            raise RuntimeError(f"mvLMM {col} vs the float64 CPU path: "
                               f"{out[col]}")
    return out


def _mv_operands(argv, idx, dev, dtypes, null=None):
    """The rotated operands of an mvLMM path on the card, per dtype: eval,
    X0 (intercept), Y (the traits), the rows [x] (R1) of the SNPs `idx`
    and the null fit; with -gxe also X0e (with env), the rows [x, x∘env]
    (R2) and the null fit of that design.  A path's own null (what
    run_mvlmm returned) is taken where given: `null`, of the -gxe design
    where the path had -gxe."""
    import torch
    from gemma_torch.cli import parse_args
    from gemma_torch.dataset import load_dataset
    from gemma_torch.models.mvlmm import MvlmmNull
    from gemma_torch.ops.pack2 import IMPUTE, prologue
    from gemma_torch.run import (_load_or_compute_eigen, _raw_wire_block,
                                 _to_device)
    from gemma_torch.utils.log import RunLog
    cfg = parse_args(argv)
    ds = load_dataset(cfg)
    out = {}
    for dt in dtypes:
        ev, U, _ = _load_or_compute_eigen(cfg, ds, RunLog(argv=[]), dt, dev)
        X0 = (U.T @ torch.as_tensor(ds.W, dtype=dt, device=dev)).T
        Y = (U.T @ torch.as_tensor(ds.Y, dtype=dt, device=dev)).T
        raw = _raw_wire_block(ds, idx, len(idx), dt, all_individuals=False)
        x = prologue(_to_device(raw, dev), ds.ni_test, IMPUTE, dtype=dt)
        Utx = x @ U
        X0, Y = X0.contiguous(), Y.contiguous()
        o = out[dt] = dict(ev=ev, X0=X0, Y=Y, R1=Utx[:, None].contiguous())
        if ds.gxe is None:
            o["null"] = null or MvlmmNull(ev, X0, Y, cfg)
        else:
            env = torch.as_tensor(ds.gxe, dtype=dt, device=dev)
            o["X0e"] = torch.cat([X0, (U.T @ env)[None]]).contiguous()
            o["R2"] = torch.stack([Utx, (x * env) @ U], 1).contiguous()
            o["null_x"] = null or MvlmmNull(ev, o["X0e"], Y, cfg)
            if null is None:
                o["null"] = MvlmmNull(ev, X0, Y, cfg)
    return out


def _mv_sums(d, c, kind):
    """(sums, flops per individual) of one pass of K9-K11 (the families
    of csrc/mvlmm_lane.cuh; a sum of f factors costs f flops per
    individual)."""
    tc, td = c * (c + 1) // 2, d * (d + 1) // 2
    fam = {
        "core": [(d * tc, 3), (d * c, 3), (d, 3), (d, 1)],
        "em_a_reml": [(2 * d, 2)],
        "em_b_reml": [(td, 2), (td, 3), (d, 3), (d, 4)],
        "p": [(d * tc, 3), (d * c, 3)],
        "nr_a": [(3 * td, 3), (2 * d, 2), (2 * td * tc, 5)],
        "nr_b": [(2 * td, 3), (3 * d * td, 4), (2 * d * d * c, 4),
                 (3 * d * d, 5), (2 * d, 4)],
    }[kind]
    return sum(k for k, _ in fam), sum(k * f for k, f in fam)


def _read_assoc(path):
    """(rs list, {column: float array}) of an assoc.txt (geneID for the
    gene-mode files)."""
    with open(path) as fh:
        head = fh.readline().split()
        rows = [ln.split() for ln in fh]
    key = "rs" if "rs" in head else "geneID"
    rs = [r[head.index(key)] for r in rows]
    cols = {c: np.array([r[i] for r in rows], float)
            for i, c in enumerate(head) if c in P_COLS}
    return rs, cols


def _aligned(rs, cols, rs_ref):
    pos = {r: i for i, r in enumerate(rs)}
    return {c: v[[pos[r] for r in rs_ref]] for c, v in cols.items()}


def _log_times(path):
    """'time on ...' lines of a .log.txt, in seconds."""
    out = {}
    with open(path) as fh:
        for ln in fh:
            if "time" in ln and "min" in ln:
                key = ln.split("=")[0].strip("# \n")
                out[key] = float(ln.split("=")[1].split()[0]) * 60.0
    return out


def _run(argv, device, keep=False):
    """Run one path; RESULTS keeps what it returned under its -o tag
    (with `keep`, all of it)."""
    from gemma_torch.cli import parse_args
    from gemma_torch.run import batch_run
    import torch
    t0 = time.time()
    argv = argv + ["-silence"]
    res = batch_run(parse_args(argv), argv=["gemma_torch"] + argv,
                    device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    tag = argv[argv.index("-o") + 1]
    if keep:
        RESULTS[tag] = res
    elif isinstance(res, dict) and "em_iters" in res.get("stats", {}):
        RESULTS[tag] = {k: res[k] for k in ("stats", "snp_indices",
                                            "null_seconds")}
    return time.time() - t0


def _cpu_path(argv):
    """Run one path on the CPU in a process of its own (spawned by
    _start_cpu, so the card's process goes on meanwhile); returns what
    RESULTS keeps of it."""
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    _run(argv, "cpu")
    return RESULTS[argv[argv.index("-o") + 1]]


def _start_cpu(argv):
    """(pool, async result) of _cpu_path(argv) in one spawned process;
    the pool is ended when the script exits, whatever happens before."""
    import atexit
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(1)
    atexit.register(pool.terminate)
    return pool, pool.apply_async(_cpu_path, (argv,))


def _drive(kernels, paths, name, argvs, need, keep=False):
    """Run one path with every launch count at 0; return the counts.
    Fails unless every kernel named in `need` launched."""
    kernels.reset_launches()
    secs = [(tag, _run(argv, "cuda", keep)) for tag, argv in argvs]
    counts = {k.name: k.launches for k in kernels.ALL}
    paths[name] = {"secs": secs, "launches": counts,
                   "splits": {k.name: k.splits for k in kernels.ALL
                              if k.splits}}
    for k in need:
        if counts[k] == 0:
            raise RuntimeError(f"path {name} never launched {k}")
    return counts


def _profile(argv):
    """Warm run of one path under torch.profiler: device time by kernel
    and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _run(argv, "cuda")
    dev_ms = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0)) / 1e3
        if t > 0:
            dev_ms[ev.key[:80]] = t
    busy_ms = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_s": wall, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / 1e3 / wall,
            "top_device_ms": top}


def time_ms(fn, reps):
    """Median ms of `reps` calls after a warm-up.  Before each timed call
    a 64 MiB write, outside the events, evicts the L2, so the call reads
    its inputs from device memory as the main path does."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def _time_device_ms(fn, reps):
    """(median device ms, reps not hidden) of `reps` calls after a
    warm-up: as time_ms, but the card sleeps DEVICE_SLEEP_CYCLES after
    the flush, so that the host has enqueued the call before the first
    event fires and the time is the card's alone, without the host's
    enqueue (which time_ms includes).  A rep is hidden where the host's
    time from just before enqueuing the sleep to enqueuing the last
    event is below the sleep's own time on the card (measured once, with
    the host ahead behind a longer sleep): the sleep cannot start before
    it is enqueued, so the first event fires after the host is done.
    The median is over the hidden reps, None if there are none."""
    import torch

    def ev():
        return torch.cuda.Event(enable_timing=True)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    c0, c1 = ev(), ev()
    torch.cuda._sleep(4 * DEVICE_SLEEP_CYCLES)
    c0.record()
    torch.cuda._sleep(DEVICE_SLEEP_CYCLES)
    c1.record()
    c1.synchronize()
    sleep_ms = c0.elapsed_time(c1)
    ts, missed = [], 0
    for _ in range(reps):
        flush.zero_()
        a, b = ev(), ev()
        h0 = time.perf_counter()
        torch.cuda._sleep(DEVICE_SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        host_ms = (time.perf_counter() - h0) * 1e3
        b.synchronize()
        if host_ms < sleep_ms:
            ts.append(a.elapsed_time(b))
        else:
            missed += 1
    return (float(np.median(ts)) if ts else None), missed


def _p_errors(got, ref, tol, min_finite, same_nan=None):
    """Max |Δp| per column over lanes finite in both; fails past `tol`,
    below `min_finite` finite lanes, or (float64) past `same_nan` share
    of lanes whose NaN status differs."""
    out = {}
    for c in ref:
        g, r = got[c], ref[c]
        both = np.isfinite(g) & np.isfinite(r)
        err = float(np.max(np.abs(g[both] - r[both]))) if both.any() else 0.
        nan_diff = int((np.isnan(g) != np.isnan(r)).sum())
        out[c] = {"max_abs": err, "finite": float(both.mean()),
                  "nan_lanes_differ": nan_diff}
        if both.mean() < min_finite or err > tol or (
                same_nan is not None and 1 - nan_diff / len(r) < same_nan):
            raise RuntimeError(f"{c} vs the float64 CPU path: {out[c]}")
    return out


def _say(obj):
    """Print one report line (a JSON object, or text) and append it to
    REPORT: standard output may be cut to its end by whoever reads it."""
    if isinstance(obj, dict) and ("phase" in obj or "kernel" in obj):
        obj = {**obj, "t_s": time.time() - T_START}
    line = obj if isinstance(obj, str) else json.dumps(obj)
    print(line, flush=True)
    with open(REPORT, "a") as fh:
        fh.write(line + "\n")


def _drive_mvlmm(kernels, paths, td, f64, dev):
    """Phase (f): the mvLMM paths on the card at the protocol shape and
    their output checks against the port's float64 CPU run; returns
    the paths' launch counts and the kernels' operands."""
    t_f = time.time()
    mv_geno, mv_pheno, causal = _synth_mv(td)
    _say({"phase": "data_mvlmm", "seconds": time.time() - t_f})
    base = f"-g {mv_geno} -p {mv_pheno} -outdir {td} -no-check".split()
    mvk = base + f"-k {td}/MK.cXX.txt".split()
    mvx = f"-gxe {td}/mv_env.txt".split()
    n12 = "-n 1 2".split()
    crt = "-crt -pnr 0.9".split()
    mv32 = ("mph_em", "mph_calc_p", "mph_nr")
    mv64 = ("mph_em_f64", "mph_calc_p_f64", "mph_nr_f64")
    counts_f = {
        "gk": _drive(kernels, paths, "mv_gk", [
            ("mv_gk", base + "-gk 1 -o MK".split())], ("geno_prologue",)),
        "lmm1": _drive(kernels, paths, "mv_lmm1", [
            ("mv_lmm1_cold", mvk + n12 + "-lmm 1 -o M1".split()),
            ("mv_lmm1_warm", mvk + n12 + "-lmm 1 -o M1w".split())],
            mv32),
        "lmm4": _drive(kernels, paths, "mv_lmm4", [
            ("mv_lmm4", mvk + n12 + "-lmm 4 -o M4".split())], mv32),
        "lmm4_f64": _drive(kernels, paths, "mv_lmm4_f64", [
            ("mv_lmm4_f64", mvk + n12 + f64 + "-lmm 4 -o M4d".split())],
            mv64),
        "gxe": _drive(kernels, paths, "mv_gxe", [
            ("mv_gxe_lmm4", mvk + n12 + mvx + "-lmm 4 -o MX4".split())],
            mv32),
        "gxe_f64": _drive(kernels, paths, "mv_gxe_f64", [
            ("mv_gxe_lmm4_f64", mvk + n12 + mvx + f64
             + "-lmm 4 -o MX4d".split())], mv64),
        "d5": _drive(kernels, paths, "mv_d5", [
            ("mv_lmm1_d5", mvk + f"-snps {td}/mv_1024.snps -n 1 2 3 4 5 "
             "-lmm 1 -o M5".split())], mv32),
        # -crt on the lanes -pnr 0.9 refines (most of them); it runs in
        # float64 whatever -precision says (ROADMAP §C18)
        "crt": _drive(kernels, paths, "mv_crt", [
            ("mv_crt_lmm4", mvk + n12 + crt + "-lmm 4 -o MR".split())],
            mv64 + ("calc_crt",)),
        "crt_f64": _drive(kernels, paths, "mv_crt_f64", [
            ("mv_crt_lmm4_f64", mvk + n12 + crt + f64
             + "-lmm 4 -o MRd".split())], mv64 + ("calc_crt",)),
        "d5_crt": _drive(kernels, paths, "mv_d5_crt", [
            ("mv_crt_lmm1_d5", mvk + f"-snps {td}/mv_1024.snps -n 1 2 3 4 "
             "5 -lmm 1 -o M5R".split() + crt)], mv64 + ("calc_crt",)),
    }
    if any(counts_f["crt"][k] for k in mv32):
        raise RuntimeError("-crt launched a float32 mvLMM kernel")
    _say({"phase": "e2e_mvlmm", "paths": {
        k: v for k, v in paths.items() if k.startswith("mv_")}})
    cold, warm = (s for _, s in paths["mv_lmm1"]["secs"])
    n_mv = len(RESULTS["M1"]["snp_indices"])
    prof_mv = _profile(mvk + n12 + "-lmm 1 -o MW".split())
    _say({"phase": "profile_mvlmm1_warm", **prof_mv})
    _say({"phase": "mvlmm_protocol", "snps": n_mv, "cold_s": cold,
          "warm_s": warm, "snps_per_s_cold": n_mv / cold,
          "snps_per_s_warm": n_mv / warm,
          "log_seconds": _log_times(f"{td}/M1w.log.txt"),
          "causal_p_wald": RESULTS["M1"]["stats"]["p_wald"][
              np.searchsorted(RESULTS["M1"]["snp_indices"],
                              causal)].tolist()})
    # against the port's float64 CPU run, first MV_CHECK SNPs
    t0 = time.time()
    first = f"-snps {td}/mv_first.snps".split()
    _run(mvk + n12 + first + "-lmm 4 -o MC".split(), "cpu")
    _run(mvk + n12 + first + mvx + "-lmm 4 -o MXC".split(), "cpu")
    _run(mvk + n12 + first + crt + "-lmm 4 -o MRC".split(), "cpu")
    chk_f = {"cpu_f64_seconds": time.time() - t0}
    for tag, ref_tag, tol, match in (
            ("M1", "MC", 1e-3, None), ("M4", "MC", 1e-3, None),
            ("M4d", "MC", 1e-6, 0.99), ("MX4", "MXC", 1e-3, None),
            ("MX4d", "MXC", 1e-6, 0.99), ("MRd", "MRC", 1e-6, 0.99)):
        cols = ("p_wald",) if tag == "M1" else P_COLS
        chk_f[tag] = _mv_close(RESULTS[tag], RESULTS[ref_tag], tol, 0.97,
                               cols, match=match)
    # -crt at the default precision is the float64 run: the same p-values
    chk_f["MR_vs_MRd_max_abs"] = max(
        float(np.max(np.abs(RESULTS["MR"]["stats"][c]
                            - RESULTS["MRd"]["stats"][c]))) for c in P_COLS)
    if chk_f["MR_vs_MRd_max_abs"] > 1e-12:
        raise RuntimeError("-crt auto vs float64: "
                           f"{chk_f['MR_vs_MRd_max_abs']}")
    for tag in ("M5", "M5R"):
        p5 = RESULTS[tag]["stats"]["p_wald"]
        fin5 = float(np.isfinite(p5).mean())
        if fin5 < 0.97 or not ((p5[np.isfinite(p5)] >= 0)
                               & (p5[np.isfinite(p5)] <= 1)).all():
            raise RuntimeError(f"-n 1 2 3 4 5 ({tag}): {fin5:.4f} finite "
                               "p_wald")
        chk_f[f"{tag}_p_wald_finite"] = fin5
    chk_f["phase_f_seconds"] = time.time() - t_f
    _say({"phase": "check_mvlmm", **chk_f})
    # the kernels' operands: the protocol block and the -n 1 2 3 4 5 block
    import torch
    ops = _mv_operands(mvk + n12 + mvx + ["-lmm", "1"],
                       RESULTS["M1"]["snp_indices"], dev,
                       (torch.float32, torch.float64))
    d5 = _mv_operands(
        mvk + f"-snps {td}/mv_1024.snps -n 1 2 3 4 5 -lmm 1".split(),
        RESULTS["M5"]["snp_indices"], dev, (torch.float32, torch.float64))
    ops["d5"], ops["d5_f64"] = d5[torch.float32], d5[torch.float64]
    return counts_f, ops


def _timed(fn):
    """(fn(), ms) of one call (CUDA events, L2 flushed before it): the
    plain loops (the mvLMM's, lambda_solve's, the BSLMM chain's), seconds
    long at a whole block, are timed on the call that is compared."""
    import torch
    torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                device="cuda").zero_()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _mrel(a, b):
    """max |a - b| / max |b| over the entries finite in both."""
    import torch
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float((a[ok] - b[ok]).abs().max() / b[ok].abs().max())


def _cpu(args):
    """args with every tensor moved to the CPU."""
    return tuple(x.cpu() if hasattr(x, "cpu") else x for x in args)


def _em_gaps(a, b):
    """(Vg and Ve, logl) max relative gaps of EM result a to b."""
    d = b.Vg.device
    return (max(_mrel(a.Vg.to(d), b.Vg), _mrel(a.Ve.to(d), b.Ve)),
            _mrel(a.logl.to(d), b.logl))


def _em_capped_d10(blk):
    """K9 on the ten-trait path's lanes capped at D10_CAP iterations
    (prec 0), REML and ML, against the plain version on the card, beside
    two witnesses' gaps to that same plain run: the plain version on the
    CPU (LAPACK's eigenvectors, another order of sums) and on the card
    from Y moved by one ulp.  Also K9 capped at 30 iterations on 16
    seeded lanes of the same shape (random Vg, Ve; _mv_seeded), where
    the tight float64 limit holds.  Returns (the report, passed)."""
    import torch
    from gemma_torch.models import mvlmm_core as mvc
    ev, X0, Y, R = blk["ev"], blk["X0"], blk["Y"], blk["R"]
    V, E, B = blk["Vg"], blk["Ve"], blk["B"]
    sign = torch.from_numpy(np.random.default_rng(0).choice(
        [-1.0, 1.0], Y.shape)).to(Y)
    Yu = Y * (1 + torch.finfo(Y.dtype).eps * sign)
    line, ok = {}, True
    for reml in (True, False):
        fit = "reml" if reml else "ml"
        a = (reml, D10_CAP, 0.0, ev, X0, Y, R, V, E, B)
        pp = mvc.mph_em_plain(*a)
        for who, r in (("kernel", mvc.mph_em_cuda(*a)),
                       ("cpu", mvc.mph_em_plain(*_cpu(a))),
                       ("ulp", mvc.mph_em_plain(
                           reml, D10_CAP, 0.0, ev, X0, Yu, R, V, E, B))):
            vv, ll = _em_gaps(r, pp)
            line[f"capped_{fit}_{who}_VgVe_rel"] = vv
            line[f"capped_{fit}_{who}_logl_rel"] = ll
        ok = (ok and line[f"capped_{fit}_kernel_VgVe_rel"]
              <= D10_LIM["em_capped_VgVe"]
              and line[f"capped_{fit}_kernel_logl_rel"]
              <= D10_LIM["em_capped_logl"])
    o = _mv_seeded(WIDE_TRAITS, X0.shape[0] + 1, ev.shape[0], 16, Y.dtype,
                    ev.device)
    nul = o["null"]
    err = 0.0
    for reml in (True, False):
        a = (reml, 30, 0.0, o["ev"], o["X0"], o["Y"], o["R1"],
             nul.Vg_start[None], nul.Ve_start[None], nul.B_start[None])
        err = max(err, *_em_gaps(mvc.mph_em_cuda(*a), mvc.mph_em_plain(*a)))
    line["capped_seeded_max_rel_err"] = err
    return line, ok and err <= 1e-10


def _hold_mv_block(blk, record, check, amax):
    """K9, K10 and K11 against their plain versions on one block, as its
    path runs them: K9 with a fixed cap of 50 iterations and prec = 0
    (REML and ML), then converged in the path's REML form; K10 at the
    converged (Vg, Ve); K11 from there (the -pnr refinement's form).
    `blk`: the operands, the starts, the form's name, its launches, the
    kernel names' suffix, the converged fit's cap and staging, and `tight`
    for the float64 tolerances.  With `witness` (the ten-trait path's
    lanes, ROADMAP §C20) each kernel is also set beside its plain version
    on the CPU, K9's capped form is _em_capped_d10's, K11 runs on the
    first WIDE_NR_HOLD lanes, and the limits are D10_LIM's; and one call
    of K9, K11 split into launches of three lanes must equal the unsplit
    call."""
    import torch
    from gemma_torch import kernels
    from gemma_torch.models import mvlmm_core as mvc
    ev, X0, Y, R = blk["ev"], blk["X0"], blk["Y"], blk["R"]
    V, E, B = blk["Vg"], blk["Ve"], blk["B"]
    sfx, form, cnt, tight = blk["sfx"], blk["form"], blk["launches"], \
        blk["tight"]
    wit = blk.get("witness", False)
    S, n, d = R.shape[0], ev.shape[0], Y.shape[0]
    c = X0.shape[0] + R.shape[1]
    p2 = d * (d + 1)
    isz = torch.finfo(ev.dtype).bits // 8
    in_bytes = isz * (n + X0.numel() + Y.numel() + R.numel())
    tol = {k: TOL[k + "_f64"] for k in ("mph_em", "mph_calc_p", "mph_nr")} \
        if tight and not sfx else {}
    if wit:
        tol = dict(TOL_D10)
    base = {"block": form or "snp", "S": S, "n": n, "d": d, "c": c}

    def rec(name, err, ms, pms, nbytes, nops, extra=None):
        record(name + sfx, err, ms, pms, nbytes, nops, peak=PEAK_F64_PER_S,
               launches=cnt, form=form, tol=tol.get(name), extra=extra)

    def chk(name, ok, line):
        if name in tol:
            line = {"tolerance": tol[name], **line}
        check(name + sfx, ok, {**base, **line})

    # K9
    if wit:
        wline, ok_cap = _em_capped_d10(blk)
        cap_err = max(wline["capped_reml_kernel_VgVe_rel"],
                      wline["capped_ml_kernel_VgVe_rel"])
        a = (True, D10_CAP, 0.0, ev, X0, Y, R, V, E, B)
        wline["split_launches_added"], wline["split_equal"] = _split_equal(
            kernels, kernels.MPH_EM_F64, mvc.mph_em_cuda, a,
            mvc.mph_em_cuda(*a))
        ok_cap = ok_cap and wline["split_equal"] \
            and wline["split_launches_added"] > 0
    else:
        wline, cap_err = {}, 0.0
        for reml in (True, False):
            a = (reml, 50, 0.0, ev, X0, Y, R, V, E, B)
            cap_err = max(cap_err, *_em_gaps(mvc.mph_em_cuda(*a),
                                             mvc.mph_em_plain(*a)))
    a = (True, blk["cap"], 1e-3, ev, X0, Y, R, V, E, B, blk["staged"])
    kk = mvc.mph_em_cuda(*a)
    pp, pms = _timed(lambda: mvc.mph_em_plain(*a))

    def p_at(r):
        return mvc.mph_calc_p_plain(ev, X0, Y, R, r.Vg.to(ev.device),
                                    r.Ve.to(ev.device)).p

    p_pp = p_at(pp)

    def p_gaps(r, tag):
        """(|Δp| on lanes that left at the same iteration as pp's, every
        lane, the share of such lanes), reported under `tag`."""
        same = r.iters.to(pp.iters.device) == pp.iters
        dp = (p_at(r) - p_pp).abs().nan_to_num(0.0)
        out = (float(dp[same].max()) if bool(same.any()) else 0.0,
               float(dp.max()), float(same.double().mean()))
        wline.update({f"{tag}p_max_abs_err": out[0],
                      f"{tag}p_max_abs_err_all": out[1],
                      f"{tag}same_iters": out[2]})
        return out

    err, err_all, same_share = p_gaps(kk, "")
    if wit:
        p_gaps(mvc.mph_em_plain(*_cpu(a)), "cpu_")
        ok = (ok_cap and err <= D10_LIM["em_p_same"]
              and err_all <= D10_LIM["em_p_all"])
    elif tight:
        ok = (cap_err <= 1e-10 and err <= 1e-6 and same_share >= 0.99
              and err_all <= 1e-3)
    else:
        ok = cap_err <= 1e-6 and err_all <= 1e-3
    ms = time_ms(lambda: mvc.mph_em_cuda(*a), 3)
    its = float((kk.iters.double() + 1).sum())
    # the lanes' iterations and the time a lane-iteration takes; the null
    # fit of the path that runs this form, timed by its own phase clock
    work = {"mean_iters": its / S, "us_per_lane_iter": ms * 1e3 / its}
    if blk.get("null_s") is not None:
        work["null_fit_s"] = blk["null_s"]
    chk("mph_em", ok, {"capped_max_rel_err": cap_err, **wline, **work,
                       "ms": ms, "plain_ms": pms})
    flops = sum(_mv_sums(d, c, k)[1] for k in ("core", "em_a_reml",
                                               "em_b_reml"))
    rec("mph_em", max(err, cap_err), ms, pms,
        in_bytes + 8 * S * (2 * d * d + d * c + 2), its * n * flops, work)
    # K10 at the converged (Vg, Ve)
    a = (ev, X0, Y, R, kk.Vg, kk.Ve)
    ck, cq = mvc.mph_calc_p_cuda(*a), mvc.mph_calc_p_plain(*a)
    se = torch.sqrt(torch.diagonal(cq.Vbeta, dim1=-2, dim2=-1))
    err = amax(ck.p, cq.p)
    beta_se = float(((ck.beta - cq.beta).abs() / se).max())
    ms = time_ms(lambda: mvc.mph_calc_p_cuda(*a), 10)
    pms = time_ms(lambda: mvc.mph_calc_p_plain(*a), 3)
    line = {"max_abs_err": err, "beta_max_err_over_se": beta_se}
    if wit:
        cc = mvc.mph_calc_p_plain(*_cpu(a))
        line["cpu_max_abs_err"] = amax(cc.p.to(ev.device), cq.p)
        line["cpu_beta_max_err_over_se"] = float(
            ((cc.beta.to(ev.device) - cq.beta).abs() / se).max())
        ok = err <= D10_LIM["calc_p"] and beta_se <= D10_LIM["calc_p_se"]
    else:
        ok = (err <= (1e-10 if tight else 1e-5)
              and beta_se <= (1e-8 if tight else 1e-3))
    chk("mph_calc_p", ok, {**line, "ms": ms, "plain_ms": pms})
    rec("mph_calc_p", err, ms, pms,
        in_bytes + 8 * S * (2 * d * d + 2 + d + d * d),
        S * n * _mv_sums(d, c, "p")[1])
    # K11 from the converged EM
    m = WIDE_NR_HOLD if wit else S
    a = (True, 10, 1e-3, ev, X0, Y, R[:m].contiguous(), kk.Vg[:m],
         kk.Ve[:m])
    nk = mvc.mph_nr_cuda(*a)
    st = {}
    nq, pms = _timed(lambda: mvc.mph_nr_plain(*a, stats=st))
    l_rel, h_rel = _mrel(nk[2], nq[2]), _mrel(nk[3], nq[3])
    ms = time_ms(lambda: mvc.mph_nr_cuda(*a), 3)
    # the lanes' Newton iterations and evaluations as the plain version
    # counts them on the same lanes (K11 does not report its own), and
    # the kernel's time over those
    its, n_lik, n_der = (float(st[k].sum()) for k in ("iters", "lik_evals",
                                                       "der_evals"))
    work = {"plain_mean_iters": its / m,
            "us_per_plain_lane_iter": ms * 1e3 / its,
            "plain_lik_evals_per_lane": n_lik / m,
            "plain_der_evals_per_lane": n_der / m}
    line = {"S": m, "logl_max_rel_err": l_rel, "Hvar_max_rel_err": h_rel,
            **work}
    if wit:
        nc = mvc.mph_nr_plain(*_cpu(a))
        line["cpu_logl_max_rel_err"] = _mrel(nc[2].to(ev.device), nq[2])
        line["cpu_Hvar_max_rel_err"] = _mrel(nc[3].to(ev.device), nq[3])
        line["split_launches_added"], same = _split_equal(
            kernels, kernels.MPH_NR_F64, mvc.mph_nr_cuda, a, nk)
        line["split_equal"] = same
        ok = (l_rel <= D10_LIM["nr_logl"] and h_rel <= D10_LIM["nr_Hvar"]
              and same and line["split_launches_added"] > 0)
    else:
        ok = l_rel <= 1e-10 and h_rel <= 1e-8
    chk("mph_nr", ok, {**line, "ms": ms, "plain_ms": pms})
    # the evaluations the plain version made on these lanes: a
    # likelihood pass each, two derivative passes each, and X X' once a
    # lane
    nops = n * (n_lik * _mv_sums(d, c, "core")[1]
                + n_der * sum(_mv_sums(d, c, k)[1] for k in ("nr_a", "nr_b"))
                + m * c * (c + 1))
    rec("mph_nr", max(l_rel, h_rel), ms, pms,
        isz * (n + X0.numel() + Y.numel() + R[:m].numel())
        + 8 * m * (4 * d * d + 1 + p2 * p2), nops, work)


# K3 and K7 on seeded blocks that mix the searches' exits: (n, seed) of
# _mixed_block, MIXED_S lanes ordered so that a block of L lanes mixes
# them, held at lane counts 1, L - 1, L + 1 and 3L + 3
MIXED, MIXED_S = ((60, 135), (200, 9)), 64
# _mixed_block's rows that repeat the intercept: a singular design, on
# which K7 NaN-poisons and K3's logf_stable (which does not poison) is the
# log of a pivot of rounding size in the kernel and its plain version
# alike, so K3's mixed holds leave them out
MIXED_COLLINEAR = (5, 17, 30)


def _mixed_block(n, seed, S=MIXED_S):
    """A seeded shared-operand block in rotated form whose lanes mix the
    λ searches' exits (tests/test_torch_lane_search.py builds the same):
    eigenvalues log-uniform (three zero), a response whose variance along
    the eigenvectors follows one of two random λ on random halves (the
    likelihood of some lanes has two sign-change intervals, of others
    none), genotype rows of random scales, three rows that repeat the
    intercept (collinear: the REML search NaN-poisons).  Returns eval,
    W (n, 1), y, X (S, n)."""
    rng = np.random.default_rng(seed)
    ev = np.sort(np.exp(rng.uniform(np.log(1e-3), np.log(1e3), n)))
    ev[:3] = 0.0
    l1, l2 = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), 2))
    grp = rng.random(n) < 0.5
    y = rng.normal(size=n) * np.sqrt(np.where(grp, l1 * ev + 1,
                                              l2 * ev + 1))
    w = rng.normal(size=n)
    X = rng.normal(size=(S, n)) * np.exp(rng.uniform(-3, 3, (S, 1)))
    X[list(MIXED_COLLINEAR)] = np.stack([w, 2.0 * w, -w])
    return ev, w[:, None], y, X


def _exit_kinds(st, lam):
    """Each lane's exits from a plain search's stats: two or more
    sign-change intervals, none, Newton in one step a bracket, NaN."""
    import torch
    iv, steps, nan = st["intervals"], st["newton_steps"], torch.isnan(lam)
    return {"several": (iv >= 2) & ~nan, "flat": iv == 0,
            "one_step": (steps == iv) & (iv > 0), "nan": nan}


def _hold_mixed(check, amax):
    """K3 (float32) and K7 (float64) on the MIXED blocks against their
    plain versions, REML and ML, at TOL's tolerances: the lanes ordered
    round-robin over K7's exits in either fit (every kind in each block
    of L), then held at 1, L - 1, L + 1 and 3L + 3 of them."""
    import torch
    from gemma_torch.models.lmm import likelihood as lk
    from gemma_torch.models.lmm import optimize as opt
    from gemma_torch.models.lmm.engine import fit_null
    dev = torch.device("cuda")
    fine = opt.fine_grid(1e-5, 1e5, 10, opt._F32_GRID_REFINE)
    for n, seed in MIXED:
        ev, W, y, X = _mixed_block(n, seed)

        def blk(dt, rows):
            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                       device=dev)
            return lk.build_batch_data(t(ev), t(W), t(y), t(rows), 1)
        kinds = None
        for reml in (True, False):
            st = {}
            r = opt.lambda_solve_f64_plain(blk(torch.float64, X), 1, False,
                                           reml, 1e-5, 1e5, 10, stats=st)
            kf = _exit_kinds(st, r.lam)
            kinds = kf if kinds is None else {k: kinds[k] | kf[k]
                                              for k in kinds}
        queues = [[int(i) for i in torch.nonzero(m).flatten()]
                  for m in kinds.values()]
        order, seen = [], set()
        while any(queues):
            for q in queues:
                while q and q[0] in seen:
                    q.pop(0)
                if q:
                    seen.add(q[0])
                    order.append(q.pop(0))
        order += [i for i in range(X.shape[0]) if i not in seen]
        if not all(bool(m.any()) for m in kinds.values()):
            raise RuntimeError(f"mixed block n={n} seed={seed} lacks an "
                               f"exit: { {k: int(m.sum()) for k, m in kinds.items()} }")
        for dt, name, L in ((torch.float32, "lambda_solve", 8),
                            (torch.float64, "lambda_solve_f64", 4)):
            for count in (1, L - 1, L + 1, 3 * L + 3):
                data = blk(dt, X[order[:count]])
                nf = fit_null(data.eval, data.UtWy[:, :1], data.UtWy[:, 1],
                              float(ev.mean()), 1)
                for reml in (True, False):
                    st = {}
                    if dt == torch.float32:
                        d1f = lk.dev1_grid(fine, data, 1, False, reml)
                        args = (d1f, fine, data, 1, False, reml, 1e-5, 1e5,
                                10, False)
                        r_k = opt.lambda_solve_cuda(*args)
                        r_p = opt.lambda_solve_plain(*args, stats=st)
                    else:
                        args = (data, 1, False, reml, 1e-5, 1e5, 10)
                        r_k = opt.lambda_solve_f64_cuda(*args)
                        r_p = opt.lambda_solve_f64_plain(*args, stats=st)
                    if reml:
                        pk, pp = (lk.wald_pvalues_plain(q.lam, data, 1)[2]
                                  for q in (r_k, r_p))
                    else:
                        pk, pp = (lk.lrt_pvalues_plain(
                            q.lam, q.logf, data, 1, nf.l_mle,
                            nf.logl_mle)[1] for q in (r_k, r_p))
                    # K3 on the regular designs (MIXED_COLLINEAR)
                    keep = torch.tensor(
                        [dt == torch.float64 or order[j] not in
                         MIXED_COLLINEAR for j in range(count)], device=dev)
                    pk, pp = pk[keep], pp[keep]
                    err = amax(pk, pp)
                    logf_rel = float(((r_k.logf.double() - r_p.logf.double())
                                      .abs() / r_p.logf.double().abs())[keep]
                                     .nan_to_num(0.0).max())
                    nan_diff = int((torch.isnan(r_k.lam)
                                    != torch.isnan(r_p.lam)).sum())
                    same_finite = not bool((torch.isfinite(pk)
                                            != torch.isfinite(pp)).any())
                    if dt == torch.float32:
                        ok = err <= 1e-3 and logf_rel <= 1e-4 and same_finite
                    else:
                        ok = err <= 1e-6 and logf_rel <= 1e-9 \
                            and nan_diff <= 1e-3 * count
                    held = _exit_kinds(st, r_p.lam)
                    check(name, ok, {
                        "block": "mixed", "n": n, "seed": seed,
                        "fit": "reml" if reml else "ml", "S": count,
                        "lanes_held": int(keep.sum()),
                        "lanes_a_block": L, "max_abs_err": err,
                        "logf_max_rel": logf_rel, "nan_lanes_differ": nan_diff,
                        "exits": {k: int(m.sum()) for k, m in held.items()},
                        "evals": int(st["evals"].sum())})


def _hold_search_layout(kernels, check):
    """The Python mirror of K3's and K7's launch layout
    (optimize.search_geometry) against the kernels' own size functions,
    every form at three n."""
    from gemma_torch.models.lmm import optimize as opt
    bad = []
    for n in (60, 1940, 20000):
        for c in (0, 1, 3, 16, 24, 32, 33, 40, 64):
            for wide, pl in ((0, 0), (1, 1), (0, 1)):
                a = kernels.LAMBDA_SOLVE.query("smem_bytes", c, n, wide, pl)
                b = opt.search_geometry(c, n, False, bool(wide), bool(pl))
                if a != b["bytes"]:
                    bad.append(("lambda_solve", n, c, wide, pl, a, b["bytes"]))
            for pl in (0, 1):
                a = kernels.LAMBDA_SOLVE_F64.query("smem_bytes", c, n, pl)
                b = opt.search_geometry(c, n, True, False, bool(pl))
                if a != b["bytes"]:
                    bad.append(("lambda_solve_f64", n, c, pl, a, b["bytes"]))
    for name in ("lambda_solve", "lambda_solve_f64"):
        check(name, not bad, {"layout_mirror_equal": not bad,
                              "differ": bad[:4]})


# K4-K6's launch layout (csrc/test_sums.cuh ts_layout) in Python, held
# equal to the kernels' own size functions on the card (_hold_tail_layout)
# and used by tests/test_torch_test_tails.py.  The launch forms: a warp a lane up to 16 sums a lane, a tile of 8 lanes
# on DMMA (shared operands), a block a lane (per-lane operands)
TAIL_REG, TAIL_MMA, TAIL_LANE = 0, 1, 2
# what a launch sums: K4/K5's rows, K6's alternative or null model
TAIL_TEST, TAIL_LRT, TAIL_LRT_NULL = 0, 1, 2
_TS = dict(threads=256, reg_q=16, lanes=8, km=32, kl=16, rc=64, tpw=10,
           qpt=3, stage=160 * 1024, lab_max=16 * 1024, wide_cvt=32)


def _r16(b):
    return (b + 15) // 16 * 16


def _r8(v):
    return (v + 7) // 8 * 8


def tail_form(n_cvt, shared_ops):
    """The launch form of K4-K6 at n_cvt covariates (ts_form)."""
    C1 = n_cvt + 1
    Q = C1 * (C1 + 1) // 2 + C1 + 1
    return (TAIL_REG if Q <= _TS["reg_q"] else
            TAIL_MMA if shared_ops else TAIL_LANE)


def tail_layout(n_cvt, form, kind, tsize):
    """ts_layout: a launch's geometry, its dynamic shared memory (`bytes`)
    and a lane's scratch above 32 covariates (`lane_bytes`)."""
    C1 = n_cvt + 1
    M = C1 * (C1 + 1) // 2
    Q = M + C1 + 1
    CZ = n_cvt if kind == TAIL_LRT_NULL else C1
    xc = 0 if kind == TAIL_LRT_NULL else C1
    dyn = n_cvt > _TS["wide_cvt"]
    mma = form == TAIL_MMA
    lanes = {TAIL_REG: _TS["threads"] // 32, TAIL_MMA: _TS["lanes"],
             TAIL_LANE: 1}[form]
    Mp = _r8(M) if mma else M
    Qp = Mp + _r8(xc) if mma else M + xc
    pcols = min(Qp, _TS["threads"] // 32 * _TS["tpw"] * 8 if mma
                else _TS["threads"] * _TS["qpt"])
    isz = tsize if kind == TAIL_TEST else 4
    row = M + C1 if kind == TAIL_TEST else C1
    kc = _TS["km"] if mma else _TS["kl"]
    while kc > 4 and 2 * kc * row * isz > _TS["stage"]:
        kc //= 2
    raw = 2 * kc * row * isz <= _TS["stage"]
    pc8 = _r8(pcols)
    bst = 0 if raw else (pc8 + 4 if tsize == 8
                         else pc8 + (8 if pc8 % 16 == 0 else 0))
    if not raw:
        kc = _TS["kl"]
    bsz = kc * row if raw else kc * bst
    lane_set = (_r16(Q * tsize) if kind == TAIL_TEST else
                _r16(8 * (Q + 1)) + _r16(8 * (M + C1)))
    sets = 0 if dyn else lanes * lane_set
    lab = kind == TAIL_TEST and 4 * Q <= _TS["lab_max"]
    o = _r16(4 * Q) if lab else 0
    # K6's residual chunks of TS_RC rows where two fit, else none (and
    # each lane's solution in its scratch)
    rc = _TS["rc"] if 2 * _TS["rc"] * C1 * 4 <= _TS["stage"] else 0
    o += 0 if kind == TAIL_TEST or (mma and rc == 0) else _r16(8 * lanes * CZ)
    if form == TAIL_REG:
        nbytes = o + sets
    else:
        o += sets if form == TAIL_LANE else 0
        base = o
        o += _r16(8 * 2 * 2 * (_TS["km"] * (_TS["lanes"] + 4) if mma
                               else _TS["kl"]))
        o += _r16(2 * bsz * isz)
        nbytes = o
        if mma:
            p3 = 0 if kind == TAIL_TEST else base + _r16(4 * 2 * rc * C1)
            nbytes = max(nbytes, base + sets, p3)
    return dict(form=form, lanes=lanes, kc=kc, raw=raw, lab=lab, Mp=Mp, Qp=Qp,
                pcols=pcols, passes=-(-Qp // pcols), bst=bst, dyn=dyn, rc=rc,
                bytes=nbytes, lane_set=lane_set,
                lane_bytes=lane_set if dyn else 0)


def _hold_tail_layout(kernels, check):
    """K4-K6's launch layout as the kernels' own <name>_smem_bytes,
    <name>_lane_bytes and lrt_tail_null_bytes give it, every form and
    kind, c up to K6's 5,119: equal to tail_layout's, every block within
    the card's 227 KB, scratch a lane exactly above 32 covariates, the
    single-lane null's scratch, and a budget of three lanes' scratch
    splitting a block into launches that take every lane once."""
    from gemma_torch.kernels import lane_ranges
    bad = []
    cs = list(range(0, 42)) + [64, 100, 120, 200, 319, 320, 500, 1000, 3000,
                               5119]
    for c in cs:
        sizes = []
        for kern, tsize in ((kernels.WALD_TAIL, 4), (kernels.WALD_TAIL_F64, 8),
                            (kernels.SCORE_TAIL, 4),
                            (kernels.SCORE_TAIL_F64, 8)):
            sizes += [(kern.name, sh, kern.query("smem_bytes", c, sh),
                       kern.lane_bytes(c), tail_layout(
                           c, tail_form(c, sh), TAIL_TEST, tsize))
                      for sh in (0, 1)]
        sizes += [("lrt_tail", sh, kernels.LRT_TAIL.query(
            "smem_bytes", c, sh, null), kernels.LRT_TAIL.lane_bytes(c),
            tail_layout(c, tail_form(c, sh),
                        TAIL_LRT_NULL if null else TAIL_LRT, 8))
                  for sh in (0, 1) for null in (0, 1)]
        for name, sh, smem, lb, mirror in sizes:
            if not (0 < smem <= 227 * 1024 and (lb > 0) == (c > 32)
                    and smem == mirror["bytes"]
                    and lb == mirror["lane_set"] * mirror["dyn"]):
                bad.append((name, c, sh, smem, lb, mirror["bytes"]))
            for S in ((1, 3, 16, 64) if lb > 0 else ()):
                rs = lane_ranges(S, lb, 3 * lb)
                if ([i for a, e in rs for i in range(a, e)] != list(range(S))
                        or any(e - a > 3 for a, e in rs)):
                    bad.append((name, c, S, "lane_ranges"))
        if kernels.LRT_TAIL.query("null_bytes", c, MOUSE_N) <= 0:
            bad.append(("lrt_tail null_bytes", c))
    for name in ("wald_tail", "score_tail", "lrt_tail"):
        check(name, not bad, {"layout_mirror_equal_and_fits": not bad,
                              "violations": bad[:4]})


# the bound of K4-K6 (chip_smoke's record): what the design does, the
# sums' products at the FP64 tensor cores' rate, the rest at the CUDA
# cores', each lane's operands read once
TAIL_BOUND_NOTE = ("bound: the sums' float64 products at 67 TFLOP/s "
                   "(DMMA), the rest (weights, logs, the recurrence or the "
                   "factor, K6's residual pass) at 34; bytes: one read of "
                   "eval, [W, y], wy_prod (K4/K5) and Utx, shared ones once")


def _tail_work(data, nc, isz, lam_n, lrt=False, null_lanes=0):
    """(bytes, operations at the DMMA rate) of one call of K4/K5 (or K6's
    speed mode, with its null launch over null_lanes lanes): the sums'
    products 2 n Q a lane at 67 TFLOP/s, the weights (4 an individual a
    lane, K6 a log more), the recurrence's live entries (3 operations
    each, K4/K5) or the factor (CZ³/3) and the residual pass (2 C1 + 6 an
    individual, K6) at 34 TFLOP/s, counted at 67 as twice as many."""
    from gemma_torch.models.lmm import likelihood as lk
    S, n = lk.n_lanes(data), data.eval.shape[0]
    C1 = nc + 1
    M = C1 * (C1 + 1) // 2
    Q = M + C1 + 1
    rate = PEAK_F64_TC_PER_S / PEAK_F64_PER_S
    if not lrt:
        live = sum((nc + 2 - p) * (nc + 3 - p) // 2 for p in range(1, C1))
        nb = isz * sum(t.numel() for t in (data.eval, data.UtWy,
                                           data.wy_prod, data.Utx))
        nb += isz * (lam_n + 3 * S)
        return nb, S * (2 * n * Q + rate * (4 * n + 3 * live + 300))
    nb = 4 * (data.eval.numel() + data.UtWy.numel() + data.Utx.numel()
              + S + null_lanes) + 8 * 2 * S + 8 * null_lanes
    ops = 0.0
    for lanes, CZ, q in ((S, C1, Q), (null_lanes, nc, M)):
        ops += lanes * (2 * n * q + rate * (n * (5 + 2 * C1 + 6)
                                            + CZ ** 3 / 3 + 300))
    return nb, ops


def _hold_tail_split(kernels, kern, fn, args, whole, name, label, check):
    """K4-K6 split into launches of three lanes against the unsplit
    call: every output the same bit for bit."""
    added, same = _split_equal(kernels, kern, fn, args, whole)
    check(name, same and added > 0,
          {"block": label, "split_launches_added": added,
           "split_equal": same})


def _hold_mv_geometry(kernels, check):
    """K9-K11's launch geometry and lane scratch as the kernels' own
    <name>_geometry and <name>_lane_bytes give them, d = 2..10, c =
    2..14, both precisions, lane counts from one to the protocol block's:
    W warps a team from the lane count (16 at 128 lanes and fewer, 4 above
    256), at most two teams a block, NB a multiple of 32 up to 32 W, the
    block's shared bytes within the card's 227 KB; the protocol block
    four warps a lane, two lanes a block, its operands in shared memory;
    and a budget of three lanes' scratch splitting a block into launches
    that take every lane once."""
    from gemma_torch.kernels import lane_ranges
    bad = []
    for pair in ((kernels.MPH_EM, kernels.MPH_EM_F64),
                 (kernels.MPH_NR, kernels.MPH_NR_F64),
                 (kernels.MPH_CALC_P, kernels.MPH_CALC_P_F64)):
        for k in pair:
            for d in range(2, 11):
                for c in range(2, 15):
                    lb = k.lane_bytes(d, c)
                    for S in ((1, 3, 16, 64) if lb else ()):
                        rs = lane_ranges(S, lb, 3 * lb)
                        if ([i for a, e in rs for i in range(a, e)]
                                != list(range(S))
                                or any(e - a > 3 for a, e in rs)):
                            bad.append((k.name, d, c, S, "lane_ranges"))
                    if lb < 0:
                        bad.append((k.name, d, c, "lane_bytes", lb))
                    for count in (1, 3, 16, 64, 128, 129, 256, 257, 1024,
                                  10759):
                        W, L, NB, common, team, nbytes = (
                            k.query("geometry", count, MV_N, d, c - 1, 1, w)
                            for w in range(6))
                        ok = (W in (4, 8, 16) and (W == 16) == (count <= 128)
                              and (W == 4) == (count > 256)
                              and 1 <= L and L * W <= max(W, 8)
                              and NB % 32 == 0 and 32 <= NB <= 32 * W
                              and common in (0, 1)
                              and L * team * 8 <= nbytes <= 227 * 1024)
                        if not ok:
                            bad.append((k.name, d, c, count,
                                        (W, L, NB, common, team, nbytes)))
            g = [k.query("geometry", 10759, MV_N, 2, 1, 1, w)
                 for w in range(4)]
            if (g[0], g[1], g[3]) != (4, 2, 1):
                bad.append((k.name, "protocol", g))
    for name in ("mph_em", "mph_nr", "mph_calc_p"):
        check(name, not bad, {"geometry_invariants": not bad,
                              "violations": bad[:4]})


def _split_equal(kernels, kern, fn, args, whole):
    """(launches that a split added, equal): fn(*args) with
    kernels.split_lanes at three, so that `kern` splits its lanes into
    launches of three, against `whole`, the same call unsplit: every
    output the same bit for bit, NaN where it is NaN."""
    import torch
    before = kern.splits
    kernels.split_lanes = 3
    try:
        out = fn(*args)
    finally:
        kernels.split_lanes = None
    if isinstance(out, torch.Tensor):
        out, whole = (out,), (whole,)
    same = True
    for x, y in zip(out, whole):
        if not isinstance(x, torch.Tensor):
            continue
        if x.is_floating_point():
            same = same and torch.equal(x.isnan(), y.isnan()) \
                and torch.equal(x.nan_to_num(0.0), y.nan_to_num(0.0))
        else:
            same = same and torch.equal(x, y)
    return kern.splits - before, bool(same)


def _hold_grid_wide(fac, x, fine_np, check):
    """K2 against its plain version at each of GRID_WIDE_N covariates,
    REML and ML, at K2's tolerance, from the float32 factors `fac` and the
    genotypes x (S, n); the launch must take scratch."""
    import torch
    from gemma_torch import kernels
    from gemma_torch.models.lmm import likelihood as lk
    f32 = torch.float32
    ev, U, _, y = fac
    n, dev = ev.shape[0], ev.device
    grid = fine_np[::GRID_WIDE_STEP]
    lam_g = torch.as_tensor(grid, dtype=f32, device=dev)[:, None]
    for nc in GRID_WIDE_N:
        rng = np.random.default_rng(nc)
        W = torch.as_tensor(np.column_stack(
            [np.ones(n), rng.normal(size=(n, nc - 1))]), dtype=f32,
            device=dev)
        data = lk.build_batch_data(
            ev, U.T @ W, U.T @ y, (x[:GRID_WIDE_LANES] @ U).contiguous(), nc)
        gp = lk.grid_products(grid, data, nc)
        lane_bytes = kernels.LAMBDA_GRID.lane_bytes(nc, len(grid))
        for reml in (True, False):
            d_k = lk.grid_epilogue_cuda(gp, n, nc, False, reml)
            d_p, pms = _timed(lambda: lk.grid_epilogue_plain(gp, n, nc, False,
                                                            reml))
            bound = (1e-5 * d_p.abs().max()
                     + 8 * n * torch.finfo(f32).eps / lam_g)
            worst = float(((d_k - d_p).abs() / bound).max())
            ms = time_ms(lambda: lk.grid_epilogue_cuda(gp, n, nc, False,
                                                       reml), 3)
            check("lambda_grid", worst <= 1.0 and lane_bytes > 0,
                  {"block": f"wide_c{nc}", "fit": "reml" if reml else "ml",
                   "max_abs_err": float((d_k - d_p).abs().max()),
                   "max_err_over_bound": worst, "S": GRID_WIDE_LANES,
                   "G": len(grid), "lane_bytes": lane_bytes, "ms": ms,
                   "plain_ms": pms})
        del data, gp


def _hold_lrt_wide(label, data, nc, lam, l0, check):
    """K6's speed mode on one wide float32 block: the null launch (one
    shared lane split over n, or a null per lane) against the float64
    logf_stable, then the SNP launch against its plain version."""
    from gemma_torch import kernels
    from gemma_torch.models.lmm import likelihood as lk
    d64 = data._replace(eval=data.eval.double(), UtWy=data.UtWy.double(),
                        Utx=data.Utx.double())
    l0_p = lk.logf_stable(l0.double().reshape(-1), d64, nc, True, False)
    l0_k = lk.lrt_null_cuda(l0, data, nc)
    null_rel = float(((l0_k - l0_p).abs() / l0_p.abs()).max())
    l_k, p_k = lk.lrt_pvalues_cuda(lam, None, data, nc, l0, None)
    l_p, p_p = lk.lrt_pvalues_plain(lam, None, data, nc, l0, None)
    logl_rel = float(((l_k.double() - l_p.double()).abs()
                      / l_p.double().abs()).max())
    err = float((p_k - p_p).abs().max())
    ms = time_ms(lambda: lk.lrt_pvalues_cuda(lam, None, data, nc, l0, None),
                 3)
    lane_bytes = kernels.LRT_TAIL.lane_bytes(nc)
    check("lrt_tail", null_rel <= 1e-12 and logl_rel <= 1e-12
          and err <= 1e-6 and lane_bytes > 0,
          {"mode": "speed", "block": label, "S": lk.n_lanes(data),
           "max_abs_err": err, "logl_max_rel": logl_rel,
           "null_logl_max_rel": null_rel, "lane_bytes": lane_bytes,
           "ms": ms})


def _hold_tail_wide(fac, xs, env, check):
    """K4, K5 (both precisions) and K6's speed mode against their plain
    versions at each of TAIL_WIDE_N covariates, shared operands and a
    -gxe block, and K6 alone on shared operands at TAIL_WIDE_LRT_N; at
    seeded λ, from the factors `fac`, the genotypes `xs` and env (n,) of
    each precision, at the c >= 24 forms' tolerances (TOL_LANE; float64
    TOL); the launches must take scratch."""
    import torch
    from gemma_torch import kernels
    from gemma_torch.models.lmm import likelihood as lk
    from gemma_torch.models.lmm.engine import gxe_batch_data
    f32, f64 = torch.float32, torch.float64
    n = fac[f32][0].shape[0]
    for nc in TAIL_WIDE_N + (TAIL_WIDE_LRT_N,):
        rng = np.random.default_rng(nc)
        W = np.column_stack([np.ones(n), rng.normal(size=(n, nc - 1))])
        lam_np = 10.0 ** rng.uniform(-1.5, 1.5, TAIL_WIDE_LANES)
        lrt_only = nc == TAIL_WIDE_LRT_N
        for dt in (f32,) if lrt_only else (f32, f64):
            ev, U, _, y = fac[dt]
            dev = ev.device
            Wd = torch.as_tensor(W, dtype=dt, device=dev)
            Uty = U.T @ y
            x = xs[dt]
            lam = torch.as_tensor(lam_np, dtype=dt, device=dev)
            if lrt_only:
                # K6 reads no wy_prod: the block without it
                data = lk.LmmBatchData(
                    eval=ev, UtWy=torch.cat([U.T @ Wd, Uty[:, None]],
                                            dim=1).contiguous(),
                    wy_prod=ev[:, None][:, :0],
                    Utx=(x[:TAIL_WIDE_LANES] @ U).contiguous(),
                    iab_logdiag=None)
                _hold_lrt_wide(f"wide_c{nc}", data, nc, lam, lam[:1] * 1.1,
                               check)
                del data
                continue
            env_d = torch.as_tensor(env, dtype=dt, device=dev)
            xg = x[:TAIL_WIDE_GXE_LANES]
            blocks = (
                (f"wide_c{nc}", lk.build_batch_data(
                    ev, U.T @ Wd, Uty, (x[:TAIL_WIDE_LANES] @ U).contiguous(),
                    nc)),
                (f"gxe_wide_c{nc}", gxe_batch_data(
                    ev, U.T @ Wd[:, :nc - 2], U.T @ env_d, Uty, xg @ U,
                    (xg * env_d) @ U, nc - 2)))
            for label, data in blocks:
                S = lk.n_lanes(data)
                sfx = "" if dt == f32 else "_f64"
                for name, fk, fp, lm in (
                        ("wald_tail", lk.wald_pvalues_cuda,
                         lk.wald_pvalues_plain, lam[:S]),
                        ("score_tail", lk.score_pvalues_cuda,
                         lk.score_pvalues_plain, lam[:1])):
                    kern = getattr(kernels, (name + sfx).upper())
                    b_k, s_k, p_k = fk(lm, data, nc)
                    b_p, s_p, p_p = fp(lm, data, nc)
                    ok = torch.isfinite(p_p) & torch.isfinite(s_p)
                    err = float((p_k[ok] - p_p[ok]).abs().max())
                    beta_se = float(((b_k - b_p).abs() / s_p)[ok].max())
                    same_nan = bool((torch.isnan(p_k)
                                     == torch.isnan(p_p)).all())
                    tol_p, tol_b = (3e-5, 1e-3) if dt == f32 else (1e-10,
                                                                   1e-8)
                    ms = time_ms(lambda: fk(lm, data, nc), 3)
                    check(name + sfx,
                          err <= tol_p and beta_se <= tol_b and same_nan
                          and bool(ok.any()) and kern.lane_bytes(nc) > 0,
                          {"block": label, "S": S, "max_abs_err": err,
                           "beta_max_err_over_se": beta_se,
                           "finite_lanes": int(ok.sum()),
                           "lane_bytes": kern.lane_bytes(nc), "ms": ms})
                if dt == f32:
                    l0 = lam[:1] * 1.1 if data.UtWy.dim() == 2 \
                        else lam[:S] * 1.1
                    _hold_lrt_wide(label, data, nc, lam[:S], l0, check)
            del blocks, data


def _hold_mvlmm(mv_ops, counts_f, record, check, amax):
    """K9-K11 against their plain versions on the card, at the blocks the
    mvLMM paths give them: the whole protocol block (n = 757, d = 2,
    design 1 + x) and its GxE form (1 + env + x + x∘env), float32 and
    float64 operands, and the -n 1 2 3 4 5 path's 1,024 SNPs (d = 5, 1 +
    x, float32, held at the float64 tolerances: the kernels compute in
    float64, and only there do they run the d >= 3 Jacobi and the ML
    sign carry-over).  Each row reports the launches of the path that runs
    its form: -lmm 1 (float32 protocol), the parity -lmm 4 (float64), the
    -gxe paths and -n 1 2 3 4 5."""
    import torch
    from gemma_torch.models import mvlmm_core as mvc
    f32, f64 = torch.float32, torch.float64
    blocks = []
    def null_s(tag):
        """The null fit's seconds in the path run `tag` (its phase clock)."""
        return RESULTS[tag].get("null_seconds")

    for dt, sfx, cnt, cnt_x, tag, tag_x in (
            (f32, "", counts_f["lmm1"], counts_f["gxe"], "M1w", "MX4"),
            (f64, "_f64", counts_f["lmm4_f64"], counts_f["gxe_f64"], "M4d",
             "MX4d")):
        o = mv_ops[dt]
        nul, nx = o["null"], o["null_x"]
        common = dict(ev=o["ev"], Y=o["Y"], sfx=sfx, tight=dt == f64)
        # -lmm 1's REML fit: staged, and in float32 to the Newton switch
        blocks.append(dict(
            common, X0=o["X0"], R=o["R1"], Vg=nul.Vg_start[None],
            Ve=nul.Ve_start[None], B=nul.B_start[None], form=None,
            launches=cnt, staged=True, null_s=null_s(tag),
            cap=1000 if dt == f64 else mvc.nr_switch_point(1000)))
        # the GxE H1 fit: REML from the null to convergence
        blocks.append(dict(
            common, X0=o["X0e"], R=o["R2"], Vg=nx.Vg_start[None],
            Ve=nx.Ve_start[None], form="gxe", launches=cnt_x,
            staged=False, cap=1000, null_s=null_s(tag_x),
            B=torch.cat([nx.B_start, nx.B_start.new_zeros((2, 1))],
                        1)[None]))
    o = mv_ops["d5"]
    blocks.append(dict(
        ev=o["ev"], Y=o["Y"], X0=o["X0"], R=o["R1"],
        Vg=o["null"].Vg_start[None], Ve=o["null"].Ve_start[None],
        B=o["null"].B_start[None], form="d5", launches=counts_f["d5"],
        sfx="", tight=True, staged=True, cap=mvc.nr_switch_point(1000),
        null_s=null_s("M5")))
    for blk in blocks:
        _hold_mv_block(blk, record, check, amax)


def _crt_work(S, d, c, n, isz):
    """(bytes, float64 operations, a multiply or an add each) that K14's
    function needs for S lanes: the lanes' rows and parameters read once
    and the factors written; per individual its Gram weights and blocks,
    Hi, R, P, Z P and F, the rows P D_v Hi, and its share of the three
    products over n (G_p = P' diag(δ^p) P, T_p = Hi' diag(δ^p) F, L_p =
    X' diag(δ^p) W); per lane Qi, C = SS Z, Y = Qi (L' Z) as its two
    products, and the pair traces (csrc/calc_crt.cu)."""
    vs, cd, dd, tc = d * (d + 1) // 2, c * d, d * d, c * (c + 1) // 2
    npair = vs * (vs + 1) // 2
    # Hi, F, G_p and Qi are symmetric: each counts its entries on and
    # above the diagonal only
    per_k = 2 * (d * tc + vs * d + dd * c + 2 * dd * d + vs * d + 2 * vs * dd
                 + dd * (dd + 1) + 3 * vs * vs + 2 * c * vs * dd)
    per_lane = 2 * (cd * (cd + 1) // 2 * d
                    + 2 * vs * (dd * d + cd * d * d + cd * cd * d)
                    + npair * 4 * (d * cd + dd))
    nbytes = S * (isz * n + 8 * (2 * d * d + 4 * vs * vs + 3)) \
        + isz * (n + (c - 1) * n)
    return nbytes, S * (n * per_k + per_lane)


def _hold_crt(mv_ops, counts_f, record, check):
    """K14 against its plain version on the card, on the lanes the -crt
    paths refined: the protocol block's REML lanes of `-lmm 4 -crt`
    (float64) and the -n 1 2 3 4 5 block's (1,024 SNPs, d = 5), float64
    operands as -crt runs."""
    import torch
    for o, cnt, form, tag, of in (
            (mv_ops[torch.float64], counts_f["crt"], None, "MRd", "M1"),
            (mv_ops["d5_f64"], counts_f["d5_crt"], "d5", "M5R", "M5")):
        _hold_crt_block(o, cnt, form, tag, of, record, check)


def _crt_args(o, tag, max_lanes=None):
    """K14's arguments on the lanes the -crt path `tag` refined (its
    results' `refined` column; at most max_lanes of them), at their Newton
    optima as the path reaches them (models/mvlmm.py refine), from the
    operands `o` of that path's SNPs."""
    import torch
    from gemma_torch.config import GemmaConfig
    from gemma_torch.models import mvlmm_core as mvc
    from gemma_torch.models.mvlmm import _Iters
    it = _Iters(GemmaConfig())
    ev, X0, Y, R, nul = o["ev"], o["X0"], o["Y"], o["R1"], o["null"]
    Vs, Es, B0 = (nul.Vg_start[None], nul.Ve_start[None],
                  nul.B_start[None])
    idx = torch.as_tensor(np.flatnonzero(
        RESULTS[tag]["stats"]["refined"][:, 1])[:max_lanes],
        device=R.device)
    Ri = R[idx].contiguous()
    em = mvc.mph_em(True, it.em_iter, it.em_prec, ev, X0, Y, Ri, Vs, Es,
                    B0)
    Vg2, Ve2, _, Hvar = mvc.mph_nr(True, it.nr_iter, it.nr_prec, ev, X0,
                                   Y, Ri, em.Vg, em.Ve)
    return ev, X0, Ri, Vg2, Ve2, Hvar


def _hold_crt_block(o, cnt, form, tag, of, record, check, max_lanes=None,
                    witness=False):
    """K14 on the lanes the -crt path `tag` refined (its results'
    `refined` column; at most max_lanes of them), at their Newton optima
    as the path reaches them (models/mvlmm.py refine), from the operands
    `o` of the SNPs of the path `of`.  With `witness` (the ten-trait
    path, ROADMAP §C20) the plain version also runs on the CPU, the limit
    is D10_LIM's, and one call split into launches of three lanes must
    equal the unsplit call."""
    import torch
    from gemma_torch import kernels
    from gemma_torch.models import mvlmm_core as mvc
    if not np.array_equal(RESULTS[tag]["snp_indices"],
                          RESULTS[of]["snp_indices"]):
        raise RuntimeError(f"{tag}: not the SNPs of the operands")
    a = _crt_args(o, tag, max_lanes)
    ev, X0, Ri = a[:3]
    kk = mvc.calc_crt_cuda(*a)
    pp, pms = _timed(lambda: mvc.calc_crt_plain(*a))

    def gap(got):
        """(max rel gap to pp over crt_a, crt_b, crt_c, same finite)."""
        err, same = 0.0, True
        for x, y in zip(got, pp):
            x = x.to(y.device)
            ok = torch.isfinite(x) & torch.isfinite(y)
            same = same and bool((torch.isfinite(x) == torch.isfinite(y))
                                 .all())
            err = max(err, _mrel(x, y))
        return err, same

    err, same = gap(kk)
    ms = time_ms(lambda: mvc.calc_crt_cuda(*a), 3)
    S, n, d = Ri.shape[0], ev.shape[0], o["Y"].shape[0]
    c = X0.shape[0] + 1
    # the scratch a lane takes, against its Python mirror
    lane_bytes = kernels.CALC_CRT.lane_bytes(d, c, n)
    line = {"block": form or "snp", "S": S, "n": n, "d": d, "c": c,
            "max_rel_err": err, "same_finite": same,
            "finite_lanes": float(torch.isfinite(kk[0]).double().mean()),
            "lane_bytes": lane_bytes,
            "lane_bytes_mirror": 8 * mvc.crt_layout(n, d, c)["len"]}
    ok = (err <= 1e-9 and same
          and line["lane_bytes"] == line["lane_bytes_mirror"])
    if witness:
        line["cpu_max_rel_err"], line["cpu_same_finite"] = gap(
            mvc.calc_crt_plain(*_cpu(a)))
        line["split_launches_added"], line["split_equal"] = _split_equal(
            kernels, kernels.CALC_CRT, mvc.calc_crt_cuda, a, kk)
        line["tolerance"] = TOL_D10["calc_crt"]
        ok = (err <= D10_LIM["crt"] and same and line["split_equal"]
              and line["split_launches_added"] > 0
              and line["lane_bytes"] == line["lane_bytes_mirror"])
    check("calc_crt", ok, {**line, "ms": ms, "plain_ms": pms})
    nbytes, nops = _crt_work(S, d, c, n, ev.element_size())
    record("calc_crt", err, ms, pms, nbytes, nops,
           peak=PEAK_F64_TC_PER_S, launches=cnt, form=form,
           tol=(TOL_D10["calc_crt"] if witness else TOL["calc_crt"])
           if form else None)


def _drive_vc(kernels, paths, td, geno, f64):
    """Phase (h): -vc 1/2/3 with -k and -mk and -calccor/-gw on the mouse
    genotypes, in both precisions on the card, and their checks: float64
    against the port's float64 CPU runs, float32 against float64, REML's
    total pve against the simulated h².  Returns the paths' launch counts
    and the normalised rows."""
    t_h = time.time()
    Xn = _synth_vc(td)
    _say({"phase": "data_vc", "seconds": time.time() - t_h})
    vp = f"-g {geno} -p {td}/vc_pheno.txt -outdir {td} -no-check".split()
    kins = {"k": f"-k {td}/VK0.cXX.txt".split(),
            "mk": f"-mk {td}/vc_mk.txt".split()}
    cc = f"-a {td}/vc_anno.txt".split()
    counts = {
        "gk": _drive(kernels, paths, "vc_gk", [
            (f"vc_gk{i}", vp + f"-gk 1 -snps {td}/vc_half{i}.snps "
             f"-o VK{i}".split()) for i in (0, 1)], ("geno_prologue",))}
    restore = _keep_pair_colsum(PC_OPERANDS)
    try:
        counts["vc"] = _drive(kernels, paths, "vc", [
            (f"vc{m}_{k}", vp + kv + f"-vc {m} -o V{m}{k}".split())
            for m in (1, 2, 3) for k, kv in kins.items()], ("pair_colsum",),
            keep=True)
        counts["vc_f64"] = _drive(kernels, paths, "vc_f64", [
            (f"vc{m}_{k}_f64", vp + kv + f64 + f"-vc {m} -o V{m}{k}d".split())
            for m in (1, 2, 3) for k, kv in kins.items()],
            ("pair_colsum_f64",), keep=True)
    finally:
        restore()
    counts.update({
        "cor": _drive(kernels, paths, "calccor", [
            ("calccor", vp + cc + "-calccor -o VC".split()),
            ("gw", vp + cc + "-gw -o VG".split())], ("banded_cor",),
            keep=True),
        "cor_f64": _drive(kernels, paths, "calccor_f64", [
            ("calccor_f64", vp + cc + f64 + "-calccor -o VCd".split()),
            ("gw_f64", vp + cc + f64 + "-gw -o VGd".split())],
            ("banded_cor_f64",), keep=True),
    })
    _say({"phase": "e2e_vc", "paths": {
        k: v for k, v in paths.items() if k.startswith(("vc", "calccor"))}})
    t0 = time.time()
    for m in (1, 2, 3):
        for k, kv in kins.items():
            _run(vp + kv + f"-vc {m} -o C{m}{k}".split(), "cpu", keep=True)
    R = RESULTS
    chk = {"cpu_f64_seconds": time.time() - t0}
    failed = []
    fields = ("pve", "se_pve", "sigma2", "se_sigma2")
    for m in (1, 2, 3):
        for k in kins:
            d, c, f = R[f"V{m}{k}d"], R[f"C{m}{k}"], R[f"V{m}{k}"]
            rel = max(float(np.max(np.abs(getattr(d, x) - getattr(c, x))
                                   / np.abs(getattr(c, x)))) for x in fields)
            gap = float(np.max(np.abs(f.pve - d.pve)))
            chk[f"vc{m}_{k}"] = {"pve_card_f64": d.pve.tolist(),
                                 "se_pve": d.se_pve.tolist(),
                                 "f64_vs_cpu_f64_max_rel": rel,
                                 "f32_pve_vs_f64_max_abs": gap}
            if not rel <= 1e-8 or not gap <= 1e-3:
                failed.append(f"vc{m}_{k}")
    reml = R["V2mkd"]
    chk["reml_mk_total_pve"] = [reml.pve_total, reml.se_pve_total]
    if not abs(reml.pve_total - VC_H2) <= 3 * reml.se_pve_total:
        failed.append("reml_total_pve")
    cors = {t: np.concatenate(R[t]["cors"]) for t in ("VC", "VCd", "VG",
                                                      "VGd")}
    chk["cor_values"] = int(cors["VCd"].size)
    chk["bandwidth"] = int(R["VCd"]["n_nb"].max())
    chk["cor_f32_vs_f64_max_abs"] = float(np.max(np.abs(cors["VC"]
                                                        - cors["VCd"])))
    chk["gw_equals_calccor"] = bool(np.array_equal(cors["VGd"], cors["VCd"])
                                    and np.array_equal(cors["VG"],
                                                       cors["VC"]))
    if not (chk["cor_f32_vs_f64_max_abs"] <= 1e-5 and chk["gw_equals_calccor"]
            and np.array_equal(R["VC"]["var"], R["VCd"]["var"])):
        failed.append("calccor")
    chk["phase_h_seconds"] = time.time() - t_h
    _say({"phase": "check_vc", **chk})
    if failed:
        raise RuntimeError(f"phase (h) checks failed: {failed}")
    return counts, Xn


def _hold_pair_colsum(A, B, sfx, cnt, form, record, check):
    """K15 (sfx "" or "_f64") against its plain version on the stacks A
    and B, timed beside torch.einsum (time_ms, as every kernel; the
    card's time alone, _time_device_ms, beside it as device_ms); `form`
    None is the kernels line's main row."""
    import torch
    from gemma_torch.models import vc
    kk = vc.pair_colsum_cuda(A, B)
    pp = vc.pair_colsum_plain(A, B)
    err = float((kk - pp).abs().max() / pp.abs().max())
    del kk, pp
    ms = time_ms(lambda: vc.pair_colsum_cuda(A, B), 10)
    lib = time_ms(lambda: torch.einsum("ist,jst->ijt", A, B), 5)
    dev_ms, dev_missed = _time_device_ms(
        lambda: vc.pair_colsum_cuda(A, B), 10)
    dev_lib, lib_missed = _time_device_ms(
        lambda: torch.einsum("ist,jst->ijt", A, B), 5)
    pms = time_ms(lambda: vc.pair_colsum_plain(A, B), 3)
    ma, mb, n = A.shape[0], B.shape[0], A.shape[-1]
    same = A.data_ptr() == B.data_ptr()
    check("pair_colsum" + sfx, err <= 1e-12,
          {"block": form or "random", "max_rel_err": err, "n": n,
           "ma": ma, "mb": mb, "B_is_A": same, "ms": ms,
           "plain_ms": pms, "library_ms": lib, "device_ms": dev_ms,
           "library_device_ms": dev_lib,
           "device_reps_not_hidden": [dev_missed, lib_missed],
           "faster_than_library": ms < lib})
    record("pair_colsum" + sfx, err, ms, pms,
           (ma + (0 if same else mb)) * n * n * A.element_size()
           + 8 * ma * mb * n, 2 * ma * mb * n * n, peak=PEAK_F64_PER_S,
           launches=cnt, library_ms=lib, form=form,
           extra={"device_ms": dev_ms, "library_device_ms": dev_lib},
           note="library_ms is torch.einsum('ist,jst->ijt', A, B) on "
                "the same operands; ms and library_ms include the "
                "host's enqueue, as every kernel's; device_ms and "
                "library_device_ms are the card's time alone (the "
                "enqueue hidden behind a sleep on the card, over the "
                "reps where it was)")


def _drive_cvt(kernels, paths, td, common, kin, f64):
    """Phase (i): -lmm 4 and -lm 4 with CVT_N covariates (an intercept and
    CVT_N - 1 seeded normal columns), and -lmm 4 -gxe with the first
    CVT_N - 2 of them (c = CVT_N with env and x: the per-lane forms), on
    the mouse set, in both precisions on the card (K2-K8's second
    instantiation, above 16 covariates), and their checks against the
    port's float64 CPU run on the first CHECK_SNPS SNPs (CVT_GXE_CHECK for
    -gxe): within 1e-3 (>= 97% finite) in float32, within 1e-6 with >=
    99.9% the same NaN lanes in float64.  Returns the paths' launch counts
    and the covariates."""
    t_i = time.time()
    rng = np.random.default_rng(CVT_SEED)
    W = np.column_stack([np.ones(MOUSE_N),
                         rng.normal(size=(MOUSE_N, CVT_N - 1))])
    np.savetxt(f"{td}/cov24.txt", W, fmt="%.6f")
    np.savetxt(f"{td}/cov22.txt", W[:, :CVT_N - 2], fmt="%.6f")
    c24 = f"-c {td}/cov24.txt".split()
    gxe22 = f"-c {td}/cov22.txt -gxe {td}/env.txt".split()
    lane32 = ("lambda_grid", "lambda_solve", "wald_tail", "score_tail",
              "lrt_tail")
    lane64 = ("lambda_solve_f64", "wald_tail_f64", "score_tail_f64",
              "lrt_tail")
    counts = {
        "f32": _drive(kernels, paths, "cvt24", [
            ("lmm4_c24", common + kin + c24 + "-lmm 4 -o A24".split()),
            ("lm4_c24", common + c24 + "-lm 4 -o L24".split())],
            ("geno_prologue", "lambda_grid", "lambda_solve", "wald_tail",
             "score_tail", "lrt_tail", "lm_tail")),
        "f64": _drive(kernels, paths, "cvt24_f64", [
            ("lmm4_c24_f64", common + kin + c24 + f64
             + "-lmm 4 -o A24d".split()),
            ("lm4_c24_f64", common + c24 + f64 + "-lm 4 -o L24d".split())],
            ("geno_prologue_f64", "lambda_solve_f64", "wald_tail_f64",
             "score_tail_f64", "lrt_tail", "lm_tail_f64")),
        "gxe": _drive(kernels, paths, "gxe24", [
            ("gxe_c24", common + kin + gxe22 + "-lmm 4 -o X24".split())],
            ("geno_prologue",) + lane32),
        "gxe_f64": _drive(kernels, paths, "gxe24_f64", [
            ("gxe_c24_f64", common + kin + gxe22 + f64
             + "-lmm 4 -o X24d".split())],
            ("geno_prologue_f64",) + lane64),
    }
    t0 = time.time()
    snps1 = f"-snps {td}/first.snps".split()
    with open(f"{td}/gxe_first.snps", "w") as fh:
        fh.write("\n".join(f"rs{j}" for j in range(CVT_GXE_CHECK)) + "\n")
    _run(common + kin + c24 + snps1 + "-lmm 4 -o C24".split(), "cpu")
    _run(common + c24 + snps1 + "-lm 4 -o CL24".split(), "cpu")
    _run(common + kin + gxe22 + f"-snps {td}/gxe_first.snps -lmm 4 -o CX24"
         .split(), "cpu")
    chk = {"cpu_f64_seconds": time.time() - t0}
    for tag, ref_tag, tol, same_nan in (
            ("A24", "C24", 1e-3, None), ("A24d", "C24", 1e-6, 0.999),
            ("L24", "CL24", 1e-3, None), ("L24d", "CL24", 1e-6, 0.999),
            ("X24", "CX24", 1e-3, None), ("X24d", "CX24", 1e-6, 0.999)):
        rs_r, ref_r = _read_assoc(f"{td}/{ref_tag}.assoc.txt")
        rs_t, c_t = _read_assoc(f"{td}/{tag}.assoc.txt")
        chk[tag] = _p_errors(_aligned(rs_t, c_t, rs_r), ref_r, tol, 0.97,
                             same_nan=same_nan)
        chk[tag]["lanes"] = len(rs_t)
    chk["phase_i_seconds"] = time.time() - t_i
    _say({"phase": "check_cvt24", "covariates": CVT_N, **chk,
          "paths": {k: paths[k]["secs"] for k in (
              "cvt24", "cvt24_f64", "gxe24", "gxe24_f64")}})
    return counts, W


def _synth_mqs(td, Xn):
    """Phase (j)'s summary statistics on phase (h)'s genotypes and h²
    VC_H2 phenotype: each SNP's marginal z-score on the standardised
    genotypes in a -beta file (a1 a0 z n), MQS_CATS categories (the
    quarters of the SNPs) in a -cat file, seeded -wsnp weights, and -wcat
    LD scores: per category, the sum of r² over the SNP and its window in
    that category, from phase (h)'s float64 -calccor correlations."""
    p, n = Xn.shape
    y = np.loadtxt(f"{td}/vc_pheno.txt")
    z = Xn @ ((y - y.mean()) / y.std())
    cat = np.arange(p) * MQS_CATS // p
    with open(f"{td}/mqs_beta.txt", "w") as fh:
        fh.write("rs\ta1\ta0\tz\tn\n")
        fh.write("".join(f"rs{j}\tA\tT\t{z[j]:.6f}\t{n}\n"
                         for j in range(p)))
    head = "SNP\t" + "\t".join(f"c{k}" for k in range(MQS_CATS)) + "\n"
    onehot = np.eye(MQS_CATS, dtype=int)[cat]
    with open(f"{td}/mqs_cat.txt", "w") as fh:
        fh.write(head + "".join(
            f"rs{j}\t" + "\t".join(map(str, onehot[j])) + "\n"
            for j in range(p)))
    w = np.random.default_rng(MQS_SEED).uniform(0.5, 2.0, p)
    with open(f"{td}/mqs_wsnp.txt", "w") as fh:
        fh.write("".join(f"rs{j}\t{w[j]:.6f}\n" for j in range(p)))
    cor = RESULTS["VCd"]
    idx = cor["snp_indices"]
    cq = cat[idx]
    ld = np.eye(MQS_CATS)[cq]
    for i, c in enumerate(cor["cors"]):
        if len(c):
            r2 = np.asarray(c, np.float64) ** 2
            nb = np.arange(i + 1, i + 1 + len(c))
            ld[i] += np.bincount(cq[nb], weights=r2, minlength=MQS_CATS)
            ld[nb, cq[i]] += r2
    with open(f"{td}/mqs_wcat.txt", "w") as fh:
        fh.write(head + "".join(
            f"rs{j}\t" + "\t".join(f"{v:.6g}" for v in row) + "\n"
            for j, row in zip(idx, ld)))


def _keep_ci_raw(store):
    """Wrap models.ci.standardized_genotypes so that its first call in
    each operand type keeps a copy of the raw block (K1's -ci standardised
    form is held on the path's own operand).  Returns the function that
    unwraps it."""
    from gemma_torch.models import ci
    wrapped = ci.standardized_genotypes

    def keep(raw, n, dtype):
        store.setdefault(dtype, (raw.clone(), n))
        return wrapped(raw, n, dtype)

    ci.standardized_genotypes = keep
    return lambda: setattr(ci, "standardized_genotypes", wrapped)


def _mqs_fields(r):
    """The estimates of an MQS or -ci result, float64 arrays."""
    return {f: np.atleast_1d(np.asarray(getattr(r, f), np.float64))
            for f in ("pve", "se_pve", "sigma2persnp", "se_sigma2persnp",
                      "enrich", "se_enrich", "pve_total", "se_pve_total")}


def _max_rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _drive_mqs(kernels, paths, td, geno, f64, Xn):
    """Phase (j): the summary-statistics paths on phase (h)'s genotypes
    and phenotype — -gq, -gs, -vc 1 -beta (with -wsnp), -vc 2 -beta (with
    -wcat), -vc 1 -study/-ref and -ci 1/2 (-pve from the card's float64
    -vc 1), with MQS_CATS categories, in both precisions on the card —
    and their checks: float64 against the port's float64 CPU runs rel
    1e-8, float32 pve and se_pve within 1e-3 of float64, the MQS total pve
    within 0.15 of phase (h)'s HE total pve (-vc 1 -mk) and within 3 se
    of the simulated VC_H2.  Returns the paths' launch counts."""
    t_j = time.time()
    _synth_mqs(td, Xn)
    _say({"phase": "data_mqs", "seconds": time.time() - t_j})
    vp = f"-g {geno} -p {td}/vc_pheno.txt -outdir {td} -no-check".split()
    beta = f"-beta {td}/mqs_beta.txt".split()
    cat = f"-cat {td}/mqs_cat.txt".split()
    wsnp = f"-wsnp {td}/mqs_wsnp.txt".split()
    wcat = f"-wcat {td}/mqs_wcat.txt".split()

    def vc_paths(sfx, prec):
        return [("gq" + sfx, beta + cat + f"-gq -outdir {td} -o MQ{sfx}"
                 .split() + prec),
                ("gs" + sfx, vp + cat + prec + f"-gs -o MG{sfx}".split()),
                ("vc1_beta" + sfx, vp + beta + cat + wsnp + prec
                 + f"-vc 1 -o MV1{sfx}".split()),
                ("vc2_beta" + sfx, vp + beta + cat + wcat + prec
                 + f"-vc 2 -o MV2{sfx}".split()),
                ("vc1_study_ref" + sfx, f"-study {td}/MQ{sfx} -ref "
                 f"{td}/MG{sfx} -vc 1 -outdir {td} -o MS{sfx}".split()
                 + prec)]

    def ci_paths(sfx, prec, pve):
        base = vp + beta + cat + f"-ref {td}/MG{sfx} -pve".split() + pve
        return [("ci1" + sfx, base + prec + f"-ci 1 -o MC1{sfx}".split()),
                ("ci2" + sfx, base + wcat + prec
                 + f"-ci 2 -o MC2{sfx}".split())]

    restore = _keep_pair_colsum(MQS_PC)
    restore_ci = _keep_ci_raw(CI_RAW)
    try:
        counts = {
            "f64": _drive(kernels, paths, "mqs_f64", vc_paths("d", f64),
                          ("geno_prologue_f64", "pair_colsum_f64"),
                          keep=True),
            "f32": _drive(kernels, paths, "mqs", vc_paths("", []),
                          ("geno_prologue", "pair_colsum_f64"), keep=True)}
        pve = [f"{v:.8g}" for v in RESULTS["MV1d"].pve]
        counts["ci_f64"] = _drive(kernels, paths, "mqs_ci_f64",
                                  ci_paths("d", f64, pve),
                                  ("geno_prologue_f64",), keep=True)
        counts["ci"] = _drive(kernels, paths, "mqs_ci", ci_paths("", [], pve),
                              ("geno_prologue",), keep=True)
    finally:
        restore()
        restore_ci()
    _say({"phase": "e2e_mqs", "paths": {
        k: v for k, v in paths.items() if k.startswith("mqs")}})

    t0 = time.time()
    # the CPU's runs, -ci on its own -gs panel
    for _, argv in vc_paths("c", f64) + ci_paths("c", f64, pve):
        _run(argv, "cpu", keep=True)
    R = RESULTS
    chk = {"cpu_f64_seconds": time.time() - t0, "pve_arg": pve}
    failed = []
    # S and Svar relative to each matrix's largest entry: an off-diagonal
    # S_ij = tr(A_i K_j)/(tr A_i tr K_j) - 1/(n - c) cancels to ~1e-3 of
    # the diagonal, so entry by entry the summation order shows at ~1e-7
    S_card, S_cpu = R["MGd"], R["MGc"]
    chk["gs_f64_vs_cpu_f64_max_rel"] = max(
        float(np.max(np.abs(S_card[i] - S_cpu[i]))
              / np.max(np.abs(S_cpu[i]))) for i in (0, 1))
    if not chk["gs_f64_vs_cpu_f64_max_rel"] <= 1e-8 or \
            not np.array_equal(S_card[2], S_cpu[2]):
        failed.append("gs")
    for key in ("MV1", "MV2", "MS", "MC1", "MC2"):
        d, c, f = (_mqs_fields(R[key + t]) for t in ("d", "c", ""))
        rel = max(_max_rel(d[x], c[x]) for x in d)
        gap = max(float(np.max(np.abs(f[x] - d[x])))
                  for x in ("pve", "se_pve"))
        chk[key] = {"pve_card_f64": d["pve"].tolist(),
                    "se_pve": d["se_pve"].tolist(),
                    "pve_total": float(d["pve_total"][0]),
                    "se_pve_total": float(d["se_pve_total"][0]),
                    "f64_vs_cpu_f64_max_rel": rel,
                    "f32_vs_f64_max_abs": gap}
        if not rel <= 1e-8 or not gap <= 1e-3:
            failed.append(key)
    mqs, he = R["MV1d"], R["V1mkd"]
    chk["mqs_total_pve"] = [mqs.pve_total, mqs.se_pve_total]
    chk["he_mk_total_pve"] = [he.pve_total, he.se_pve_total]
    if not (abs(mqs.pve_total - he.pve_total) <= 0.15
            and abs(mqs.pve_total - VC_H2) <= 3 * mqs.se_pve_total):
        failed.append("mqs_total_pve")
    chk["phase_j_seconds"] = time.time() - t_j
    _say({"phase": "check_mqs", **chk})
    if failed:
        raise RuntimeError(f"phase (j) checks failed: {failed}")
    return counts


def _hold_mqs(counts_j, record, check):
    """K15 on the MQS paths' own stacks (n = 1,940, MQS_CATS categories,
    float64 from the finished stacks on in both precisions: A = K on
    -gs/-vc 1, A the LDSC-weighted stack on -vc 2's second pass), and
    K1's standardised form on the -ci paths' first raw block, each
    against its plain version."""
    import torch
    from gemma_torch.ops import pack2
    for key in sorted(MQS_PC, key=str):
        A, B = MQS_PC[key]
        _hold_pair_colsum(A, B, "_f64", counts_j["f64"], "mqs_" + (
            "k_k" if key[1] else "a_k"), record, check)
    MQS_PC.clear()
    for dt, name, tol, cnt in (
            (torch.float32, "geno_prologue", 1e-5, counts_j["ci"]),
            (torch.float64, "geno_prologue_f64", 1e-12, counts_j["ci_f64"])):
        raw, n = CI_RAW.pop(dt)
        args = (raw, n, pack2.CENTRE, True, n, dt)
        x_k = pack2.prologue_cuda(*args)
        x_p = pack2.prologue_plain(*args)
        err = float((x_k - x_p).abs().max())
        ms = time_ms(lambda: pack2.prologue_cuda(*args), 20)
        pms = time_ms(lambda: pack2.prologue_plain(*args), 5)
        S = raw.shape[0]
        check(name, err <= tol, {"block": "ci_standardised",
                                 "max_abs_err": err, "S": S, "n": n,
                                 "wire": str(raw.dtype), "ms": ms,
                                 "plain_ms": pms})
        isz = torch.finfo(dt).bits // 8
        record(name, err, ms, pms, raw.numel() * raw.element_size()
               + isz * S * n, 6 * S * n,
               peak=PEAK_F32_PER_S if dt == torch.float32
               else PEAK_F64_PER_S, launches=cnt, form="ci_standardised")


def _keep_pair_colsum(store):
    """Wrap models.vc.pair_colsum so that the first call of each form
    (operand type, B is A, stack sizes) keeps a copy of its operands in
    `store`: K15 is held on the -vc paths' own stacks.  Returns the
    function that unwraps it."""
    from gemma_torch.models import vc
    wrapped = vc.pair_colsum

    def keep(A, B):
        same = A.data_ptr() == B.data_ptr()
        key = (A.dtype, same, A.shape[0], B.shape[0])
        if key not in store:
            a = A.clone()
            store[key] = (a, a if same else B.clone())
        return wrapped(A, B)

    vc.pair_colsum = keep
    return lambda: setattr(vc, "pair_colsum", wrapped)


def _pc_form(key):
    """The name of a K15 form kept by _keep_pair_colsum: HE's centred and
    scaled stack against itself (ACL's standardised stack has the same
    shape), or REML's P against the stack, for one kinship (-k) or two
    (-mk)."""
    _, same, ma, mb = key
    return ("he_" if same else "reml_") + ("k" if mb == 1 else "mk")


def _hold_vc(counts_h, Xn, record, check):
    """K15 against its plain version on the -vc paths' own stacks (n =
    1,940, each in the precision that ran it: HE's scaled stack against
    itself and REML's P against the stack, for -k and -mk) and on PC_M
    random symmetric PC_N² matrices made on the card (the kernels line's
    main row), beside torch.einsum; K16 on the whole band of phase (h)'s
    normalised rows (all SNPs, the path's bandwidth) and on the path's
    first and last blocks (varcov.BLOCK rows and the bw rows after them),
    beside the reference's block product and gather."""
    import torch
    from gemma_torch.models import varcov
    dev = torch.device("cuda")

    for key in sorted(PC_OPERANDS, key=str):
        A, B = PC_OPERANDS[key]
        f64 = key[0] == torch.float64
        _hold_pair_colsum(A, B, "_f64" if f64 else "",
                          counts_h["vc_f64" if f64 else "vc"], _pc_form(key),
                          record, check)
    PC_OPERANDS.clear()
    gen = torch.Generator(device=dev).manual_seed(PC_N)
    A64 = torch.randn((PC_M, PC_N, PC_N), dtype=torch.float64, device=dev,
                      generator=gen)
    A64 = (A64 + A64.transpose(1, 2)) / 2
    for dt, sfx, cnt in ((torch.float64, "_f64", counts_h["vc_f64"]),
                         (torch.float32, "", counts_h["vc"])):
        A = A64 if dt == torch.float64 else A64.float()
        _hold_pair_colsum(A, A, sfx, cnt, None, record, check)
        del A
    del A64
    torch.cuda.empty_cache()

    blk = varcov.BLOCK
    bw = int(RESULTS["VCd"]["n_nb"].max())
    Rn, n = Xn.shape
    last = (Rn - 1) // blk * blk
    # (form, first row, rows correlated, rows given)
    spans = ((None, 0, Rn, Rn),
             ("first_block", 0, blk, min(blk + bw, Rn)),
             ("last_block", last, Rn - last, Rn - last))

    def library(X, S):
        """The reference's form (varcov.py:51-60, 63-105): each block of
        varcov.BLOCK rows times its rows and the next bw, zero-padded, then
        the bw diagonals gathered."""
        R = X.shape[0]
        for s in range(0, S, blk):
            e = min(s + blk, S)
            nb = torch.cat([X[s:min(e + bw, R)],
                            X.new_zeros((max(e + bw - R, 0), n))])
            full = X[s:e] @ nb.T
            idx = (torch.arange(e - s, device=dev)[:, None]
                   + torch.arange(1, bw + 1, device=dev)[None, :])
            torch.take_along_dim(full, idx, dim=1)

    for dt, sfx, cnt in ((torch.float32, "", counts_h["cor"]),
                         (torch.float64, "_f64", counts_h["cor_f64"])):
        Xd = torch.as_tensor(Xn, dtype=dt, device=dev)
        for form, s0, S, R in spans:
            X = Xd[s0:s0 + R].contiguous()
            kk = varcov.banded_cor_cuda(X, S, bw)
            pp = varcov.banded_cor_plain(X, S, bw)
            diff = float((kk - pp).abs().max())
            err = diff if dt == torch.float32 else \
                diff / float(pp.abs().max())
            ms = time_ms(lambda: varcov.banded_cor_cuda(X, S, bw), 10)
            pms = time_ms(lambda: varcov.banded_cor_plain(X, S, bw), 3)
            lib = time_ms(lambda: library(X, S), 3)
            tol = 1e-5 if dt == torch.float32 else 1e-12
            check("banded_cor" + sfx, err <= tol,
                  {"block": form or "band", "max_err": err, "S": S,
                   "rows": R, "bw": bw, "n": n, "ms": ms, "plain_ms": pms,
                   "library_ms": lib})
            # the pairs inside the rows given (the rest are 0, not read)
            pairs = sum(max(0, min(S, R - j - 1)) for j in range(bw))
            record("banded_cor" + sfx, err, ms, pms,
                   X.element_size() * (R * n + S * bw), 2 * pairs * n,
                   peak=PEAK_F32_PER_S if dt == torch.float32
                   else PEAK_F64_TC_PER_S, launches=cnt, library_ms=lib,
                   form=form,
                   note="library_ms is the reference's form: blocks of "
                        f"{blk} rows times their rows and the next bw "
                        "by torch.matmul, then torch.take_along_dim of the "
                        "bw diagonals; the float64 bound is at the FP64 "
                        "tensor cores' rate, where the kernel runs")
            del X, kk, pp
        del Xd


def _drive_bslmm(kernels, paths, td, geno, f64):
    """Phase (g): BSLMM and prediction on the mouse genotypes with phase
    (g)'s phenotypes, on the card, and their checks against the port's
    float64 CPU runs; returns the paths' launch counts."""
    t_g = time.time()
    causal, g_true, held = _synth_bslmm(td)
    _say({"phase": "data_bslmm", "seconds": time.time() - t_g})
    base = f"-g {geno} -outdir {td} -no-check -seed {BSLMM_SEED}".split()
    bs = base + f"-p {td}/bs_pheno.txt".split()
    kin = f"-k {td}/Kd.cXX.txt".split()
    chain = f"-bslmm 1 -w {BSLMM_W} -s {BSLMM_S}".split()
    chain32 = ("geno_prologue", "lambda_grid", "lambda_solve", "bslmm_chain")
    # the DAP grid's default h range ends at h = 1, where its sigma_a2 is
    # undefined (ROADMAP §C13)
    dap4 = "-bslmm 4 -hmax 0.95".split()
    counts = {
        "b1": _drive(kernels, paths, "bslmm1", [
            ("bslmm1", bs + chain + "-o B1".split())], chain32, keep=True),
        "b1_f64": _drive(kernels, paths, "bslmm1_f64", [
            ("bslmm1_f64", bs + f64 + "-bslmm 1 -w 1000 -s 4000 "
             "-o B1d".split())],
            ("geno_prologue_f64", "lambda_solve_f64", "bslmm_chain_f64"),
            keep=True),
        "b2": _drive(kernels, paths, "bslmm2", [
            ("bslmm2", bs + kin + "-bslmm 2 -o B2".split())],
            ("geno_prologue",), keep=True),
        "b3": _drive(kernels, paths, "bslmm3", [
            ("bslmm3", base + f"-p {td}/bs_binary.txt -bslmm 3 -w 1000 "
             "-s 10000 -o B3".split())], ("bslmm_chain",), keep=True),
        "b4": _drive(kernels, paths, "bslmm4", [
            ("bslmm4", bs + kin + dap4 + "-o B4".split())], ("dap_bf",),
            keep=True),
        "b4_f64": _drive(kernels, paths, "bslmm4_f64", [
            ("bslmm4_f64", bs + kin + f64 + dap4 + "-o B4d".split())],
            ("dap_bf_f64",), keep=True),
        "b4_rho1": _drive(kernels, paths, "bslmm4_rho1", [
            ("bslmm4_rho1", bs + "-bslmm 4 -rmin 1 -rmax 1 -w 100 -s 1000 "
             "-o B4r".split())], ("bslmm_chain",)),
    }
    # -bslmm 5 from the card's float64 Bayes factors (blocks of 100 SNPs,
    # the reader's `rs block BF...` layout) with annotations
    _bf_input(td, "B4d")
    dap5 = (f"-bslmm 5 -hyp {td}/B4d.hyp.txt -bf {td}/bf_in.txt "
            f"-cat {td}/cat.txt -outdir {td}").split()
    epm = (f"-epm {td}/B1.param.txt -emu {td}/B1.log.txt").split()
    pred = [("bslmm5", dap5 + "-o B5".split()),
            ("predict1", bs + epm + f"-ebv {td}/B1.bv.txt".split() + kin
             + "-predict 1 -o P1".split()),
            ("predict2", bs + epm + "-predict 2 -o P2".split()),
            ("predict3", bs + kin + f64 + "-predict 3 -o P3".split())]
    counts["pred"] = _drive(kernels, paths, "bslmm5_predict", pred,
                            ("lambda_solve_f64",), keep=True)
    _say({"phase": "e2e_bslmm", "paths": {
        k: v for k, v in paths.items() if k.startswith(("bslmm", "pred"))},
        "bslmm1_chain_seconds": RESULTS["B1"]["chain_seconds"],
        "bslmm1_ms_per_1000_iterations": RESULTS["B1"]["chain_seconds"]
        * 1e3 / (BSLMM_W + BSLMM_S) * 1e3})
    prof = _profile(bs + "-bslmm 1 -w 2000 -s 20000 -o BW".split())
    _say({"phase": "profile_bslmm1_22000_iterations", **prof})

    # against the port's float64 CPU runs on the same files
    t0 = time.time()
    with open(f"{td}/first.snps", "w") as fh:
        fh.write("\n".join(f"rs{j}" for j in range(CHECK_SNPS)) + "\n")
    cpu = [("CB1", bs + "-bslmm 1 -w 0 -s 1".split()),
           ("CB2", bs + kin + "-bslmm 2".split()),
           ("CB4", bs + kin + f"-snps {td}/first.snps".split() + dap4),
           ("CB5", dap5),
           ("CP1", bs + epm + f"-ebv {td}/B1.bv.txt".split() + kin
            + ["-predict", "1"]),
           ("CP2", bs + epm + ["-predict", "2"]),
           ("CP3", bs + kin + ["-predict", "3"])]
    for tag, argv in cpu:
        _run(argv + ["-o", tag], "cpu", keep=True)
    R = RESULTS
    chk = {"cpu_f64_seconds": time.time() - t0}

    def rel(a, b):
        """max |a - b| / max |b| over b's finite entries (inf where a is
        not finite there or where the two disagree on which are)."""
        a, b = np.asarray(a, float), np.asarray(b, float)
        fin = np.isfinite(b)
        if (np.isfinite(a) != fin).any():
            return float("inf")
        return float(np.max(np.abs(a[fin] - b[fin])) / np.max(np.abs(b[fin])))

    failed = []

    def need(name, ok):
        chk[name + "_ok"] = bool(ok)
        if not ok:
            failed.append(name)

    # -bslmm 1: the initial state, the chain's summaries, the prediction
    i32, i64 = R["B1"]["init"], R["CB1"]["init"]
    chk["b1_init"] = {"card_f32": i32, "cpu_f64": i64}
    need("b1_init", i32["n_gamma"] == i64["n_gamma"] and all(
        abs(i32[k] - i64[k]) <= 1e-4 * abs(i64[k])
        for k in ("h", "rho", "logp")))
    st = R["B1"]["state"]
    hyp = st.rec_hyp[:st.w].cpu().numpy()
    top20 = np.argsort(-R["B1"]["gamma"], kind="stable")[:20]
    idx = np.flatnonzero(R["B1"]["dataset"].qc.indicator_snp)
    found = len(set(idx[top20]) & set(causal))
    accept = st.n_accept / (BSLMM_W + BSLMM_S)
    p1 = R["P1"]
    r_pred = float(np.corrcoef(p1, g_true[held])[0, 1])
    chk["b1"] = {"records": st.w, "pve_mean": float(hyp[:, 1].mean()),
                 "n_gamma_mean": float(hyp[:, 5].mean()),
                 "causal_in_top20_pip": found, "acceptance": accept,
                 "predict_r_held_out": r_pred, "held_out": int(held.sum())}
    need("b1_pve", abs(hyp[:, 1].mean() - 0.5) <= 0.1)
    need("b1_causal", found >= 8)
    need("b1_predict", r_pred >= 0.3)
    hyp_d = R["B1d"]["state"].rec_hyp[:R["B1d"]["state"].w].cpu().numpy()
    chk["b1_f64"] = {"records": int(hyp_d.shape[0]),
                     "pve_mean": float(hyp_d[:, 1].mean())}
    need("b1_f64", np.isfinite(hyp_d).all() and hyp_d.shape[0] == 400)
    h3 = R["B3"]["state"].rec_hyp[:R["B3"]["state"].w].cpu().numpy()
    chk["b3"] = {"records": int(h3.shape[0]),
                 "pve_mean": float(h3[:, 1].mean()),
                 "acceptance": R["B3"]["state"].n_accept / (
                     (R["B3"]["settings"].w_step + R["B3"]["settings"].s_step)
                     * R["B3"]["settings"].n_mh)}
    need("b3", np.isfinite(h3).all() and ((h3[:, 1] >= 0)
                                          & (h3[:, 1] <= 1)).all())
    # -bslmm 2: alpha and bv, float32 against float64
    chk["b2_alpha_rel"] = rel(R["B2"]["alpha"], R["CB2"]["alpha"])
    chk["b2_bv_rel"] = rel(R["B2"]["bv"], R["CB2"]["bv"])
    need("b2", chk["b2_alpha_rel"] <= 1e-4 and chk["b2_bv_rel"] <= 1e-4)
    # -bslmm 4: log BF on the first CHECK_SNPS SNPs
    ref = np.log(R["CB4"]["BF"])
    snps_cpu = np.flatnonzero(R["CB4"]["dataset"].qc.indicator_snp)
    for tag, tol in (("B4", 1e-3), ("B4d", 1e-8)):
        pos = {j: i for i, j in enumerate(
            np.flatnonzero(R[tag]["dataset"].qc.indicator_snp))}
        got = np.log(R[tag]["BF"][[pos[j] for j in snps_cpu]])
        fin = np.isfinite(ref)
        err = float(np.max(np.abs(got[fin] - ref[fin])))
        chk[tag + "_logbf_max_abs"] = err
        chk[tag + "_finite_where_cpu"] = float(np.isfinite(got[fin]).mean())
        need(tag, err <= tol and np.isfinite(got[fin]).all()
             and fin.mean() >= 0.8)
    # -bslmm 5 and -predict from the same files
    for tag, ref_tag in (("B5", "CB5"), ("P1", "CP1"), ("P2", "CP2"),
                         ("P3", "CP3")):
        a, b = R[tag], R[ref_tag]
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        chk[tag + "_rel"] = err = max(rel(x, y) for x, y in pairs)
        need(tag, err <= 1e-8)
    chk["phase_g_seconds"] = time.time() - t_g
    _say({"phase": "check_bslmm", **chk})
    if failed:
        raise RuntimeError(f"phase (g) checks failed: {failed}")
    return counts


def _bf_input(td, tag):
    """A -bf input (`rs block BF...`, blocks of 100 SNPs) from a -bslmm 4
    run's .bf.txt, and a -cat annotation file (a discrete and a
    continuous column) for its SNPs."""
    with open(f"{td}/{tag}.bf.txt") as fh:
        head = fh.readline().split()
        rows = [ln.split() for ln in fh]
    rng = np.random.default_rng(9)
    with open(f"{td}/bf_in.txt", "w") as fh, open(f"{td}/cat.txt",
                                                  "w") as fc:
        fh.write("rs\tblock\t" + "\t".join(head[4:]) + "\n")
        fc.write("rs\tcoding\tscore_c\n")
        for i, r in enumerate(rows):
            fh.write(f"{r[1]}\tb{i // 100}\t" + "\t".join(r[4:]) + "\n")
            fc.write(f"{r[1]}\t{int(rng.random() < 0.2)}\t"
                     f"{rng.normal():.4f}\n")


def _hold_bslmm(counts_g, record, check):
    """K12 against its plain version on the card, on the -bslmm 1 paths'
    operands (float32 and float64) and the -bslmm 3 path's, from the
    paths' initial states and seed, every iteration recorded; K13 on the
    -bslmm 4 paths' products."""
    import torch
    from gemma_torch.models import bslmmdap as dap
    for tag, sfx, cnt, iters, form in (
            ("B1", "", counts_g["b1"], HOLD_ITERS, None),
            ("B1d", "_f64", counts_g["b1_f64"], HOLD_ITERS, None),
            ("B3", "", counts_g["b3"], 100, "probit")):
        _hold_chain(tag, sfx, cnt, iters, form, record, check)
    for tag, sfx, cnt, tol in (("B4", "", counts_g["b4"], 1e-6),
                               ("B4d", "_f64", counts_g["b4_f64"], 1e-10)):
        res = RESULTS[tag]
        grid = res["grid"]
        Uty = res["Uty"]
        n = Uty.shape[0]
        tau = n / float(Uty.double() @ Uty.double())
        prods = dap.bf_products(res["UtXT"], Uty, res["eval"], grid[:, 3])
        sa2 = torch.as_tensor(grid[:, 2], dtype=torch.float64,
                              device=Uty.device)
        a = prods + (sa2, tau, n)
        bk, bp = dap.bf_epilogue_cuda(*a), dap.bf_epilogue_plain(*a)
        fin = torch.isfinite(bp)
        err = float(((bk - bp).abs() / bp.abs())[fin].max())
        same = bool((torch.isfinite(bk) == fin).all())
        ms = time_ms(lambda: dap.bf_epilogue_cuda(*a), 20)
        pms = time_ms(lambda: dap.bf_epilogue_plain(*a), 5)
        S, G = bk.shape
        isz = prods[0].element_size()
        check("dap_bf" + sfx, err <= tol and same,
              {"max_rel_err": err, "same_finite": same, "S": S, "G": G,
               "ms": ms, "plain_ms": pms})
        record("dap_bf" + sfx, err, ms, pms, S * G * (2 * isz + 8) + 24 * G,
               25 * S * G, peak=PEAK_F64_PER_S, launches=cnt)


def chain_agreement(kk, pp, iters):
    """(first, err, ok) of K12's chain kk against the plain version's pp
    over `iters` recorded iterations: the first iteration whose ranks
    differ or whose hyper-parameter row differs by more than 1e-9
    relative (None if none), the largest relative difference before it,
    and whether that comes after iteration 1,000 (or `iters`, if fewer)
    or never."""
    hk, hp = kk.rec_hyp.cpu().numpy(), pp.rec_hyp.cpu().numpy()
    gk, gp = kk.rec_gamma.cpu().numpy(), pp.rec_gamma.cpu().numpy()
    row_rel = (np.abs(hk - hp) / np.maximum(np.abs(hp), 1e-300)).max(1)
    apart = np.flatnonzero((row_rel > 1e-9) | (gk != gp).any(1))
    first = int(apart[0]) if apart.size else None
    err = float(row_rel[:first].max()) if first != 0 else 0.0
    ok = (first is None or first >= min(1000, iters)) and err <= 1e-9
    return first, err, ok


def _hold_chain(tag, sfx, cnt, iters, form, record, check, reps=3,
                s_min=None):
    """K12 against its plain version for `iters` iterations from the
    initial state and seed of the -bslmm 1/3 path `tag`, every iteration
    recorded; K12 timed on `reps` launches.  `s_min` raises the path's
    s_min and starts from that many active ranks."""
    import dataclasses
    import torch
    from gemma_torch import kernels as kernels_mod
    from gemma_torch.models import bslmm as pb
    res = RESULTS[tag]
    ops, i0 = res["ops"], res["init"]
    n = ops.eval.shape[0]
    st = dataclasses.replace(res["settings"], w_step=0, s_step=iters,
                             r_pace=1)
    ng0 = i0["n_gamma"]
    if s_min is not None:
        st = dataclasses.replace(st, s_min=s_min)
        ng0 = s_min
    s0 = pb.init_state(ops, st, i0["h"], i0["rho"], i0["logp"], ng0,
                       BSLMM_SEED)
    kk = pb.bslmm_chain_cuda(ops, st, s0, iters, BSLMM_SEED)
    pp, pms = _timed(lambda: pb.bslmm_chain_plain(ops, st, s0, iters,
                                                  BSLMM_SEED))
    first, err, ok = chain_agreement(kk, pp, iters)
    ms = time_ms(lambda: pb.bslmm_chain_cuda(ops, st, s0, iters,
                                             BSLMM_SEED), reps)
    ng = float(kk.rec_hyp[:, 5].mean())
    posts = st.n_mh + (st.a_mode == 13)
    isz = torch.finfo(ops.UtXT.dtype).bits // 8
    nops = iters * posts * (n * ng * ng + ng ** 3 / 3 + 20 * n)
    nbytes = iters * posts * (n * ng * isz + 10 * n * 8)
    if st.a_mode == 13:
        nops += iters * 4 * n * n
        nbytes += iters * 2 * n * n * isz
    kern = kernels_mod.variant(kernels_mod.BSLMM_CHAIN,
                               kernels_mod.BSLMM_CHAIN_F64, ops.UtXT.dtype)
    cluster = kern.cluster
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the bound of the cluster's SMs alone: a chain runs on one cluster
    cluster_bound = max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_F64_PER_S) \
        * 1e3 * sms / cluster
    check("bslmm_chain" + sfx, ok, {
        "block": form or "chain", "iterations": iters,
        "first_divergence": first, "hyp_max_rel_err_before": err,
        "accepts_card": kk.n_accept, "accepts_plain": pp.n_accept,
        "mean_n_gamma": ng, "cluster": cluster,
        "cluster_bound_ms": cluster_bound, "ms": ms, "plain_ms": pms,
        "ms_per_1000_iterations": ms * 1000 / iters})
    record("bslmm_chain" + sfx, err, ms, pms, nbytes,
           nops, peak=PEAK_F64_PER_S, launches=cnt, form=form,
           extra={"cluster": cluster, "mean_n_gamma": ng,
                  "cluster_bound_ms": cluster_bound},
           note=f"ms and plain_ms: one launch and one plain loop of the "
                f"same {iters} iterations; bound_ms "
                "from this run's mean n_gamma, per iteration: "
                "operations n n_gamma² + n_gamma³/3 + 20 n and bytes "
                "n n_gamma (the active rows) + 10 n words for each "
                "posterior (and 4 n² operations, 2 n² elements of U "
                "for the probit step); a chain is sequential and runs "
                f"on one cluster of {cluster} CTAs (one SM each), so it "
                "sits far above this whole-card bound; cluster_bound_ms "
                f"is the same bound on those {cluster} of the card's "
                f"{sms} SMs")


def _drive_wide(kernels, paths, td, common, kin, f64, geno, dev):
    """Phase (k): each shape past a bound the kernels once had, at full
    width on the card in both precisions, with its checks against the
    port's float64 CPU run; returns the paths' launch counts, phase (k)'s
    covariates and the mvLMM kernels' operands."""
    import torch
    t_k = time.time()
    counts = {}
    # the mvLMM: 10 traits, 13 design rows; -gxe 14; -crt at c = 13 and
    # at d = 10 (phase (f)'s genotypes and kinship)
    mvk = (f"-g {td}/mv_geno.txt.gz -p {td}/mv_pheno10.txt -outdir {td} "
           f"-no-check -k {td}/MK.cXX.txt").split()
    cov, cov11 = (f"-c {td}/mv_cov12.txt".split(),
                  f"-c {td}/mv_cov11.txt".split())
    s1024, s256 = (f"-snps {td}/mv_1024.snps".split(),
                   f"-snps {td}/mv_256.snps".split())
    n10 = ["-n"] + [str(i) for i in range(1, WIDE_TRAITS + 1)]
    n12, mvx = "-n 1 2".split(), f"-gxe {td}/mv_env.txt".split()
    crt = "-crt -pnr 0.9".split()
    mv32 = ("mph_em", "mph_calc_p", "mph_nr")
    mv64 = ("mph_em_f64", "mph_calc_p_f64", "mph_nr_f64")
    # beyond 8 traits the default run is the float64 run (ROADMAP §C20):
    # one run at d = 10, with -crt (K14 at d = 10) on its refined lanes;
    # its float64 CPU run on the first WIDE_MV_CHECK SNPs goes on
    # meanwhile, until _check_d10 after the holds
    first = f"-snps {td}/mv_wide_first.snps".split()
    d10_cpu = _start_d10_cpu(td, n10 + crt)
    for key, argv, need in (
            ("w_d10", mvk + cov + s256 + n10 + crt
             + "-lmm 4 -o W10".split(), mv64 + ("calc_crt",)),
            ("w_gxe14", mvk + cov11 + s1024 + n12 + mvx
             + "-lmm 4 -o WX".split(), mv32),
            ("w_gxe14_f64", mvk + cov11 + s1024 + n12 + mvx + f64
             + "-lmm 4 -o WXd".split(), mv64),
            ("w_crt13", mvk + cov + s1024 + n12 + crt
             + "-lmm 4 -o WR".split(), mv64 + ("calc_crt",))):
        counts[key] = _drive(kernels, paths, key, [(key, argv)], need,
                             keep=True)
    t0 = time.time()
    _run(mvk + cov11 + first + n12 + mvx + "-lmm 4 -o WXC".split(), "cpu")
    _run(mvk + cov + first + n12 + crt + "-lmm 4 -o WRC".split(), "cpu")
    chk = {"mv_cpu_f64_seconds": time.time() - t0}
    failed = []

    def hold(tag, fn):
        """chk[tag] = fn(); a check that raises is recorded as failed,
        and the phase raises once every check has run."""
        try:
            chk[tag] = fn()
        except RuntimeError as e:
            chk[tag] = {"failed": str(e)}
            failed.append(tag)

    for tag, ref_tag, tol, match in (
            ("WX", "WXC", 1e-3, None), ("WXd", "WXC", 1e-6, 0.99),
            ("WR", "WRC", 1e-6, 0.99)):
        hold(tag, lambda: _mv_close(RESULTS[tag], RESULTS[ref_tag], tol,
                                    0.97, P_COLS, match=match))
    # ten traits: the default run is the float64 run (ROADMAP §C20), so
    # it launches no float32 mvLMM kernel; it is held against the CPU's
    # float64 at the end of the phase
    if any(counts["w_d10"][k] for k in mv32):
        failed.append("w_d10_launched_float32")
    p10 = np.concatenate([RESULTS["W10"]["stats"][c] for c in P_COLS])
    chk["W10_p_finite"] = float(np.isfinite(p10).mean())
    if chk["W10_p_finite"] < 0.97 or not (
            (p10[np.isfinite(p10)] >= 0) & (p10[np.isfinite(p10)] <= 1)).all():
        failed.append("W10_p")
    ops = {}
    for dt in (torch.float32, torch.float64):
        ops[("gxe14", dt)] = _mv_operands(
            mvk + cov11 + s1024 + n12 + mvx + ["-lmm", "4"],
            RESULTS["WX"]["snp_indices"][:WIDE_MV_HOLD], dev, (dt,),
            RESULTS["WX" if dt == torch.float32 else "WXd"]["null"])[dt]
    ops["W10"] = _mv_operands(
        mvk + cov + s256 + n10 + ["-lmm", "4"], RESULTS["W10"]["snp_indices"],
        dev, (torch.float64,), RESULTS["W10"]["null"])[torch.float64]
    ops["WR"] = _mv_operands(
        mvk + cov + s1024 + n12 + ["-lmm", "4"], RESULTS["WR"]["snp_indices"],
        dev, (torch.float64,), RESULTS["WR"]["null"])[torch.float64]

    # BSLMM: s_min 1,100, s_max 2,048 (phase (g)'s data): past s_max
    # 1,656 K12 keeps its vectors and rank lists in global scratch
    bs = (f"-g {geno} -outdir {td} -no-check -seed {BSLMM_SEED} "
          f"-p {td}/bs_pheno.txt -bslmm 1 -smin {WIDE_SMIN} -smax "
          f"{WIDE_SMAX} -w {WIDE_W} -s {WIDE_S}").split()
    counts["w_bslmm"] = _drive(kernels, paths, "w_bslmm", [
        ("w_bslmm", bs + "-o BWk".split())],
        ("geno_prologue", "lambda_grid", "lambda_solve", "bslmm_chain"),
        keep=True)
    counts["w_bslmm_f64"] = _drive(kernels, paths, "w_bslmm_f64", [
        ("w_bslmm_f64", bs + f64 + "-o BWkd".split())],
        ("geno_prologue_f64", "lambda_solve_f64", "bslmm_chain_f64"),
        keep=True)
    # BSLMM: s_min 200, s_max 300, GEMMA's default s_max (phase (g)'s data)
    bs3 = (f"-g {geno} -outdir {td} -no-check -seed {BSLMM_SEED} "
           f"-p {td}/bs_pheno.txt -bslmm 1 -smin {S300_SMIN} -smax "
           f"{S300_SMAX} -w {WIDE_W} -s {WIDE_S}").split()
    counts["s300"] = _drive(kernels, paths, "s300", [
        ("s300", bs3 + "-o BSk".split())],
        ("geno_prologue", "lambda_grid", "lambda_solve", "bslmm_chain"),
        keep=True)
    counts["s300_f64"] = _drive(kernels, paths, "s300_f64", [
        ("s300_f64", bs3 + f64 + "-o BSkd".split())],
        ("geno_prologue_f64", "lambda_solve_f64", "bslmm_chain_f64"),
        keep=True)
    for tag, smin in (("BWk", WIDE_SMIN), ("BWkd", WIDE_SMIN),
                      ("BSk", S300_SMIN), ("BSkd", S300_SMIN)):
        ng = np.loadtxt(f"{td}/{tag}.hyp.txt", skiprows=1, ndmin=2)[:, 5]
        chk[f"{tag}_n_gamma"] = [float(ng.min()), float(ng.max())]
        chk[f"{tag}_n_gamma_start"] = RESULTS[tag]["init"]["n_gamma"]
        if ng.min() < smin or RESULTS[tag]["init"]["n_gamma"] < smin:
            failed.append(f"{tag}_n_gamma")

    # K2-K8: CVT40_N covariates, -gxe with CVT40_N - 2 (CVT40_N a lane)
    rng = np.random.default_rng(CVT40_SEED)
    W = np.column_stack([np.ones(MOUSE_N),
                         rng.normal(size=(MOUSE_N, CVT40_N - 1))])
    np.savetxt(f"{td}/cov40.txt", W, fmt="%.6f")
    np.savetxt(f"{td}/cov38.txt", W[:, :CVT40_N - 2], fmt="%.6f")
    for name, m in (("first_c40.snps", CVT40_SNPS),
                    ("first40.snps", CVT40_CHECK),
                    ("gxe40.snps", CVT40_GXE_CHECK)):
        with open(f"{td}/{name}", "w") as fh:
            fh.write("\n".join(f"rs{j}" for j in range(m)) + "\n")
    c40 = f"-c {td}/cov40.txt -snps {td}/first_c40.snps".split()
    gxe38 = (f"-c {td}/cov38.txt -gxe {td}/env.txt -snps "
             f"{td}/first_c40.snps").split()
    lane32 = ("lambda_grid", "lambda_solve", "wald_tail", "score_tail",
              "lrt_tail")
    lane64 = ("lambda_solve_f64", "wald_tail_f64", "score_tail_f64",
              "lrt_tail")
    counts["cvt40"] = _drive(kernels, paths, "cvt40", [
        ("lmm4_c40", common + kin + c40 + "-lmm 4 -o A40".split()),
        ("lm4_c40", common + c40 + "-lm 4 -o L40".split())],
        ("geno_prologue", "lambda_grid", "lambda_solve", "wald_tail",
         "score_tail", "lrt_tail", "lm_tail"))
    counts["cvt40_f64"] = _drive(kernels, paths, "cvt40_f64", [
        ("lmm4_c40_f64", common + kin + c40 + f64 + "-lmm 4 -o A40d".split()),
        ("lm4_c40_f64", common + c40 + f64 + "-lm 4 -o L40d".split())],
        ("geno_prologue_f64", "lambda_solve_f64", "wald_tail_f64",
         "score_tail_f64", "lrt_tail", "lm_tail_f64"))
    counts["gxe40"] = _drive(kernels, paths, "gxe40", [
        ("gxe_c40", common + kin + gxe38 + "-lmm 4 -o X40".split())],
        ("geno_prologue",) + lane32)
    counts["gxe40_f64"] = _drive(kernels, paths, "gxe40_f64", [
        ("gxe_c40_f64", common + kin + gxe38 + f64
         + "-lmm 4 -o X40d".split())], ("geno_prologue_f64",) + lane64)
    t0 = time.time()
    s40 = f"-c {td}/cov40.txt -snps {td}/first40.snps".split()
    _run(common + kin + s40 + "-lmm 4 -o C40".split(), "cpu")
    _run(common + s40 + "-lm 4 -o CL40".split(), "cpu")
    _run(common + kin + f"-c {td}/cov38.txt -gxe {td}/env.txt -snps "
         f"{td}/gxe40.snps -lmm 4 -o CX40".split(), "cpu")
    chk["cvt40_cpu_f64_seconds"] = time.time() - t0
    for tag, ref_tag, tol, same_nan in (
            ("A40", "C40", 1e-3, None), ("A40d", "C40", 1e-6, 0.999),
            ("L40", "CL40", 1e-3, None), ("L40d", "CL40", 1e-6, 0.999),
            ("X40", "CX40", 1e-3, None), ("X40d", "CX40", 1e-6, 0.999)):
        rs_r, ref_r = _read_assoc(f"{td}/{ref_tag}.assoc.txt")
        rs_t, c_t = _read_assoc(f"{td}/{tag}.assoc.txt")
        hold(tag, lambda: {**_p_errors(_aligned(rs_t, c_t, rs_r), ref_r,
                                       tol, 0.97, same_nan=same_nan),
                           "lanes": len(rs_t)})
    chk["phase_k_seconds"] = time.time() - t_k
    wide_paths = list(counts)
    _say({"phase": "check_wide", **chk,
          "paths": {k: paths[k]["secs"] for k in wide_paths},
          # launches beyond one that a scratch budget added, by kernel
          "lane_splits": {k: paths[k]["splits"] for k in wide_paths},
          # phase (h)'s -calccor: the host's and the card's share
          "calccor_log_seconds": {t: _log_times(f"{td}/{t}.log.txt")
                                  for t in ("VC", "VCd", "VG", "VGd")}})
    if failed:
        raise RuntimeError(f"phase (k) checks failed: {failed}")
    return counts, W, ops, d10_cpu


def _start_d10_cpu(td, flags):
    """(pool, async result, directory) of phase (k)'s ten-trait path with
    `flags` on the CPU on the first WIDE_MV_CHECK SNPs (-o W10C), in a
    process of its own, on copies of its inputs in a directory of its
    own beside `td`: it outlives `td`.  The kinship's binary cache is
    copied with it, times kept, so that both runs read the same float64
    kinship and not one of them its 10-digit text."""
    d10 = tempfile.mkdtemp(dir=os.path.dirname(td))
    for f in ("mv_geno.txt.gz", "mv_pheno10.txt", "MK.cXX.txt",
              "MK.cXX.txt.bin", "mv_cov12.txt", "mv_wide_first.snps"):
        shutil.copy2(os.path.join(td, f), d10)
    return _start_cpu(
        (f"-g {d10}/mv_geno.txt.gz -p {d10}/mv_pheno10.txt -outdir {d10} "
         f"-no-check -k {d10}/MK.cXX.txt -c {d10}/mv_cov12.txt -snps "
         f"{d10}/mv_wide_first.snps").split() + flags
        + "-lmm 4 -o W10C".split()) + (d10,)


def _check_d10(pool, w10c, d10):
    """Phase (k)'s ten-trait run against the CPU's float64 on every lane
    (D10_LIM, ROADMAP §C20), with the lanes that left their EM at the
    CPU's iteration reported.  Called after the holds, which the CPU's
    run (started in phase (k)) overlaps."""
    t0 = time.time()
    RESULTS["W10C"] = w10c.get()
    pool.close()
    pool.join()
    shutil.rmtree(d10)
    chk, failed = {"W10_cpu_wait_seconds": time.time() - t0}, []
    for col, tol in D10_LIM["path"].items():
        try:
            chk[f"W10_{col}"] = _mv_close(
                RESULTS["W10"], RESULTS["W10C"], tol, 0.97, (col,),
                match=0.0, tol_all=tol)[col]
        except RuntimeError as e:
            chk[f"W10_{col}"] = {"failed": str(e)}
            failed.append(f"W10_{col}")
    _say({"phase": "check_wide_d10", **chk})
    if failed:
        raise RuntimeError(f"phase (k) checks failed: {failed}")


def _mv_seeded(d, c, n, S, dt, dev, seed=10):
    """Seeded rotated mvLMM lanes on `dev`: eigenvalues of a kinship
    from 300 binomial SNPs, an intercept and c - 2 normal covariates, d
    traits with random (not equicorrelated) Vg and Ve, S SNP rows, and
    those Vg, Ve as the starts (`null`): lanes away from the boundary,
    where K9 at ten traits is held at the tight float64 limit
    (_em_capped_d10)."""
    import types
    import torch
    rng = np.random.default_rng(seed)
    G = rng.binomial(2, 0.3, size=(300, n)).astype(float)
    G -= G.mean(1, keepdims=True)
    K = G.T @ G / 300
    K = K - K.mean(0) - K.mean(1)[:, None] + K.mean()
    ev, U = np.linalg.eigh(K)
    ev = np.where(ev < 1e-10, 0.0, ev)
    L = np.linalg.cholesky(K + 1e-6 * np.eye(n))
    Vg, Ve = ((A @ A.T) / d + 0.5 * np.eye(d) for A in
              (rng.normal(size=(d, d)), rng.normal(size=(d, d))))
    Yr = ((L @ rng.normal(size=(n, d))) @ np.linalg.cholesky(Vg).T
          + rng.normal(size=(n, d)) @ np.linalg.cholesky(Ve).T)
    W = np.column_stack([np.ones(n), rng.normal(size=(n, c - 2))])
    x = rng.binomial(2, 0.3, size=(S, n)).astype(float)

    def t(a, f=dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=f, device=dev)

    f64 = torch.float64
    null = types.SimpleNamespace(Vg_start=t(Vg, f64), Ve_start=t(Ve, f64),
                                 B_start=torch.zeros((d, c), dtype=f64,
                                                     device=dev))
    return dict(ev=t(ev), X0=t((U.T @ W).T), Y=t((U.T @ Yr).T),
                R1=t((x @ U)[:, None, :]), null=null)


def _hold_wide(ops, counts_k, record, check, amax):
    """K9-K11 against their plain versions on the first WIDE_MV_HOLD
    lanes of phase (k)'s ten-trait run (13 design rows, float64 as that
    run reads them; K11 on the first WIDE_NR_HOLD) with the witnesses of
    _hold_mv_block, and on the first WIDE_MV_HOLD lanes of its -gxe block
    (two traits, 14 rows), float32 and float64 operands; K14 on up to
    WIDE_CRT_HOLD lanes that the c = 13 and the ten-trait -crt paths
    refined; K12 for WIDE_HOLD_ITERS iterations from the s_min 1,100
    chains' states and S300_HOLD_ITERS from the s_max 300 chains'."""
    import torch
    f32, f64 = torch.float32, torch.float64
    o = ops["W10"]
    nul = o["null"]
    _hold_mv_block(dict(o, R=o["R1"][:WIDE_MV_HOLD].contiguous(),
                        Vg=nul.Vg_start[None], Ve=nul.Ve_start[None],
                        B=nul.B_start[None], form="d10",
                        launches=counts_k["w_d10"], sfx="_f64", tight=True,
                        staged=True, cap=1000, witness=True,
                        null_s=RESULTS["W10"]["null_seconds"]),
                   record, check, amax)
    for dt, sfx in ((f32, ""), (f64, "_f64")):
        o = ops[("gxe14", dt)]
        nul = o["null_x"]
        B = torch.cat([nul.B_start, nul.B_start.new_zeros(
            (nul.B_start.shape[0], 1))], 1)
        _hold_mv_block(dict(o, X0=o["X0e"], R=o["R2"], Vg=nul.Vg_start[None],
                            Ve=nul.Ve_start[None], B=B[None], form="gxe14",
                            launches=counts_k["w_gxe14" + sfx], sfx=sfx,
                            tight=dt == f64, staged=False, cap=1000),
                       record, check, amax)
    _hold_crt_block(ops["WR"], counts_k["w_crt13"], "crt_c13", "WR", "WR",
                    record, check, WIDE_CRT_HOLD)
    _hold_crt_block(ops["W10"], counts_k["w_d10"], "crt_d10", "W10", "W10",
                    record, check, WIDE_CRT_HOLD, witness=True)
    # one s_min 1,100 launch takes about 2 s: timed once
    _hold_chain("BWk", "", counts_k["w_bslmm"], WIDE_HOLD_ITERS, "s_min1100",
                record, check, reps=1)
    _hold_chain("BWkd", "_f64", counts_k["w_bslmm_f64"], WIDE_HOLD_ITERS,
                "s_min1100", record, check, reps=1)
    _hold_chain("BSk", "", counts_k["s300"], S300_HOLD_ITERS, "s_max300",
                record, check)
    _hold_chain("BSkd", "_f64", counts_k["s300_f64"], S300_HOLD_ITERS,
                "s_max300", record, check)
    # past S300_DIST active ranks Omega no longer fits rank 0's shared
    # memory and is cut over the cluster's
    _hold_chain("BSk", "", counts_k["s300"], S300_HOLD_ITERS,
                "s_max300_distributed", record, check, s_min=S300_DIST)


def main():
    t_start = time.time()
    try:
        import torch
    except ImportError:
        _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        _fail("no CUDA device: this script runs on the card only")
    sys.path.insert(0, HERE)
    try:
        from gemma_torch import kernels
    except ImportError as e:
        _fail(f"the gemma_torch package is not beside this script ({e})")
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    open(REPORT, "w").close()
    from gemma_torch import precision
    from gemma_torch.models import lm
    from gemma_torch.models.lmm import likelihood as lk
    from gemma_torch.models.lmm import optimize as opt
    from gemma_torch.models.lmm.engine import fit_null
    from gemma_torch.ops import pack2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    precision.apply_matmul_precision()
    _say(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} ({smi})")

    # 1. build
    t0 = time.time()
    by_source = kernels.build_all()
    build_s = time.time() - t0
    _say({"phase": "build", "seconds": build_s,
          "seconds_to_each_library": by_source})

    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    os.environ.setdefault("GEMMA_TORCH_GENO_SIDECAR_DIR",
                          os.path.join(work, "geno_cache"))
    f32_kernels = ("geno_prologue", "lambda_grid", "lambda_solve",
                   "wald_tail")
    with tempfile.TemporaryDirectory(dir=work) as td:
        # 2. the paths
        t0 = time.time()
        geno, pheno = _synth_mouse(td)
        prefix, cov = _synth_plink(td)
        np.savetxt(f"{td}/w.txt",
                   np.random.default_rng(2).uniform(0.5, 2.0, PLINK_N))
        _say({"phase": "data", "seconds": time.time() - t0})
        common = f"-g {geno} -p {pheno} -outdir {td} -no-check".split()
        kin = f"-k {td}/K.cXX.txt".split()
        paths = {}
        main_counts = _drive(kernels, paths, "gk+lmm1", [
            ("gk", common + ["-gk", "1", "-o", "K"]),
            ("lmm1", common + kin + "-lmm 1 -o A".split())], f32_kernels)
        lmm_times = _log_times(f"{td}/A.log.txt")
        gk_times = _log_times(f"{td}/K.log.txt")
        # warm repeat of -lmm 1 (kernels loaded, cuBLAS/cuSOLVER up),
        # profiled: device time by kernel and the device's busy share
        prof1 = _profile(common + kin + "-lmm 1 -o W".split())
        _say({"phase": "profile_lmm_warm", **prof1})
        plink_common = f"-bfile {prefix} -outdir {td} -no-check".split()
        pk = f"-c {cov} -k {td}/PK.sXX.txt".split()
        _drive(kernels, paths, "plink_c3", [
            ("gk2", plink_common + ["-gk", "2", "-o", "PK"]),
            ("lmm1_c3", plink_common + pk + "-lmm 1 -o PA".split())],
            f32_kernels)
        # (a) and (b): -lmm 4 at full width, speed then parity mode
        counts_a = _drive(kernels, paths, "lmm4", [
            ("lmm4", common + kin + "-lmm 4 -o A4".split())],
            f32_kernels + ("score_tail", "lrt_tail"))
        counts_b = _drive(kernels, paths, "lmm4_f64", [
            ("gk_f64", common + "-gk 1 -precision float64 -o Kd".split()),
            ("lmm4_f64", common + kin
             + "-lmm 4 -precision float64 -o A4d".split())],
            ("geno_prologue_f64", "lambda_solve_f64", "wald_tail_f64",
             "score_tail_f64", "lrt_tail"))
        prof4 = _profile(common + kin + "-lmm 4 -o W4".split())
        _say({"phase": "profile_lmm4_warm", **prof4})
        # (c) the eigen paths, -lmm 5 and -widv on the PLINK set
        _drive(kernels, paths, "plink_modes", [
            ("eigen", plink_common + pk + "-eigen -o PE".split()),
            ("ud_lmm9", plink_common + f"-c {cov} -u {td}/PE.eigenU.txt "
             f"-d {td}/PE.eigenD.txt -lmm 9 -o PU".split()),
            ("k_lmm9", plink_common + pk + "-lmm 9 -o PK9".split()),
            ("lmm5", plink_common + pk + "-lmm 5 -o P5".split()),
            ("widv_lmm2", plink_common + pk
             + f"-widv {td}/w.txt -lmm 2 -o PW".split())],
            ("geno_prologue", "lambda_grid", "lambda_solve", "score_tail",
             "lrt_tail"))
        # (e) LOCO, GxE, gene mode and -lm at full width
        t0 = time.time()
        env_np, expr_np = _synth_slice3(td, pheno)
        _say({"phase": "data_slice3",
              "seconds": time.time() - t0})
        loco = f"-a {td}/anno.txt -loco 1".split()
        gxe = f"-gxe {td}/env.txt".split()
        gene = f"-gene {td}/expr.txt".split()
        f64 = "-precision float64".split()
        lane32 = ("lambda_grid", "lambda_solve", "wald_tail", "score_tail",
                  "lrt_tail")
        lane64 = ("lambda_solve_f64", "wald_tail_f64", "score_tail_f64",
                  "lrt_tail")
        counts_e = {
            "loco": _drive(kernels, paths, "loco", [
                ("gk_loco", common + loco + "-gk 1 -o KL".split()),
                ("gk_loco_f64", common + loco + f64 + "-gk 1 -o KLd".split()),
                ("lmm1_loco", common + loco
                 + f"-k {td}/KL.cXX.txt -lmm 1 -o AL".split())],
                f32_kernels + ("geno_prologue_f64",)),
            "gxe": _drive(kernels, paths, "gxe", [
                ("gxe_lmm4", common + kin + gxe + "-lmm 4 -o X4".split())],
                ("geno_prologue",) + lane32),
            "gxe_f64": _drive(kernels, paths, "gxe_f64", [
                ("gxe_lmm4_f64", common + kin + gxe + f64
                 + "-lmm 4 -o X4d".split())],
                ("geno_prologue_f64",) + lane64),
            "gene": _drive(kernels, paths, "gene", [
                ("gene_lmm4", common + kin + gene + "-lmm 4 -o G4".split())],
                lane32),
            "gene_f64": _drive(kernels, paths, "gene_f64", [
                ("gene_lmm4_f64", common + kin + gene + f64
                 + "-lmm 4 -o G4d".split())], lane64),
            "lm": _drive(kernels, paths, "lm", [
                ("lm4", common + "-lm 4 -o L4".split()),
                ("lm4_gene", common + gene + "-lm 4 -o LG4".split()),
                ("lm4_f64", common + f64 + "-lm 4 -o L4d".split())],
                ("geno_prologue", "lm_tail", "lm_tail_f64")),
        }
        profx = _profile(common + kin + gxe + "-lmm 4 -o WX".split())
        _say({"phase": "profile_gxe_lmm4_warm", **profx})
        _say({"phase": "e2e", "paths": paths,
              "gk_log_seconds": gk_times,
              "lmm_log_seconds": lmm_times})

        # 3. output checks
        rs, cols = _read_assoc(f"{td}/A.assoc.txt")
        finite = float(np.isfinite(cols["p_wald"]).mean())
        if len(rs) < 0.9 * MOUSE_P or finite < 0.97:
            raise RuntimeError(f"{len(rs)} SNPs, {finite:.4f} finite p_wald")
        with open(f"{td}/first.snps", "w") as fh:
            fh.write("\n".join(f"rs{j}" for j in range(CHECK_SNPS)) + "\n")
        t0 = time.time()
        _run(common + kin + f"-lmm 4 -snps {td}/first.snps -o C".split(),
             "cpu")
        cpu_s = time.time() - t0
        rs_c, ref = _read_assoc(f"{td}/C.assoc.txt")
        main_err = _p_errors(_aligned(rs, cols, rs_c),
                             {"p_wald": ref["p_wald"]}, 1e-3, 0.97)
        _say({"phase": "check", "p_wald_finite": finite,
              "snps": len(rs), "cpu_f64_snps": len(rs_c),
              "cpu_f64_seconds": cpu_s,
              "p_wald_max_abs_vs_cpu_f64":
                  main_err["p_wald"]["max_abs"]})
        rs4, c4 = _read_assoc(f"{td}/A4.assoc.txt")
        err_a = _p_errors(_aligned(rs4, c4, rs_c), ref, 1e-3, 0.97)
        rs4d, c4d = _read_assoc(f"{td}/A4d.assoc.txt")
        err_b = _p_errors(_aligned(rs4d, c4d, rs_c), ref, 1e-6, 0.97,
                          same_nan=0.999)
        # the float64 kinship of the card against the CPU's, to the
        # 10 significant digits of the text
        from gemma_torch.io.readers import read_kinship
        _run(common + "-gk 1 -o Kc".split(), "cpu")
        every = np.ones(MOUSE_N, bool)
        Kd, Kc = (read_kinship(f"{td}/{k}.cXX.txt", every)
                  for k in ("Kd", "Kc"))
        gk_err = float(np.abs(Kd - Kc).max() / np.abs(Kc).max())
        if gk_err > 1e-9:
            raise RuntimeError(f"-gk float64 vs the CPU: rel {gk_err}")
        rs_u, cu = _read_assoc(f"{td}/PU.assoc.txt")
        rs_k, ck = _read_assoc(f"{td}/PK9.assoc.txt")
        err_c = _p_errors(_aligned(rs_u, cu, rs_k), ck, 1e-3, 0.97)
        resid = [np.loadtxt(f"{td}/P5.{f}.txt") for f in ("residU", "residE")]
        if any(r.shape != (PLINK_N,) or not np.isfinite(r).all()
               for r in resid):
            raise RuntimeError("-lmm 5 residuals: wrong length or not finite")
        _, cw = _read_assoc(f"{td}/PW.assoc.txt")
        w_fin = float(np.isfinite(cw["p_lrt"]).mean())
        if w_fin < 0.97 or not (cw["p_lrt"][np.isfinite(cw["p_lrt"])]
                                <= 1.0).all():
            raise RuntimeError(f"-widv -lmm 2: {w_fin:.4f} finite p_lrt")
        _say({"phase": "check_modes",
              "gk_f64_vs_cpu_f64_rel": gk_err,
              "lmm4_f32_vs_cpu_f64": err_a,
              "lmm4_f64_vs_cpu_f64": err_b,
              "ud_lmm9_vs_k_lmm9": err_c,
              "widv_p_lrt_finite": w_fin})

        # (e) against the port's float64 CPU path on the same files
        t0 = time.time()

        def cpu_ref(tag, argv):
            _run(argv + ["-o", tag], "cpu")
            return _read_assoc(f"{td}/{tag}.assoc.txt")

        _run(common + loco + "-gk 1 -o KLc".split(), "cpu")
        KLd, KLc = (read_kinship(f"{td}/{k}.cXX.txt", every)
                    for k in ("KLd", "KLc"))
        loco_k_err = float(np.abs(KLd - KLc).max() / np.abs(KLc).max())
        if loco_k_err > 1e-9:
            raise RuntimeError(f"-gk -loco float64 vs the CPU: rel "
                               f"{loco_k_err}")
        if np.allclose(KLc, Kc):
            raise RuntimeError("-gk -loco 1 left the kinship unchanged")
        chk = {"gk_loco_f64_vs_cpu_f64_rel": loco_k_err}
        rs_l, ref_l = cpu_ref("CL", common + loco
                              + f"-k {td}/KL.cXX.txt -lmm 1".split())
        rs_al, c_al = _read_assoc(f"{td}/AL.assoc.txt")
        if not rs_al or {int(r[2:]) % 19 for r in rs_al} != {0}:
            raise RuntimeError("-lmm 1 -loco 1 tested SNPs off chromosome 1")
        chk["lmm1_loco"] = _p_errors(_aligned(rs_al, c_al, rs_l),
                                     {"p_wald": ref_l["p_wald"]}, 1e-3, 0.97)
        snps1 = f"-snps {td}/first.snps".split()
        gene1 = f"-gene {td}/expr_check.txt".split()
        refs = {"X": cpu_ref("CX", common + kin + gxe + snps1
                             + "-lmm 4".split()),
                "G": cpu_ref("CG", common + kin + gene1 + "-lmm 4".split()),
                "L": cpu_ref("CLM", common + snps1 + "-lm 4".split()),
                "LG": cpu_ref("CLG", common + gene1 + "-lm 4".split())}
        for tag, ref_tag, tol, same_nan in (
                ("X4", "X", 1e-3, None), ("X4d", "X", 1e-6, 0.999),
                ("G4", "G", 1e-3, None), ("G4d", "G", 1e-6, 0.999),
                ("L4", "L", 1e-3, None), ("L4d", "L", 1e-6, 0.999),
                ("LG4", "LG", 1e-3, None)):
            rs_r, ref_r = refs[ref_tag]
            rs_t, c_t = _read_assoc(f"{td}/{tag}.assoc.txt")
            got = _aligned(rs_t, c_t, rs_r)
            if tag == "G4" and np.isnan(got["p_lrt"]).any():
                raise RuntimeError("-lmm 4 -gene float32: NaN p_lrt")
            chk[tag] = _p_errors(got, ref_r, tol, 0.97, same_nan=same_nan)
            chk[tag]["lanes"] = len(rs_t)
        _say({"phase": "check_slice3", **chk,
              "cpu_f64_seconds": time.time() - t0})

        # (f) the multivariate LMM at the releases.org protocol shape
        counts_f, mv_ops = _drive_mvlmm(kernels, paths, td, f64, dev)
        # (g) BSLMM and prediction on the mouse genotypes
        counts_g = _drive_bslmm(kernels, paths, td, geno, f64)
        # (h) variance components and correlations on the mouse genotypes
        counts_h, vc_rows = _drive_vc(kernels, paths, td, geno, f64)
        # (i) CVT_N covariates: K2-K8's second instantiation
        counts_i, W24 = _drive_cvt(kernels, paths, td, common, kin, f64)
        # (j) summary statistics (MQS) on phase (h)'s data
        counts_j = _drive_mqs(kernels, paths, td, geno, f64, vc_rows)
        # (k) shapes past the kernels' old bounds
        counts_k, W40, wide_ops, d10_cpu = _drive_wide(
            kernels, paths, td, common, kin, f64, geno, dev)

        # 4. kernels against their plain versions, main-path shapes
        from gemma_torch.config import GemmaConfig
        from gemma_torch.dataset import load_dataset
        from gemma_torch.ops.center import center_matrix
        from gemma_torch.ops.eigh import eigh_zeroed
        from gemma_torch.run import _block_size, _raw_wire_block, _to_device

        cfg = GemmaConfig(file_geno=geno, file_pheno=pheno, check=False)
        ds = load_dataset(cfg)
        n = ds.ni_test
        idx = np.flatnonzero(ds.qc.indicator_snp)
        S = _block_size(cfg, dev, len(idx), n_axis=n)
        sel = idx[:S]
        raw_a = _to_device(_raw_wire_block(
            ds, sel, S, torch.float32, all_individuals=False), dev)
        K = read_kinship(f"{td}/K.cXX.txt", ds.indicator_idv)
        y_np = ds.Y[:, 0]
    f32, f64 = torch.float32, torch.float64
    fac = {}
    for dt in (f32, f64):
        ev, U, tr = eigh_zeroed(center_matrix(
            torch.as_tensor(K, dtype=dt, device=dev)))
        fac[dt] = (ev, U, tr, torch.as_tensor(y_np, dtype=dt, device=dev))
    rng = np.random.default_rng(7)
    W3 = np.column_stack([np.ones(n), rng.normal(size=(n, 2))])

    results = []
    per_lane = {}         # kernel → {form: record} for the per-lane forms

    def record(name, err, ms, plain_ms, nbytes, nops, peak=PEAK_F32_PER_S,
               launches=None, library_ms=None, note=None, form=None,
               tol=None, extra=None):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = nops / peak * 1e3
        k = getattr(kernels, name.upper())
        entry = {"launches": (main_counts if launches is None
                              else launches)[name],
                 "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": library_ms, "tolerance": TOL[name]}
        entry.update(extra or {})
        if note:
            entry["note"] = note
        if form is not None:
            entry["tolerance"] = tol or TOL_LANE.get(name, TOL[name])
            per_lane.setdefault(name, {})[form] = entry
            return
        results.append({"name": name, "route": "cuda",
                        "source": os.path.relpath(k.source, HERE),
                        "replaces": k.replaces, **entry,
                        "launches_by_path": {p: v["launches"][name]
                                             for p, v in paths.items()}})

    def check(name, passed, line):
        tol = TOL_LANE.get(name) if "block" in line and (line["block"] in (
            "gxe", "gene", "c24", "gxe_c24", "c40", "gxe_c40")
            or "wide_c" in line["block"]) else None
        line = {"kernel": name, "tolerance": tol or TOL[name], **line}
        _say(line)
        if not passed:
            raise RuntimeError(f"{name} disagrees with its plain version: "
                               f"{line}")

    def amax(a, b):
        ok = torch.isfinite(a) & torch.isfinite(b)
        return float((a[ok] - b[ok]).abs().max()) if bool(ok.any()) else 0.0

    def operand_bytes(data, isz):
        """One read of a block's eval, UtWy, wy_prod and Utx."""
        return isz * sum(t.numel() for t in (data.eval, data.UtWy,
                                             data.wy_prod, data.Utx))

    # K1: the association operand (impute) on the main path's block, and
    # the kinship operand (centre + standardise), float32 and float64
    xs = {}
    for dt, name, tol in ((f32, "geno_prologue", 1e-5),
                          (f64, "geno_prologue_f64", 1e-12)):
        x_k = pack2.prologue_cuda(raw_a, n, pack2.IMPUTE, False, None, dt)
        x_p = pack2.prologue_plain(raw_a, n, pack2.IMPUTE, False, None, dt)
        err = float((x_k - x_p).abs().max())
        ms = time_ms(lambda: pack2.prologue_cuda(raw_a, n, pack2.IMPUTE,
                                                 False, None, dt), 20)
        pms = time_ms(lambda: pack2.prologue_plain(
            raw_a, n, pack2.IMPUTE, False, None, dt), 5)
        c_k = pack2.prologue_cuda(raw_a, n, pack2.CENTRE, True, None, dt)
        c_p = pack2.prologue_plain(raw_a, n, pack2.CENTRE, True, None, dt)
        err = max(err, float((c_k - c_p).abs().max()))
        check(name, err <= tol and x_k.dtype == dt,
              {"max_abs_err": err, "S": S, "n": n, "ms": ms,
               "plain_ms": pms})
        isz = torch.finfo(dt).bits // 8
        record(name, err, ms, pms, raw_a.numel() + isz * S * n, 6 * S * n,
               peak=PEAK_F32_PER_S if dt == f32 else PEAK_F64_PER_S,
               launches=main_counts if dt == f32 else counts_b)
        xs[dt] = x_k

    fine_np = opt.fine_grid(1e-5, 1e5, 10, opt._F32_GRID_REFINE)
    G = len(fine_np)

    def hold32(label, data, nc, l_score, l0, logl0, counts, form=None,
               rec=True):
        """K2-K6 on one float32 block against their plain versions: the
        score at l_score, the LRT against the null at (l0, logl0) —
        shared by the lanes (0-d) or one per lane."""
        S_ = lk.n_lanes(data)
        C1, M = nc + 1, data.wy_prod.shape[-1]
        # K2's recurrence entries: step p updates only the pairs a, b > p,
        # the ones a later step or dev1 reads again
        live = sum((nc + 2 - p) * (nc + 3 - p) // 2 for p in range(1, C1 + 1))
        opb = operand_bytes(data, 4)
        # the shared forms' K2-K4 launch on the main path (-gk + -lmm 1)
        main_path = {k: main_counts if form is None else counts
                     for k in ("lambda_grid", "lambda_solve", "wald_tail")}
        lam_k = {}
        for reml in (True, False):
            tag = "reml" if reml else "ml"
            # K2
            gp = lk.grid_products(fine_np, data, nc)
            d_k = lk.grid_epilogue_cuda(gp, n, nc, False, reml)
            d_p = lk.grid_epilogue_plain(gp, n, nc, False, reml)
            diff = (d_k - d_p).abs()
            lam_g = torch.as_tensor(fine_np, dtype=f32, device=dev)[:, None]
            bound = (1e-5 * d_p.abs().max()
                     + 8 * n * torch.finfo(f32).eps / lam_g)
            worst = float((diff / bound).max())
            err = float(diff.max())
            ms = time_ms(lambda: lk.grid_epilogue_cuda(gp, n, nc, False,
                                                       reml), 20)
            pms = time_ms(lambda: lk.grid_epilogue_plain(gp, n, nc, False,
                                                         reml), 3)
            check("lambda_grid", worst <= 1.0,
                  {"max_abs_err": err, "max_err_over_bound": worst,
                   "block": label, "fit": tag, "S": S_, "G": G, "ms": ms,
                   "plain_ms": pms})
            if form == "c40" and reml:
                # the warp form split into launches of three lanes
                added, same = _split_equal(
                    kernels, kernels.LAMBDA_GRID, lk.grid_epilogue_cuda,
                    (gp, n, nc, False, reml), d_k)
                check("lambda_grid", same and added > 0,
                      {"block": label, "fit": tag, "S": S_,
                       "split_launches_added": added, "split_equal": same})
            if rec and reml:
                record("lambda_grid", err, ms, pms,
                       4 * (gp.xcross.numel() + gp.xx.numel()
                            + gp.shared.numel() + 2 * G + G * S_),
                       G * S_ * 2 * live * 6,
                       launches=main_path["lambda_grid"], form=form)

            # K3, from the kernel's d1f
            args = (d_k, fine_np, data, nc, False, reml, 1e-5, 1e5, 10,
                    lk.per_lane(data))
            r_k = opt.lambda_solve_cuda(*args)
            # the plain search takes seconds: timed (REML only) on the
            # call that is compared; it counts each lane's evaluations
            st = {}
            r_p, pms = _timed(lambda: opt.lambda_solve_plain(*args,
                                                             stats=st))
            evals = int(st["evals"].sum())
            lam_k[tag] = r_k
            if reml:
                pk = lk.wald_pvalues_plain(r_k.lam, data, nc)[2]
                pp = lk.wald_pvalues_plain(r_p.lam, data, nc)[2]
            else:
                pk, pp = (lk.lrt_pvalues_plain(r.lam, r.logf, data, nc, l0,
                                               logl0)[1]
                          for r in (r_k, r_p))
            err = amax(pk, pp)
            logf_rel = float(((r_k.logf - r_p.logf).abs()
                              / r_p.logf.abs()).nan_to_num(0.0).max())
            same_finite = not bool(
                (torch.isfinite(pk) != torch.isfinite(pp)).any())
            ms = time_ms(lambda: opt.lambda_solve_cuda(*args), 5)
            pms = pms if reml else None
            check("lambda_solve",
                  err <= 1e-3 and logf_rel <= 1e-4 and same_finite,
                  {"max_abs_err": err, "logf_max_rel": logf_rel,
                   "same_finite": same_finite, "block": label, "fit": tag,
                   "S": S_, "ms": ms, "plain_ms": pms, "evals": evals,
                   "ms_per_eval": ms / evals})
            if form == "c40":
                # the GT_DYN form split into launches of three lanes
                kern = kernels.LAMBDA_SOLVE
                added, same = _split_equal(
                    kernels, kern, opt.lambda_solve_cuda, args,
                    (r_k.lam, r_k.logf))
                check("lambda_solve", same and added > 0,
                      {"block": label, "fit": tag, "S": S_,
                       "split_launches_added": added, "split_equal": same})
            if rec and reml:
                # work this run's data needs, at least: per lane one dev12
                # at each bracket's start and one Newton step, logf_stable
                # at each candidate and both endpoints
                d1c = d_k[::opt._F32_GRID_REFINE]
                n_br = float((d1c[:-1] * d1c[1:] <= 0).sum())
                q_dev12 = 3 * M + 3 * C1 + 5
                q_logf = C1 * (C1 + 1) // 2 + C1 + 1
                nops = n * (2 * n_br * (2 * q_dev12 + 4)
                            + (n_br + 2 * S_) * (2 * q_logf + 2 * C1 + 8))
                record("lambda_solve", err, ms, pms,
                       opb + 4 * (G * S_ + G + 2 * S_), nops,
                       launches=main_path["lambda_solve"], form=form,
                       extra={"evals": evals, "ms_per_eval": ms / evals})

        # K4 (at the kernel's REML λ) and K5 (at l_score)
        tails = (("wald_tail", lk.wald_pvalues_cuda, lk.wald_pvalues_plain,
                  lam_k["reml"].lam),
                 ("score_tail", lk.score_pvalues_cuda,
                  lk.score_pvalues_plain, l_score))
        for name, fk, fp, lam in tails:
            b_k, s_k, p_k = fk(lam, data, nc)
            b_p, s_p, p_p = fp(lam, data, nc)
            ok = torch.isfinite(p_p)
            err = float((p_k[ok] - p_p[ok]).abs().max())
            beta_se = float(((b_k - b_p).abs() / s_p)[ok].max())
            ms = time_ms(lambda: fk(lam, data, nc), 20)
            pms = time_ms(lambda: fp(lam, data, nc), 3)
            check(name, err <= (3e-5 if form else 1e-5) and beta_se <= 1e-3,
                  {"max_abs_err": err, "beta_max_err_over_se": beta_se,
                   "block": label, "S": S_, "ms": ms, "plain_ms": pms})
            if form == "c40":
                _hold_tail_split(kernels, getattr(kernels, name.upper()),
                                 fk, (lam, data, nc), (b_k, s_k, p_k),
                                 name, label, check)
            if rec:
                nb, nops = _tail_work(data, nc, 4, lam.numel())
                record(name, err, ms, pms, nb, nops, peak=PEAK_F64_TC_PER_S,
                       form=form, launches=main_path.get(name, counts),
                       note=TAIL_BOUND_NOTE)

        # K6, speed mode: at the kernel's ML λ and the null's
        ml = lam_k["ml"]
        l_k, p_k = lk.lrt_pvalues_cuda(ml.lam, ml.logf, data, nc, l0, logl0)
        l_p, p_p = lk.lrt_pvalues_plain(ml.lam, ml.logf, data, nc, l0, logl0)
        logl_rel = float(((l_k.double() - l_p.double()).abs()
                          / l_p.double().abs()).nan_to_num(0.0).max())
        err = amax(p_k, p_p)
        ms = time_ms(lambda: lk.lrt_pvalues_cuda(
            ml.lam, ml.logf, data, nc, l0, logl0), 20)
        pms = time_ms(lambda: lk.lrt_pvalues_plain(
            ml.lam, ml.logf, data, nc, l0, logl0), 3)
        # the null launch apart (one shared lane split over n, or a null
        # per lane), held against the plain logf_stable, then the SNP
        # launch alone on its logl_H0
        d64 = data._replace(eval=data.eval.double(), UtWy=data.UtWy.double(),
                            Utx=data.Utx.double())
        l0_p = lk.logf_stable(l0.double().reshape(-1), d64, nc, True, False)
        l0_k = lk.lrt_null_cuda(l0, data, nc)
        null_rel = float(((l0_k - l0_p).abs() / l0_p.abs()).max())
        null_ms = time_ms(lambda: lk.lrt_null_cuda(l0, data, nc), 20)
        snp_ms = time_ms(lambda: lk.lrt_pvalues_cuda(
            ml.lam, ml.logf, data, nc, None, l0_k), 20)
        check("lrt_tail", null_rel <= 1e-12,
              {"mode": "speed", "launch": "null", "logl_max_rel": null_rel,
               "block": label, "S": l0.numel(), "ms": null_ms})
        # the library's tail alone on the same Δ
        delta = (lk.logf_stable(ml.lam.double(), d64, nc, False, False)
                 - l0_p)
        lib_ms = time_ms(lambda: torch.special.gammaincc(
            torch.full_like(delta, 0.5), delta.clamp(min=0.0)), 20)
        check("lrt_tail", err <= 1e-6 and logl_rel <= 1e-12,
              {"mode": "speed", "max_abs_err": err, "logl_max_rel": logl_rel,
               "block": label, "S": S_, "ms": ms, "null_ms": null_ms,
               "snp_ms": snp_ms, "plain_ms": pms,
               "library_ms_gammaincc": lib_ms})
        if form == "c40":
            _hold_tail_split(kernels, kernels.LRT_TAIL, lk.lrt_pvalues_cuda,
                             (ml.lam, ml.logf, data, nc, None, l0_k),
                             (l_k, p_k), "lrt_tail", label, check)
        if rec:
            nb, nops = _tail_work(data, nc, 4, S_, lrt=True,
                                  null_lanes=l0.numel())
            record("lrt_tail", err, ms, pms, nb, nops,
                   peak=PEAK_F64_TC_PER_S, launches=counts,
                   library_ms=lib_ms,
                   note="library_ms is torch.special.gammaincc(0.5, Δ) on "
                        "the same Δ: the tail alone; the kernel also "
                        "re-evaluates both ML log-likelihoods in float64. "
                        + TAIL_BOUND_NOTE,
                   form=form, extra={"null_ms": null_ms, "snp_ms": snp_ms})

    def hold64(label, data, nc, l_score, l0, logl0, counts, form=None,
               rec=True):
        """K7, K4_f64/K5_f64 and K6's tail on one float64 block."""
        S_ = lk.n_lanes(data)
        C1, M = nc + 1, data.wy_prod.shape[-1]
        opb = operand_bytes(data, 8)
        fits = {}
        for reml in (True, False):
            tag = "reml" if reml else "ml"
            args = (data, nc, False, reml, 1e-5, 1e5, 10)
            r_k = opt.lambda_solve_f64_cuda(*args)
            st = {}
            r_p, pms = _timed(lambda: opt.lambda_solve_f64_plain(*args,
                                                                 stats=st))
            evals = int(st["evals"].sum())
            fits[tag] = r_k
            pk = lk.wald_pvalues_plain(r_k.lam, data, nc)[2]
            pp = lk.wald_pvalues_plain(r_p.lam, data, nc)[2]
            err = amax(pk, pp)
            logf_rel = float(((r_k.logf - r_p.logf).abs()
                              / r_p.logf.abs()).nan_to_num(0.0).max())
            nan_diff = int((torch.isnan(r_k.lam)
                            != torch.isnan(r_p.lam)).sum())
            ms = time_ms(lambda: opt.lambda_solve_f64_cuda(*args), 3)
            pms = pms if reml else None
            check("lambda_solve_f64",
                  err <= 1e-6 and logf_rel <= 1e-9
                  and nan_diff <= 1e-3 * S_,
                  {"max_abs_err": err, "logf_max_rel": logf_rel,
                   "nan_lanes": int(torch.isnan(r_p.lam).sum()),
                   "nan_lanes_differ": nan_diff, "block": label, "fit": tag,
                   "S": S_, "ms": ms, "plain_ms": pms, "evals": evals,
                   "ms_per_eval": ms / evals})
            if form == "c40":
                kern = kernels.LAMBDA_SOLVE_F64
                added, same = _split_equal(
                    kernels, kern, opt.lambda_solve_f64_cuda, args,
                    (r_k.lam, r_k.logf))
                check("lambda_solve_f64", same and added > 0,
                      {"block": label, "fit": tag, "S": S_,
                       "split_launches_added": added, "split_equal": same})
            if rec and reml:
                # at least: the n_region + 1 scan points, and per bracket
                # one Brent step, two Newton steps and the logf at the
                # candidate, plus both endpoint logfs
                grid = opt.fine_grid(1e-5, 1e5, 10, 1)
                d1g = torch.stack([lk.dev1(torch.full((S_,), float(g),
                                                      dtype=f64, device=dev),
                                           data, nc, False, True)
                                   for g in grid])
                n_br = float((d1g[:-1] * d1g[1:] <= 0).sum())
                q1, q2, q3 = M + C1 + 2, 2 * M + 2 * C1 + 4, 3 * M + 3 * C1 + 5
                nops = 2 * n * (S_ * len(grid) * q2
                                + n_br * (q2 + 2 * q3 + q1) + 2 * S_ * q1)
                record("lambda_solve_f64", err, ms, pms,
                       opb + 8 * (S_ * C1 + 2 * S_), nops,
                       peak=PEAK_F64_PER_S, launches=counts, form=form,
                       extra={"evals": evals, "ms_per_eval": ms / evals})
        tails = (("wald_tail_f64", lk.wald_pvalues_cuda,
                  lk.wald_pvalues_plain, fits["reml"].lam),
                 ("score_tail_f64", lk.score_pvalues_cuda,
                  lk.score_pvalues_plain, l_score))
        for name, fk, fp, lam in tails:
            b_k, s_k, p_k = fk(lam, data, nc)
            b_p, s_p, p_p = fp(lam, data, nc)
            ok = torch.isfinite(p_p) & torch.isfinite(s_p)
            err = float((p_k[ok] - p_p[ok]).abs().max())
            beta_se = float(((b_k - b_p).abs() / s_p)[ok].max())
            same_nan = bool((torch.isnan(p_k) == torch.isnan(p_p)).all())
            ms = time_ms(lambda: fk(lam, data, nc), 20)
            pms = time_ms(lambda: fp(lam, data, nc), 3)
            check(name, err <= 1e-10 and beta_se <= 1e-8 and same_nan
                  and p_k.dtype == f64,
                  {"max_abs_err": err, "beta_max_err_over_se": beta_se,
                   "block": label, "S": S_, "ms": ms, "plain_ms": pms})
            if form == "c40":
                _hold_tail_split(kernels, getattr(kernels, name.upper()),
                                 fk, (lam, data, nc), (b_k, s_k, p_k),
                                 name, label, check)
            if rec:
                nb, nops = _tail_work(data, nc, 8, lam.numel())
                record(name, err, ms, pms, nb, nops, peak=PEAK_F64_TC_PER_S,
                       launches=counts, form=form, note=TAIL_BOUND_NOTE)
        ml = fits["ml"]
        l_k, p_k = lk.lrt_pvalues_cuda(ml.lam, ml.logf, data, nc, l0, logl0)
        l_p, p_p = lk.lrt_pvalues_plain(ml.lam, ml.logf, data, nc, l0, logl0)
        err = amax(p_k, p_p)
        same = bool((torch.isnan(p_k) == torch.isnan(p_p)).all()
                    and torch.equal(l_k.nan_to_num(0), l_p.nan_to_num(0)))
        ms = time_ms(lambda: lk.lrt_pvalues_cuda(
            ml.lam, ml.logf, data, nc, l0, logl0), 20)
        check("lrt_tail", err <= 1e-12 and same,
              {"mode": "parity", "max_abs_err": err, "block": label,
               "S": S_, "ms": ms})

    # the shared forms: the main path's block at c = 1, and c = 3
    for c_label, W in (("c1", np.ones((n, 1))), ("c3", W3)):
        nc = W.shape[1]
        main = c_label == "c1"
        for dt, hold in ((f32, hold32), (f64, hold64)):
            ev, U, tr, y = fac[dt]
            Wd = torch.as_tensor(W, dtype=dt, device=dev)
            UtW, Uty = U.T @ Wd, U.T @ y
            data = lk.build_batch_data(ev, UtW, Uty, (xs[dt] @ U).contiguous(),
                                       nc)
            nf = fit_null(ev, UtW, Uty, tr, nc)
            hold(c_label, data, nc, nf.l_mle, nf.l_mle, nf.logl_mle,
                 counts_a if dt == f32 else counts_b, rec=main)

    # the c = 24 forms: phase (i)'s covariates on the first CVT_LANES lanes
    # of the main path's block
    from gemma_torch.models.lmm.engine import gene_batch_data, gxe_batch_data
    for dt, hold, key in ((f32, hold32, "f32"), (f64, hold64, "f64")):
        ev, U, tr, y = fac[dt]
        Wd = torch.as_tensor(W24, dtype=dt, device=dev)
        UtW, Uty = U.T @ Wd, U.T @ y
        data = lk.build_batch_data(ev, UtW, Uty,
                                   (xs[dt][:CVT_LANES] @ U).contiguous(),
                                   CVT_N)
        nf = fit_null(ev, UtW, Uty, tr, CVT_N)
        hold("c24", data, CVT_N, nf.l_mle, nf.l_mle, nf.logl_mle,
             counts_i[key], form="c24")
        del data
        # the per-lane forms at c = 24: phase (i)'s -gxe block, its first
        # CVT_N - 2 covariates plus env and x, one ML null per SNP
        W22 = torch.as_tensor(W24[:, :CVT_N - 2], dtype=dt, device=dev)
        UtW = U.T @ W22
        nf = fit_null(ev, UtW, Uty, tr, CVT_N - 2)
        env_d = torch.as_tensor(env_np[ds.indicator_idv], dtype=dt,
                                device=dev)
        x = xs[dt][:CVT_GXE_LANES]
        data = gxe_batch_data(ev, UtW, U.T @ env_d, Uty, x @ U,
                              (x * env_d) @ U, CVT_N - 2)
        null = opt.calc_lambda(data, CVT_N, True, False, 1e-5, 1e5, 10)
        hold("gxe_c24", data, CVT_N, nf.l_mle, null.lam, null.logf,
             counts_i["gxe" if dt == f32 else "gxe_f64"], form="gxe_c24")
        del data
    # the run-time-sized forms above 32 covariates: phase (k)'s CVT40_N
    # on the first CVT40_LANES lanes, and its -gxe block (CVT40_N - 2
    # columns, env and x) on the first CVT40_GXE_LANES
    for dt, hold, key in ((f32, hold32, "cvt40"), (f64, hold64,
                                                   "cvt40_f64")):
        ev, U, tr, y = fac[dt]
        Wd = torch.as_tensor(W40, dtype=dt, device=dev)
        UtW, Uty = U.T @ Wd, U.T @ y
        data = lk.build_batch_data(ev, UtW, Uty,
                                   (xs[dt][:CVT40_LANES] @ U).contiguous(),
                                   CVT40_N)
        nf = fit_null(ev, UtW, Uty, tr, CVT40_N)
        hold("c40", data, CVT40_N, nf.l_mle, nf.l_mle, nf.logl_mle,
             counts_k[key], form="c40")
        del data
        W38 = torch.as_tensor(W40[:, :CVT40_N - 2], dtype=dt, device=dev)
        UtW = U.T @ W38
        nf = fit_null(ev, UtW, Uty, tr, CVT40_N - 2)
        env_d = torch.as_tensor(env_np[ds.indicator_idv], dtype=dt,
                                device=dev)
        x = xs[dt][:CVT40_GXE_LANES]
        data = gxe_batch_data(ev, UtW, U.T @ env_d, Uty, x @ U,
                              (x * env_d) @ U, CVT40_N - 2)
        null = opt.calc_lambda(data, CVT40_N, True, False, 1e-5, 1e5, 10)
        hold("gxe_c40", data, CVT40_N, nf.l_mle, null.lam, null.logf,
             counts_k["gxe40" if dt == f32 else "gxe40_f64"],
             form="gxe_c40")
        del data
    _hold_grid_wide(fac[f32], xs[f32], fine_np, check)
    _hold_tail_wide(fac, xs, env_np[ds.indicator_idv], check)

    # the per-lane forms: the GxE block (each SNP's covariates [1, env,
    # x], the interaction as predictor, one ML null per SNP; the score at
    # the covariate-only null) and the gene block (each gene a response,
    # the phenotype the one predictor, one null per gene for the score
    # and the LRT), float32 and float64
    from gemma_torch.run import _lane_rows
    S_gxe = _block_size(cfg, dev, len(idx), n_axis=n,
                        per_lane=_lane_rows(4, 4))  # c = 1 plus env, x
    for dt, hold, tag in ((f32, hold32, ""), (f64, hold64, "_f64")):
        ev, U, tr, y = fac[dt]
        Wd = torch.ones((n, 1), dtype=dt, device=dev)
        UtW, Uty = U.T @ Wd, U.T @ y
        nf = fit_null(ev, UtW, Uty, tr, 1)
        env_d = torch.as_tensor(env_np[ds.indicator_idv], dtype=dt,
                                device=dev)
        x = xs[dt][:S_gxe]
        data = gxe_batch_data(ev, UtW, U.T @ env_d, Uty, x @ U,
                              (x * env_d) @ U, 1)
        null = opt.calc_lambda(data, 3, True, False, 1e-5, 1e5, 10)
        hold("gxe", data, 3, nf.l_mle, null.lam, null.logf,
             counts_e["gxe" + tag], form="gxe")
        E = torch.as_tensor(expr_np[:, ds.indicator_idv], dtype=dt,
                            device=dev).contiguous()
        data = gene_batch_data(ev, UtW, Uty, E @ U, 1)
        null = opt.calc_lambda(data, 1, True, False, 1e-5, 1e5, 10)
        hold("gene", data, 1, null.lam, null.lam, null.logf,
             counts_e["gene" + tag], form="gene")
        del data

    # K8 on the -lm path's SNP block and on the gene rows, and on the SNP
    # block with phase (i)'s CVT_N covariates
    for dt, name, tol_p, tol_b in ((f32, "lm_tail", 1e-6, 1e-5),
                                   (f64, "lm_tail_f64", 1e-12, 1e-10)):
        _, _, _, y = fac[dt]
        W1 = torch.ones((n, 1), dtype=dt, device=dev)
        E = torch.as_tensor(expr_np[:, ds.indicator_idv], dtype=dt,
                            device=dev).contiguous()
        for rows, gene, Wd in ((xs[dt], False, W1), (E, True, W1),
                               (xs[dt], False, torch.as_tensor(
                                   W24, dtype=dt, device=dev)),
                               (xs[dt], False, torch.as_tensor(
                                   W40, dtype=dt, device=dev))):
            c24 = Wd.shape[1] == CVT_N
            c40 = Wd.shape[1] == CVT40_N
            consts = lm.lm_consts(Wd, y)
            args = (rows, y, Wd, consts, gene, False)
            k_out = lm.lm_tail_cuda(*args)
            p_out = lm.lm_tail_plain(*args)
            err = max(amax(getattr(k_out, f), getattr(p_out, f))
                      for f in ("p_wald", "p_lrt", "p_score"))
            beta_se = float(((k_out.beta - p_out.beta).abs()
                             / p_out.se).nan_to_num(0.0).max())
            same_nan = bool((torch.isnan(k_out.p_wald)
                             == torch.isnan(p_out.p_wald)).all())
            ms = time_ms(lambda: lm.lm_tail_cuda(*args), 20)
            pms = time_ms(lambda: lm.lm_tail_plain(*args), 3)
            S_ = rows.shape[0]
            check(name, err <= tol_p and beta_se <= tol_b and same_nan,
                  {"max_abs_err": err, "beta_max_err_over_se": beta_se,
                   "rows": "genes" if gene else "snps", "c": Wd.shape[1],
                   "S": S_, "ms": ms, "plain_ms": pms})
            isz = torch.finfo(dt).bits // 8
            nc = Wd.shape[1]
            record(name, err, ms, pms,
                   isz * (S_ * n + (1 + nc) * n + 5 * S_)
                   + 8 * (nc * nc + nc + 1),
                   2 * (2 + nc) * S_ * n, peak=PEAK_F64_PER_S,
                   launches=counts_i["f32" if dt == f32 else "f64"] if c24
                   else counts_k["cvt40" if dt == f32 else "cvt40_f64"]
                   if c40 else counts_e["lm"],
                   form="c24" if c24 else "c40" if c40 else "gene" if gene
                   else None)
    _hold_search_layout(kernels, check)
    _hold_tail_layout(kernels, check)
    _hold_mv_geometry(kernels, check)
    _hold_mixed(check, amax)
    _hold_mvlmm(mv_ops, counts_f, record, check, amax)
    _hold_crt(mv_ops, counts_f, record, check)
    _hold_bslmm(counts_g, record, check)
    _hold_vc(counts_h, vc_rows, record, check)
    _hold_mqs(counts_j, record, check)
    _hold_wide(wide_ops, counts_k, record, check, amax)
    _check_d10(*d10_cpu)

    for entry in results:
        if entry["name"] in per_lane:
            entry["per_lane"] = per_lane[entry["name"]]

    _say({"phase": "total", "seconds": time.time() - t_start})
    _say(smi)
    _say({"kernels": results})
    _say({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
