"""GEMMA-compatible command-line interface.

Flag names and mode numbers follow GEMMA::Assign (gemma.cpp:754-1639)
so existing GEMMA invocations work unchanged:

    python -m gemma_torch -g geno.txt.gz -p pheno.txt -gk -o out
    python -m gemma_torch -g geno.txt.gz -p pheno.txt -k out.cXX.txt -lmm 1

Extra (non-GEMMA) flags: -precision {auto,float32,float64},
-block-size N, -device {cuda,cpu}.
"""

from __future__ import annotations

import sys

from gemma_torch.config import GemmaConfig


HELP = """\
gemma_torch: Genome-wide Efficient Mixed Model Association on an NVIDIA GPU
Flag-compatible with GEMMA (gemma.cpp PrintHelp, :153-752).

 FILE I/O
  -bfile/-b  [prefix]   PLINK binary ped prefix (.bed/.bim/.fam)
  -g         [file]     BIMBAM mean genotype file (.txt or .txt.gz)
  -mbfile/-mg [file]    list file of PLINK prefixes / BIMBAM files
  -p         [file]     phenotype file (one column per phenotype)
  -n         [nums]     phenotype column(s), 1-based (default 1)
  -a         [file]     BIMBAM SNP annotation (rs, bp, chr[, cM])
  -c         [file]     covariates (include a 1s intercept column)
  -gxe       [file]     environmental variable for GxE tests
  -widv      [file]     residual weights per individual
  -k/-mk     [file]     kinship matrix / list of kinship files
  -km        [num]      kinship format: 1 dense, 2 id id value
  -u/-d      [file]     eigen U matrix / D values of the kinship
  -snps/-ksnps/-gwasnps [file]  SNP subsets (analysis/kinship/tests)
  -epm/-en   [file/cols] estimated parameters for -predict (+columns)
  -ebv/-emu  [file/num] estimated breeding values / mean estimate
  -beta/-cor [file]     summary statistics (z or beta/se) / LD file
  -cat/-mcat [file]     SNP categories (multi-VC) / list of cat files
  -wsnp/-wcat [file]    per-SNP / per-category MQS weights
  -study/-ref [prefix]  MQS study (.q/.Vq/.size) / reference (.S/.size)
  -mstudy/-mref [file]  lists of study / reference prefixes
  -gene      [file]     gene expression matrix (each gene a response)
  -hyp/-bf   [file]     DAP hyper-parameter grid / Bayes factor files
  -outdir    [path]     output directory (default ./output)
  -o         [prefix]   output file prefix (default result)

 QC
  -miss/-maf/-hwe/-r2 [num]   filters (defaults 0.05/0.01/0/0.9999)
  -notsnp               disable the MAF filter (any numeric values)
  -nind      [num]      keep only the first N analyzed individuals
  -sample    [num]      random subsample of N analyzed individuals

 ANALYSES (one of)
  -gk   [1|2]           centered / standardized relatedness matrix
  -eigen                eigendecomposition of the kinship
  -lmm  [1..5,9]        Wald / LRT / score / all / resid / LRT+Wald
  -lm   [1..4]          plain linear model tests
  -vc   [1|2|3]         HE regression / REML-AI / ACL components
  -ci   [1|2]           MQS confidence intervals (needs -pve, -ref)
  -gs / -gq             MQS S matrix / q vector building blocks
  -bslmm [1..5]         MCMC / ridge / probit / DAP-BF / DAP-EM
  -predict [1|2|3]      phenotype prediction (+probit, +MVN imputation)
  -calccor / -gw        windowed SNP correlations
  -loco  [chr]          leave-one-chromosome-out for -gk/-lmm

 LMM
  -lmin/-lmax [num]     lambda optimisation interval (1e-5 / 1e5)
  -region    [num]      lambda sign-scan subdivisions (10)
  -pnr       [num]      NR refinement p-value threshold (0.001)
  -emi/-nri  [num]      max EM / NR iterations (10000 / 100)
  -emp/-nrp  [num]      EM / NR precision (1e-4)
  -crt                  small-sample p-value correction (mvLMM)
  -pve       [nums]     pve point estimates (for -ci)
  -noconstrain          REML in sigma2 (not log sigma2) coordinates
  -blocks    [num]      jackknife block count for MQS (200)

 BSLMM / MCMC
  -hmin/-hmax, -rmin/-rmax, -pmin/-pmax, -smin/-smax   prior ranges
  -hscale/-rscale/-pscale [num]  MH proposal step scales
  -w/-s      [num]      burn-in / sampling steps (100000 / 1000000)
  -rpace/-wpace [num]   recording / writing paces (10 / 1000)
  -mh        [num]      MH steps per iteration (10)
  -gmean     [num]      geometric-mean rank weighting (2000)
  -seed      [num]      RNG seed
  -mu        [num]      phenotype mean for -predict

 WINDOWS (-calccor / -beta LD correction)
  -windowbp/-windowcm/-windowns [num]

 RUNTIME
  -pace      [num]      progress stride
  -check/-no-check      kinship validation on/off
  -debug/-debug-data/-debug-dump   verbose diagnostics
  -silence/--quiet      suppress console output
  -precision [auto|float32|float64]   dtype policy (auto: float32 on
                        cuda, float64 on cpu)
  -block-size [num]     SNPs per device batch
  -device    [cuda|cpu] where the analysis runs (default cuda; there is
                        no fallback to the CPU)
  -ckpt      [num]      checkpoint the BSLMM chain every N iterations;
                        an interrupted run resumes from
                        <prefix>.mcmc.ckpt.npz automatically
  -trace     [dir]      profiler trace of the analysis (not ported)
  -h / -license         this help / license info
"""


def _is_flag(tok: str) -> bool:
    if not tok.startswith("-"):
        return False
    # negative numbers are values, not flags
    try:
        float(tok)
        return False
    except ValueError:
        return True


def parse_args(argv: list) -> GemmaConfig:
    cfg = GemmaConfig()
    i = 0

    def set_mode(mode: int):
        # only one analysis flag per run (gemma.cpp:1168-1175 etc.)
        if cfg.a_mode != 0:
            raise ValueError(
                "error! only one of -gk -gs -gq -eigen -vc -ci -lm -lmm "
                "-bslmm -predict -calccor options is allowed.")
        cfg.a_mode = mode

    def take(default=None):
        nonlocal i
        if i + 1 < len(argv) and not _is_flag(argv[i + 1]):
            i += 1
            return argv[i]
        if default is not None:
            return default
        raise ValueError(f"flag {argv[i]} requires a value")

    def take_multi():
        nonlocal i
        vals = []
        while i + 1 < len(argv) and not _is_flag(argv[i + 1]):
            i += 1
            vals.append(argv[i])
        return vals

    while i < len(argv):
        a = argv[i]
        if a in ("-g",):
            cfg.file_geno = take()
        elif a in ("-bfile", "--bfile", "-b"):
            cfg.file_bfile = take()
        elif a == "-mg":
            cfg.file_mgeno = take()
        elif a in ("-mbfile", "--mbfile", "-mb"):
            cfg.file_mbfile = take()
        elif a == "-p":
            cfg.file_pheno = take()
        elif a == "-a":
            cfg.file_anno = take()
        elif a == "-c":
            cfg.file_cvt = take()
        elif a == "-gxe":
            cfg.file_gxe = take()
        elif a == "-widv":
            cfg.file_weight = take()
        elif a == "-k":
            cfg.file_kin = take()
        elif a == "-mk":
            cfg.file_mk = take()
        elif a == "-u":
            cfg.file_ku = take()
        elif a == "-d":
            cfg.file_kd = take()
        elif a == "-snps":
            cfg.file_snps = take()
        elif a == "-ksnps":
            cfg.file_ksnps = take()
        elif a == "-gwasnps":
            cfg.file_gwasnps = take()
        elif a == "-epm":
            cfg.file_epm = take()
        elif a == "-ebv":
            cfg.file_ebv = take()
        elif a == "-emu":
            cfg.file_emu = take()
        elif a == "-beta":
            cfg.file_beta = take()
        elif a == "-cor":
            cfg.file_cor = take()
        elif a == "-gene":
            cfg.file_gene = take()
        elif a == "-cat":
            cfg.file_cat = take()
        elif a == "-mcat":
            cfg.file_mcat = take()
        elif a == "-catc":
            cfg.file_catc = take()
        elif a == "-mcatc":
            cfg.file_mcatc = take()
        elif a == "-wsnp":
            cfg.file_wsnp = take()
        elif a == "-wcat":
            cfg.file_wcat = take()
        elif a == "-study":
            cfg.file_study = take()
        elif a == "-ref":
            cfg.file_ref = take()
        elif a == "-mstudy":
            cfg.file_mstudy = take()
        elif a == "-mref":
            cfg.file_mref = take()
        elif a == "-r":
            cfg.file_read = take()
        elif a == "-en":
            cfg.est_column = tuple(int(v) for v in take_multi())
        elif a == "-pve":
            cfg.v_pve = tuple(float(v) for v in take_multi())
        elif a == "-hyp":
            cfg.file_hyp = take()
        elif a == "-bf":
            cfg.file_bf = take()
        elif a == "-n":
            cfg.p_columns = tuple(int(v) for v in take_multi()) or (1,)
        elif a == "-km":
            cfg.k_mode = int(take())
        elif a == "-outdir":
            cfg.path_out = take()
        elif a == "-o":
            cfg.file_out = take()
        elif a == "-miss":
            cfg.miss_level = float(take())
        elif a == "-maf":
            cfg.maf_level = float(take())
        elif a == "-hwe":
            cfg.hwe_level = float(take())
        elif a == "-r2":
            cfg.r2_level = float(take())
        elif a == "-notsnp":
            cfg.maf_level = -1.0
        elif a == "-gk":
            cfg.gk_mode = int(take(default="1"))
            set_mode(20 + cfg.gk_mode)
        elif a == "-eigen":
            set_mode(31)
        elif a in ("-lmm", "-fa"):
            set_mode(int(take(default="1")))
        elif a == "-lm":
            set_mode(50 + int(take(default="1")))
        elif a == "-vc":
            set_mode(60 + int(take(default="1")))
        elif a == "-ci":
            set_mode(65 + int(take(default="1")))
        elif a == "-gs":
            set_mode(24 + int(take(default="1")))
        elif a == "-gq":
            set_mode(26 + int(take(default="1")))
        elif a == "-gw":
            # -gw [N] → 71+N (gemma.cpp:1181-1188), default 72
            set_mode(71 + int(take(default="1")))
        elif a == "-calccor":
            # -calccor [N] → 70+N (gemma.cpp:1221-1227), default 71
            set_mode(70 + int(take(default="1")))
        elif a == "-bslmm":
            set_mode(10 + int(take(default="1")))
        elif a == "-predict":
            set_mode(40 + int(take(default="1")))
        elif a == "-lmin":
            cfg.l_min = float(take())
        elif a == "-lmax":
            cfg.l_max = float(take())
        elif a == "-region":
            cfg.n_region = int(take())
        elif a == "-loco":
            cfg.loco = take()
        elif a == "-pnr":
            cfg.p_nr = float(take())
        elif a == "-emi":
            cfg.em_iter = int(take())
        elif a == "-nri":
            cfg.nr_iter = int(take())
        elif a == "-emp":
            cfg.em_prec = float(take())
        elif a == "-nrp":
            cfg.nr_prec = float(take())
        elif a == "-crt":
            cfg.crt = 1
        elif a == "-hmin":
            cfg.h_min = float(take())
        elif a == "-hmax":
            cfg.h_max = float(take())
        elif a == "-rmin":
            cfg.rho_min = float(take())
        elif a == "-rmax":
            cfg.rho_max = float(take())
        elif a == "-pmin":
            cfg.logp_min = float(take())
        elif a == "-pmax":
            cfg.logp_max = float(take())
        elif a == "-smin":
            cfg.s_min = int(take())
        elif a == "-smax":
            cfg.s_max = int(take())
        elif a == "-gmean":
            cfg.geo_mean = float(take())
        elif a == "-mu":
            cfg.pheno_mean = float(take())
        elif a == "-w":
            cfg.w_step = int(take())
        elif a == "-s":
            cfg.s_step = int(take())
        elif a == "-rpace":
            cfg.r_pace = int(take())
        elif a == "-wpace":
            cfg.w_pace = int(take())
        elif a == "-mh":
            cfg.n_mh = int(take())
        elif a == "-seed":
            cfg.seed = int(take())
        elif a == "-nind":
            cfg.ni_max = int(take())
        elif a == "-sample":
            cfg.ni_subsample = int(take())
        elif a == "-pace":
            cfg.d_pace = int(take())
        elif a == "-noconstrain":
            cfg.noconstrain = True
        elif a == "-hscale":
            cfg.h_scale = float(take())
        elif a == "-rscale":
            cfg.rho_scale = float(take())
        elif a == "-pscale":
            cfg.logp_scale = float(take())
        elif a == "-windowbp":
            cfg.window_bp = float(take())
        elif a == "-windowcm":
            cfg.window_cm = float(take())
        elif a == "-windowns":
            cfg.window_ns = float(take())
        elif a == "-blocks":
            cfg.n_block = int(take())
        elif a in ("-check",):
            cfg.check = True
        elif a in ("-no-check", "-nocheck"):
            cfg.check = False
        elif a in ("-debug", "-debug-data", "-debug-dump"):
            cfg.debug = True
        elif a == "-ldr":
            raise NotImplementedError(
                "-ldr is vestigial in GEMMA (LDR::VB never defined, "
                "ldr.h:65) and deliberately not built")
        elif a in ("-silence", "--quiet"):
            cfg.quiet = True
        elif a == "-strict":
            # escalate validation warnings to hard stops
            # (debug.h:144-191 `-strict` semantics)
            cfg.strict = True
        elif a == "-no-fpe-check":
            cfg.fpe_check = False
        elif a == "-legacy":
            cfg.legacy = True
        elif a == "-issue":
            take()   # parsed-and-ignored (runtime issue asserts)
        elif a == "-precision":
            cfg.precision = take()
        elif a == "-device":
            cfg.device = take()
        elif a == "-block-size":
            cfg.block_size = int(take())
            cfg.block_size_set = True
        elif a in ("-ckpt", "-checkpoint"):
            cfg.checkpoint_every = int(take())
        elif a == "-trace":
            cfg.trace_dir = take()
        elif a in ("-h", "--help"):
            print(HELP)
            sys.exit(0)
        elif a == "-license":
            print("gemma_torch: GPU GWAS mixed-model engine.\n"
                  "Distributed under the GPLv3 license, like the GEMMA\n"
                  "reference implementation it is format-compatible with.")
            sys.exit(0)
        else:
            raise ValueError(f"unknown flag: {a}")
        i += 1

    return cfg


def main(argv: list | None = None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    cfg = parse_args(argv)
    from gemma_torch.run import batch_run
    batch_run(cfg, argv=["gemma_torch"] + list(argv))


if __name__ == "__main__":
    main()
