"""Where a K12 (bslmm_chain) iteration spends its time, on the card: an
instrumented copy of csrc/bslmm_chain.cu in which thread 0 of rank 0
adds clock64() intervals per phase, run on scripts/k12_k15_random.py's
seeded data.

    python3 scripts/k12_phase_profile.py     # on a machine with the card

The copy goes to build/k12_profile/ (with the shared headers) and builds
as its own library; the phases are marked at fixed lines of the source,
so an edit that moves one of them makes this script stop with the line
it could not find.  Cases, float32 operands: the -bslmm 1 chain (1,000
iterations), the probit chain (-bslmm 3, -mh 10, 20 iterations) and the
-smin 1100 -smax 1536 chain (3 iterations).  Rank 0's thread 0 waits at
every barrier, so its phases add up to the iteration: each phase's share
of the clocks, times the launch's time per iteration (CUDA events), is
printed as microseconds per iteration, a case a line, then the card's
name and power limit.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import k12_k15_random as rnd  # noqa: E402
from gemma_torch import kernels  # noqa: E402
from gemma_torch.models import bslmm as pb  # noqa: E402

PROBE = '''namespace cg = cooperative_groups;
__device__ unsigned long long bs_prof[32];
__device__ __forceinline__ void bsp(int k, long long& t) {
  if (threadIdx.x == 0 && cg::this_cluster().block_rank() == 0) {
    const long long now = clock64();
    bs_prof[k] += now - t;
    t = now;
  }
}
extern "C" int bs_prof_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, bs_prof, sizeof(bs_prof));
  unsigned long long z[32] = {0};
  cudaMemcpyToSymbol(bs_prof, z, sizeof(z));
  return (int)cudaGetLastError();
}'''

# (phase, the line it ends before or after, what to insert); a phase's
# clock starts where the previous phase of its function ended
MARKS = (
    ("namespace cg = cooperative_groups;", PROBE),
    ("  bs_draws(C, sh, t, st);\n",
     "  long long T2 = clock64();\n  bs_draws(C, sh, t, st);\n"
     "  __syncthreads();\n  bsp(0, T2);\n"),
    ("  bs_sort_new(sh);\n  bs_posterior(",
     "  bsp(1, T2);\n  bs_sort_new(sh);\n  bsp(2, T2);\n  bs_posterior("),
    ("  // the draws that wait for nothing: rank 0's z and gamma(n/2)\n",
     "  long long T0 = clock64();\n"
     "  // the draws that wait for nothing: rank 0's z and gamma(n/2)\n"),
    ("  // at most 32 active ranks: the slice's partial X'WX",
     "  bsp(3, T0);\n  // at most 32 active ranks: the slice's partial X'WX"),
    ("  cl.sync();\n\n  if (tid == 0) {\n    double s1",
     "  __syncthreads();\n  bsp(4, T0);\n  cl.sync();\n  bsp(5, T0);\n\n"
     "  if (tid == 0) {\n    double s1"),
    ("      if (warp == 0)\n        bs_small_solve(",
     "      bsp(6, T0);\n      if (warp == 0)\n        bs_small_solve("),
    ("    cl.sync();\n    bs_cholesky_cluster(cl, sh, ng);\n",
     "    bsp(7, T0);\n    cl.sync();\n    bs_cholesky_cluster(cl, sh, ng);\n"
     "    bsp(8, T0);\n"),
    ("  cl.sync();\n\n  // UtXb, alpha and Utu over the slice\n",
     "  __syncthreads();\n  bsp(9, T0);\n  cl.sync();\n  bsp(10, T0);\n\n"
     "  // UtXb, alpha and Utu over the slice\n"),
    ("    bs_push(cl, cs, sh.in2[rank], v, 2);\n  }\n  cl.sync();\n",
     "    bs_push(cl, cs, sh.in2[rank], v, 2);\n  }\n  bsp(11, T0);\n"
     "  cl.sync();\n  bsp(12, T0);\n"),
    ("    sh.post_logpost = lp;\n  }\n  __syncthreads();\n}\n",
     "    sh.post_logpost = lp;\n  }\n  __syncthreads();\n  bsp(13, T0);\n"
     "}\n"),
    ("      sh.pg[j] = sh.pg_eval[j];\n    }\n  __syncthreads();\n}\n",
     "      sh.pg[j] = sh.pg_eval[j];\n    }\n  __syncthreads();\n"
     "  long long T3 = clock64();\n  bsp(14, T3);\n}\n"),
    ("  const double* cs = C.slot[sh.cur];\n  for (int i = i0 + tid;",
     "  long long T4 = clock64();\n  const double* cs = C.slot[sh.cur];\n"
     "  for (int i = i0 + tid;"),
    ("  if (tid == 0) sh.mean_z = mean;\n  __syncthreads();\n",
     "  if (tid == 0) sh.mean_z = mean;\n  __syncthreads();\n"
     "  bsp(15, T4);\n"),
)
NAMES = ("draws", "propose", "sort", "weights and staging",
         "partial X'WX", "cluster barrier 1", "rank 0 adds partials",
         "Omega (> 32 ranks)", "Cholesky (> 32 ranks)",
         "rank 0 factor and solves", "cluster barrier 2", "UtXb, alpha, Utu",
         "cluster barrier 3", "posterior tail", "accept",
         "probit liabilities")


def _instrumented() -> str:
    out = os.path.join(kernels.REPO_ROOT, "build", "k12_profile")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(kernels.CSRC_DIR):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(kernels.CSRC_DIR, f), out)
    with open(os.path.join(kernels.CSRC_DIR, "bslmm_chain.cu")) as fh:
        src = fh.read()
    for at, new in MARKS:
        if src.count(at) != 1:
            raise SystemExit(f"k12_phase_profile: no single mark {at!r}")
        src = src.replace(at, new)
    src += "\nGT_ERROR_FN(bslmm_chain_profile)\n"
    path = os.path.join(out, "bslmm_chain_profile.cu")
    with open(path, "w") as fh:
        fh.write(src)
    return path


def main():
    path = _instrumented()
    for k in (kernels.BSLMM_CHAIN, kernels.BSLMM_CHAIN_F64):
        k.source, k.stem = path, "bslmm_chain_profile"
    kernels.BSLMM_CHAIN._load()
    read = kernels.BSLMM_CHAIN._lib.bs_prof_read
    buf = (ctypes.c_ulonglong * 32)()
    data = rnd._chain_data(torch.device("cuda"))
    X, y, ylab, ev, U, tr = data
    n, p = X.shape[1], X.shape[0]

    def f32(a):
        return a.float().contiguous()

    ops = pb.chain_operands(f32(X @ U), f32(U.T @ y), f32(ev), tr, 2000.0)
    ops3 = pb.chain_operands(f32(X @ U), f32(U.T @ ylab), f32(ev), tr,
                             2000.0, U=f32(U), y_labels=f32(ylab))
    cases = (("bslmm1", 1000, dict(s_max=300), 16, ops),
             ("probit", 20, dict(s_max=300, a_mode=13, n_mh=10), 16, ops3),
             ("smin1100_smax1536", 3, dict(s_min=1100, s_max=1536), 1200,
              ops))
    for case, iters, kw, ng0, ops in cases:
        st = pb.BslmmSettings(ns_test=p, ni_test=n, w_step=0, s_step=iters,
                              r_pace=1, **kw)
        s0 = pb.init_state(ops, st, 0.4, 0.8, float(np.log(ng0 / p)), ng0,
                           1)
        pb.bslmm_chain_cuda(ops, st, s0, iters, 1)    # warm-up
        torch.cuda.synchronize()
        read(buf)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        pb.bslmm_chain_cuda(ops, st, s0, iters, 1)
        b.record()
        b.synchronize()
        read(buf)
        cyc = list(buf[:len(NAMES)])
        us_it = a.elapsed_time(b) * 1e3 / iters
        print(json.dumps({
            "case": case, "cluster": kernels.BSLMM_CHAIN.cluster,
            "us_per_iteration": us_it,
            "phases_us": {nm: us_it * c / sum(cyc)
                          for nm, c in zip(NAMES, cyc)}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
