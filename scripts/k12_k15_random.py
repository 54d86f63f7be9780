"""K12 bslmm_chain and K15 pair_colsum on seeded random operands, on the
card: each built, held against its plain version and timed.

    python3 scripts/k12_k15_random.py        # on a machine with the card

K15 at n = 1,940 (the -vc and MQS paths' width) and 1,939 (odd: the
one-value loads) with float32 and float64 operands: a stack of 1, 2 and 4
symmetric matrices against itself, 1 against 1, 1 against 2 and 4 against
4, beside torch.einsum (chip_smoke.time_ms: the CUDA events around one
call after a 64 MiB write that evicts the L2, median of five).  K12 on a seeded genotype
matrix (n = 1,746, p = 4,096, binomial(2, 0.3) centred, a phenotype of
five causal SNPs, the kinship's eigenbasis): the -bslmm 1 chain (s_max
300, 16 starting ranks, 1,000 iterations) in both operand types, the
probit chain (-bslmm 3, -mh 10, 20 iterations), -smin 200 -smax 300,
-smin 224 -smax 300 (Omega across the cluster's shared memory) and
-smin 1100 -smax 2048 (the vectors and rank lists in global scratch; 5, 5
and 3 iterations), each from the same start and seed as its plain
version, every iteration recorded and compared by
chip_smoke.chain_agreement, K12 timed on one launch.  Prints one JSON
line a case, then the card's name and power limit.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from gemma_torch import kernels  # noqa: E402
from gemma_torch.models import bslmm as pb  # noqa: E402
from gemma_torch.models import vc  # noqa: E402


def _pair_colsum(rng, dev):
    for n in (1940, 1939):
        base = torch.as_tensor(rng.normal(size=(4, n, n)), device=dev)
        base = (base + base.transpose(1, 2)) / 2
        for dt in (torch.float32, torch.float64):
            S = base.to(dt)
            for ma, mb, same in ((1, 1, True), (2, 2, True), (4, 4, True),
                                 (1, 1, False), (1, 2, False),
                                 (4, 4, False)):
                A = S[:ma].contiguous()
                B = A if same else S[4 - mb:].contiguous()
                k = vc.pair_colsum_cuda(A, B)
                p = vc.pair_colsum_plain(A, B)
                err = float((k - p).abs().max() / p.abs().max())
                ms = chip_smoke.time_ms(lambda: vc.pair_colsum_cuda(A, B), 5)
                lib = chip_smoke.time_ms(
                    lambda: torch.einsum("ist,jst->ijt", A, B), 5)
                print(json.dumps({
                    "kernel": "pair_colsum", "n": n, "dtype": str(dt),
                    "ma": ma, "mb": mb, "B_is_A": same, "max_rel_err": err,
                    "ok": err <= 1e-12, "ms": ms, "einsum_ms": lib,
                    "plan": vc.pc_launches(ma, mb, n, A.element_size(),
                                           kernels.sm_count(A.device),
                                           True)}), flush=True)


def _chain_data(dev, n=1746, p=4096, seed=3):
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.binomial(2, 0.3, size=(p, n)), dtype=torch.float64,
                        device=dev)
    X -= X.mean(1, keepdim=True)
    y = X[:5].sum(0) * 0.3 + torch.as_tensor(rng.normal(size=n), device=dev)
    y -= y.mean()
    ev, U = torch.linalg.eigh(X.T @ X / p)
    ev = torch.where(ev < 1e-10, torch.zeros_like(ev), ev)
    yb = (y > 0).double()
    return X, y, yb - yb.mean(), ev, U, float(ev.sum()) / n


def _chain(data, case, dt, iters, s_min=0, s_max=300, ng0=16, a_mode=11,
           n_mh=1):
    X, y, ylab, ev, U, tr = data
    n, p = X.shape[1], X.shape[0]
    probit = a_mode == 13
    yy = ylab if probit else y
    t = lambda a: a.to(dt).contiguous()  # noqa: E731
    st = pb.BslmmSettings(ns_test=p, ni_test=n, s_min=s_min, s_max=s_max,
                          w_step=0, s_step=iters, r_pace=1, a_mode=a_mode,
                          n_mh=n_mh)
    ops = pb.chain_operands(t(X @ U), t(U.T @ yy), t(ev), tr,
                            st.geo_mean, U=t(U) if probit else None,
                            y_labels=t(yy) if probit else None)
    s0 = pb.init_state(ops, st, 0.4, 0.8, float(np.log(ng0 / p)), ng0, 1)
    kern = kernels.variant(kernels.BSLMM_CHAIN, kernels.BSLMM_CHAIN_F64, dt)
    kk = pb.bslmm_chain_cuda(ops, st, s0, iters, 1)
    t0 = time.time()
    pp = pb.bslmm_chain_plain(ops, st, s0, iters, 1)
    torch.cuda.synchronize()
    pms = (time.time() - t0) * 1e3
    first, err, ok = chip_smoke.chain_agreement(kk, pp, iters)
    ms = chip_smoke.time_ms(lambda: pb.bslmm_chain_cuda(ops, st, s0, iters,
                                                        1), 1)
    hk = kk.rec_hyp.cpu().numpy()
    print(json.dumps({
        "kernel": kern.name, "case": case, "iterations": iters,
        "first_divergence": first, "hyp_max_rel_err_before": err,
        "ok": ok,
        "accepts": [kk.n_accept, pp.n_accept],
        "n_gamma": [float(hk[:, 5].min()), float(hk[:, 5].mean()),
                    float(hk[:, 5].max())], "cluster": kern.cluster,
        "ms": ms, "ms_per_iteration": ms / iters, "plain_ms": pms}),
        flush=True)


def main():
    dev = torch.device("cuda")
    t0 = time.time()
    for k in (kernels.PAIR_COLSUM, kernels.BSLMM_CHAIN):
        k.build()
        with open(os.path.join(kernels.BUILD_DIR,
                               f"{k.stem}.ptxas.txt")) as fh:
            print(fh.read()[-3000:])
    print(json.dumps({"build_s": time.time() - t0}), flush=True)
    rng = np.random.default_rng(0)
    _pair_colsum(rng, dev)
    data = _chain_data(dev)
    which = sys.argv[1:] or ["mouse", "probit", "s300", "s2048"]
    for dt in (torch.float32, torch.float64):
        if "mouse" in which:
            _chain(data, "bslmm1", dt, 1000)
    if "probit" in which:
        _chain(data, "probit", torch.float32, 20, s_max=10, ng0=4,
               a_mode=13, n_mh=10)
    if "s300" in which:
        _chain(data, "smin200_smax300", torch.float32, 5, s_min=200,
               s_max=300, ng0=210)
        # past 216 active ranks Omega is cut over the cluster's regions
        _chain(data, "smin224_smax300", torch.float32, 5,
               s_min=chip_smoke.S300_DIST, s_max=300,
               ng0=chip_smoke.S300_DIST)
    if "s2048" in which:
        for dt in (torch.float32, torch.float64):
            _chain(data, "smin1100_smax2048", dt, 3, s_min=1100,
                   s_max=2048, ng0=1200)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
