"""chip_smoke.py's ms of K4 (wald_tail), K5 (score_tail), their float64
forms and K6's speed mode (lrt_tail, its null launch and SNP launch
together) on the two blocks of 40 covariates, with the kernels of the
checkout at --root (default: this one), so that two trees are timed by
one script in one run on the same card.

    python3 scripts/k4_k6_tree_times.py [--root DIR]  # on a machine with the card

The blocks have chip_smoke.py phase (k)'s shapes: n = MOUSE_N (1,940);
"c40", CVT40_N covariates (an intercept and seeded normal columns)
shared by CVT40_LANES (128) lanes; "gxe_c40", CVT40_GXE_LANES (128)
lanes of CVT40_N - 2 of them plus env and x a lane.  The operands are
seeded and already rotated (eval uniform in [0, 2), the rest normal) and
λ is seeded a lane (K5 the first lane's; K6's null 1.1 times the first
lane's where the lanes share it, else each lane's): the kernels' work
depends on the shapes alone.  Timing: this checkout's
chip_smoke.time_ms, the median of REPS calls after a warm-up with the L2
flushed and the host's enqueue included, and the card's time alone
(device_ms, chip_smoke._time_device_ms: the enqueue hidden behind a
sleep on the card).  Prints one JSON line a (kernel, block), then the
card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_HERE,
                    help="the checkout whose gemma_torch is timed")
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, _HERE)
    import chip_smoke as cs
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card only")
    from gemma_torch import kernels
    from gemma_torch.models.lmm import likelihood as lk
    from gemma_torch.models.lmm.engine import gxe_batch_data
    assert kernels.REPO_ROOT == root, (kernels.REPO_ROOT, root)

    # one nvcc a library (each holds both precisions), all at once
    libs = {k.lib_stem: k for k in (kernels.WALD_TAIL, kernels.SCORE_TAIL,
                                    kernels.LRT_TAIL)}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda k: k.build(), libs.values()))

    n, nc = cs.MOUSE_N, cs.CVT40_N
    rng = np.random.default_rng(cs.CVT40_SEED)
    ev = rng.uniform(0.0, 2.0, n)
    UtW = np.column_stack([np.ones(n), rng.normal(size=(n, nc - 1))])
    Utenv, Uty = rng.normal(size=n), rng.normal(size=n)
    S, Sg = cs.CVT40_LANES, cs.CVT40_GXE_LANES
    Utx = rng.normal(size=(max(S, Sg), n))
    Utxe = rng.normal(size=(Sg, n))
    lam_np = 10.0 ** rng.uniform(-1.5, 1.5, max(S, Sg))
    for dt in (torch.float32, torch.float64):
        def t(a):
            return torch.as_tensor(a, dtype=dt, device="cuda")
        blocks = (
            ("c40", lk.build_batch_data(t(ev), t(UtW), t(Uty), t(Utx[:S]),
                                        nc)),
            ("gxe_c40", gxe_batch_data(t(ev), t(UtW[:, :nc - 2]), t(Utenv),
                                       t(Uty), t(Utx[:Sg]), t(Utxe),
                                       nc - 2)))
        sfx = "" if dt == torch.float32 else "_f64"
        for label, data in blocks:
            lanes = lk.n_lanes(data)
            lam = t(lam_np[:lanes])
            l0 = lam[:1] * 1.1 if label == "c40" else lam * 1.1
            calls = [("wald_tail" + sfx,
                      lambda: lk.wald_pvalues_cuda(lam, data, nc)),
                     ("score_tail" + sfx,
                      lambda: lk.score_pvalues_cuda(lam[:1], data, nc))]
            if dt == torch.float32:
                calls.append(("lrt_tail", lambda: lk.lrt_pvalues_cuda(
                    lam, None, data, nc, l0, None)))
            for name, fn in calls:
                dev_ms, _ = cs._time_device_ms(fn, REPS)
                print(json.dumps({"kernel": name, "block": label, "S": lanes,
                                  "n": n, "ms": cs.time_ms(fn, REPS),
                                  "device_ms": dev_ms, "root": root}),
                      flush=True)
        del blocks, data
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)


if __name__ == "__main__":
    main()
