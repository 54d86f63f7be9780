"""K14 calc_crt, K15 pair_colsum and K16 banded_cor on random operands,
on the card: each built, held against its plain version and timed.

    python3 scripts/k14_k16_random.py        # on a machine with the card

Shapes: K14 at (d, c, n, lanes) = (2, 2, 757, 4,096), (5, 2, 757, 256),
(3, 4, 200, 64) and (8, 10, 100, 4), eigenvalues with one zero, an
intercept and c - 2 covariates, positive definite Vg, Ve and a negative
definite Hvar (tests/test_torch_crt.py's lanes, widened); K15 at (n, ma,
mb) = (1,940, 2, 2) with B = A, (1,940, 1, 2), (4,096, 3, 3) with B = A
and (1,000, 9, 3); K16 at (rows, S, bw, n) = (12,226, 12,226, 333,
1,940), (2,381, 2,048, 333, 1,940) and (50, 40, 7, 33) on unit rows.
K15 and K16 run with float32 and with float64 operands, K14 with float64
ones (its only instantiation, ROADMAP.md §C18).  A time is the
mean of three calls after one warm-up (CUDA events, no L2 flush: unlike
chip_smoke.py's, the operands may sit in L2).  Prints, per case, the
largest difference from the plain version (relative for K14 and K15,
absolute for K16) and the ms, then the card's name and power limit.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gemma_torch import kernels  # noqa: E402
from gemma_torch.models import mvlmm_core as core  # noqa: E402
from gemma_torch.models import varcov, vc  # noqa: E402

DTYPES = (torch.float32, torch.float64)


def _ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _crt(rng, dev, res):
    for d, c, n, S in ((2, 2, 757, 4096), (5, 2, 757, 256), (3, 4, 200, 64),
                       (8, 10, 100, 4)):
        ev = np.abs(rng.gamma(2.0, 1.0, n))
        ev[0] = 0.0
        X0 = np.vstack([np.ones((1, n)), rng.normal(size=(c - 2, n))])
        R = rng.normal(size=(S, 1, n))
        pd = []
        for _ in range(2):
            A = rng.normal(size=(S, d, d))
            pd.append(A @ A.transpose(0, 2, 1) / d + 0.3 * np.eye(d))
        Hr = rng.normal(size=(S, d * (d + 1), d * (d + 1)))
        H = -(Hr @ Hr.transpose(0, 2, 1) + 0.5 * np.eye(d * (d + 1)))
        args = tuple(torch.as_tensor(a, dtype=torch.float64, device=dev)
                     .contiguous() for a in (ev, X0, R, pd[0], pd[1], H))
        k = core.calc_crt_cuda(*args)
        p = core.calc_crt_plain(*args)
        err = max(float(((x - y).abs() / y.abs()).max())
                  for x, y in zip(k, p))
        res[f"crt d{d} c{c} S{S} {torch.float64}"] = (
            err, _ms(lambda: core.calc_crt_cuda(*args)))


def _pair_colsum(dev, res):
    for n, ma, mb, same in ((1940, 2, 2, True), (1940, 1, 2, False),
                            (4096, 3, 3, True), (1000, 9, 3, False)):
        for dt in DTYPES:
            A = torch.randn((ma, n, n), dtype=dt, device=dev)
            B = A if same else torch.randn((mb, n, n), dtype=dt, device=dev)
            k = vc.pair_colsum_cuda(A, B)
            p = vc.pair_colsum_plain(A, B)
            err = float((k - p).abs().max() / p.abs().max())
            res[f"pc n{n} {ma}x{mb} {dt}"] = (
                err, _ms(lambda: vc.pair_colsum_cuda(A, B)))
            del A, B, k, p


def _banded_cor(dev, res):
    for R, n, S, bw in ((12226, 1940, 12226, 333), (2381, 1940, 2048, 333),
                        (50, 33, 40, 7)):
        for dt in DTYPES:
            X = torch.randn((R, n), dtype=dt, device=dev)
            X = X / X.norm(dim=1, keepdim=True)
            k = varcov.banded_cor_cuda(X, S, bw)
            p = varcov.banded_cor_plain(X, S, bw)
            res[f"bc R{R} S{S} bw{bw} {dt}"] = (
                float((k - p).abs().max()),
                _ms(lambda: varcov.banded_cor_cuda(X, S, bw)))


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card")
    for k in (kernels.CALC_CRT, kernels.PAIR_COLSUM, kernels.BANDED_COR):
        k.build()
    dev = torch.device("cuda")
    res = {}
    _crt(np.random.default_rng(0), dev, res)
    _pair_colsum(dev, res)
    _banded_cor(dev, res)
    print(json.dumps(res, indent=1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
