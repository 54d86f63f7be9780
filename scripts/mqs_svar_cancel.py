"""How far a float64 rounding of MQS's kinship stacks moves the jackknife
variance Svar, in the reference's form and in the port's, on the CPU:
the reading behind ROADMAP.md §C19.

    JAX_PLATFORMS=cpu python3 scripts/mqs_svar_cancel.py [--n 1940] [--p 3000]

It draws p seeded genotypes for n individuals in four categories (the
quarters of the SNPs) and builds the centred and scaled per-category
kinship stacks twice, once from the SNPs in file order and once in a
seeded permutation of it: the same sums in another order, as a card and
a CPU add them.  For each stack it takes Svar with the reference's
jackknife_ak_to_s (gemma_tpu/models/mqs.py: (mean(d²) - mean(d)²)(n - 1))
and with the port's (gemma_torch/models/mqs.py: the variance in two
passes), and prints one JSON line: the stacks' largest relative change,
and each form's largest change of S and Svar relative to the matrix's
largest entry, and how far the two forms part on the same stack.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gemma_torch.models import mqs  # noqa: E402
from gemma_tpu.models import mqs as ref  # noqa: E402


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1940)
    ap.add_argument("--p", type=int, default=3000)
    args = ap.parse_args()
    n, p = args.n, args.p
    rng = np.random.default_rng(0)
    X = rng.binomial(2, rng.uniform(0.05, 0.5, p)[:, None],
                     size=(p, n)).astype(np.float64)
    W = np.ones((n, 1))
    cats = np.arange(p) * 4 // p
    perm = rng.permutation(p)
    stacks = [mqs.center_scale(
        mqs.category_kinship(Xo, W, co, 4, device="cpu")[0])
              for Xo, co in ((X, cats), (X[perm], cats[perm]))]
    out = {"n": n, "p": p, "stack_max_rel_change": _rel(
        stacks[1].numpy(), stacks[0].numpy())}
    port, reference = [], []
    for A in stacks:
        port.append(mqs.ak_to_s(A, A, 1))
        An = A.numpy()
        S = ref.comp_ak_to_s(An, An, 1)
        reference.append(ref.jackknife_ak_to_s(An, An, 1, S))
    for name, (a, b) in (("port", port), ("reference", reference)):
        out[name] = {"S_max_rel_change": _rel(b[0], a[0]),
                     "Svar_max_rel_change": _rel(b[1], a[1])}
    out["Svar_port_vs_reference"] = _rel(reference[0][1], port[0][1])
    print(json.dumps(out))


if __name__ == "__main__":
    torch.set_num_threads(os.cpu_count() or 1)
    main()
