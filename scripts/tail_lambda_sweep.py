"""K4 (wald_tail) and K5 (score_tail) in float32 against their plain
versions on chip_smoke.py's c = 3 block, over a sweep of the λ at which
they are evaluated: eleven values within 5e-4 relative (the float32
Newton tolerance of K3) of the float64 null optimum.  Shows how far the
holds' max |p - p_plain| moves with the λ that K3 hands them.

    python3 scripts/tail_lambda_sweep.py     # on a machine with the card

Builds chip_smoke's mouse genotypes and kinship (`-gk 1` on the card)
in build/tail_sweep/, the block's operands as chip_smoke's main() does
(its first block of SNPs, the intercept and two seeded normal
covariates), fits the float64 null, and prints a line a λ, then the
card's name and power limit.
"""

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gemma_torch import precision  # noqa: E402
from gemma_torch.config import GemmaConfig  # noqa: E402
from gemma_torch.dataset import load_dataset  # noqa: E402
from gemma_torch.io.readers import read_kinship  # noqa: E402
from gemma_torch.models.lmm import likelihood as lk  # noqa: E402
from gemma_torch.models.lmm.engine import fit_null  # noqa: E402
from gemma_torch.ops import pack2  # noqa: E402
from gemma_torch.ops.center import center_matrix  # noqa: E402
from gemma_torch.ops.eigh import eigh_zeroed  # noqa: E402
from gemma_torch.run import _block_size, _raw_wire_block, _to_device  # noqa: E402


def main():
    dev = torch.device("cuda")
    precision.apply_matmul_precision()
    work = os.path.join(cs.HERE, "build", "tail_sweep")
    os.makedirs(work, exist_ok=True)
    td = tempfile.mkdtemp(dir=work)
    geno, pheno = cs._synth_mouse(td)
    cs._run(f"-g {geno} -p {pheno} -outdir {td} -no-check -gk 1 -o K"
            .split(), "cuda")
    cfg = GemmaConfig(file_geno=geno, file_pheno=pheno, check=False)
    ds = load_dataset(cfg)
    n = ds.ni_test
    idx = np.flatnonzero(ds.qc.indicator_snp)
    S = _block_size(cfg, dev, len(idx), n_axis=n)
    raw = _to_device(_raw_wire_block(ds, idx[:S], S, torch.float32,
                                     all_individuals=False), dev)
    K = read_kinship(f"{td}/K.cXX.txt", ds.indicator_idv)
    W3 = np.column_stack([np.ones(n),
                          np.random.default_rng(7).normal(size=(n, 2))])
    data = {}
    for dt in (torch.float32, torch.float64):
        ev, U, tr = eigh_zeroed(center_matrix(torch.as_tensor(
            K, dtype=dt, device=dev)))
        y = torch.as_tensor(ds.Y[:, 0], dtype=dt, device=dev)
        x = pack2.prologue_cuda(raw, n, pack2.IMPUTE, False, None, dt)
        UtW, Uty = U.T @ torch.as_tensor(W3, dtype=dt, device=dev), U.T @ y
        data[dt] = (lk.build_batch_data(ev, UtW, Uty, (x @ U).contiguous(),
                                        3), fit_null(ev, UtW, Uty, tr, 3))
    blk, _ = data[torch.float32]
    l_opt = float(data[torch.float64][1].l_mle)
    for d in np.linspace(-5e-4, 5e-4, 11):
        lam = torch.tensor([l_opt * (1 + d)], dtype=torch.float32, device=dev)
        row = {"delta": float(d), "lam": float(lam)}
        for name, fk, fp in (("wald", lk.wald_pvalues_cuda,
                              lk.wald_pvalues_plain),
                             ("score", lk.score_pvalues_cuda,
                              lk.score_pvalues_plain)):
            lv = (lam.expand(lk.n_lanes(blk)).contiguous() if name == "wald"
                  else lam)
            pk = fk(lv, blk, 3)[2]
            pp = fp(lv, blk, 3)[2]
            ok = torch.isfinite(pp)
            row[name] = float((pk[ok] - pp[ok]).abs().max())
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
