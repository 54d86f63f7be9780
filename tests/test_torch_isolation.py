"""gemma_torch stands alone: it imports neither JAX nor anything of
gemma_tpu, it runs on the card unless asked for the CPU, and
chip_smoke.py refuses to run without a card or without the package."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import gemma_torch
names = [m.name for m in pkgutil.walk_packages(gemma_torch.__path__,
                                                "gemma_torch.")
         if m.name != "gemma_torch.__main__"]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "gemma_tpu")))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_no_jax_and_no_reference_package_imported():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL.format(repo=REPO)],
                       capture_output=True, text=True, cwd=REPO,
                       env=_clean_env(), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20


def test_cli_without_device_flag_refuses_to_run_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    r = subprocess.run(
        [sys.executable, "-m", "gemma_torch", "-g", "geno.txt", "-p",
         "pheno.txt", "-gk", "1", "-outdir", str(tmp_path)],
        capture_output=True, text=True, cwd=REPO, env=_clean_env(),
        timeout=300)
    assert r.returncode != 0
    assert "-device cpu" in r.stderr
    assert not list(tmp_path.iterdir())


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"],
                       capture_output=True, text=True, cwd=tmp_path,
                       env=_clean_env(), timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_wrappers_send_cpu_tensors_to_plain_versions():
    """On CPU tensors no kernel is built or launched."""
    from gemma_torch import kernels
    from gemma_torch.ops import pack2
    kernels.reset_launches()
    raw = torch.tensor([[0, 1, 2, -1]], dtype=torch.int8)
    out = pack2.prologue(raw, 4, pack2.IMPUTE, dtype=torch.float64)
    assert out.tolist() == [[0.0, 1.0, 2.0, 1.0]]
    assert all(k.launches == 0 for k in kernels.ALL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lmm_wrappers_send_cpu_tensors_to_plain_versions(dtype):
    """The score, LRT and λ-search wrappers on CPU tensors, float32 and
    float64: plain versions only, no kernel built or launched."""
    import numpy as np
    from gemma_torch import kernels
    from gemma_torch.models.lmm import likelihood as lk
    from gemma_torch.models.lmm.engine import assoc_block_impl, fit_null
    rng = np.random.default_rng(0)
    n, S = 30, 4
    ev = torch.as_tensor(np.sort(rng.uniform(0, 2, n)), dtype=dtype)
    UtW = torch.as_tensor(rng.normal(size=(n, 1)), dtype=dtype)
    Uty = torch.as_tensor(rng.normal(size=n), dtype=dtype)
    Utx = torch.as_tensor(rng.normal(size=(S, n)), dtype=dtype)
    kernels.reset_launches()
    nf = fit_null(ev, UtW, Uty, ev.mean(), 1)
    st = assoc_block_impl(ev, UtW, Uty, Utx, nf.l_mle, nf.logl_mle,
                          n_cvt=1, mode=4)
    assert all(k.launches == 0 for k in kernels.ALL)
    for f in ("p_wald", "p_lrt", "p_score"):
        p = getattr(st, f)
        assert p.dtype == dtype and p.shape == (S,)
        assert bool(((p >= 0) & (p <= 1)).all())
    assert lk.score_pvalues(nf.l_mle, lk.build_batch_data(
        ev, UtW, Uty, Utx, 1), 1)[2].dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mvlmm_wrappers_send_cpu_tensors_to_plain_versions(dtype):
    """K9-K11's wrappers and the mvLMM driver on CPU tensors, float32 and
    float64: plain versions only, no kernel built or launched."""
    import types
    import numpy as np
    from gemma_torch import kernels
    from gemma_torch.models import mvlmm_core as core
    from gemma_torch.models.mvlmm import MvlmmNull, mvlmm_assoc
    rng = np.random.default_rng(1)
    n, S, d = 40, 3, 2
    ev = torch.as_tensor(np.sort(rng.uniform(0, 2, n)), dtype=dtype)
    X0 = torch.ones((1, n), dtype=dtype)
    Y = torch.as_tensor(rng.normal(size=(d, n)), dtype=dtype)
    Utx = torch.as_tensor(rng.normal(size=(S, n)), dtype=dtype)
    cfg = types.SimpleNamespace(l_min=1e-5, l_max=1e5, n_region=10,
                                em_iter=200, em_prec=1e-4, nr_iter=20,
                                nr_prec=1e-4, p_nr=0.5)
    kernels.reset_launches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # small-tensor loops (test_torch_mvlmm.py)
    try:
        null = MvlmmNull(ev, X0, Y, cfg)
        out = mvlmm_assoc(ev, X0, Y, Utx, null, 4, cfg, dtype)
        em = core.mph_em(True, 5, 1e-3, ev, X0, Y, Utx[:, None],
                         null.Vg_start[None], null.Ve_start[None],
                         null.B_start[None])
    finally:
        torch.set_num_threads(threads)
    assert all(k.launches == 0 for k in kernels.ALL)
    assert em.Vg.dtype == torch.float64 and em.iters.shape == (S,)
    for f in ("p_wald", "p_lrt", "p_score"):
        assert out[f].shape == (S,)
        assert ((out[f] >= 0) & (out[f] <= 1)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bslmm_wrappers_send_cpu_tensors_to_plain_versions(dtype):
    """K12's and K13's wrappers on CPU tensors, float32 and float64
    operands: plain versions only, no kernel built or launched; the
    chain's state is float64 whatever the operands."""
    import math
    import numpy as np
    from gemma_torch import kernels
    from gemma_torch.models import bslmm, bslmmdap
    rng = np.random.default_rng(2)
    n, p = 30, 12
    ev = torch.as_tensor(np.sort(rng.uniform(0, 2, n)), dtype=dtype)
    UtXT = torch.as_tensor(rng.normal(size=(p, n)), dtype=dtype)
    Uty = torch.as_tensor(rng.normal(size=n), dtype=dtype)
    st = bslmm.BslmmSettings(ns_test=p, ni_test=n, s_max=5, w_step=2,
                             s_step=6, r_pace=2)
    ops = bslmm.chain_operands(UtXT, Uty, ev, float(ev.mean()), st.geo_mean)
    kernels.reset_launches()
    s0 = bslmm.init_state(ops, st, 0.4, 0.6, math.log(2 / p), 2, 1)
    out = bslmm.bslmm_chain(ops, st, s0, 8, 1)
    grid = bslmmdap.hyper_grid(0.1, 0.9, 2, 0.2, 0.8, 2, float(ev.mean()))
    bf = bslmmdap.dap_calc_bf(UtXT, Uty, ev, grid)
    assert all(k.launches == 0 for k in kernels.ALL)
    assert out.t == 8 and out.w == 3 and out.alpha.dtype == torch.float64
    assert bf.shape == (p, 4) and np.isfinite(bf).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_crt_vc_varcov_wrappers_send_cpu_tensors_to_plain_versions(dtype):
    """K14's, K15's and K16's wrappers on CPU tensors, float32 and float64
    operands: plain versions only, no kernel built or launched."""
    import numpy as np
    from gemma_torch import kernels
    from gemma_torch.models import mvlmm_core, varcov, vc
    rng = np.random.default_rng(3)
    n, S, d = 20, 3, 2
    t = lambda a: torch.as_tensor(a, dtype=dtype)         # noqa: E731
    ev = t(np.sort(rng.uniform(0, 2, n)))
    X0 = torch.ones((1, n), dtype=dtype)
    R = t(rng.normal(size=(S, 1, n)))
    V = torch.eye(d, dtype=torch.float64).expand(S, d, d)
    H = -torch.eye(d * (d + 1), dtype=torch.float64).expand(S, 6, 6)
    K = t(rng.normal(size=(2, n, n)))
    kernels.reset_launches()
    crt = mvlmm_core.calc_crt(ev, X0, R, V, 0.5 * V, H)
    pc = vc.pair_colsum(K, K[:1])
    band = varcov.banded_cor(t(rng.normal(size=(8, n))), 5, 3)
    assert all(k.launches == 0 for k in kernels.ALL)
    assert all(x.shape == (S,) and bool(torch.isfinite(x).all())
               for x in crt)
    assert pc.shape == (2, 1, n) and pc.dtype == torch.float64
    assert band.shape == (5, 3) and band.dtype == dtype
