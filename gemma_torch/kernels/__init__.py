"""The port's hand-written CUDA kernels: build, bind, count launches.

Each kernel is a `.cu` file under `gemma_torch/csrc/` with a plain C
entry point `<name>_launch(...)` that launches on the stream it is given
and returns `cudaGetLastError()`.  `nvcc` compiles each source into its
own shared library under `build/gemma_torch/` at the root of the
checkout, at first use, and `ctypes` binds it:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/gemma_torch/lib<name>-<hash>.so <name>.cu

The library name carries a hash of the source, the shared headers
(`*.cuh`) and the flags, so an edited source is rebuilt.  `build_all()`
starts one `nvcc` per library at once.  A source may hold a float64
instantiation beside its float32 kernel: that is a `Kernel` of its own
(name `<name>_f64`, entry point `<name>_f64_launch`) with its own count,
built into the same library, or, for the mvLMM's K9, K10 and K11, whose
precisions each take most of their source's build, into one of its own
(`only`: the source compiled with `-DGT_ONLY=32` or `64`).

Every `Kernel` keeps `launches`, a plain count that its wrapper raises
by one where it launches the kernel and nowhere else; a run reads them
to show which kernels its path went through.  Nothing here is imported
from or falls back to a CPU path: wrappers send CPU tensors to their
plain PyTorch versions and CUDA tensors here.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gemma_torch.models.lmm.indices import pab_indices

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
REPO_ROOT = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "gemma_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the share of the card's free memory that the scratch of one split
# launch may take (launch_lanes)
SCRATCH_SHARE = 0.25
# lanes that one launch may take; None: as many as SCRATCH_SHARE of the
# card's free memory holds the scratch of.  chip_smoke.py sets a few to
# hold a forced split against one unsplit call
split_lanes: int | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "gemma_torch's kernels (set CUDA_HOME)")


class Kernel:
    """One CUDA kernel: its source, its C entry point, its launch count."""

    def __init__(self, name: str, argtypes: tuple, replaces: str,
                 source: str | None = None, only: int = 0):
        self.name = name
        self.stem = source or name
        self.source = os.path.join(CSRC_DIR, f"{self.stem}.cu")
        # nonzero: the source is built with -DGT_ONLY=<only> into a
        # library of this entry point's own, so that nvcc compiles a
        # source's precisions at once (each is most of its build time)
        self.only = only
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        # launches beyond the first that a lane split added (launch_lanes)
        self.splits = 0
        # CTAs in the thread-block cluster of the last launch (K12)
        self.cluster = 0
        self._fn = None
        self._err = None
        self._lib = None
        self._sizes = {}   # query's answers

    @property
    def lib_stem(self) -> str:
        return f"{self.stem}_{self.only}" if self.only else self.stem

    def _flags(self) -> tuple:
        return NVCC_FLAGS + ((f"-DGT_ONLY={self.only}",) if self.only
                             else ())

    def library_path(self) -> str:
        h = hashlib.sha256(" ".join(self._flags()).encode())
        headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
        for path in [self.source] + [os.path.join(CSRC_DIR, f)
                                     for f in headers]:
            with open(path, "rb") as fh:
                h.update(fh.read())
        return os.path.join(BUILD_DIR,
                            f"lib{self.lib_stem}-{h.hexdigest()[:12]}.so")

    def build(self) -> str:
        """Compile the source unless its library exists; returns the
        library path.  ptxas's register/shared-memory report lands
        beside it as `<lib_stem>.ptxas.txt`."""
        lib = self.library_path()
        if os.path.exists(lib):
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *self._flags(), "-o", tmp, self.source]
        res = subprocess.run(cmd, capture_output=True, text=True)
        with open(os.path.join(BUILD_DIR, f"{self.lib_stem}.ptxas.txt"),
                  "w") as fh:
            fh.write(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, lib)
        return lib

    def _load(self):
        lib = self._lib = ctypes.CDLL(self.build())
        fn = getattr(lib, f"{self.name}_launch")
        fn.argtypes = list(self.argtypes) + [_P]     # ..., stream
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.stem}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def launch(self, device: torch.device, *args) -> None:
        """Launch on `device`'s current stream; raise on a refused launch."""
        if self._fn is None:
            self._load()
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc}: "
                               f"{self._err(rc).decode()}")
        self.launches += 1

    def query(self, what: str, *args: int) -> int:
        """The kernel's C size function `<name>_<what>` at these sizes
        (pure: each answer is kept)."""
        key = (what,) + args
        if key not in self._sizes:
            if self._fn is None:
                self._load()
            fn = getattr(self._lib, f"{self.name}_{what}")
            fn.argtypes = [_I] * len(args)
            fn.restype = ctypes.c_long
            self._sizes[key] = int(fn(*args))
        return self._sizes[key]

    def lane_bytes(self, *args: int) -> int:
        """Bytes of scratch a lane of this kernel needs at these sizes
        (its C function `<name>_lane_bytes`); 0 where the kernel runs a
        fixed instantiation without scratch."""
        return self.query("lane_bytes", *args)

    def launch_lanes(self, device: torch.device, S: int, lane_bytes: int,
                     args) -> None:
        """Launch over S lanes.  `args(s0, count, scratch)` gives the
        launch's arguments for lanes [s0, s0 + count) and the address of
        a scratch of lane_bytes a lane.  Without scratch one launch takes
        every lane; with it the lanes are split into launches whose scratch
        fits SCRATCH_SHARE of the card's free memory, one scratch reused by
        all.  Where `split_lanes` is set, no launch takes more lanes than
        that.  Lanes are independent, so the split changes no lane's
        result."""
        if not S or not (lane_bytes or split_lanes):
            self.launch(device, *args(0, S, None))
            return
        per, ptr = min(S, split_lanes or S), None
        if lane_bytes:
            free = torch.cuda.mem_get_info(device)[0]
            per = min(per, max(1, int(free * SCRATCH_SHARE) // lane_bytes))
            scratch = torch.empty(lane_bytes * per, dtype=torch.uint8,
                                  device=device)
            ptr = scratch.data_ptr()
        # launches of `per` lanes each
        self.splits += run_lanes(S, 1, per, lambda a, b: self.launch(
            device, *args(a, b - a, ptr))) - 1


def lane_ranges(S: int, lane_bytes: int, budget: int) -> list:
    """[a, b) ranges that cover lanes 0..S once, in order, each of at
    most max(1, budget // lane_bytes) lanes."""
    per = max(1, budget // lane_bytes)
    return [(a, min(a + per, S)) for a in range(0, S, per)]


def run_lanes(S: int, lane_bytes: int, budget: int, fn) -> int:
    """Call fn(a, b) on each of lane_ranges(S, lane_bytes, budget);
    returns the number of calls."""
    ranges = lane_ranges(S, lane_bytes, budget)
    for a, b in ranges:
        fn(a, b)
    return len(ranges)


_PROLOGUE_ARGS = (_P, _I, _I, _I, _I, _I, _I, _I, _P)
_PROLOGUE_REPLACES = (
    "gemma_tpu/ops/pack2.py:56 unpack_bed + gemma_tpu/parallel/shard.py:41 "
    "impute_rows + gemma_tpu/ops/kinship.py:32 center_genotype_block")
GENO_PROLOGUE = Kernel("geno_prologue", _PROLOGUE_ARGS, _PROLOGUE_REPLACES)
GENO_PROLOGUE_F64 = Kernel("geno_prologue_f64", _PROLOGUE_ARGS,
                           _PROLOGUE_REPLACES, source="geno_prologue")
# K2-K7 end in (s0, count, scratch): the lanes of the launch and, above
# 32 covariates (GT_DYN), their scratch (launch_lanes); K8 ends in its
# scratch.  K3 and K7 take before them the launch's lane counter (an
# int32 at 0), from which their teams take the lanes
_LANES = (_I, _I, _P)
LAMBDA_GRID = Kernel(
    "lambda_grid",
    (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P) + _LANES,
    "gemma_tpu/models/lmm/likelihood.py:380 dev1_grid (recurrence epilogue)")
LAMBDA_SOLVE = Kernel(
    "lambda_solve",
    (_P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _D,
     _D, _D, _I, _D, _P, _P, _P) + _LANES,
    "gemma_tpu/models/lmm/optimize.py:247 calc_lambda (float32 bracket/"
    "Newton loop :307-434, _newton_batched :186, dev12 likelihood.py:441, "
    "logf_stable likelihood.py:269)")
# K4 and K5 share one argument list: lam is (S,) for Wald, (1,) for score
# (or (S,), one null λ per lane); then the lanes' strides of λ, UtWy,
# wy_prod and Utx (0 = shared)
_TAIL_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
              _I, _P, _P, _P) + _LANES
_WALD_REPLACES = ("gemma_tpu/models/lmm/likelihood.py:488 wald_stats + "
                  "gemma_tpu/ops/stats.py:21 f_sf")
_SCORE_REPLACES = ("gemma_tpu/models/lmm/likelihood.py:519 score_stats + "
                   "gemma_tpu/ops/stats.py:21 f_sf")
WALD_TAIL = Kernel("wald_tail", _TAIL_ARGS, _WALD_REPLACES)
WALD_TAIL_F64 = Kernel("wald_tail_f64", _TAIL_ARGS, _WALD_REPLACES,
                       source="wald_tail")
SCORE_TAIL = Kernel("score_tail", _TAIL_ARGS, _SCORE_REPLACES)
SCORE_TAIL_F64 = Kernel("score_tail_f64", _TAIL_ARGS, _SCORE_REPLACES,
                        source="score_tail")
LRT_TAIL = Kernel(
    "lrt_tail",
    (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _D, _P, _P, _I, _P, _P)
    + _LANES,
    "gemma_tpu/ops/stats.py:46 chisq_sf + gemma_tpu/models/lmm/engine.py:163 "
    "(the LRT difference)")
LAMBDA_SOLVE_F64 = Kernel(
    "lambda_solve_f64",
    (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _D, _D, _D,
     _D, _I, _I, _D, _P, _P, _P) + _LANES,
    "gemma_tpu/models/lmm/optimize.py:247 calc_lambda (float64 branch: "
    "per-point dev1 scan :300-302, _brent_batched :66, _newton_batched "
    ":186, logf likelihood.py:237)")
_LM_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
            _P)
_LM_REPLACES = ("gemma_tpu/models/lm.py:38 lm_block + :68 lm_gene_block "
                "(with gemma_tpu/ops/stats.py:21 f_sf, :46 chisq_sf)")
LM_TAIL = Kernel("lm_tail", _LM_ARGS, _LM_REPLACES)
LM_TAIL_F64 = Kernel("lm_tail_f64", _LM_ARGS, _LM_REPLACES,
                     source="lm_tail")

# the mvLMM kernels K9-K11: the lane operands eval, X0 (c0, n), Y (d, n)
# and R (S, r, n) in the operand type, starting values in float64 at a
# lane stride (0 = shared), outputs float64
# ...; then the launch's lane counter (an int32 at 0, from which the
# lanes' teams take them, as K3's) and (s0, count, scratch): the lanes of
# the launch and the run-time-sized form's scratch beyond d = 8 or 10
# design rows (K11 and K14 take scratch at every shape; launch_lanes)
_EM_ARGS = (_I, _I, _I, _D, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
            _P, _I, _P, _P, _P, _P, _P, _P, _P) + _LANES
_EM_REPLACES = "gemma_tpu/models/mvlmm_core.py:225 mph_em"
MPH_EM = Kernel("mph_em", _EM_ARGS, _EM_REPLACES, only=32)
MPH_EM_F64 = Kernel("mph_em_f64", _EM_ARGS, _EM_REPLACES, source="mph_em",
                    only=64)
_P_ARGS = (_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P,
           _P, _P, _P, _P, _P) + _LANES
_P_REPLACES = ("gemma_tpu/models/mvlmm_core.py:712 mph_calc_p + "
               "gemma_tpu/ops/stats.py:46 chisq_sf")
MPH_CALC_P = Kernel("mph_calc_p", _P_ARGS, _P_REPLACES, only=32)
MPH_CALC_P_F64 = Kernel("mph_calc_p_f64", _P_ARGS, _P_REPLACES,
                        source="mph_calc_p", only=64)
_NR_ARGS = (_I, _I, _D, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P,
            _P, _P, _P, _P) + _LANES
_NR_REPLACES = ("gemma_tpu/models/mvlmm_core.py:439 mph_nr (with "
                "_nr_logl_fn :393, _is_pd :423)")
MPH_NR = Kernel("mph_nr", _NR_ARGS, _NR_REPLACES, only=32)
MPH_NR_F64 = Kernel("mph_nr_f64", _NR_ARGS, _NR_REPLACES, source="mph_nr",
                    only=64)

# K12, the BSLMM chain: segment, shapes and settings, the seed, then the
# operands, the state and the scratch (models/bslmm.py bslmm_chain_cuda)
_CHAIN_ARGS = (_I,) * 10 + (ctypes.c_uint64,) + (_P,) * 21 + (_I, _P)
_CHAIN_REPLACES = ("gemma_tpu/models/bslmm.py:121 make_mcmc_step "
                   "(calc_posterior :144, sample_new_rank :202, "
                   "propose_gamma :227, propose_h_rho_pi :289, mh_step :315, "
                   "iteration :353) + :421 run_mcmc (fori_loop :461-463)")
BSLMM_CHAIN = Kernel("bslmm_chain", _CHAIN_ARGS, _CHAIN_REPLACES)
BSLMM_CHAIN_F64 = Kernel("bslmm_chain_f64", _CHAIN_ARGS, _CHAIN_REPLACES,
                         source="bslmm_chain")
# K13, the DAP Bayes-factor epilogue
_BF_ARGS = (_P, _P, _P, _P, _P, _D, _I, _I, _I, _P)
_BF_REPLACES = "gemma_tpu/models/bslmmdap.py:43 _bf_table"
DAP_BF = Kernel("dap_bf", _BF_ARGS, _BF_REPLACES)
DAP_BF_F64 = Kernel("dap_bf_f64", _BF_ARGS, _BF_REPLACES, source="dap_bf")

# K14, the mvLMM -crt factors (float64 operands; -crt runs in float64):
# shapes, then eval, X0, R, Vg, Ve, Hvar, the (3, S) output and the lanes
CALC_CRT = Kernel(
    "calc_crt", (_I,) * 5 + (_P,) * 7 + _LANES,
    "gemma_tpu/models/mvlmm_core.py:681 calc_crt (_calc_crt_one :561; from "
    "gemma_tpu/models/mvlmm.py:322 _crt_block)")
# K15, the pair column sums of -vc: ma, mb, n, same, the row slices
# (rows, ns), the columns a thread reads, A, B, the output's row of
# matrices (mb of the whole output), the slices' partial sums and the
# output
_PC_ARGS = (_I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P)
_PC_REPLACES = ("gemma_tpu/models/vc.py:50 _he_core (:74), :135 _reml_dev12 "
                "(:154), :262 _acl_moments (:285): the Hadamard pair sums")
PAIR_COLSUM = Kernel("pair_colsum", _PC_ARGS, _PC_REPLACES)
PAIR_COLSUM_F64 = Kernel("pair_colsum_f64", _PC_ARGS, _PC_REPLACES,
                         source="pair_colsum")
# K16, the correlation band of -calccor/-gw: R, n, S, bw, X, out
_BC_ARGS = (_I, _I, _I, _I, _P, _P)
_BC_REPLACES = "gemma_tpu/models/varcov.py:51 _banded_cor"
BANDED_COR = Kernel("banded_cor", _BC_ARGS, _BC_REPLACES)
BANDED_COR_F64 = Kernel("banded_cor_f64", _BC_ARGS, _BC_REPLACES,
                        source="banded_cor")

ALL = (GENO_PROLOGUE, LAMBDA_GRID, LAMBDA_SOLVE, WALD_TAIL, SCORE_TAIL,
       LRT_TAIL, LAMBDA_SOLVE_F64, GENO_PROLOGUE_F64, WALD_TAIL_F64,
       SCORE_TAIL_F64, LM_TAIL, LM_TAIL_F64, MPH_EM, MPH_EM_F64, MPH_CALC_P,
       MPH_CALC_P_F64, MPH_NR, MPH_NR_F64, BSLMM_CHAIN, BSLMM_CHAIN_F64,
       DAP_BF, DAP_BF_F64, CALC_CRT, PAIR_COLSUM, PAIR_COLSUM_F64,
       BANDED_COR, BANDED_COR_F64)


def variant(k32: Kernel, k64: Kernel, dtype: torch.dtype) -> Kernel:
    """The float32 or float64 instantiation of a kernel for `dtype`."""
    if dtype == torch.float32:
        return k32
    if dtype == torch.float64:
        return k64
    raise TypeError(f"{k32.name} takes float32 or float64 operands, got "
                    f"{dtype}")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of `device`'s card, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def build_all() -> dict:
    """Build every kernel, one nvcc per library, all started together;
    returns each library's seconds from the start to its end (about 0
    where it was built already)."""
    sources = {k.lib_stem: k for k in ALL}
    t0 = time.perf_counter()

    def build(k):
        k.build()
        return time.perf_counter() - t0
    with ThreadPoolExecutor(len(sources)) as pool:
        futs = {stem: pool.submit(build, k) for stem, k in sources.items()}
        return {stem: fut.result() for stem, fut in futs.items()}


def reset_launches() -> None:
    for k in ALL:
        k.launches = 0
        k.splits = 0


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  shape: tuple | None = None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape`, where given): what the kernels take."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def check_mvlmm_shape(d: int, c: int) -> None:
    if d < 2 or c < 1:
        raise ValueError(f"the mvLMM kernels take at least 2 phenotypes and "
                         f"1 design row, got {d} and {c}")


def check_bslmm_shape(s_max: int) -> None:
    if s_max < 1:
        raise ValueError(f"the BSLMM chain kernel takes s_max >= 1, got "
                         f"{s_max}")


def check_n_cvt(n_cvt: int) -> None:
    if n_cvt < 0:
        raise ValueError(f"the kernels take n_cvt >= 0, got {n_cvt}")


@functools.lru_cache(maxsize=64)
def pab_tables(n_cvt: int, device: str) -> torch.Tensor:
    """The Pab index tables as one int32 tensor in the layout of
    csrc/common.cuh: aw | bw | ww | diag | kind | col."""
    idx = pab_indices(n_cvt)
    kind = np.full(idx.n_index, 2, np.int32)
    col = np.zeros(idx.n_index, np.int32)
    for i, p in enumerate(idx.wy_positions):
        kind[p], col[p] = 0, i
    for p, j in zip(idx.xw_positions, idx.xw_partners):
        col[p] = j
    kind[idx.xx] = 1
    flat = np.concatenate([idx.aw.ravel(), idx.bw.ravel(), idx.ww,
                           idx.diag, kind, col]).astype(np.int32)
    return torch.as_tensor(flat, device=device)
