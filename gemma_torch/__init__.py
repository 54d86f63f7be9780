"""gemma_torch — the GEMMA-compatible LMM GWAS engine in PyTorch for
one NVIDIA H100.

The same flags, inputs and GEMMA-format output files as `gemma_tpu`,
which stays beside it as the reference.  Importing this package loads
no JAX and nothing of `gemma_tpu`.

Layering (bottom → top):
  csrc/, kernels/  hand-written CUDA kernels for sm_90a, built with
                   nvcc at first use and bound with ctypes.
  ops/             genotype decode/centre, kinship, centring, eigh,
                   survival functions, the Philox random stream.
  io/              genotype/phenotype ingestion, QC, writers (copies of
                   the reference package's host modules).
  models/lmm/      the univariate LMM: likelihood, λ search, engine.
  models/          the linear model, the multivariate LMM, BSLMM and
                   its DAP approximation, phenotype prediction.
  run.py           `batch_run`, the GEMMA mode dispatch.
"""

__version__ = "0.1.0"
