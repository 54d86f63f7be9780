"""Precision policy.

GEMMA computes everything in float64.  On the card float32 is the
speed mode (the default there); float64 is the reference-parity mode,
on the card (the float64 kernels: K1/K4/K5 instantiations and K7) or on
the CPU.

Every numerical entry point takes an explicit torch dtype; nothing
relies on `torch.get_default_dtype()`.
"""

from __future__ import annotations

import torch


def resolve_dtype(precision: str, device: torch.device) -> torch.dtype:
    """Map a config string to a torch dtype for `device`.

    "auto" selects float32 on cuda and float64 on cpu."""
    device = torch.device(device)
    if precision == "auto":
        return torch.float32 if device.type == "cuda" else torch.float64
    if precision == "float32":
        return torch.float32
    if precision == "float64":
        return torch.float64
    raise ValueError(f"unknown precision {precision!r}")


def apply_matmul_precision() -> None:
    """Keep float32 products in full float32.

    NVIDIA TF32 keeps 10 mantissa bits — it is NOT the bf16x3 pass the
    reference package calls "tensorfloat32" on a TPU — and 8-bit
    products alone moved p_wald by ~1e-2 there, outside the 1e-3
    speed-mode contract.  Both switches are set explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
