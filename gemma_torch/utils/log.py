"""Run log (.log.txt) with GEMMA-compatible field names.

Field layout follows GEMMA::WriteLog (gemma.cpp:3148-3596): version
banner, command line, date, dataset summary, null-model estimates,
per-phase timing breakdown (in minutes, as the reference reports).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

import gemma_torch


class PhaseTimer:
    """Accumulates wall-clock per phase (PARAM time_* fields)."""

    def __init__(self):
        self.times = {}
        self._t0 = time.time()

    @contextmanager
    def phase(self, name: str):
        start = time.time()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.time() - start)

    def minutes(self, name: str) -> float:
        return self.times.get(name, 0.0) / 60.0

    def total_minutes(self) -> float:
        return (time.time() - self._t0) / 60.0


def device_name(device: torch.device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class RunLog:
    def __init__(self, argv: list, timer: PhaseTimer | None = None,
                 quiet: bool = False, device: str = "cpu"):
        self.argv = argv
        self.timer = timer or PhaseTimer()
        self.quiet = quiet
        self.device = device
        self.summary = {}      # dataset summary lines (ordered dict semantics)
        self.null_model = {}   # null model estimates
        self.extra = []        # extra "## ..." lines

    def console_summary(self) -> None:
        """Mirror PrintSummary's console output (param.cpp:1252-1310)
        unless -silence was given (main.cpp:75-78)."""
        if self.quiet:
            return
        for k, v in self.summary.items():
            print(f"## {k} = {v}")

    def write(self, path: str, a_mode: int, n_ph: int = 1) -> None:
        self.console_summary()
        t = self.timer
        with open(path, "w") as fh:
            w = fh.write
            w("##\n")
            w(f"## GEMMA-TORCH Version = {gemma_torch.__version__}\n")
            w(f"## PyTorch Version   = {torch.__version__}\n")
            w(f"## Device            = {device_name(self.device)}\n")
            w("##\n")
            w("## Command Line Input = " + " ".join(self.argv) + " \n")
            w("##\n")
            w("## Date = " + time.asctime() + "\n")
            w("##\n")
            w("## Summary Statistics:\n")
            for k, v in self.summary.items():
                w(f"## {k} = {v}\n")
            if self.null_model:
                nm = self.null_model
                if "logl_remle_H0" in nm:
                    w("## REMLE log-likelihood in the null model = "
                      f"{nm['logl_remle_H0']:.6g}\n")
                if "logl_mle_H0" in nm:
                    w("## MLE log-likelihood in the null model = "
                      f"{nm['logl_mle_H0']:.6g}\n")
                if n_ph == 1 and "pve_null" in nm:
                    w(f"## pve estimate in the null model = {nm['pve_null']:.6g}\n")
                    w(f"## se(pve) in the null model = {nm['pve_se_null']:.6g}\n")
                    w(f"## vg estimate in the null model = {nm['vg_remle_null']:.6g}\n")
                    w(f"## ve estimate in the null model = {nm['ve_remle_null']:.6g}\n")
                    beta = nm.get("beta_remle_null", [])
                    w("## beta estimate in the null model = " +
                      "".join(f"  {b:.6g}" for b in beta) + "\n")
                    se = nm.get("se_beta_remle_null", [])
                    w("## se(beta) = " + "".join(f"  {s:.6g}" for s in se) + "\n")
            for line in self.extra:
                w(f"## {line}\n")
            w("##\n")
            w("## Computation Time:\n")
            w(f"## total computation time = {t.total_minutes():.6g} min \n")
            w("## computation time break down: \n")
            if a_mode in (21, 22):
                w(f"##      time on calculating relatedness matrix = "
                  f"{t.minutes('kinship') + t.minutes('readback'):.6g}"
                  f" min \n")
            if a_mode == 1:
                w(f"##      time on eigen-decomposition = "
                  f"{t.minutes('eigen'):.6g} min \n")
                w(f"##      time on calculating UtX = "
                  f"{t.minutes('utx'):.6g} min \n")
                w(f"##      time on optimization = "
                  f"{t.minutes('opt'):.6g} min \n")
            if a_mode in (71, 72):     # -calccor / -gw: the host's share
                for name, what in (("load", "reading genotypes"),
                                   ("opt", "calculating correlations"),
                                   ("write", "writing correlations")):
                    w(f"##      time on {what} = {t.minutes(name):.6g} "
                      "min \n")
            w("##\n")
