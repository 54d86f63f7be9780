"""BSLMM: the Bayesian sparse linear mixed model by MCMC (-bslmm 1/2/3).

Reference src/bslmm.cpp (Zhou, Carbonetto & Stephens 2013), through the
reference package's `gemma_tpu/models/bslmm.py`.  The model in the
kinship eigenbasis: y = X_gamma beta + u + e with a sparse effect set
gamma, u ~ N(0, sigma_b^2 tau^-1 diag(eval)), and Metropolis-Hastings
over (h, rho, log pi, gamma).

The chain is kernel K12 (`csrc/bslmm_chain.cu`): one thread block runs a
whole segment of iterations with the state on the card.  Its plain
version is the loop below, one iteration at a time.  Both draw from the
same counter-based stream (`ops/philox.py`): each draw is named by the
iteration t, its purpose in the MH step and its index, so kernel and
plain version draw the same numbers and a chain resumed at t continues
it.  The reference's jax.random stream cannot be replayed (ROADMAP §C6):
a chain of this package equals the reference's only in distribution,
while `calc_posterior` takes its draws as arguments so that tests can
feed it the reference's.

Layout: UtXT (p, n) holds the rotated genotypes as rows, in rank order
(row r = the SNP ranked r by the per-SNP likelihood ratio), so gathering
an active rank reads one contiguous row.  The active set is a list of
n_gamma ranks (sentinel p beyond it in `ChainState.ranks`); the
posterior factors the n_gamma × n_gamma Omega, which equals the
reference's s_max-padded factor on its leading block (the padding's
identity block adds 0 to log|Omega| and to beta).  Arithmetic is
float64 for float32 and float64 operands alike.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from gemma_torch import kernels
from gemma_torch.ops import philox

F64 = torch.float64

# the purposes of a draw within an MH step (the counter's stream word is
# mh * STREAM_STRIDE + purpose); the posterior's three draws take
# REFRESH (the probit refresh) or INIT (the starting state) on top
P_JUMP, P_H, P_LOGP, P_FLAG, P_ADD = 1, 2, 3, 4, 5
P_UTU, P_TAU, P_Z, P_ACC, P_TZ, P_MZ = 6, 7, 8, 9, 10, 11
REFRESH, INIT, STREAM_STRIDE = 16, 32, 64
# iterations a K12 launch runs at most
SEGMENT = 10000


@dataclasses.dataclass
class BslmmSettings:
    """Derived MCMC settings (PARAM defaults, param.cpp:1174-1199)."""
    ns_test: int
    ni_test: int
    s_min: int = 0
    s_max: int = 300
    h_min: float = 0.0
    h_max: float = 1.0
    rho_min: float = 0.0
    rho_max: float = 1.0
    logp_min: float = 0.0   # set from ns_test if 0
    logp_max: float = 0.0
    h_scale: float = -1.0
    rho_scale: float = -1.0
    logp_scale: float = -1.0
    geo_mean: float = 2000.0
    w_step: int = 100000
    s_step: int = 1000000
    r_pace: int = 10
    w_pace: int = 1000
    n_mh: int = 1            # a_mode 11 forces n_mh = 1 (param.cpp:1177)
    a_mode: int = 11

    def __post_init__(self):
        if self.logp_min == 0:
            self.logp_min = -np.log(self.ns_test)
        if self.h_scale == -1:
            self.h_scale = min(1.0, 10.0 / np.sqrt(self.ni_test))
        if self.rho_scale == -1:
            self.rho_scale = min(1.0, 10.0 / np.sqrt(self.ni_test))
        if self.logp_scale == -1:
            self.logp_scale = min(1.0, 5.0 / np.sqrt(self.ni_test))
        if self.h_min == -1:
            self.h_min = 0.0
        if self.h_max == -1:
            self.h_max = 1.0
        self.s_max = min(self.s_max, self.ns_test)

    def steps(self) -> tuple:
        """(d_h, d_rho, d_logp): the proposals' step widths
        (bslmm.py:290-292 of the reference)."""
        return ((self.h_max - self.h_min) * self.h_scale,
                (self.rho_max - self.rho_min) * self.rho_scale,
                min(0.1, (self.logp_max - self.logp_min) * self.logp_scale))

    def records_before(self, t: int) -> int:
        """Iterations t' in [w_step, t) with t' % r_pace == 0: the rows
        the chain has recorded before iteration t."""
        first = -(-self.w_step // self.r_pace) * self.r_pace
        return 0 if first >= t else (t - 1 - first) // self.r_pace + 1

    def n_records(self) -> int:
        """The rows the whole chain records."""
        return self.records_before(self.w_step + self.s_step)


def calc_p_gamma(ns_test: int, geo_mean: float) -> np.ndarray:
    """Rank proposal: 0.7 geometric(1/geo_mean) + 0.3 uniform,
    normalised (CalcPgamma, bslmm.cpp:311-324)."""
    i = np.arange(1, ns_test + 1)
    q = 1.0 / geo_mean
    p = 0.7 * q * (1 - q) ** (i - 1) + 0.3 / ns_test
    return p / p.sum()


def _reflect(x: float, lo: float, hi: float) -> float:
    if x < lo:
        x = 2 * lo - x
    if x > hi:
        x = 2 * hi - x
    return x


class ChainOperands(NamedTuple):
    """What the chain reads: UtXT (p, n) rows in rank order, Uty and eval
    (n,) in the operand dtype; the rank proposal's p_gamma and its
    cumulative sum (p,) in float64 (a float32 cumsum over 10^4 SNPs does
    not end at 1); for the probit model (a_mode 13) U (n, n) and the
    centred case/control labels y_labels (n,)."""
    UtXT: torch.Tensor
    Uty: torch.Tensor
    eval: torch.Tensor
    trace_G: float
    p_gamma: torch.Tensor
    cum_p: torch.Tensor
    U: torch.Tensor | None = None
    y_labels: torch.Tensor | None = None


def chain_operands(UtXT, Uty, eval_, trace_G: float, geo_mean: float,
                   U=None, y_labels=None) -> ChainOperands:
    p = UtXT.shape[0]
    dev = UtXT.device
    pg = calc_p_gamma(p, geo_mean)
    return ChainOperands(
        UtXT=UtXT.contiguous(), Uty=Uty.contiguous(),
        eval=eval_.contiguous(), trace_G=float(trace_G),
        p_gamma=torch.as_tensor(pg, dtype=F64, device=dev),
        cum_p=torch.as_tensor(np.cumsum(pg), dtype=F64, device=dev),
        U=None if U is None else U.contiguous(),
        y_labels=None if y_labels is None else y_labels.contiguous())


class ChainState(NamedTuple):
    """The chain after iterations [0, t): the reference's ChainState with
    the iteration counter t in place of its RNG key.  Vectors are float64
    (ranks and recorded gammas int32) on the operands' device; scalars
    are Python numbers."""
    t: int
    ranks: torch.Tensor        # (s_max,) int32, sentinel p beyond n_gamma
    n_gamma: int
    h: float
    rho: float
    logp: float
    logpost: float
    pve: float
    pge: float
    beta: torch.Tensor         # (s_max,) effects of the active ranks
    alpha: torch.Tensor        # (n,)
    Utu: torch.Tensor          # (n,)
    UtXb: torch.Tensor         # (n,)
    Utz: torch.Tensor          # (n,) working response: Uty, or (a_mode
                               # 13) the rotated latent liabilities
    mean_z: float
    acc_mean_z: float
    n_accept: int
    acc_alpha: torch.Tensor    # (n,)
    acc_Utu: torch.Tensor      # (n,)
    acc_beta: torch.Tensor     # (p,) summed effects per rank
    acc_betacnt: torch.Tensor  # (p,) inclusion counts per rank
    rec_hyp: torch.Tensor      # (n_rec, 6) h pve rho pge logp n_gamma
    rec_gamma: torch.Tensor    # (n_rec, s_max) int32 ranks + 1 (0 empty)
    w: int                     # rows recorded


_SCALARS = ("h", "rho", "logp", "logpost", "pve", "pge", "mean_z",
            "acc_mean_z")
_INTS = ("n_gamma", "n_accept", "w")
_VECTORS = ("ranks", "beta", "alpha", "Utu", "UtXb", "Utz", "acc_alpha",
            "acc_Utu", "acc_beta", "acc_betacnt", "rec_hyp", "rec_gamma")


# ---------------------------------------------------------------------------
# the marginal posterior at one state (CalcPosterior, bslmm.cpp:450-642)

class Posterior(NamedTuple):
    logpost: float
    beta: torch.Tensor     # (s_max,)
    UtXb: torch.Tensor     # (n,)
    alpha: torch.Tensor    # (n,)
    Utu: torch.Tensor      # (n,)
    pve: float
    pge: float


def posterior_draws(key: tuple, t: int, stream: int, ops: ChainOperands,
                    s_max: int, probit: bool) -> tuple:
    """(utu normals (n,), the gamma(n/2) draw, z normals (s_max,)) of the
    posterior evaluated at stream `stream` of iteration t; no gamma draw
    in the probit model, whose tau is 1."""
    n, dev = ops.eval.shape[0], ops.eval.device
    index = torch.cat([torch.arange(n, device=dev),
                       torch.arange(s_max, device=dev)])
    streams = torch.full_like(index, stream + P_UTU)
    streams[n:] = stream + P_Z
    ez = philox.normal_t(key, t, streams, index)
    g = 0.0 if probit else philox.gamma(key, t, stream + P_TAU, n / 2.0)
    return ez[:n], g, ez[n:]


def calc_posterior(ops: ChainOperands, st: BslmmSettings, uty: torch.Tensor,
                   ranks, n_gamma: int, h: float, rho: float, logp: float,
                   draws: tuple) -> Posterior:
    """The marginal log-posterior at (gamma, h, rho, log pi), with a draw
    of beta and u from their conditional posteriors (the reference's
    calc_posterior, bslmm.py:144-200), in float64.  `ranks` lists the
    n_gamma active ranks; `draws` = (utu_rand normals (n,), the gamma(n/2)
    draw, z normals (>= n_gamma,)), from `posterior_draws` or any
    source."""
    e_utu, g, z = draws
    p = ops.UtXT.shape[0]
    n = ops.eval.shape[0]
    dev = ops.eval.device
    probit = st.a_mode == 13
    ev = ops.eval.to(F64)
    uty = uty.to(F64)
    trace_G = ops.trace_G
    sigma_b2 = h * (1.0 - rho) / (trace_G * (1.0 - h))
    sigma_a2 = h * rho / (trace_G * (1.0 - h) * math.exp(logp) * p)

    d = ev * sigma_b2
    w_hi = 1.0 / (d + 1.0)
    logdet_H = float(-torch.log(w_hi).sum())
    hi_yy0 = float((w_hi * uty * uty).sum())
    utu_rand = e_utu.to(F64) * torch.sqrt(d * w_hi)
    use_x = n_gamma > 0 and rho != 0

    beta = torch.zeros(st.s_max, dtype=F64, device=dev)
    UtXb = torch.zeros(n, dtype=F64, device=dev)
    logdet_O = quad = 0.0
    Xg = None
    if n_gamma:
        idx = torch.as_tensor(list(ranks)[:n_gamma], dtype=torch.int64,
                              device=dev)
        Xg = ops.UtXT[idx].to(F64)                     # (n_gamma, n)
        Xw = Xg * w_hi
        Omega = sigma_a2 * (Xw @ Xg.T) + torch.eye(n_gamma, dtype=F64,
                                                   device=dev)
        XtHiy = Xw @ uty
        L = torch.linalg.cholesky(Omega)
        logdet_O = float(2.0 * torch.log(torch.diagonal(L)).sum())
        beta_hat = sigma_a2 * torch.cholesky_solve(XtHiy[:, None], L)[:, 0]
        quad = float(XtHiy @ beta_hat)
    P_yy = hi_yy0 - quad if use_x else hi_yy0
    tau = 1.0 if probit else g * (2.0 / P_yy)
    if n_gamma:
        # beta = beta_hat + sqrt(sigma_a2/tau) L^-T z (bslmm.cpp:582-590)
        zz = z[:n_gamma].to(F64)[:, None]
        bs = torch.linalg.solve_triangular(L.T, zz, upper=True)[:, 0]
        bs = bs * math.sqrt(sigma_a2 / tau) + beta_hat
        beta[:n_gamma] = bs
        if use_x:
            UtXb = bs @ Xg
    alpha = (uty - UtXb) * w_hi * sigma_b2
    scale_u = 1.0 if probit else math.sqrt(1.0 / tau)
    Utu = alpha * ev + utu_rand * scale_u

    pge_raw = float((UtXb * UtXb).sum()) / n
    uu = float((Utu * Utu).sum()) / n
    pve = pge_raw + uu if use_x else uu
    pge = pge_raw / max(pve, 1e-300) if use_x and pve != 0 else 0.0
    pve = pve / (pve + 1.0 / tau)

    logpost = -0.5 * logdet_H - (0.5 * logdet_O if use_x else 0.0)
    logpost -= 0.5 * P_yy if probit else 0.5 * n * math.log(P_yy)
    logpost += (n_gamma - 1.0) * logp + (p - n_gamma) * math.log(
        1.0 - math.exp(logp))
    return Posterior(logpost, beta, UtXb, alpha, Utu, pve, pge)


# ---------------------------------------------------------------------------
# the plain chain (the reference's make_mcmc_step and fori_loop)

class _Chain:
    """The plain version's constants: host copies of the rank proposal,
    the step widths and the key."""

    def __init__(self, ops: ChainOperands, st: BslmmSettings, seed: int):
        self.ops, self.st = ops, st
        self.key = philox.key_of(seed)
        self.p, self.n = ops.UtXT.shape
        self.pg = ops.p_gamma.cpu().numpy()
        self.cum_p = ops.cum_p.cpu().numpy()
        self.d_h, self.d_rho, self.d_logp = st.steps()
        self.probit = st.a_mode == 13

    def u2(self, t, stream, index=0, sub=0):
        return philox.unit2(self.key, t, stream, index, sub)

    def posterior(self, t, stream, uty, ranks, ng, h, rho, logp):
        draws = posterior_draws(self.key, t, stream, self.ops, self.st.s_max,
                                self.probit)
        return calc_posterior(self.ops, self.st, uty, ranks, ng, h, rho,
                              logp, draws)

    def new_rank(self, t, stream, i, ranks) -> int:
        """A rank drawn from p_gamma and not active: attempt k takes the
        draw (i, k) (the reference's bounded rejection, bslmm.py:202)."""
        k = 0
        while True:
            u, _ = self.u2(t, stream + P_ADD, i, k)
            r = min(int(np.searchsorted(self.cum_p, u)), self.p - 1)
            if r not in ranks:
                return r
            k += 1

    def propose_h_rho_pi(self, t, stream, s, repeat):
        st = self.st
        h, rho, logp, lr = s["h"], s["rho"], s["logp"], 0.0
        for i in range(repeat):
            uh, urho = self.u2(t, stream + P_H, i)
            ulp, _ = self.u2(t, stream + P_LOGP, i)
            h2 = _reflect(h + (uh - 0.5) * self.d_h, st.h_min, st.h_max)
            rho2 = _reflect(rho + (urho - 0.5) * self.d_rho, st.rho_min,
                            st.rho_max)
            logp2 = _reflect(logp + (ulp - 0.5) * self.d_logp, st.logp_min,
                             st.logp_max)
            lr = lr + (logp2 - logp)
            h, rho, logp = h2, rho2, logp2
        return h, rho, logp, lr

    def propose_gamma(self, t, stream, ranks, ng, repeat):
        """add/remove/swap with the proposal correction (ProposeGamma,
        bslmm.cpp:770-877); ranks sorted at the end."""
        st, pg = self.st, self.pg
        ranks = list(ranks)
        logmh = 0.0
        for i in range(repeat):
            uf, ud = self.u2(t, stream + P_FLAG, i)
            if uf < 0.40 and ng < st.s_max:
                flag = 1
            elif 0.40 <= uf < 0.80 and ng > st.s_min:
                flag = 2
            elif uf >= 0.80 and 0 < ng < self.p:
                flag = 3
            else:
                continue
            prob_act = 0.0
            for r in ranks:
                prob_act += pg[r]
            if flag != 2:
                r_add = self.new_rank(t, stream, i, ranks)
            if flag != 1:
                col = int(ud * ng)
                r_rem = ranks[col]
            if flag == 1:
                prob_total = 1.0 - prob_act
                logmh += -math.log(pg[r_add] / prob_total) - math.log(ng + 1.0)
                ranks.append(r_add)
                ng += 1
            elif flag == 2:
                prob_total = 1.0 - prob_act + pg[r_rem]
                logmh += math.log(pg[r_rem] / prob_total) + math.log(
                    max(float(ng), 1.0))
                ranks[col] = ranks[ng - 1]
                ranks.pop()
                ng -= 1
            else:
                prob_total = 1.0 - prob_act
                logmh += (math.log(pg[r_rem] / (prob_total + pg[r_rem]
                                                - pg[r_add]))
                          - math.log(pg[r_add] / prob_total))
                ranks[col] = r_add
        return sorted(ranks), ng, logmh

    def mh_step(self, t, m, s):
        stream = m * STREAM_STRIDE
        uj, ur = self.u2(t, stream + P_JUMP)
        repeat = 1 + int(ur * 20.0) if uj < 0.33 else 1
        h, rho, logp, lr_pi = self.propose_h_rho_pi(t, stream, s, repeat)
        ranks, ng, lr_g = self.propose_gamma(t, stream, s["ranks"],
                                             s["n_gamma"], repeat)
        post = self.posterior(t, stream, s["Utz"], ranks, ng, h, rho, logp)
        logmh = lr_pi + lr_g + post.logpost - s["logpost"]
        ua, _ = self.u2(t, stream + P_ACC)
        if logmh > 0 or math.log(ua) < logmh:
            s.update(ranks=ranks, n_gamma=ng, h=h, rho=rho, logp=logp,
                     **post._asdict())
            s["n_accept"] += 1

    def probit_refresh(self, t, s):
        """Resample the latent liabilities around z_hat (SampleZ,
        bslmm.cpp:689-713) and refresh the posterior at the current
        state (bslmm.cpp:1006-1026)."""
        ops = self.ops
        U = ops.U.to(F64)
        z_hat = U @ (s["UtXb"] + s["Utu"]) + s["mean_z"]
        case = ops.y_labels > 0
        # cases: eps > -z_hat; controls: eps < -z_hat, i.e. -eps > z_hat
        bound = torch.where(case, -z_hat, z_hat)
        x = philox.truncnorm_above_t(self.key, t, P_TZ, bound)
        z = z_hat + torch.where(case, x, -x)
        mean_z = float(z.mean())
        s["Utz"] = U.T @ (z - mean_z)
        s["mean_z"] = mean_z
        post = self.posterior(t, REFRESH, s["Utz"], s["ranks"], s["n_gamma"],
                              s["h"], s["rho"], s["logp"])
        s.update(post._asdict())

    def iteration(self, t, s):
        st = self.st
        if self.probit:
            self.probit_refresh(t, s)
        for m in range(st.n_mh):
            self.mh_step(t, m, s)
        if self.probit:
            s["mean_z"] = s["mean_z"] + philox.normal(
                self.key, t, P_MZ, 0) * math.sqrt(1.0 / self.n)
        # record every r_pace steps after burn-in (bslmm.cpp:1110-1149)
        if t >= st.w_step and t % st.r_pace == 0 and \
                s["w"] < s["rec_hyp"].shape[0]:
            w, ng = s["w"], s["n_gamma"]
            dev = s["alpha"].device
            s["rec_hyp"][w] = torch.tensor(
                [s["h"], s["pve"], s["rho"], s["pge"], s["logp"], float(ng)],
                dtype=F64, device=dev)
            if ng:
                idx = torch.as_tensor(s["ranks"], dtype=torch.int64,
                                      device=dev)
                s["rec_gamma"][w, :ng] = (idx + 1).to(torch.int32)
                s["acc_beta"].index_add_(0, idx, s["beta"][:ng])
                s["acc_betacnt"][idx] += 1.0
            s["acc_alpha"] += s["alpha"]
            s["acc_Utu"] += s["Utu"]
            s["acc_mean_z"] += s["mean_z"]
            s["w"] = w + 1


def _live(state: ChainState) -> dict:
    """A mutable copy of the state for the plain loop: ranks as the list
    of active ranks, every tensor cloned."""
    s = {f: getattr(state, f) for f in ChainState._fields}
    for f in _VECTORS:
        s[f] = s[f].clone()
    s["ranks"] = [int(r) for r in state.ranks[:state.n_gamma].tolist()]
    return s


def _frozen(s: dict, t: int, st: BslmmSettings, p: int) -> ChainState:
    ranks = torch.full((st.s_max,), p, dtype=torch.int32,
                       device=s["alpha"].device)
    ranks[:s["n_gamma"]] = torch.as_tensor(s["ranks"], dtype=torch.int32)
    out = dict(s, t=t, ranks=ranks)
    return ChainState(**{f: out[f] for f in ChainState._fields})


def check_records(st: BslmmSettings, state: ChainState, t1: int) -> None:
    """Raise unless [state.t, t1) lies within the chain and the state's
    record rows and count are the ones these settings give, so that every
    row the segment records lands inside its buffers."""
    n_rec = st.n_records()
    if not state.t <= t1 <= st.w_step + st.s_step:
        raise ValueError(f"BSLMM chain: segment [{state.t}, {t1}) outside "
                         f"the chain's {st.w_step + st.s_step} iterations")
    if (tuple(state.rec_hyp.shape) != (n_rec, 6)
            or tuple(state.rec_gamma.shape) != (n_rec, st.s_max)
            or state.w != st.records_before(state.t)):
        raise ValueError(
            f"BSLMM chain: the state holds {state.rec_hyp.shape[0]} record "
            f"rows with {state.w} written at t = {state.t}; these settings "
            f"give {n_rec} rows with {st.records_before(state.t)} written")


def bslmm_chain_plain(ops: ChainOperands, st: BslmmSettings,
                      state: ChainState, t1: int, seed: int) -> ChainState:
    """PyTorch version of K12: iterations [state.t, t1) one at a time."""
    check_records(st, state, t1)
    C = _Chain(ops, st, seed)
    s = _live(state)
    for t in range(state.t, t1):
        C.iteration(t, s)
    return _frozen(s, t1, st, C.p)


def chain_config(ops: ChainOperands, st: BslmmSettings) -> torch.Tensor:
    """The kernel's float64 settings: trace_G, the (h, rho, log pi)
    bounds and step widths."""
    vals = [ops.trace_G, st.h_min, st.h_max, st.rho_min, st.rho_max,
            st.logp_min, st.logp_max, *st.steps()]
    return torch.tensor(vals, dtype=F64, device=ops.eval.device)


def chain_scratch(n: int, s_max: int) -> int:
    """float64 words of K12's scratch (bslmm_chain_run in bslmm_chain.cu):
    two proposal slots (alpha, Utu, UtXb, beta), w_hi, two n-vectors of
    the probit step, Omega, three s_max vectors and the room for the three
    s_max int rank lists, which the kernel keeps there only where they
    outgrow its shared memory."""
    return (2 * (3 * n + s_max) + 3 * n + s_max * s_max + 3 * s_max
            + (3 * s_max + 1) // 2)


def bslmm_chain_cuda(ops: ChainOperands, st: BslmmSettings,
                     state: ChainState, t1: int, seed: int) -> ChainState:
    """K12 on the card: one launch runs iterations [state.t, t1).  The
    state's tensors are cloned and the kernel updates the clones."""
    dt = ops.UtXT.dtype
    kern = kernels.variant(kernels.BSLMM_CHAIN, kernels.BSLMM_CHAIN_F64, dt)
    p, n = ops.UtXT.shape
    kernels.check_bslmm_shape(st.s_max)
    check_records(st, state, t1)
    co = kernels.check_operand
    co(ops.UtXT, "UtXT", dt, (p, n))
    co(ops.eval, "eval", dt, (n,))
    co(ops.p_gamma, "p_gamma", F64, (p,))
    co(ops.cum_p, "cum_p", F64, (p,))
    probit = st.a_mode == 13
    if probit:
        co(ops.U, "U", dt, (n, n))
        co(ops.y_labels, "y_labels", dt, (n,))
    dev = ops.UtXT.device
    out = {f: getattr(state, f).clone() for f in _VECTORS}
    n_rec = out["rec_hyp"].shape[0]
    for f, shape in (("ranks", (st.s_max,)), ("beta", (st.s_max,)),
                     ("alpha", (n,)), ("Utu", (n,)), ("UtXb", (n,)),
                     ("Utz", (n,)), ("acc_alpha", (n,)), ("acc_Utu", (n,)),
                     ("acc_beta", (p,)), ("acc_betacnt", (p,)),
                     ("rec_hyp", (n_rec, 6)),
                     ("rec_gamma", (n_rec, st.s_max))):
        co(out[f], f, torch.int32 if f in ("ranks", "rec_gamma") else F64,
           shape)
    scal = torch.tensor([getattr(state, f) for f in _SCALARS], dtype=F64,
                        device=dev)
    ints = torch.tensor([getattr(state, f) for f in _INTS],
                        dtype=torch.int32, device=dev)
    cfg = chain_config(ops, st)
    work = torch.empty(chain_scratch(n, st.s_max), dtype=F64, device=dev)
    if t1 > state.t:
        kern.launch(
            dev, state.t, t1, n, p, st.s_max, st.s_min, st.n_mh, st.a_mode,
            st.w_step, st.r_pace, int(seed) & 0xFFFFFFFFFFFFFFFF,
            cfg.data_ptr(), ops.UtXT.data_ptr(), ops.eval.data_ptr(),
            ops.cum_p.data_ptr(), ops.p_gamma.data_ptr(),
            ops.U.data_ptr() if probit else None,
            ops.y_labels.data_ptr() if probit else None,
            scal.data_ptr(), ints.data_ptr(),
            *(out[f].data_ptr() for f in _VECTORS), n_rec, work.data_ptr())
    vals = dict(zip(_SCALARS, scal.tolist()))
    vals.update(zip(_INTS, ints.tolist()))
    return ChainState(t=t1, **vals, **out)


def bslmm_chain(ops: ChainOperands, st: BslmmSettings, state: ChainState,
                t1: int, seed: int) -> ChainState:
    """Iterations [state.t, t1) of the chain (K12 on the card)."""
    if ops.UtXT.device.type == "cpu":
        return bslmm_chain_plain(ops, st, state, t1, seed)
    return bslmm_chain_cuda(ops, st, state, t1, seed)


def init_state(ops: ChainOperands, st: BslmmSettings, h0: float, rho0: float,
               logp0: float, n_gamma0: int, seed: int) -> ChainState:
    """The chain's state before iteration 0: the top n_gamma0 ranks
    active, and the posterior there (its draws at stream INIT of t = 0)."""
    p, n = ops.UtXT.shape
    dev = ops.UtXT.device
    key = philox.key_of(seed)
    ranks = list(range(n_gamma0))
    uty = ops.Uty.to(F64)
    post = calc_posterior(
        ops, st, uty, ranks, n_gamma0, h0, rho0, logp0,
        posterior_draws(key, 0, INIT, ops, st.s_max, st.a_mode == 13))
    n_rec = st.n_records()

    def zeros(*shape, dtype=F64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    s = dict(ranks=ranks, n_gamma=n_gamma0, h=float(h0), rho=float(rho0),
             logp=float(logp0), Utz=uty.clone(), mean_z=0.0, acc_mean_z=0.0,
             n_accept=0, acc_alpha=zeros(n), acc_Utu=zeros(n),
             acc_beta=zeros(p), acc_betacnt=zeros(p),
             rec_hyp=zeros(n_rec, 6),
             rec_gamma=zeros(n_rec, st.s_max, dtype=torch.int32), w=0,
             **post._asdict())
    return _frozen(s, 0, st, p)


def chain_id(ops: ChainOperands, st: BslmmSettings) -> np.ndarray:
    """What a checkpoint must match to be resumed: every setting (the
    burn-in/sampling split and r_pace size the record buffers), n and p."""
    return np.array([*dataclasses.astuple(st), *ops.UtXT.shape],
                    dtype=np.float64)


def save_checkpoint(path: str, state: ChainState, chain: np.ndarray,
                    seed: int) -> None:
    payload = {f: (getattr(state, f).cpu().numpy() if f in _VECTORS
                   else np.asarray(getattr(state, f)))
               for f in ChainState._fields}
    payload.update(chain=chain, seed=seed)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, chain: np.ndarray, total: int, seed: int,
                    device) -> ChainState | None:
    """The state saved at `path` if it belongs to this chain (the same
    chain_id and seed) and is unfinished; else None."""
    if not os.path.exists(path):
        return None
    ck = np.load(path)
    if "chain" not in ck.files or not np.array_equal(ck["chain"], chain) \
            or int(ck["seed"]) != seed or int(ck["t"]) >= total:
        return None
    vals = {}
    for f in ChainState._fields:
        if f in _VECTORS:
            vals[f] = torch.as_tensor(ck[f], device=device)
        elif f in _SCALARS:
            vals[f] = float(ck[f])
        else:
            vals[f] = int(ck[f])
    return ChainState(**vals)


def run_mcmc(ops: ChainOperands, st: BslmmSettings, h0: float, rho0: float,
             logp0: float, n_gamma0: int, seed: int = 0,
             checkpoint_path: str | None = None, checkpoint_every: int = 0,
             on_segment: Callable | None = None) -> ChainState:
    """Run the whole chain, w_step + s_step iterations, on the operands'
    device: one K12 launch per segment of at most SEGMENT iterations on
    the card, the plain loop on the CPU.

    With a checkpoint path and stride the state lands in an .npz every
    `checkpoint_every` iterations (and `on_segment(state)` flushes partial
    results then, as the reference's w_pace writes do); a killed run
    resumes from it and ends in the same state as an uninterrupted one.
    The port's .npz holds its own state, not the reference's."""
    total = st.w_step + st.s_step
    ckpt = bool(checkpoint_path) and checkpoint_every > 0
    cid = chain_id(ops, st)
    state = None
    if ckpt:
        state = load_checkpoint(checkpoint_path, cid, total, seed,
                                ops.UtXT.device)
    if state is None:
        state = init_state(ops, st, h0, rho0, logp0, n_gamma0, seed)
    while state.t < total:
        stop = min(state.t + SEGMENT, total)
        if ckpt:
            stop = min(stop, (state.t // checkpoint_every + 1)
                       * checkpoint_every)
        state = bslmm_chain(ops, st, state, stop, seed)
        if ckpt and (stop % checkpoint_every == 0 or stop == total):
            save_checkpoint(checkpoint_path, state, cid, seed)
            if on_segment is not None:
                on_segment(state)
    return state


def ridge_gblup(UtXT, Uty, eval_, lam):
    """-bslmm 2: GBLUP / ridge (RidgeR, bslmm.cpp:1194-1222), with UtXT
    (p, n).  Returns (alpha (p,), breeding values in rotated space (n,))."""
    H = lam * eval_ + 1.0
    bv_rot = Uty / H
    alpha = (lam / UtXT.shape[0]) * (UtXT @ bv_rot)
    u_rot = (H - 1.0) * bv_rot
    return alpha, u_rot
