"""Counter-based random numbers: Philox4x32-10 keyed by the seed.

The BSLMM chain (kernel K12, `csrc/bslmm_chain.cu`) draws its random
numbers inside the kernel, and its plain PyTorch version has to draw the
same ones, so the stream cannot be `torch.Generator`'s (no kernel can
replay it) or jax's threefry.  Philox4x32-10 (Salmon et al. 2011, the
generator of Random123 and cuRAND) maps a 128-bit counter and a 64-bit
key to 128 random bits with integer arithmetic only, so the kernel
(`csrc/philox.cuh`) and these functions give the same bits.

A draw's counter names it: (index, sub, stream, t) — the element (an
individual, a rank slot), the attempt of a rejection loop, the purpose
within the MH step (`stream`) and the chain's iteration t.  The key is
the seed's two 32-bit halves.  No draw depends on which thread or which
call makes it, so a chain resumed at iteration t continues the same
stream.

From one block of four words: two uniforms in (0, 1) of 52 bits each,
(k + 1/2) 2^-52, exact in float64; a normal by Box-Muller (the cosine
branch); gamma(a) by Marsaglia-Tsang (boosted by U^(1/a) below a = 1); a
normal truncated to (a, ∞) by rejection from N(0, 1) where a < 0 and by
Robert's exponential proposal where a >= 0, which stays exact however
far into the tail a lies.  Rejection loops take attempt k from sub = k
(two blocks, 2k and 2k + 1, for a gamma attempt).

`philox4x32` computes on int64 tensors (the 32x32-bit products split
into 16-bit halves, so nothing overflows int64) and equally on Python
ints: the chain's plain version draws its scalars with ints and its
vectors with tensors.
"""

from __future__ import annotations

import math

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
TWO_PI = 6.283185307179586
_UNIT = 2.0 ** -52
GAMMA_BOOST_SUB = 0xFFFFFFFF     # the sub of the U^(1/a) draw, a < 1


def key_of(seed: int) -> tuple:
    """The 64-bit key: the seed's low and high 32-bit words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK, seed >> 32


def _mulhilo(a, m):
    """(high, low) 32-bit words of a * m for a, m < 2^32, on int64
    tensors: a in 16-bit halves, so no product passes 2^48."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    s = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (s >> 32), s & _MASK


def _philox_int(c0: int, c1: int, c2: int, c3: int, key: tuple):
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & _MASK,
                          (p0 >> 32) ^ c3 ^ k1, p0 & _MASK)
    return c0, c1, c2, c3


def philox4x32(c0, c1, c2, c3, key: tuple):
    """Philox4x32-10 of the counter (c0, c1, c2, c3) under `key`: four
    words in [0, 2^32), as int64 tensors (broadcast together) or, given
    Python ints, as ints."""
    if isinstance(c0, int):
        return _philox_int(c0, c1, c2, c3, key)
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    dev = c0.device
    shape = (2,) + (1,) * c0.dim()
    m = torch.tensor([_M0, _M1], dtype=torch.int64, device=dev).view(shape)
    a = torch.stack([c0, c2])          # the words multiplied
    b = torch.stack([c1, c3])
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi, lo = _mulhilo(a, m)
        k = torch.tensor([k0, k1], dtype=torch.int64, device=dev).view(shape)
        a, b = hi.flip(0) ^ b ^ k, lo.flip(0)
    return a[0], b[0], a[1], b[1]


def unit2(key: tuple, t: int, stream: int, index: int, sub: int = 0):
    """Two uniforms in (0, 1) of one block, as Python floats."""
    x0, x1, x2, x3 = philox4x32(index, sub, stream, t, key)
    return ((((x0 >> 6) << 26) | (x1 >> 6)) + 0.5) * _UNIT, \
        ((((x2 >> 6) << 26) | (x3 >> 6)) + 0.5) * _UNIT


def normal(key: tuple, t: int, stream: int, index: int, sub: int = 0):
    u1, u2 = unit2(key, t, stream, index, sub)
    return math.sqrt(-2.0 * math.log(u1)) * math.cos(TWO_PI * u2)


def _counter(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64)
    return torch.as_tensor(v, dtype=torch.int64, device=device)


def unit2_t(key: tuple, t: int, stream, index: torch.Tensor, sub=0):
    """Two uniform tensors in (0, 1), float64, one per counter of the
    broadcast (index, sub, stream)."""
    index = index.to(torch.int64)
    x0, x1, x2, x3 = philox4x32(
        index, _counter(sub, index.device), _counter(stream, index.device),
        _counter(t, index.device), key)
    k_a = ((x0 >> 6) << 26) | (x1 >> 6)
    k_b = ((x2 >> 6) << 26) | (x3 >> 6)
    return ((k_a.to(torch.float64) + 0.5) * _UNIT,
            (k_b.to(torch.float64) + 0.5) * _UNIT)


def normal_t(key: tuple, t: int, stream, index: torch.Tensor, sub=0):
    """Standard normals (Box-Muller, cosine branch), float64."""
    u1, u2 = unit2_t(key, t, stream, index, sub)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)


def _first_accepted(propose, index: torch.Tensor, batch: int = 4):
    """Per element of `index`, the value of its first accepted attempt.
    `propose(rows, subs)` gives (values, accepted), each (len(rows),
    len(subs)), for attempts `subs`; attempts are tried in order, `batch`
    at a time, until every element has one."""
    out = torch.empty(index.shape, dtype=torch.float64, device=index.device)
    todo = torch.arange(index.numel(), device=index.device)
    k0 = 0
    while todo.numel():
        subs = torch.arange(k0, k0 + batch, device=index.device)
        val, ok = propose(todo, subs)
        has = ok.any(dim=1)
        first = ok.to(torch.int8).argmax(dim=1)
        rows = todo[has]
        out[rows] = val[has, first[has]]
        todo = todo[~has]
        k0 += batch
    return out


def gamma(key: tuple, t: int, stream: int, a: float, index: int = 0):
    """One gamma(a, 1) draw (Marsaglia-Tsang), as a Python float."""
    boost = 1.0
    if a < 1.0:
        ub, _ = unit2(key, t, stream, index, GAMMA_BOOST_SUB)
        boost = ub ** (1.0 / a)
        a = a + 1.0
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    k = 0
    while True:
        x = normal(key, t, stream, index, 2 * k)
        v = 1.0 + c * x
        if v > 0:
            v3 = v * v * v
            u, _ = unit2(key, t, stream, index, 2 * k + 1)
            if math.log(u) < 0.5 * x * x + d - d * v3 + d * math.log(v3):
                return d * v3 * boost
        k += 1


def truncnorm_above_t(key: tuple, t: int, stream: int, a: torch.Tensor,
                      index: torch.Tensor | None = None) -> torch.Tensor:
    """X ~ N(0, 1) conditioned on X > a, one per element of `a`
    (counters `index`, default 0..len-1), float64; NaN where a is NaN."""
    a = a.to(torch.float64)
    if index is None:
        index = torch.arange(a.numel(), device=a.device)
    alpha = 0.5 * (a + torch.sqrt(a * a + 4.0))

    def propose(rows, subs):
        ar, al = a[rows][:, None], alpha[rows][:, None]
        u1, u2 = unit2_t(key, t, stream, index[rows][:, None], subs[None, :])
        naive = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)
        expo = ar - torch.log(u1) / al
        tail = ar >= 0
        nan = torch.isnan(ar)
        x = torch.where(tail, expo, torch.where(nan, ar, naive))
        e = expo - al
        ok = torch.where(tail, u2 <= torch.exp(-0.5 * e * e),
                         (naive > ar) | nan)
        return x, ok

    return _first_accepted(propose, index)
