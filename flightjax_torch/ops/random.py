"""A counter-based random stream exact to `jax.random` (the parts the
turbulence and the Monte Carlo fleet use): the threefry2x32 hash of the
default PRNG implementation, `PRNGKey`, `fold_in`, `split`, the raw bits in
32 and 64 bits, `uniform`, `normal` and `randint`, in the partitionable
layout (`jax_threefry_partitionable=True`, the default of JAX 0.9).

Keys are int64 tensors of shape `[..., 2]` holding the two uint32 words;
the integer arithmetic is exact uint32 arithmetic carried in int64 with
masks, so batched keys (one per lane) hash in one pass. The layouts:

- `PRNGKey(seed)` = (seed >> 32, seed & 0xFFFFFFFF);
- `fold_in(key, d)` = threefry2x32(key, (0, uint32(d)));
- `split(key, n)[j]` = threefry2x32(key, (0, j));
- the bits at flat index j of `shape` come from y = threefry2x32(key, (0,
  j)): y0 ^ y1 in 32 bits, (y0 << 32) | y1 in 64 bits.

`uniform` fills the mantissa from the top bits (32 bits for float32, 64 for
float64) and maps [1, 2) onto [minval, maxval) with one fused multiply-add,
as XLA contracts `floats * (maxval - minval) + minval` on the CPU (`fma`
rounds it once, exactly); `normal` is sqrt(2) erfinv(uniform(nextafter(-1,
0), 1)) (`jax._src.random._normal_real`), whose span is 2, so that there
the fused and the plain forms agree.
"""

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & M32


def _round(x0, x1, r):
    x0 = (x0 + x1) & M32
    x1 = x0 ^ _rotl(x1, r)
    return x0, x1


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 hash of the counters (x0, x1) under the key
    (k0, k1), all uint32 values in int64 tensors (broadcast); returns the two
    output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for j in range(5):
        for r in _ROT[j % 2]:
            x0, x1 = _round(x0, x1, r)
        x0 = (x0 + ks[(j + 1) % 3]) & M32
        x1 = (x1 + ks[(j + 2) % 3] + (j + 1)) & M32
    return x0, x1


def _u32(v, device=None):
    """An integer tensor (or int) as its uint32 words in int64 (two's
    complement low word)."""
    return torch.as_tensor(v, device=device).to(torch.int64) & M32


def PRNGKey(seed, device=None):
    """The key of an integer seed: (seed >> 32, seed & 0xFFFFFFFF)."""
    s = int(seed)
    return torch.tensor([(s >> 32) & M32, s & M32], dtype=torch.int64,
                        device=device)


def fold_in(key, data):
    """fold_in(key, data) for keys `[..., 2]` and integer data broadcast
    against the key's batch shape (taken as uint32)."""
    d = _u32(data, key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _counters(key, shape):
    """The hash of the flat indices of `shape` under the keys `[..., 2]`:
    two int64 tensors `[..., *shape]`."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError("more than 2**32 draws from one key")
    j = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(lead + (1,) * len(shape))
    k1 = key[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k0, k1, torch.zeros_like(j), j)


def split(key, num=2):
    """`num` keys from one: `[..., num, 2]`."""
    y0, y1 = _counters(key, (int(num),))
    return torch.stack([y0, y1], dim=-1)


def random_bits(key, bit_width, shape):
    """The raw bits `[..., *shape]`: uint32 values in int64 for 32 bits, the
    uint64 values' two's complement in int64 for 64 bits."""
    y0, y1 = _counters(key, tuple(shape))
    if bit_width == 32:
        return y0 ^ y1
    if bit_width == 64:
        hi = torch.where(y0 >= 2 ** 31, y0 - 2 ** 32, y0)
        return hi * 2 ** 32 + y1
    raise ValueError(f"bit_width {bit_width} is not 32 or 64")


_FLOAT = {torch.float32: (np.float32, np.uint32, torch.int32, 32, 23),
          torch.float64: (np.float64, np.uint64, torch.int64, 64, 52)}


def _unit(key, shape, dtype):
    """Floats in [1, 2) with the mantissa from the top random bits."""
    _, _, itype, nbits, nmant = _FLOAT[dtype]
    y0, y1 = _counters(key, tuple(shape))
    one = 0x3FF0000000000000 if nbits == 64 else 0x3F800000
    if nbits == 32:
        mant = (y0 ^ y1) >> (32 - nmant)
    else:  # the top 52 of the 64 bits (y0 << 32) | y1
        mant = (y0 << 20) | (y1 >> 12)
    raw = mant | one
    if nbits == 32:
        raw = torch.where(raw >= 2 ** 31, raw - 2 ** 32, raw)
    return raw.to(itype).view(dtype)


def _two_sum(a, b):
    """s = a + b rounded and its exact error e (a + b = s + e)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    """Veltkamp's split of a float64 into two halves of 26 bits."""
    c = 134217729.0 * a
    hi = c - (c - a)
    return hi, a - hi


def _round_odd(s, e):
    """s, rounded to nearest from s + e, turned into s + e rounded to odd:
    an inexact s with an even last bit steps one ulp towards e."""
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, math.inf)
    step = torch.nextafter(s, torch.where(e > 0, inf, -inf))
    return torch.where((e != 0) & even, step, s)


def fma(a, b, c):
    """a * b + c rounded once, in float32 or float64 (tensors of one dtype):
    the float32 product is exact in float64, whose sum is rounded to odd
    before float32; in float64 the product splits exactly (Dekker) and the
    low parts are summed to odd under the high one (Boldo and Melquiond)."""
    if a.dtype == torch.float32:
        p = a.double() * b.double()
        s, e = _two_sum(p, c.double())
        return _round_odd(s, e).float()
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pl = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    sh, sl = _two_sum(p, c)
    w, we = _two_sum(sl, pl)
    return sh + _round_odd(w, we)


def uniform(key, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0):
    """Uniform floats in [minval, maxval) `[..., *shape]` (`jax.random.
    uniform`): fma(floats, maxval - minval, minval), then at least minval,
    formed in `dtype`."""
    f = _unit(key, shape, dtype) - 1.0
    lo = torch.as_tensor(minval, dtype=dtype, device=key.device)
    hi = torch.as_tensor(maxval, dtype=dtype, device=key.device)
    lo_, span = torch.broadcast_tensors(lo, hi - lo)
    f, span, lo_ = torch.broadcast_tensors(f, span, lo_)
    return torch.maximum(lo, fma(f, span, lo_))


def normal_lo(dtype):
    """nextafter(-1, 0) in `dtype`, the lower end of `normal`'s uniform."""
    np_t = _FLOAT[dtype][0]
    return float(np.nextafter(np_t(-1.0), np_t(0.0)))


def normal(key, shape=(), dtype=torch.float32):
    """Standard normal floats `[..., *shape]` (`jax.random.normal`)."""
    u = uniform(key, shape, dtype, normal_lo(dtype), 1.0)
    return torch.full_like(u, math.sqrt(2)) * torch.erfinv(u)


def randint(key, shape, minval, maxval, dtype=torch.int32):
    """Uniform integers in [minval, maxval) `[..., *shape]` (`jax.random.
    randint` with integer bounds inside `dtype`'s range): two draws of
    `dtype`'s width from split(key), combined modulo the span."""
    nbits = {torch.int32: 32, torch.int64: 64}[dtype]
    k = split(key, 2)
    lo = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    span = torch.where(hi <= lo, torch.ones_like(lo), hi - lo)
    mult = (2 ** (nbits // 2)) % span
    mult = mult * mult
    if nbits == 32:  # the uint32 products and sums wrap
        span = span & M32
        mult = mult & M32
    mult = mult % span

    def draw(kk):  # the draw modulo span
        y0, y1 = _counters(kk, tuple(shape))
        if nbits == 32:
            return (y0 ^ y1) % span
        # (y0 2^32 + y1) mod span, in parts that fit in int64
        return ((y0 % span) * ((2 ** 32) % span) + y1 % span) % span

    off = draw(k[..., 0, :]) * mult + draw(k[..., 1, :])
    if nbits == 32:
        off = off & M32
    off = off % span
    return (lo + off).to(dtype)
