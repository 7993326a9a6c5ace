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


# XLA's float32 erf_inv (the StableHLO decomposition of chlo.erf_inv: Giles'
# polynomials in w = -log1p(-x^2)), its log1p (Cephes' rational below
# sqrt(2) - 1, log(1 + x) above) and its log (Cephes' polynomial in Estrin's
# form, as its CPU backend emits it), with the multiply-adds it contracts
# rounded once: JAX's float32 normals on the CPU, bit for bit
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
               1.00167406, 2.83297682)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _f32(v, like):
    return torch.full_like(like, float(np.float32(v)))


def _polyf(x, coeffs):
    p = _f32(coeffs[0], x)
    for c in coeffs[1:]:
        p = fma(p, x, _f32(c, x))
    return p


def _logf(x):
    """XLA's float32 log of positive normal x."""
    m, e = torch.frexp(x)
    e = e.to(torch.float32)
    small = m < _f32(0.707106781186547524, m)
    one = torch.ones_like(m)
    m = (m - one) + torch.where(small, m, torch.zeros_like(m))
    e = e - torch.where(small, one, torch.zeros_like(e))
    x2 = m * m
    x3 = x2 * m
    p = [_f32(c, m) for c in _LOG_P]
    y = fma(fma(p[0], m, p[1]), m, p[2])
    y1 = fma(fma(p[3], m, p[4]), m, p[5])
    y2 = fma(fma(p[6], m, p[7]), m, p[8])
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, e * _f32(-2.12194440e-4, e))
    m = fma(x2, _f32(-0.5, m), m)
    m = m + y
    return fma(e, _f32(0.693359375, e), m)


def _log1pf(x):
    """XLA's float32 log1p."""
    x2 = x * x
    r = _polyf(x, _LOG1P_NUM) / _polyf(x, _LOG1P_DEN)
    r = fma(_f32(-0.5, x), x2, (x * x2) * r)
    small = x + r
    large = _logf(torch.clamp_min(x + torch.ones_like(x),
                                  float(np.finfo(np.float32).tiny)))
    return torch.where(torch.abs(x) < 0.41421356237309504880, small, large)


def erfinv_f32(x):
    """XLA's float32 erf_inv of x in (-1, 1)."""
    w = -_log1pf(x * -x)
    lt = w < 5.0
    c = lambda k: torch.where(lt, _f32(_ERFINV_LT5[k], w),
                              _f32(_ERFINV_GE5[k], w))
    # the square root rounded once (PyTorch's float32 one on the CPU is not)
    w = torch.where(lt, w - _f32(2.5, w),
                    torch.sqrt(w.double()).float() - _f32(3.0, w))
    p = c(0)
    for k in range(1, 9):
        p = fma(p, w, c(k))
    return p * x


def _normal_of_unit(f):
    """The float32 normal of `normal_f32` from its floats f in [1, 2)."""
    lo = normal_lo(torch.float32)
    f = f - 1.0
    lo_t = torch.full_like(f, lo)
    u = torch.maximum(lo_t, fma(f, torch.full_like(f, 1.0 - lo), lo_t))
    return _f32(math.sqrt(2), u) * erfinv_f32(u)


_NORMAL_TABLES = {}


def normal_table(device):
    """The float32 normal of each of the 2^23 mantissas a float32 uniform
    draws from, on `device` (built once per device, 32 MiB): a draw is a
    function of its 23 random bits alone."""
    key = torch.device(device)
    t = _NORMAL_TABLES.get(key)
    if t is None:
        mant = torch.arange(2 ** 23, dtype=torch.int32, device=key)
        t = _normal_of_unit((mant | 0x3F800000).view(torch.float32))
        _NORMAL_TABLES[key] = t
    return t


def normal_f32(key, shape=()):
    """`jax.random.normal(key, shape, float32)` as the JAX package's CPU
    backend computes it: its uniforms (exact here) through XLA's float32
    erf_inv (`erfinv_f32`), where `normal` would take PyTorch's, which
    rounds differently in about half the draws. On the card each draw is
    read from `normal_table` by its 23 bits (the same values, without the
    chain's thousand small launches)."""
    if key.device.type != "cpu":
        y0, y1 = _counters(key, tuple(shape))
        return normal_table(key.device)[(y0 ^ y1) >> 9]
    return _normal_of_unit(_unit(key, shape, torch.float32))


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
