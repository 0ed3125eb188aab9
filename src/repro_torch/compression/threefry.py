"""The part of ``jax.random`` that the low-rank sketch draws from, in numpy
``uint32`` / ``float32`` arithmetic on the host.

``compression/lowrank.py`` builds each round's basis from
``normal(fold_in(fold_in(PRNGKey(seed), round), leaf), (last_dim, rank))``.
A cohort encoded by one package must decode in the other, so the draw has
to be JAX's, bit for bit, and this package may not import JAX: this module
is its own copy of the Threefry-2x32 generator as ``jax.random`` uses it
with ``jax_threefry_partitionable`` on (the default of jax 0.5 and later):

* ``threefry2x32``: 20 rounds, JAX's rotation constants and key schedule;
* ``prng_key(seed)``: the key ``[0, seed]`` of a 32-bit seed;
* ``fold_in(key, data)``: the hash of the counter pair ``[0, data]``;
* ``random_bits``: the hash of each element's row-major index, its high
  and low words as the counter pair, the two output words xor-ed;
* ``uniform``: 23 random mantissa bits under the exponent of 1.0, minus
  one, scaled into ``[minval, maxval)``;
* ``normal``: ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
  ``[nextafter(-1, 0), 1)`` and XLA's single-precision ``erf_inv``:
  Giles' polynomial on ``w = -log1p(-u * u)``, with XLA's CPU ``log1p``
  and ``log`` (Cephes) and the fused multiply-adds LLVM makes of them.

Bits, uniforms and normals equal JAX's bit for bit on the CPU
(``tests/test_torch_compression.py``); after the QR of the sketch the
basis lies within 1e-6 of the JAX package's.

Every array here is host numpy; the sketch is a few KB a leaf and a round,
built once and cached (``lowrank.py``).
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

#: XLA's ``ErfInv32`` (Giles' single-precision approximation): polynomial
#: coefficients in ``w - 2.5`` for ``w < 5`` and in ``sqrt(w) - 3`` beyond,
#: with ``w = -log1p(-x * x)``, highest degree first.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
#: XLA's ``log1p`` for ``|x| < sqrt(2) - 1``: ``x - x^2 / 2 + x^3 P(x) /
#: Q(x)`` (Cephes), coefficients highest degree first ...
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
#: ... and beyond it ``log(1 + x)``, with the Cephes ``logf`` polynomial
#: that XLA's CPU backend emits for ``log``
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_F32 = np.float32


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 of the counter pairs ``(x0, x1)`` (uint32 arrays of
    one shape) under ``key`` (two uint32 words); returns two arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` of a non-negative 32-bit seed."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be a 32-bit unsigned int, got {seed}")
    return np.array([0, seed], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a non-negative 32-bit
    ``data``."""
    if not 0 <= data < 2 ** 32:
        raise ValueError(f"data must be a 32-bit unsigned int, got {data}")
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.array([data], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def random_bits(key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (32-bit, partitionable Threefry)."""
    count = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(np.uint32)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(32 - 23)) \
        | np.float32(1.0).view(np.uint32)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once, as the fused multiply-adds that LLVM
    makes of XLA's CPU polynomials (the float64 product of two float32
    values is exact; the sum is rounded twice, to float64 then float32,
    which differs from one rounding only in rare ties)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _F32(c))
    return p


def _log(x: np.ndarray) -> np.ndarray:
    """Cephes ``logf`` of positive normal float32 ``x`` (XLA's CPU
    ``log``)."""
    bits = x.view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 126).astype(_F32)
    m = ((bits & np.uint32(0x807FFFFF))
         | _F32(0.5).view(np.uint32)).view(_F32)       # in [0.5, 1)
    low = m < _F32(0.707106781186547524)
    m = (m - _F32(1.0)) + np.where(low, m, _F32(0.0))
    e = e - np.where(low, _F32(1.0), _F32(0.0))
    m2 = m * m
    m3 = m2 * m
    y = _fma(m, _F32(_LOG_P[0]), _F32(_LOG_P[1]))
    y1 = _fma(m, _F32(_LOG_P[3]), _F32(_LOG_P[4]))
    y2 = _fma(m, _F32(_LOG_P[6]), _F32(_LOG_P[7]))
    y = _fma(y, m, _F32(_LOG_P[2]))
    y1 = _fma(y1, m, _F32(_LOG_P[5]))
    y2 = _fma(y2, m, _F32(_LOG_P[8]))
    y = _fma(y, m3, y1)
    y = _fma(y, m3, y2)
    # LLVM fuses ``y * m3 + e * q1`` on the first product
    y = _fma(y, m3, e * _F32(-2.12194440e-4))
    m = _fma(m2, _F32(-0.5), m) + y
    return _fma(e, _F32(0.693359375), m)


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log1p`` for ``x`` in ``(-1, 0]``."""
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + (_F32(-0.5) * x2 + small)
    large = _log(np.maximum(x + _F32(1.0), np.finfo(_F32).tiny))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, large)


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` on ``[-1, 1]``, elementwise."""
    x = np.asarray(x, _F32)
    w = -_log1p(-x * x)
    small = w < _F32(5.0)
    w = np.where(small, w - _F32(2.5),
                 np.sqrt(np.maximum(w, _F32(0.0))) - _F32(3.0))
    p = np.where(small, _F32(_ERFINV_SMALL[0]), _F32(_ERFINV_LARGE[0]))
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, np.where(small, _F32(cs), _F32(cl)))
    edge = np.abs(x) == _F32(1.0)
    return np.where(edge, np.copysign(_F32(np.inf), x), p * x).astype(_F32)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return _F32(np.sqrt(2)) * erfinv(u)
