"""JAX's default counter-based PRNG in numpy, so a model id gives the same
weights in this package as in the JAX package, without JAX.

What is reproduced is exactly what ``layers.seed_from``, ``_dense_init`` and
``encoder.init_params`` use from ``jax.random`` under its default settings
(``threefry2x32`` keys, ``jax_threefry_partitionable=True``):

- ``PRNGKey(seed)`` is the uint32 pair ``[seed >> 32, seed & 0xFFFFFFFF]``
  (``[0, seed]`` for a 32-bit seed);
- ``split(key, n)[i]`` is ``threefry2x32(key, (0, i))``, and
  ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
- the 32 random bits at flat index ``i`` of a shape are ``hi ^ lo`` of
  ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
- ``normal`` is ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
  ``(-1, 1)`` built from the top 23 bits, and ``erfinv`` is XLA's float32
  polynomial (Giles), evaluated in float32 step by step as XLA's CPU
  backend does, its ``log1p`` and ``log`` included. numpy's own ``log1p``
  would leave the normals up to 3 ulp away from JAX's.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) of ``(x0, x1)`` under
    ``key``; uint32 in, uint32 out, wrapping arithmetic."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        a = np.asarray(x0, np.uint32) + ks[0]
        b = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 — JAX's name
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``[num, 2]`` uint32 subkeys."""
    a, b = threefry2x32(key, np.zeros(num, np.uint32),
                        np.arange(num, dtype=np.uint32))
    return np.stack([a, b], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: ``threefry2x32(key, (0, data))``."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return np.array([a[0], b[0]], dtype=np.uint32)


# Arrays of at least twice this many elements are drawn in chunks of this
# size on a thread per core: every element depends on its flat index alone,
# and numpy's loops release the interpreter lock, so the chunks run in
# parallel and give the same bits (a BERT-base MoE draws 453M normals). A
# chunk's temporaries (1 MiB each) stay in a core's cache: 1.4-1.6x faster
# than chunks of 2M elements on 8 cores.
PARALLEL_CHUNK = 1 << 18


def _flat(shape: Tuple[int, ...], fn: Callable[[int, int], np.ndarray],
          dtype) -> np.ndarray:
    """``fn(start, stop)`` over the flat indices of ``shape``, in parallel
    chunks when the array is large."""
    n = int(np.prod(shape, dtype=np.int64))
    if n < 2 * PARALLEL_CHUNK:
        return fn(0, n).reshape(shape)
    out = np.empty(n, dtype)

    def fill(start: int) -> None:
        stop = min(start + PARALLEL_CHUNK, n)
        out[start:stop] = fn(start, stop)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        list(pool.map(fill, range(0, n, PARALLEL_CHUNK)))
    return out.reshape(shape)


def _bits(key: np.ndarray, start: int, stop: int) -> np.ndarray:
    idx = np.arange(start, stop, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    a, b = threefry2x32(key, hi, lo)
    return a ^ b


def random_bits(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """32 random bits per element of ``shape`` (uint32)."""
    return _flat(shape, lambda start, stop: _bits(key, start, stop), np.uint32)


_F32 = np.float32


def _fma(a, b, c) -> np.ndarray:
    """float32 fused multiply-add (the product of two float32 values is
    exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


# XLA CPU's float32 log (Cephes' logf, evaluated as XLA's CPU backend
# emits it, with its multiply-adds fused).
_LOG_P = tuple(_F32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))


def _log_f32(v: np.ndarray) -> np.ndarray:
    """XLA CPU's float32 ``log`` for positive normal ``v``."""
    bits = np.asarray(v, _F32).view(np.uint32)
    e = _F32(1) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(_F32)
    t = ((bits & np.uint32(0x807FFFFF))
         | np.array(0.5, _F32).view(np.uint32)).view(_F32)
    small = t < _F32(0.707106781186547524)
    t = (t - _F32(1)) + np.where(small, t, _F32(0))
    e = e - np.where(small, _F32(1), _F32(0))
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _F32(-2.12194440e-4) * e)
    t = _fma(_F32(-0.5), x2, t)
    t = t + y
    return _fma(_F32(0.693359375), e, t)


# XLA's float32 log1p: a Cephes rational for |x| < sqrt(2) - 1, else
# log(1 + x). Coefficients highest power first.
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    def horner(coeffs):
        r = np.zeros_like(x)
        for c in coeffs:
            r = _fma(r, x, _F32(c))
        return r

    x2 = x * x
    small = x + (_F32(-0.5) * x2 + (x * x2) * (horner(_LOG1P_NUM)
                                             / horner(_LOG1P_DEN)))
    return np.where(np.abs(x) < 0.41421356237309504880, small,
                    _log_f32(x + _F32(1)))


# XLA's ErfInv32 coefficients (Giles, "Approximating the erfinv function").
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA CPU's float32 ``erf_inv`` on ``x`` in (-1, 1)."""
    x = np.asarray(x, _F32)
    w = -_log1p_f32(-x * x)
    lt = w < _F32(5.0)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
    p = np.where(lt, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, _F32(c_lt), _F32(c_ge)))
    return p * x


def _uniform(bits: np.ndarray, minval: float, maxval: float) -> np.ndarray:
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    span = np.float32(hi - lo)
    return np.maximum(lo, (floats * span + lo).astype(np.float32))


def uniform(key: np.ndarray, shape: Tuple[int, ...], minval: float,
            maxval: float) -> np.ndarray:
    """float32 uniform on ``[minval, maxval)`` from the top 23 bits."""
    return _flat(shape, lambda start, stop: _uniform(_bits(key, start, stop), minval, maxval),
                 np.float32)


def normal(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """float32 standard normals, as ``jax.random.normal(key, shape)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)

    def draw(start: int, stop: int) -> np.ndarray:
        u = _uniform(_bits(key, start, stop), lo, 1.0)
        return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)

    return _flat(shape, draw, np.float32)
