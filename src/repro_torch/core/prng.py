"""Threefry-2x32 counter PRNG with ``jax.random``'s key and draw layout.

The port replays the JAX package's random streams: the sync's per-peer and
per-bucket key folds, the ``(rows, 128)`` stochastic-rounding draw, the
synthetic data and the parameter init.

The counter layout is JAX's original one (``jax_threefry_partitionable``
off, the default of the pinned jax 0.4.37, under which the golden
convergence windows were recorded): a draw of N words hashes the count
pairs ``(i, i + ceil(N/2))`` and concatenates the two output halves, and
``split`` is a draw of ``2·num`` words.  JAX releases whose flag defaults
to on draw other streams from the same key.

A key is a 2-element int64 tensor holding the two uint32 words of
``jax.random.key_data``.  Keys stay on the CPU (folding them is scalar
work); a draw takes the ``device`` it fills.  All word arithmetic runs in
int64 masked to 32 bits, because torch has no full unsigned 32-bit integer
arithmetic on every device.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds on uint32 words held in int64.

    ``k1``/``k2`` are Python ints; ``x1``/``x2`` Python ints or int64
    tensors of one shape.  Returns the two output words.
    """
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    if isinstance(x1, torch.Tensor):
        return _threefry_tensors(ks, x1, x2)
    x0 = (x1 + ks[0]) & _MASK
    y = (x2 + ks[1]) & _MASK
    for r in range(5):
        for rot in _ROTATIONS[r % 2]:
            x0 = (x0 + y) & _MASK
            y = _rotl(y, rot) ^ x0
        x0 = (x0 + ks[(r + 1) % 3]) & _MASK
        y = (y + ks[(r + 2) % 3] + r + 1) & _MASK
    return x0, y


def _threefry_tensors(ks, x1: torch.Tensor, x2: torch.Tensor):
    """:func:`threefry2x32`'s rounds in place on fresh copies of ``x1`` and
    ``x2``: one scratch tensor instead of a new one per operation."""
    x0 = (x1 + ks[0]).bitwise_and_(_MASK)
    y = (x2 + ks[1]).bitwise_and_(_MASK)
    t = torch.empty_like(y)
    for r in range(5):
        for rot in _ROTATIONS[r % 2]:
            x0.add_(y).bitwise_and_(_MASK)
            torch.bitwise_left_shift(y, rot, out=t).bitwise_and_(_MASK)
            y.bitwise_right_shift_(32 - rot).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(r + 1) % 3]).bitwise_and_(_MASK)
        y.add_(ks[(r + 2) % 3] + r + 1).bitwise_and_(_MASK)
    return x0, y


def _words(key: torch.Tensor) -> tuple[int, int]:
    if key.shape != (2,):
        raise ValueError(f"a key is a (2,) tensor of uint32 words, got shape {tuple(key.shape)}")
    k1, k2 = (int(v) for v in key.tolist())
    return k1, k2


def _key(k1: int, k2: int) -> torch.Tensor:
    return torch.tensor([k1, k2], dtype=torch.int64)


def key(seed: int) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` for 0 <= seed < 2**64."""
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return _key((seed >> 32) & _MASK, seed & _MASK)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(k, data)`` for a uint32 ``data``."""
    k1, k2 = _words(k)
    return _key(*threefry2x32(k1, k2, 0, int(data) & _MASK))


def _hash_halves(k1: int, k2: int, size: int, device=None) -> torch.Tensor:
    """``size`` words from the count pairs (i, i + h), h = ceil(size/2), the
    two output halves concatenated (an odd count is padded with one zero
    count)."""
    if size >= _MASK:
        raise ValueError(f"a draw of {size} words exceeds the 32-bit counter")
    h = (size + 1) // 2
    lo = torch.arange(h, dtype=torch.int64, device=device)
    hi = torch.where(lo + h == size, 0, lo + h)
    y1, y2 = threefry2x32(k1, k2, lo, hi)
    return torch.cat([y1, y2])[:size]


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` -> (num, 2) keys."""
    return _hash_halves(*_words(k), 2 * num).reshape(num, 2)


def _size(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _on_meta(device) -> bool:
    """A draw on the ``meta`` device has a shape and no values: it skips the
    hash (``launch.specs`` builds whole models there)."""
    return device is not None and torch.device(device).type == "meta"


def random_bits(k: torch.Tensor, shape, device=None) -> torch.Tensor:
    """32 random bits per element, int64 in [0, 2**32)."""
    if _on_meta(device):
        return torch.empty(tuple(shape), dtype=torch.int64, device="meta")
    return _hash_halves(*_words(k), _size(shape), device).reshape(tuple(shape))


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(k: torch.Tensor, shape, device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``.

    Bitwise equal to JAX on [0, 1); the affine map to another range is two
    float32 roundings, which XLA may contract into one.
    """
    u = _unit_floats(random_bits(k, shape, device))
    if minval == 0.0 and maxval == 1.0:
        return u
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(u * float(hi - lo) + float(lo), float(lo))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))
# XLA's float32 erf_inv: Giles' polynomials in w - 2.5 (w < 5) and
# sqrt(w) - 3 (w >= 5), w = -log1p(-x²), highest degree first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` for float32 on [-1, 1], op for op as XLA lowers it.

    A few ulp from JAX (XLA may contract a multiply-add that torch rounds
    twice); about 4e-6 relative from the exact inverse, like JAX.
    """
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(k: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2)·erf_inv(u)`` on the open (-1, 1),
    with XLA's erf_inv (:func:`erfinv`): a few ulp from JAX, not bitwise."""
    if _on_meta(device):
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    u = uniform(k, shape, device, _NORMAL_LO, 1.0)
    return _SQRT2 * erfinv(u)


def randint(k: torch.Tensor, shape, minval: int, maxval: int, device=None) -> torch.Tensor:
    """``jax.random.randint`` for an int32 range: int64 values in
    [minval, maxval), from two 32-bit draws reduced modulo the span."""
    k_hi, k_lo = split(k)
    hi = random_bits(k_hi, shape, device)
    lo = random_bits(k_lo, shape, device)
    span = int(maxval) - int(minval) if maxval > minval else 1
    mult = ((2**16 % span) ** 2 & _MASK) % span
    off = (((hi % span) * mult) & _MASK) + (lo % span)
    return int(minval) + (off & _MASK) % span


def bernoulli(k: torch.Tensor, p: float, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)``: ``uniform(k, shape) < p``."""
    return uniform(k, shape, device) < p
