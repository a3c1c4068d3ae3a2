"""The reference's PRNG, in torch: threefry-2x32 keys, fold_in, split and
the draws the serving paths make.

A torch copy of JAX's default PRNG as the serving engine and the one-shot
CLI loop use it (``jax.random.PRNGKey``, ``fold_in``, ``split``,
``categorical``, ``randint``, ``normal``; raw ``(2,)`` uint32 keys,
``jax_threefry_partitionable`` on), so the port draws the reference's
sample streams, prompts and frames from the same seed:

* ``threefry_2x32`` is the 20-round Threefry-2x32 hash
  (``jax/_src/prng.py`` ``_threefry2x32_lowering``).
* ``fold_in(key, data)`` hashes the count pair ``threefry_seed(data) = (0,
  data)`` under ``key``; ``split(key, n)`` hashes the counts ``(0, i)``,
  ``i < n``, and each pair of output words is one new key.
* ``random_bits(key, shape)`` hashes the 64-bit row-major index of every
  element, split into ``(hi, lo)`` words, and XORs the two output words
  (the partitionable layout; not the older split-counter one).
* ``uniform`` sets the mantissa from the top bits under an exponent of one
  and subtracts 1 (exact); ``gumbel`` is ``-log(-log(u))`` over ``[tiny,
  1)`` (the reference's ``mode="low"``); ``categorical`` is
  ``argmax(gumbel + logits)``.

Torch has few uint32 operations on the CPU or on CUDA, so every word is
carried in int64 and masked to 32 bits after each add and rotate. A key is
a ``(..., 2)`` int64 tensor of such words; leading dims batch the keys, as
the reference's ``vmap`` does. Nothing here holds global state: keys live
on the device they were made on and every draw runs there. Only the two
``log``s of ``gumbel`` and the ``log1p`` of ``erf_inv`` may differ from
XLA's by an ulp, which the polynomial carries to a few ulps of ``normal``.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

__all__ = ["PRNGKey", "threefry_2x32", "threefry_seed", "fold_in", "split",
           "random_bits", "uniform", "gumbel", "categorical", "randint",
           "erf_inv", "normal"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# (total bits, mantissa bits, float bit pattern of 1.0) per float dtype
_FLOATS = {torch.float32: (32, 23, 0x3F800000),
           torch.bfloat16: (16, 7, 0x3F80),
           torch.float16: (16, 10, 0x3C00)}
_INT_VIEW = {32: torch.int32, 16: torch.int16}

Data = Union[int, torch.Tensor]


def _words(x: Data, device) -> torch.Tensor:
    """An int or integer tensor as int64 uint32 words (two's complement
    wrap, as ``jnp.asarray(x, uint32)`` does)."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the (2,) key ``[seed >> 32, seed &
    0xFFFFFFFF]``, i.e. ``[0, seed]`` for a 32-bit seed."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry_2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash of the count words ``(x0, x1)`` under the key
    words ``(k1, k2)`` (int64 tensors of uint32 words, broadcast together);
    returns the two output words. The reference's ``threefry_2x32(key,
    count)`` hashes the two halves of a flat count array as these words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + k1) & MASK
    x1 = (x1 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def threefry_seed(data: Data, device=None) -> torch.Tensor:
    """``threefry_seed`` of uint32 data: the key ``[0, data]`` (``(..., 2)``
    for a tensor of data)."""
    d = _words(data, device)
    return torch.stack([torch.zeros_like(d), d], dim=-1)


def fold_in(key: torch.Tensor, data: Data) -> torch.Tensor:
    """``jax.random.fold_in``: ``threefry_2x32(key, threefry_seed(data))``.

    ``key`` is (..., 2); ``data`` an int, or a tensor that broadcasts
    against ``key.shape[:-1]`` (the reference's ``vmap(fold_in)(keys,
    data)``). Data wraps to uint32 first."""
    seed = threefry_seed(data, key.device)
    y0, y1 = threefry_2x32(key[..., 0], key[..., 1], seed[..., 0], seed[..., 1])
    return torch.stack([y0, y1], dim=-1)


def _count_words(n: int, device):
    """The (hi, lo) words of the flat indices 0..n-1 (the reference's
    ``iota_2x32_shape``)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of one (2,) key: (num, 2) keys, the
    hash of the counts ``(0, i)`` (the partitionable fold-like split)."""
    hi, lo = _count_words(int(num), key.device)
    y0, y1 = threefry_2x32(key[0], key[1], hi, lo)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` under each key of ``key``
    (..., 2): a (..., *shape) int64 tensor of uint32 words."""
    shape = tuple(int(s) for s in shape)
    hi, lo = (w.reshape(shape) for w in _count_words(math.prod(shape), key.device))
    expand = (...,) + (None,) * len(shape)
    y0, y1 = threefry_2x32(key[..., 0][expand], key[..., 1][expand], hi, lo)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape: Sequence[int], dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (f32, bf16 or f16): the top mantissa bits of
    the random bits under an exponent of one, minus 1, scaled into
    ``[minval, maxval)``. Dtypes with fewer than 8 mantissa bits draw 8
    bits per element, as the reference does."""
    if dtype not in _FLOATS:
        raise ValueError(f"uniform supports {sorted(map(str, _FLOATS))}, got {dtype}")
    nbits, nmant, one = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape)
    if rng_bits < 32:
        bits = bits & ((1 << rng_bits) - 1)
    fbits = (bits >> (rng_bits - nmant)) | one
    floats = fbits.to(_INT_VIEW[nbits]).view(dtype) - 1.0
    # the bounds and their difference rounded to ``dtype`` on the host (a
    # tensor made on the card from a Python number would wait for it)
    lo, hi = torch.tensor([minval, maxval], dtype=dtype)
    return (floats * float(hi - lo) + float(lo)).clamp_min(float(lo))


def gumbel(key: torch.Tensor, shape: Sequence[int],
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): ``-log(-log(u))``, ``u`` uniform
    over ``[tiny, 1)``."""
    u = uniform(key, shape, dtype, minval=torch.finfo(dtype).tiny, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: ``argmax(gumbel +
    logits)``, one key per row of ``logits`` (key (..., 2), logits (..., V)).
    """
    g = gumbel(key, logits.shape[-1:], logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` at its default
    int32: values in ``[minval, maxval)`` (``minval`` wherever ``maxval <=
    minval``). Two words a value, one from each half of ``split(key)``,
    are folded into the span as ``((hi % span) * (2^32 % span) + lo %
    span) % span`` in wrapping uint32 arithmetic. Returns int32."""
    i32 = torch.iinfo(torch.int32)
    lo_v, hi_v = int(minval), int(maxval)
    if not (i32.min <= lo_v <= i32.max and i32.min <= hi_v <= i32.max):
        raise ValueError(f"randint bounds must lie in int32, got [{lo_v}, {hi_v})")
    span = 1 if hi_v <= lo_v else (hi_v - lo_v) & MASK
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    # (hi % span) * mult < 2^64 may pass int64's range: its wrap keeps the
    # low 32 bits, all that uint32 arithmetic keeps
    offset = ((higher % span) * mult + lower % span) & MASK
    offset = (offset % span + lo_v) & MASK
    return torch.where(offset > i32.max, offset - 2 ** 32, offset).to(torch.int32)


# XLA's f32 ErfInv: M. Giles, "Approximating the erfinv function" (GPU Gems
# Computing), one polynomial for w = -log1p(-x^2) < 5 and one above
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` for f32 as XLA computes it (its polynomial, each
    step rounded to f32; +-inf at +-1). ``torch.special.erfinv`` is another
    approximation, up to 64 ulps from XLA's near +-1."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(lt, a, b) for a, b in
            zip(torch.tensor(_ERF_INV_LT5, device=x.device),
                torch.tensor(_ERF_INV_GE5, device=x.device))]
    p = coef[0]
    for c in coef[1:]:
        p = c + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32: ``sqrt(2) * erf_inv(u)``,
    ``u`` uniform over ``[nextafter(-1, 0), 1)``."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, torch.float32, minval=lo, maxval=1.0)
    return float(torch.tensor(math.sqrt(2), dtype=torch.float32)) * erf_inv(u)
