"""Posit(N, ES) codec in torch — exact for N <= 16.

Port of ``repro/core/posit.py``: ``value = (-1)^s * (2^(2^ES))^k * 2^e *
1.f`` with two's-complement negative codes, run-length regime, MSB-aligned
zero-completed exponent, and NaR at ``10...0``. Codes are int32 tensors
holding the raw N-bit pattern in [0, 2^N).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["NAR", "posit_decode", "posit_encode", "posit_value_table"]


def NAR(N: int) -> int:
    """The Not-a-Real code for an N-bit posit (1 followed by zeros)."""
    return 1 << (N - 1)


def _check_config(N: int, ES: int) -> None:
    if not (2 <= N <= 16):
        raise ValueError(f"posit N={N} unsupported (need 2..16)")
    if not (0 <= ES <= 4):
        raise ValueError(f"posit ES={ES} unsupported (need 0..4)")


def _decode_fields(c: torch.Tensor, N: int, ES: int):
    """Shared field extraction. Returns (sign_bit, k, e, frac_window).

    ``frac_window`` is the fraction left-aligned in an (N-1)-bit window.
    Exponent bits cut off by the regime are completed with zeros.
    """
    c = c.to(torch.int32)
    mask_n = (1 << N) - 1
    mask_body = (1 << (N - 1)) - 1
    c = c & mask_n
    s = (c >> (N - 1)) & 1
    body = torch.where(s == 1, (-c) & mask_n, c) & mask_body
    r0 = (body >> (N - 2)) & 1
    x = torch.where(r0 == 1, (~body) & mask_body, body)
    m = torch.zeros_like(c)
    found = torch.zeros_like(c, dtype=torch.bool)
    for i in range(N - 2, -1, -1):
        found = found | (((x >> i) & 1) == 1)
        m = m + (~found).to(torch.int32)
    k = torch.where(r0 == 0, -m, m - 1)
    aligned = (body << (m + 1)) & mask_body
    if ES > 0:
        e = aligned >> (N - 1 - ES) if (N - 1 - ES) >= 0 else aligned
        frac = (aligned << ES) & mask_body
    else:
        e = torch.zeros_like(c)
        frac = aligned
    return s, k, e, frac


def posit_decode(codes: torch.Tensor, N: int, ES: int) -> torch.Tensor:
    """float32 decode (exact for N <= 16). Zero -> 0.0, NaR -> NaN."""
    _check_config(N, ES)
    c = codes.to(torch.int32) & ((1 << N) - 1)
    s, k, e, frac = _decode_fields(c, N, ES)
    scale = (k << ES) + e
    sig = 1.0 + frac.to(torch.float32) / float(1 << (N - 1))
    # exact 2^scale from the float32 bit pattern (|scale| <= 120 here)
    pow2 = ((scale + 127) << 23).to(torch.int32).view(torch.float32)
    val = torch.where(s == 1, -1.0, 1.0) * pow2 * sig
    val = torch.where(c == 0, torch.zeros_like(val), val)
    return torch.where(c == NAR(N), torch.full_like(val, float("nan")), val)


@functools.lru_cache(maxsize=64)
def posit_value_table(N: int, ES: int) -> np.ndarray:
    """float64 values of the non-negative posit codes [0, 2^(N-1)):
    strictly increasing, table[0] == 0."""
    _check_config(N, ES)
    codes = torch.arange(1 << (N - 1), dtype=torch.int32)
    s, k, e, frac = _decode_fields(codes, N, ES)
    sig = 1.0 + frac.to(torch.float64) / float(1 << (N - 1))
    vals = torch.ldexp(sig, ((k << ES) + e).to(torch.float64)).numpy().copy()
    vals[0] = 0.0
    if not np.all(np.diff(vals) > 0):
        raise AssertionError("posit value table must be monotonic")
    return vals


def posit_encode(x: torch.Tensor, N: int, ES: int,
                 allow_zero: bool = True) -> torch.Tensor:
    """Round float values to the nearest posit code (ties to the even code),
    through a float32 value table (``searchsorted(right=False)`` is jnp's
    default ``side="left"``)."""
    _check_config(N, ES)
    x = x.to(torch.float32)
    table = torch.as_tensor(posit_value_table(N, ES), dtype=torch.float32,
                            device=x.device)
    a = x.abs()
    L = 1 << (N - 1)
    idx = torch.searchsorted(table, a, right=False).clamp(0, L - 1)
    lo = (idx - 1).clamp(0, L - 1)
    hi = idx
    dlo = a - table[lo]
    dhi = table[hi] - a
    take_lo = (dlo < dhi) | ((dlo == dhi) & (lo % 2 == 0))
    code = torch.where(take_lo, lo, hi).to(torch.int32)
    if not allow_zero:
        code = torch.where((a > 0) & (code == 0), 1, code).to(torch.int32)
    code = torch.where(x < 0, (-code) & ((1 << N) - 1), code)
    code = torch.where(a == 0, 0, code)
    return torch.where(torch.isnan(x), NAR(N), code).to(torch.int32)
