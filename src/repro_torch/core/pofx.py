"""PoFx — the ExPAN(N)D posit -> fixed-point converter (Algorithm 1).

Port of ``repro/core/pofx.py``: stages A1-A3 (sign, two's complement,
leading-run detection), B1-B2 (regime k, exponent e, fraction), C (SHIFT =
2^ES * k + e), D (barrel shift; right shifts truncate like the RTL) and E
(sign-magnitude -> two's complement), on an int64 datapath. The normalized
variant replicates the stored leading bit and outputs FxP(M, M-1).
``pofx_norm_lut`` tabulates the bit-level algorithm; the CUDA kernels stage
that table in shared memory and the tests hold both to the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .normalized_posit import norm_expand
from .posit import NAR, _decode_fields

__all__ = ["pofx_normalized", "pofx_norm_lut"]

_LEFT_CLAMP = 45      # |mag_ext| < 2^17: a 45-bit left shift never wraps int64


def _shift_trunc(mag: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Barrel shift with truncating right shift (Stage D). Left shifts are
    clamped; any clamped shift still saturates every supported M."""
    left = shift.clamp(0, _LEFT_CLAMP)
    right = (-shift).clamp(0, 62)
    w = mag.to(torch.int64)
    return torch.where(shift >= 0, w << left, w >> right)


def _pofx_impl(codes: torch.Tensor, N: int, ES: int, M: int, F: int,
               rounding: str):
    c = codes.to(torch.int32) & ((1 << N) - 1)
    s, k, e, frac = _decode_fields(c, N, ES)
    mag_ext = (1 << (N - 1)) | frac
    shift = (k << ES) + e + (F - (N - 1))
    mag = _shift_trunc(mag_ext, shift)
    if rounding == "nearest":
        right = torch.where(shift < 0, -shift, 0)
        rc = right.clamp(0, 62).to(torch.int64)
        half = torch.where(right > 0, torch.ones_like(rc) << (rc - 1).clamp(0, 30),
                           torch.zeros_like(rc))
        mag_r = (mag_ext.to(torch.int64) + half) >> rc
        mag = torch.where(shift < 0, mag_r, mag)
    max_mag = (1 << (M - 1)) - 1
    of = mag > max_mag
    mag = mag.clamp(0, max_mag).to(torch.int32)
    out = torch.where(s == 1, -mag, mag).to(torch.int32)
    out = torch.where(c == 0, 0, out)
    nar = c == NAR(N)
    out = torch.where(nar, 0, out).to(torch.int32)
    return out, (of & ~(c == 0) & ~nar)


def pofx_normalized(codes_nm1: torch.Tensor, N: int, ES: int, M: int,
                    rounding: str = "trunc"):
    """Normalized (N-1)-bit codes -> (FxP(M, M-1) int32 codes, OF flags)."""
    return _pofx_impl(norm_expand(codes_nm1, N), N, ES, M, M - 1, rounding)


@functools.lru_cache(maxsize=64)
def pofx_norm_lut(N: int, ES: int, M: int,
                  rounding: str = "trunc") -> np.ndarray:
    """2^(N-1)-entry normalized-posit -> FxP(M, M-1) decode table (int32)."""
    out, _ = pofx_normalized(torch.arange(1 << (N - 1), dtype=torch.int32),
                             N, ES, M, rounding)
    return out.numpy().astype(np.int32)
