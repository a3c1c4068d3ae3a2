"""Normalized Posit — the ExPAN(N)D (N-1)-bit storage representation.

Port of ``repro/core/normalized_posit.py``. A normalized N-bit posit
(|value| <= 1) always has its two leading bits equal, so only N-1 bits are
stored; decode replicates the MSB.
"""
from __future__ import annotations

import torch

from .posit import posit_encode

__all__ = ["norm_expand", "norm_compress", "norm_encode"]


def norm_expand(codes: torch.Tensor, N: int) -> torch.Tensor:
    """(N-1)-bit normalized code -> N-bit posit code (replicate MSB)."""
    c = codes.to(torch.int32) & ((1 << (N - 1)) - 1)
    s = (c >> (N - 2)) & 1
    lower = c & ((1 << (N - 2)) - 1)
    return (s << (N - 1)) | (s << (N - 2)) | lower


def norm_compress(codes: torch.Tensor, N: int) -> torch.Tensor:
    """N-bit posit code -> (N-1)-bit normalized code (drop duplicated bit)."""
    c = codes.to(torch.int32) & ((1 << N) - 1)
    s = (c >> (N - 1)) & 1
    lower = c & ((1 << (N - 2)) - 1)
    return (s << (N - 2)) | lower


def _signed_clamp(codes: torch.Tensor, N: int) -> torch.Tensor:
    """Clamp raw N-bit posit codes (as signed ints) onto the normalized range."""
    c = codes.to(torch.int32) & ((1 << N) - 1)
    signed = torch.where(c >= (1 << (N - 1)), c - (1 << N), c)
    signed = signed.clamp(-(1 << (N - 2)), (1 << (N - 2)) - 1)
    return signed & ((1 << N) - 1)


def norm_encode(x: torch.Tensor, N: int, ES: int) -> torch.Tensor:
    return norm_compress(_signed_clamp(posit_encode(x, N, ES), N), N)
