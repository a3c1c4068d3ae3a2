"""Normalized Posit — the ExPAN(N)D (N-1)-bit storage representation.

Port of ``repro/core/normalized_posit.py``. A normalized N-bit posit
(|value| <= 1) always has its two leading bits equal, so only N-1 bits are
stored; decode replicates the MSB. The ``*_np`` functions and
``pack_bits``/``unpack_bits`` (true k-bit packing) are the reference's
numpy storage side: checkpoints store posit-packed leaves through them.
"""
from __future__ import annotations

import numpy as np
import torch

from .posit import (posit_decode, posit_decode_np, posit_encode, posit_encode_arith,
                    posit_encode_np)

__all__ = ["norm_expand", "norm_compress", "norm_encode", "norm_encode_arith",
           "norm_encode_np", "norm_decode", "norm_decode_np", "norm_max", "pack_bits",
           "unpack_bits"]


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


def norm_encode_arith(x: torch.Tensor, N: int, ES: int) -> torch.Tensor:
    """Gather-free normalized-posit encode (``posit.posit_encode_arith``'s
    bit-arithmetic rounding): the gradient transport's encoder."""
    return norm_compress(_signed_clamp(posit_encode_arith(x, N, ES), N), N)


def norm_decode(codes: torch.Tensor, N: int, ES: int) -> torch.Tensor:
    """(N-1)-bit normalized codes -> float32 values."""
    return posit_decode(norm_expand(codes, N), N, ES)


def norm_encode_np(x, N: int, ES: int) -> np.ndarray:
    """float64 numpy values -> (N-1)-bit normalized codes (int32)."""
    full = torch.from_numpy(posit_encode_np(x, N, ES))
    return norm_compress(_signed_clamp(full, N), N).numpy()


def norm_decode_np(codes, N: int, ES: int) -> np.ndarray:
    """(N-1)-bit normalized codes -> float64 values."""
    c = torch.from_numpy(np.asarray(codes).astype(np.int32))
    return posit_decode_np(norm_expand(c, N).numpy(), N, ES)


def norm_max(N: int, ES: int) -> float:
    """Largest representable normalized-posit magnitude (< 1)."""
    return float(norm_decode_np(np.asarray([(1 << (N - 2)) - 1]), N, ES)[0])


PACK_CHUNK = 1 << 20        # codes a pass; a multiple of 8, so every pass ends on a byte


def pack_bits(codes, k: int) -> np.ndarray:
    """Pack int codes (< 2^k) into a uint8 byte stream, MSB-first: the
    reference's bytes, built ``PACK_CHUNK`` codes at a time (a byte-wide k
    is the codes' own bytes)."""
    flat = np.asarray(codes).reshape(-1)
    if k == 8:
        return flat.astype(np.uint8)
    shifts = np.arange(k - 1, -1, -1, dtype=np.uint32)
    out = []
    for i in range(0, max(flat.size, 1), PACK_CHUNK):
        part = flat[i:i + PACK_CHUNK].astype(np.uint32)
        out.append(np.packbits(((part[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)))
    return np.concatenate(out)


def unpack_bits(packed, k: int, count: int) -> np.ndarray:
    """Inverse of pack_bits: recover ``count`` k-bit codes (int32)."""
    packed = np.asarray(packed, dtype=np.uint8).reshape(-1)
    if k == 8:
        return packed[:count].astype(np.int32)
    weights = (1 << np.arange(k - 1, -1, -1, dtype=np.uint32))
    out = []
    for i in range(0, max(count, 1), PACK_CHUNK):
        n = min(PACK_CHUNK, count - i)
        bits = np.unpackbits(packed[i * k // 8:(i + n) * k // 8 + 1])[: n * k]
        out.append((bits.reshape(n, k).astype(np.uint32) * weights).sum(axis=1)
                   .astype(np.int32))
    return np.concatenate(out)
