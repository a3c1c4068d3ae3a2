"""Plain PyTorch versions of every kernel (the correctness contract).

Port of ``repro/kernels/ref.py``. The wrappers use these on CPU tensors;
the tests hold them against the reference package and ``chip_smoke.py``
holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.pofx import pofx_normalized
from repro_torch.core.quantizers import QuantSpec, _codes_to_values, kv_dequantize

__all__ = ["decode_norm_to_fxp", "pofx_matmul_ref", "fxp_matmul_ref",
           "kv_flash_decode_ref"]


def decode_norm_to_fxp(codes: torch.Tensor, N: int, ES: int,
                       M: int) -> torch.Tensor:
    """Normalized posit codes -> FxP(M, M-1) int32 by bit-level Algorithm 1."""
    out, _ = pofx_normalized(codes, N, ES, M)
    return out


def pofx_matmul_ref(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                    N: int, ES: int, M: int = 8) -> torch.Tensor:
    """x (m, k) @ (decode(codes (k, n)) / 2^(M-1)) * scale (n,) -> f32.

    The decode goes through ``pofx_norm_lut``, which the tests hold equal
    to the bit-level ``decode_norm_to_fxp`` over every code; the table keeps
    the plain version's memory at one int64 index per weight.
    """
    w = _codes_to_values(codes, QuantSpec(kind="pofx", N=N, ES=ES, M=M))
    y = torch.matmul(x.to(torch.float32), w)
    return y * scale.reshape(1, -1).to(torch.float32)


def fxp_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32, exact: float64 holds every partial sum exactly
    (|sum| <= 2^14 * k < 2^53), and float64 matmul runs on CPU and CUDA."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def kv_flash_decode_ref(q, k_codes, k_scale, v_codes, v_scale, pos,
                        spec: QuantSpec) -> torch.Tensor:
    """Dequantize the whole cache, then masked softmax attention in f32.

    q: (B, G, R, Dh); codes: (B, G, S, Dh); scales: (B, G, 1, Dh);
    pos: scalar or (B,) valid lengths.
    """
    S = k_codes.shape[2]
    k = kv_dequantize(k_codes, spec, k_scale, torch.float32)
    v = kv_dequantize(v_codes, spec, v_scale, torch.float32)
    s = torch.einsum("bgrd,bgsd->bgrs", q.to(torch.float32), k) \
        * q.shape[-1] ** -0.5
    pos = torch.as_tensor(pos, device=q.device).reshape(-1, 1)
    valid = torch.arange(S, device=q.device)[None, :] < pos
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgrs,bgsd->bgrd", p, v)
