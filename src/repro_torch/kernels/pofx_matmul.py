"""Fused PoFx decode + matmul — the Move&Store datapath on Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/pofx_matmul.py::
pofx_matmul`` (``pallas_call`` at :89). The CUDA kernel is
``csrc/pofx_matmul.cu``: each block owns an output tile, stages the
2^(N-1)-entry decode table (``pofx_norm_lut`` / 2^(M-1), exact in f32) in
shared memory, streams uint8 code tiles with the matching x tiles, and
accumulates in f32 registers; ``* scale[n]`` is applied in the epilogue.

Bound on the card: the bytes of the codes. On the serving path x has 4 rows
(decode) or the prompt bucket (prefill), far below the ridge point, so the
product is limited by streaming k*n code bytes; the design decodes in
shared memory so decoded weights never reach device memory. No tensor
cores, so no TF32: the result is the f32 product up to summation order.
For a later speed PR: every decoded weight k/128 (|k| <= 127) is exact in
bf16, so a bf16 wgmma path loses nothing on the weight side.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.pofx import pofx_norm_lut
from . import LAUNCHES, require_cuda
from .ref import pofx_matmul_ref

__all__ = ["pofx_matmul", "pofx_matmul_ref"]


@functools.lru_cache(maxsize=32)
def _lut_values(N: int, ES: int, M: int, device: str) -> torch.Tensor:
    lut = torch.as_tensor(pofx_norm_lut(N, ES, M), dtype=torch.float32)
    return (lut * (1.0 / (1 << (M - 1)))).to(device)


def pofx_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                N: int, ES: int, M: int = 8) -> torch.Tensor:
    """x (m, k) @ decode(codes (k, n)) * scale (n,) -> (m, n) f32."""
    if x.ndim != 2 or codes.ndim != 2:
        raise ValueError(f"pofx_matmul wants 2-D x and codes, got "
                         f"{tuple(x.shape)} and {tuple(codes.shape)}")
    m, k = x.shape
    k2, n = codes.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} @ codes "
                         f"{tuple(codes.shape)}")
    if scale.numel() != n:
        raise ValueError(f"scale has {scale.numel()} entries for {n} columns")
    if not x.is_cuda:
        return pofx_matmul_ref(x, codes, scale, N, ES, M)
    require_cuda("pofx_matmul", x, codes, scale)
    if codes.dtype != torch.uint8:
        raise ValueError(f"pofx_matmul codes must be uint8, got {codes.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pofx_matmul x must be f32 or bf16, got {x.dtype}")
    if N - 1 > 8:
        raise ValueError(f"pofx_matmul decodes byte-wide codes (N <= 9), got N={N}")
    from .build import check, library
    x = x.contiguous()
    codes = codes.contiguous()
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    lut = _lut_values(N, ES, M, str(x.device))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = library("pofx_matmul")
    fn = lib.pofx_matmul_bf16 if x.dtype == torch.bfloat16 else lib.pofx_matmul_f32
    check(fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), lut.data_ptr(),
             out.data_ptr(), m, k, n, 1 << (N - 1),
             torch.cuda.current_stream(x.device).cuda_stream), "pofx_matmul")
    LAUNCHES["pofx_matmul"] += 1
    return out
