"""PoFx decode — normalized-posit codes to FxP(M, M-1) int8 codes.

Replaces the Pallas TPU kernel ``src/repro/kernels/pofx_decode.py::
pofx_decode`` (``pallas_call`` at :45). The CUDA kernel is
``csrc/pofx_decode.cu``: each block first builds the 2^(N-1)-entry decode
table in shared memory by running the paper's Algorithm 1 bit by bit once
per entry (``csrc/pofx_common.cuh``), then a persistent grid walks the array
in 16-byte spans, one byte extract and one shared lookup a code, 16 codes per
16-byte load and store.

Bound on the card: bytes, r*c in and r*c out. The kernel reads each code
once and writes each output once; ragged shapes are masked in the kernel
(the TPU wrapper pads to its block and slices back).
"""
from __future__ import annotations

import torch

from . import LAUNCHES, require_cuda
from .ref import pofx_decode_ref

__all__ = ["pofx_decode", "pofx_decode_ref"]


def pofx_decode(codes: torch.Tensor, N: int, ES: int, M: int = 8) -> torch.Tensor:
    """Decode a 2-D array of (N-1)-bit normalized posit codes of Posit(N,
    ES) to FxP(M, M-1) int8 codes (the low N-1 bits of each code are
    read). Parameters the kernel cannot take raise on every device; CPU
    tensors (of any integer dtype) get the plain version, CUDA tensors
    (uint8) the kernel."""
    if codes.ndim != 2:
        raise ValueError(f"pofx_decode wants 2-D codes, got {tuple(codes.shape)}")
    if N - 1 > 8 or N < 3:
        raise ValueError(f"pofx_decode decodes byte-wide codes (3 <= N <= 9), got N={N}")
    if not 0 <= ES <= 4:
        raise ValueError(f"pofx_decode supports 0 <= ES <= 4, got ES={ES}")
    if not 1 <= M <= 8:
        raise ValueError(f"pofx_decode writes int8 (1 <= M <= 8), got M={M}")
    if not codes.is_cuda:
        return pofx_decode_ref(codes, N, ES, M)
    require_cuda("pofx_decode", codes)
    if codes.dtype != torch.uint8:
        raise ValueError(f"pofx_decode codes must be uint8, got {codes.dtype}")
    r, c = codes.shape
    out = torch.empty((r, c), dtype=torch.int8, device=codes.device)
    if out.numel() == 0:
        return out
    if codes.stride(1) != 1 or codes.stride(0) < c:
        codes = codes.contiguous()
    if codes.is_contiguous():
        rows, cols, ld_in, ld_out = 1, r * c, r * c, r * c    # one flat row
    else:
        rows, cols, ld_in, ld_out = r, c, codes.stride(0), c
    from .build import check, library
    check(library("pofx_decode").pofx_decode(
        codes.data_ptr(), out.data_ptr(), rows, cols, ld_in, ld_out, N, ES, M,
        torch.cuda.current_stream(codes.device).cuda_stream), "pofx_decode")
    LAUNCHES["pofx_decode"] += 1
    return out
