"""FxP MAC — int8 x int8 -> int32 accumulate on Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/fxp_matmul.py::
fxp_matmul`` (``pallas_call`` at :51). The CUDA kernel
(``csrc/fxp_matmul.cu``) stages 32x64 output tiles' operands in shared
memory as packed 4-byte words and accumulates with ``__dp4a``.

Bound on the card: the bytes of ``b`` at the serving path's 4-row decode
(the weights of the fxp rules of mixed policies). Integer sums are exact in
any order, so the kernel equals ``fxp_matmul_ref`` bit for bit. s8 wgmma is
the later speed path.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, require_cuda
from .ref import fxp_matmul_ref

__all__ = ["fxp_matmul", "fxp_matmul_ref"]


def fxp_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) int8 @ b (k, n) int8 -> (m, n) int32."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"fxp_matmul shape mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if not a.is_cuda:
        return fxp_matmul_ref(a, b)
    require_cuda("fxp_matmul", a, b)
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"fxp_matmul wants int8 operands, got {a.dtype}, {b.dtype}")
    from .build import check, library
    a = a.contiguous()
    b = b.contiguous()
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    check(library("fxp_matmul").fxp_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
        torch.cuda.current_stream(a.device).cuda_stream), "fxp_matmul")
    LAUNCHES["fxp_matmul"] += 1
    return out
