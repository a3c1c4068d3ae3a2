"""FxP MAC — int8 x int8 -> int32 accumulate on Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/fxp_matmul.py::
fxp_matmul`` (``pallas_call`` at :51). The CUDA kernel is
``csrc/fxp_matmul.cu``.

What bounds it on the card: the k*n bytes of ``b`` (the weights of the fxp
rules of mixed policies) at decode (m = the slots) and at prefill (m = 64)
alike. So the kernel streams ``b`` once with 16-byte ``cp.async`` copies into
a ring of shared-memory tiles and splits k (``plan``) so that the column
blocks times the slices put ~2 blocks on every SM at decode; the products
run on the s8 tensor cores (``wgmma.m64nNk32``, the swapped product with
``b`` transposed into the register operand, m padded to N = 8..64 in shared
memory only). The slices' int32 partial sums go to the workspace
``pofx_matmul`` keeps per stream, and the last block of each tile adds them.
Integer sums are exact in any order, so every split gives
``fxp_matmul_ref``'s bits, and the split may follow the block, which
follows m.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import LAUNCHES, require_cuda
from .pofx_matmul import BN, MAX_SLICES, SMS, Plan, _scratch
from .pofx_matmul import plan as split_k
from .ref import fxp_matmul_ref

__all__ = ["fxp_matmul", "fxp_matmul_ref", "plan", "tile"]


def tile(m: int) -> Tuple[int, int, int]:
    """The kernel's block at m rows, as ``csrc/fxp_matmul.cu`` picks it: (a
    rows a block holds = the wgmma's N, warpgroups a block, the blocks a SM
    the split aims at). Above 64 rows a grid axis walks 64-row tiles of m.
    At m > 16 the blocks are wider and one a SM is aimed at, because the
    partial sums grow with m."""
    if m <= 8:
        return 8, 1, 2
    if m <= 16:
        return 16, 1, 2
    if m <= 32:
        return 32, 2, 1
    return 64, 2, 1


@functools.lru_cache(maxsize=1024)
def plan(m: int, k: int, n: int) -> Plan:
    """The split of k at (m, k, n): ``pofx_matmul.plan`` for the block at m
    (``tile``), its target shared among the m tiles. At most ``MAX_SLICES``
    slices (half that for two-warpgroup blocks), each of two 64-row tiles or
    more, and the column blocks times the slices times the m tiles stay at
    or below the larger of the target and one slice a block."""
    rows, wg, per_sm = tile(m)
    m_tiles = -(-m // rows)
    return split_k(k, n, BN * wg, max(1, per_sm * SMS // m_tiles),
                   MAX_SLICES if wg == 1 else MAX_SLICES // 2)


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
    if out.numel() == 0:
        return out
    p = plan(m, k, n)
    rows, wg, _ = tile(m)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    ws, counters = _scratch(a.device, stream, p.workspace(m, n),
                            -(-n // (BN * wg)) * -(-m // rows))
    check(library("fxp_matmul").fxp_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
        m, k, n, p.slice_len, stream), "fxp_matmul")
    LAUNCHES["fxp_matmul"] += 1
    return out
