"""Fused PoFx decode + matmul — the Move&Store datapath on Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/pofx_matmul.py::
pofx_matmul`` (``pallas_call`` at :89). The CUDA kernel is
``csrc/pofx_matmul.cu``.

What bounds it on the card: at decode (m = the slots) the bytes of the k*n
codes, far below the bf16 ridge point; at prefill (m = 64) the shared-memory
traffic of the decode and of the tensor cores' operands, and their latency;
above m ~300 the tensor cores. So the kernel streams every code byte once,
with 16-byte ``cp.async`` copies into a ring of shared-memory tiles, and
splits k (``plan``, at most 32 slices) so that the column blocks times the
slices put ~2 blocks on every SM at decode; the slices' partial sums go to
a workspace this wrapper keeps per stream, and the last block of each tile
(or, at m > 16, a second pass; one count here either way) adds them in
slice order. Decoding is one lookup in a 2^(N-1)-entry table
(``pofx_norm_lut`` / 2^(M-1)) kept once per bank in shared memory, so
decoded weights never reach device memory. bf16 activations run on the
tensor cores (``wgmma``, the decoded weights in its register operand; every
value j/128 with |j| <= 127 is exact in bf16, so only the summation order
differs from the plain version); f32 activations stay exact f32 on CUDA
cores (no TF32). No atomics, so two calls give the same bits; the f32 split
depends on (k, n) only, so an f32 row's result does not depend on m.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.pofx import pofx_norm_lut
from . import LAUNCHES, require_cuda
from .ref import pofx_matmul_ref

__all__ = ["pofx_matmul", "pofx_matmul_ref", "plan", "bf16_tile", "call_plan", "Plan"]

# csrc/pofx_matmul.cu's tiles: a warpgroup owns BN columns of n, k goes in
# BK-row tiles; SMS is the H100's count of SMs, which the split aims to fill
BN, BK, SMS = 128, 64, 132
# the bf16 split aims at TARGET_BLOCKS, two blocks a SM at decode
TARGET_BLOCKS = 2 * SMS
# the f32 kernel: F32_ROWS x rows and one warpgroup a block. Its split (four
# blocks a SM, at most 16 slices) is the one the f32 sum order was first
# checked with: chip_smoke.py phase 4 holds f32 kernel streams token for
# token against the plain version's, sampled ones too, and the bf16 split
# parts one sampled stream there at a near-tie.
F32_ROWS, F32_PLAN = 4, dict(target=4 * SMS, max_slices=16)
# at most 32 slices, each of two BK tiles or more; 16 where the partial sums
# are large (m > 16). Past these the partial sums and the blocks' start-up
# cost more than the extra blocks gain at the serving shapes (measured on the
# H100 while the kernel was tuned).
MAX_SLICES = 32


class Plan(NamedTuple):
    """How a call splits k: ``slices`` slices of ``slice_len`` rows each (a
    multiple of BK; the last may be shorter)."""
    slice_len: int
    slices: int

    def workspace(self, m: int, n: int) -> int:
        """f32 partial sums the kernel writes at (m, n): none unsplit."""
        return self.slices * m * n if self.slices > 1 else 0


def plan(k: int, n: int, bn: int = BN, target: int = TARGET_BLOCKS,
         max_slices: int = MAX_SLICES) -> Plan:
    """The split of k for a (k, n) weight and blocks of ``bn`` columns:
    enough slices (at most ``max_slices``, two BK tiles each or more) that
    the column blocks times the slices come near ``target`` blocks. The f32
    path's split (``F32_PLAN``) depends on (k, n) only, so a row's f32 sums
    are taken in the same order in decode (m = slots) and in a prefill of any
    length."""
    n_blocks = max(1, -(-n // bn))
    tiles = max(1, -(-k // BK))
    want = max(1, min(tiles // 2, max_slices, target // n_blocks))
    slice_len = -(-tiles // want) * BK
    return Plan(slice_len, max(1, -(-k // slice_len)))


def bf16_tile(m: int) -> Tuple[int, int, int]:
    """The bf16 kernel's block at m rows, as ``pofx_matmul_bf16`` picks it:
    (x rows a block holds = the wgmma's N, warpgroups a block, the blocks a
    SM the split aims at). Wider blocks at larger m keep the x tile a block
    re-reads at half its code tile or less; at m > 16 one block a SM is
    aimed at, because the partial sums grow with m."""
    if m <= 8:
        return 8, 1, 2
    if m <= 16:
        return 16, 1, 2
    if m <= 32:
        return 32, 2, 1
    return 64, 2, 1


@functools.lru_cache(maxsize=1024)
def call_plan(m: int, k: int, n: int, bf16: bool) -> Plan:
    """The split a call at (m, k, n) uses: the f32 path's from (k, n) alone,
    the bf16 path's from its block at m."""
    if not bf16:
        return plan(k, n, **F32_PLAN)
    _, wg, per_sm = bf16_tile(m)
    return plan(k, n, BN * wg, per_sm * SMS, MAX_SLICES if wg == 1 else MAX_SLICES // 2)


_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, ws: int,
             tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split's workspace (``ws`` f32) and zeroed arrival counters (one
    per output tile) for the calls on one device and stream, kept between
    calls and regrown as needed: calls on one stream run one after another,
    and the kernel sets each counter back to 0 when its tile is done."""
    key = (device.index, stream)
    buf, counters = _SCRATCH.get(key, (None, None))
    if buf is None or buf.numel() < ws:
        buf = torch.empty(max(ws, 1 << 20), dtype=torch.float32, device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=device)
    _SCRATCH[key] = buf, counters
    return buf, counters


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
    if out.numel() == 0:
        return out
    bf16 = x.dtype == torch.bfloat16
    p = call_plan(m, k, n, bf16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rows, wg = bf16_tile(m)[:2] if bf16 else (F32_ROWS, 1)
    ws, counters = _scratch(x.device, stream, p.workspace(m, n),
                            -(-n // (BN * wg)) * -(-m // rows))
    lib = library("pofx_matmul")
    fn = lib.pofx_matmul_bf16 if bf16 else lib.pofx_matmul_f32
    check(fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), lut.data_ptr(),
             out.data_ptr(), ws.data_ptr(), counters.data_ptr(), m, k, n, 1 << (N - 1),
             p.slice_len, stream), "pofx_matmul")
    LAUNCHES["pofx_matmul"] += 1
    return out
