"""Flash-decode attention over a byte-wide quantized KV cache, on Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/kv_flash_decode.py::
kv_flash_decode`` (``pallas_call`` at :139). The CUDA kernel
(``csrc/kv_flash_decode.cu``, body ``csrc/kv_flash_common.cuh``) is
split-S flash-decoding: ``plan`` cuts S into chunks of L positions from the
shapes alone, one block per (b, g) and chunk runs the online softmax (m, l
and acc in f32) over its chunk, streaming code bytes with 16-byte
``cp.async`` and dequantizing them in registers, and the last block of each
(b, g) combines the chunks' partials in split order. No float atomics, so
two calls give the same bits; one launch and one count per call.

Bound on the card: the code bytes, 2 * S_valid * Dh per (b, g) per layer
and step; chunks past ``pos[b]`` read nothing. ``with_lse`` adds each row's
log-sum-exp, written by the block that normalizes the row, for a grid rank
that holds one block of the cache's positions; there a slot of length
<= 0 (the block wholly past its position) reads nothing: out 0, lse -inf.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.quantizers import QuantSpec, _codes_to_values
from . import LAUNCHES, require_cuda
from .ref import kv_flash_decode_ref

__all__ = ["kv_flash_decode", "kv_flash_decode_ref", "plan", "Plan", "HEAD_DIMS"]

# csrc/kv_flash_common.cuh's tile of positions; SMS is the H100's count of
# SMs, and the split aims at TARGET_BLOCKS, two blocks a SM
TILE, SMS = 32, 132
TARGET_BLOCKS = 2 * SMS
# S is rounded up to a multiple of ROUND before the chunk is chosen; a block
# holds ROWS query rows (more rows take more blocks)
ROUND, ROWS = 256, 8
# the head dims the CUDA body is built for (32 x its values a lane; 192 is
# nemotron-4-340b's) and the most query rows a group
HEAD_DIMS, MAX_R = (32, 64, 128, 192, 256), 32


class Plan(NamedTuple):
    """How a call splits S: ``splits`` chunks of ``chunk`` positions (a
    multiple of TILE; the last chunk may reach past S)."""
    chunk: int
    splits: int

    def workspace(self, B: int, G: int, R: int, Dh: int) -> int:
        """f32 partials the kernel writes: acc (Dh) and (m, l) per row and
        chunk; none unsplit."""
        return self.splits * B * G * R * (Dh + 2) if self.splits > 1 else 0


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


@functools.lru_cache(maxsize=1024)
def plan(B: int, G: int, S: int) -> Plan:
    """The split of S for B slots and G groups, from the shapes alone (a
    read of ``pos`` would cost a host sync per layer).

    The target is ``2^floor(log2(TARGET_BLOCKS / (B * G)))`` chunks per
    (b, g); the chunk is ``max(TILE, 2^floor(log2(ceil256(S) / target)))``
    with ``ceil256(S)`` S rounded up to a multiple of 256, and the chunks
    are aligned to absolute positions. So there are at most 2 * target
    chunks, and the chunk is a power of two, hence a multiple of TILE.

    Dense and paged agree bit for bit because their chunk agrees: a dense
    cache of ``max_len`` and a paged one of ``ceil(max_len / ps) * ps``
    round up to the same multiple of 256 whenever ``ps`` divides 256 (the
    paged length is the first multiple of ps at or past max_len, so no
    multiple of 256 lies between the two); other page sizes agree unless a
    multiple of 256 lies in [max_len, the paged length) and the rounding
    moves the chunk across a power of two (the tests check ps = 48 at the
    lengths they use).
    """
    target = _pow2_floor(TARGET_BLOCKS // max(1, B * G))
    s_r = -(-max(1, S) // ROUND) * ROUND
    chunk = max(TILE, _pow2_floor(s_r // target))
    return Plan(chunk, -(-max(1, S) // chunk))


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed arrival counters (one per (b, g) and ROWS query rows) for the
    calls on one device and stream, kept between calls and regrown as
    needed: calls on one stream run one after another, and the last block
    to arrive sets its counter back to 0."""
    key = (device.index, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return c


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte-aligned base (the kernel's 16-byte
    copies); a copy only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _q_pos(q: torch.Tensor, pos: torch.Tensor, B: int):
    """q as the kernel reads it (f32 or bf16, contiguous) and pos as int32
    with its stride (0: one length for every slot); no copy where they are
    already so."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        q = q.to(torch.float32)
    q = q.contiguous()
    pos = pos.reshape(-1)
    if pos.dtype != torch.int32:
        pos = pos.to(torch.int32)
    if pos.numel() not in (1, B):
        raise ValueError(f"pos has {pos.numel()} entries for {B} slots")
    pos = pos.contiguous()
    return q, pos, 0 if pos.numel() == 1 else 1


def _launch_args(q, spec: QuantSpec, B: int, G: int, R: int, Dh: int, S: int):
    """The pieces both wrappers pass after the cache: byte table, output,
    workspace, counters, the plan and the decode step (2^-F for fxp; 0
    decodes through the table)."""
    p = plan(B, G, S)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty((B, G, R, Dh), dtype=torch.float32, device=q.device)
    ws = torch.empty(max(1, p.workspace(B, G, R, Dh)), dtype=torch.float32, device=q.device)
    counters = _counters(q.device, stream, B * G * -(-R // ROWS))
    step = 2.0 ** -spec.F if spec.kind == "fxp" else 0.0
    return (_byte_table(spec, str(q.device)), out, ws, counters, p, step, stream)


@functools.lru_cache(maxsize=32)
def _byte_table(spec: QuantSpec, device: str) -> torch.Tensor:
    """Value of every code byte: int8(c) * 2^-F (fxp) or the PoFx table of
    the low N-1 bits (pofx) — the plain path's exact decode."""
    c = torch.arange(256, dtype=torch.int32)
    if spec.kind == "fxp":
        codes = c.to(torch.uint8).view(torch.int8)
    else:
        codes = c & ((1 << (spec.N - 1)) - 1)
    return _codes_to_values(codes, spec).to(torch.float32).to(device)


def kv_flash_decode(q: torch.Tensor, k_codes: torch.Tensor,
                    k_scale: torch.Tensor, v_codes: torch.Tensor,
                    v_scale: torch.Tensor, pos, spec: QuantSpec,
                    with_lse: bool = False):
    """One-token attention against a quantized heads-major cache.

    q (B, G, R, Dh); codes (B, G, S, Dh) int8/uint8; scales (B, G, 1, Dh);
    pos scalar or (B,) valid lengths (mask ``arange(S) < pos``).
    Returns (B, G, R, Dh) f32; with ``with_lse`` also each row's
    log-sum-exp of its masked scores, (B, G, R) f32 (a block of a cache's
    positions held apart from the others: ``nn.sharding.combine_partials``
    weighs the blocks by it); a slot of length <= 0 then gives out 0 and
    lse -inf, as ``kv_flash_decode_ref``.
    """
    B, G, R, Dh = q.shape
    S = k_codes.shape[2]
    if v_codes.shape != k_codes.shape:
        raise ValueError(f"k/v code shape mismatch: {tuple(k_codes.shape)} vs "
                         f"{tuple(v_codes.shape)}")
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(sc.shape[-3:]) != (G, 1, Dh):
            raise ValueError(
                f"kv {name} must be per-head-dim-channel "
                f"(..., {G}, 1, {Dh}); got {tuple(sc.shape)}")
    if not q.is_cuda:
        return kv_flash_decode_ref(q, k_codes, k_scale, v_codes, v_scale,
                                   pos, spec, with_lse=with_lse)
    pos = torch.as_tensor(pos, device=q.device)
    require_cuda("kv_flash_decode", q, k_codes, k_scale, v_codes, v_scale, pos)
    if tuple(k_codes.shape[:2]) != (B, G) or k_codes.shape[3] != Dh:
        raise ValueError(f"cache {tuple(k_codes.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if k_codes.element_size() != 1 or v_codes.element_size() != 1:
        raise ValueError("kv_flash_decode wants byte-wide codes")
    if Dh not in HEAD_DIMS or R > MAX_R:
        raise ValueError(f"kv_flash_decode supports Dh in {HEAD_DIMS} and "
                         f"R <= {MAX_R}, got Dh={Dh}, R={R}")
    from .build import check, library
    qk, pos_b, pos_stride = _q_pos(q, pos, B)
    kc, vc = _aligned(k_codes), _aligned(v_codes)
    ks = k_scale.to(torch.float32).expand(B, G, 1, Dh).contiguous()
    vs = v_scale.to(torch.float32).expand(B, G, 1, Dh).contiguous()
    table, out, ws, counters, p, step, stream = _launch_args(q, spec, B, G, R, Dh, S)
    lse = (torch.empty((B, G, R), dtype=torch.float32, device=q.device)
           if with_lse else None)
    check(library("kv_flash_decode").kv_flash_decode(
        qk.data_ptr(), kc.data_ptr(), ks.data_ptr(), vc.data_ptr(),
        vs.data_ptr(), pos_b.data_ptr(), table.data_ptr(), out.data_ptr(),
        ws.data_ptr(), counters.data_ptr(), lse.data_ptr() if with_lse else None,
        B, G, R, S, Dh, p.chunk, p.splits, pos_stride,
        int(qk.dtype == torch.bfloat16), Dh ** -0.5, step, stream),
        "kv_flash_decode")
    LAUNCHES["kv_flash_decode"] += 1
    return (out, lse) if with_lse else out
