"""Flash-decode attention through a block table over a page pool, on Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/kv_flash_paged_decode.py::
kv_flash_paged_decode`` (``pallas_call`` at :142). The CUDA kernel
(``csrc/kv_flash_paged_decode.cu``) is ``kv_flash_decode``'s split-S body
(``csrc/kv_flash_common.cuh``) with each code row resolved through the
slot's block table over the logical positions [0, max_pages * ps), split
by the same ``plan``. Garbage page 0 and tails at or past ``pos`` are read
and masked, not trimmed. The plan gives a dense cache of ``max_len`` and a
paged one of ``ceil(max_len / ps) * ps`` the same chunk when ps divides 256,
and then, on the same logical cache, the output equals ``kv_flash_decode``'s
bit for bit, so paged and dense serving give the same tokens.

Bound on the card: the code bytes of the valid positions, 2 * S_valid * Dh
per (b, g) per layer and step, plus the block table.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizers import QuantSpec
from . import LAUNCHES, require_cuda
from .kv_flash_decode import HEAD_DIMS, MAX_R, _aligned, _launch_args, _q_pos
from .ref import kv_flash_paged_decode_ref

__all__ = ["kv_flash_paged_decode", "kv_flash_paged_decode_ref"]


def kv_flash_paged_decode(q: torch.Tensor, k_pool: torch.Tensor,
                          k_scale: torch.Tensor, v_pool: torch.Tensor,
                          v_scale: torch.Tensor, tables: torch.Tensor, pos,
                          spec: QuantSpec) -> torch.Tensor:
    """One-token attention against a paged quantized code pool.

    q (B, G, R, Dh); pools (n_pages, G, ps, Dh) int8/uint8; scales global
    per layer (G, 1, Dh); tables (B, max_pages) physical page ids in
    [0, n_pages) (garbage-page padded; the engine's ``PagedKVManager``
    hands out only such ids, and checking them here would cost a device
    sync per layer); pos scalar or (B,) valid lengths (mask
    ``idx < pos``). Returns (B, G, R, Dh) f32.
    """
    B, G, R, Dh = q.shape
    n_pages, Gp, ps, Dhp = k_pool.shape
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"k/v pool shape mismatch: {tuple(k_pool.shape)} vs "
                         f"{tuple(v_pool.shape)}")
    if (Gp, Dhp) != (G, Dh):
        raise ValueError(f"pool (G, Dh) {(Gp, Dhp)} does not match queries "
                         f"{(G, Dh)}")
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(sc.shape) != (G, 1, Dh):
            raise ValueError(
                f"paged kv {name} must be global per-head-dim-channel "
                f"({G}, 1, {Dh}); got {tuple(sc.shape)}")
    if tables.ndim != 2 or tables.shape[0] != B:
        raise ValueError(f"tables must be (B={B}, max_pages); got "
                         f"{tuple(tables.shape)}")
    if not q.is_cuda:
        return kv_flash_paged_decode_ref(q, k_pool, k_scale, v_pool, v_scale,
                                         tables, pos, spec)
    pos = torch.as_tensor(pos, device=q.device)
    require_cuda("kv_flash_paged_decode", q, k_pool, k_scale, v_pool,
                 v_scale, tables, pos)
    if k_pool.element_size() != 1 or v_pool.element_size() != 1:
        raise ValueError("kv_flash_paged_decode wants byte-wide codes")
    if Dh not in HEAD_DIMS or R > MAX_R:
        raise ValueError(f"kv_flash_paged_decode supports Dh in {HEAD_DIMS} "
                         f"and R <= {MAX_R}, got Dh={Dh}, R={R}")
    from .build import check, library
    max_pages = tables.shape[1]
    qk, pos_b, pos_stride = _q_pos(q, pos, B)
    kc, vc = _aligned(k_pool), _aligned(v_pool)
    ks = k_scale.to(torch.float32).contiguous()
    vs = v_scale.to(torch.float32).contiguous()
    tb = tables.to(torch.int32).contiguous()
    table, out, ws, counters, p, step, stream = _launch_args(
        q, spec, B, G, R, Dh, max_pages * ps)
    check(library("kv_flash_paged_decode").kv_flash_paged_decode(
        qk.data_ptr(), kc.data_ptr(), ks.data_ptr(), vc.data_ptr(),
        vs.data_ptr(), tb.data_ptr(), pos_b.data_ptr(), table.data_ptr(),
        out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, G, R, ps,
        max_pages, Dh, p.chunk, p.splits, pos_stride,
        int(qk.dtype == torch.bfloat16), Dh ** -0.5, step, stream),
        "kv_flash_paged_decode")
    LAUNCHES["kv_flash_paged_decode"] += 1
    return out
