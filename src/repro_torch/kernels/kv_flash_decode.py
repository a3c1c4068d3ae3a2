"""Flash-decode attention over a byte-wide quantized KV cache, on Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/kv_flash_decode.py::
kv_flash_decode`` (``pallas_call`` at :139). The CUDA kernel
(``csrc/kv_flash_decode.cu``) runs one block per (b, g) with one warp per
query row; it walks S in 32-position tiles, dequantizes the code bytes
through a 256-entry table times the per-channel scale on their way into
shared memory, and keeps the online-softmax m, l and acc in f32.

Bound on the card: the code bytes, 2 * S_valid * Dh per (b, g) per layer
and step; tiles past ``pos[b]`` are skipped. At B = 4, G = 4 the grid is
16 blocks on 132 SMs: split-S (flash-decoding) plus a combine is the
natural later design.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.quantizers import QuantSpec, _codes_to_values
from . import LAUNCHES, require_cuda
from .ref import kv_flash_decode_ref

__all__ = ["kv_flash_decode", "kv_flash_decode_ref"]


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
                    v_scale: torch.Tensor, pos, spec: QuantSpec) -> torch.Tensor:
    """One-token attention against a quantized heads-major cache.

    q (B, G, R, Dh); codes (B, G, S, Dh) int8/uint8; scales (B, G, 1, Dh);
    pos scalar or (B,) valid lengths (mask ``arange(S) < pos``).
    Returns (B, G, R, Dh) f32.
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
                                   pos, spec)
    pos = torch.as_tensor(pos, device=q.device)
    require_cuda("kv_flash_decode", q, k_codes, k_scale, v_codes, v_scale, pos)
    if tuple(k_codes.shape[:2]) != (B, G) or k_codes.shape[3] != Dh:
        raise ValueError(f"cache {tuple(k_codes.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if k_codes.element_size() != 1 or v_codes.element_size() != 1:
        raise ValueError("kv_flash_decode wants byte-wide codes")
    if Dh not in (32, 64, 128, 256) or R > 32:
        raise ValueError(f"kv_flash_decode supports Dh in 32/64/128/256 and "
                         f"R <= 32, got Dh={Dh}, R={R}")
    from .build import check, library
    qf = q.to(torch.float32).contiguous()
    kc = k_codes.contiguous()
    vc = v_codes.contiguous()
    ks = k_scale.to(torch.float32).expand(B, G, 1, Dh).contiguous()
    vs = v_scale.to(torch.float32).expand(B, G, 1, Dh).contiguous()
    pos_b = pos.reshape(-1).to(torch.int32).expand(B).contiguous()
    table = _byte_table(spec, str(q.device))
    out = torch.empty((B, G, R, Dh), dtype=torch.float32, device=q.device)
    check(library("kv_flash_decode").kv_flash_decode(
        qf.data_ptr(), kc.data_ptr(), ks.data_ptr(), vc.data_ptr(),
        vs.data_ptr(), pos_b.data_ptr(), table.data_ptr(), out.data_ptr(),
        B, G, R, S, Dh, Dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream), "kv_flash_decode")
    LAUNCHES["kv_flash_decode"] += 1
    return out
