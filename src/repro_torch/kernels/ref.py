"""Plain PyTorch versions of every kernel (the correctness contract).

Port of ``repro/kernels/ref.py``. The wrappers use these on CPU tensors;
the tests hold them against the reference package and ``chip_smoke.py``
holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.pofx import pofx_normalized
from repro_torch.core.quantizers import QuantSpec, _codes_to_values, kv_dequantize

__all__ = ["decode_norm_to_fxp", "pofx_decode_ref", "pofx_matmul_ref", "fxp_matmul_ref",
           "kv_flash_decode_ref", "empty_rows", "gather_pages", "kv_flash_paged_decode_ref"]


def decode_norm_to_fxp(codes: torch.Tensor, N: int, ES: int,
                       M: int) -> torch.Tensor:
    """Normalized posit codes -> FxP(M, M-1) int32 by bit-level Algorithm 1."""
    out, _ = pofx_normalized(codes, N, ES, M)
    return out


def pofx_decode_ref(codes: torch.Tensor, N: int, ES: int,
                    M: int = 8) -> torch.Tensor:
    """Plain version of the decode kernel: codes -> int8 FxP codes."""
    return decode_norm_to_fxp(codes.to(torch.int32), N, ES, M).to(torch.int8)


# weights the plain pofx_matmul decodes at once: a larger matrix (nemotron-
# 4-340b's 18432 x 73728 MLP and 18432-wide unembed) goes in column blocks
REF_CHUNK = 1 << 29


def pofx_matmul_ref(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                    N: int, ES: int, M: int = 8) -> torch.Tensor:
    """x (m, k) @ (decode(codes (k, n)) / 2^(M-1)) * scale (n,) -> f32.

    The decode goes through ``pofx_norm_lut``, which the tests hold equal
    to the bit-level ``decode_norm_to_fxp`` over every code; the table keeps
    the plain version's memory at one int64 index per weight, and a matrix
    of more than ``REF_CHUNK`` weights is decoded and multiplied in blocks
    of whole columns.
    """
    spec = QuantSpec(kind="pofx", N=N, ES=ES, M=M)
    k, n = codes.shape
    xf = x.to(torch.float32)
    sc = scale.reshape(1, -1).to(torch.float32)
    cols = max(1, REF_CHUNK // max(k, 1))
    if n <= cols:
        return torch.matmul(xf, _codes_to_values(codes, spec)) * sc
    return torch.cat([torch.matmul(xf, _codes_to_values(codes[:, j:j + cols], spec))
                      * sc[:, j:j + cols] for j in range(0, n, cols)], dim=1)


def fxp_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32, exact: float64 holds every partial sum exactly
    (|sum| <= 2^14 * k < 2^53), and float64 matmul runs on CPU and CUDA."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def kv_flash_decode_ref(q, k_codes, k_scale, v_codes, v_scale, pos,
                        spec: QuantSpec, with_lse: bool = False):
    """Dequantize the whole cache, then masked softmax attention in f32.

    q: (B, G, R, Dh); codes: (B, G, S, Dh); scales: (B, G, 1, Dh);
    pos: scalar or (B,) valid lengths. With ``with_lse`` also each row's
    log-sum-exp of its masked scores, (B, G, R). A row with no valid
    position (pos <= 0) averages every row of v, as the reference's mask
    does; with ``with_lse`` (a block of a cache wholly past the row's
    position) it is 0 and its lse -inf, a weight of 0 beside the other
    blocks (``nn.sharding.merge_partials``).
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
    out = torch.einsum("bgrs,bgsd->bgrd", p, v)
    return empty_rows(out, torch.logsumexp(s, dim=-1), pos[:, 0]) if with_lse else out


def empty_rows(out, lse, pos):
    """(out, lse) of a block's attention, out (B, ..., Dh) and lse (B, ...),
    with the rows of the slots whose valid length ``pos`` (B,) is <= 0 set
    to 0 and -inf: a block wholly past a row's position reads nothing."""
    empty = (pos <= 0).reshape(-1, *([1] * (lse.dim() - 1)))
    return (torch.where(empty[..., None], torch.zeros_like(out), out),
            torch.where(empty, torch.full_like(lse, float("-inf")), lse))


def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Per-slot contiguous caches from a page pool.

    pool: (n_pages, G, ps, Dh); tables: (B, max_pages) physical page ids
    (garbage-page entries gather junk that per-slot ``pos`` masks).
    Returns (B, G, max_pages * ps, Dh), the heads-major dense layout.
    """
    B, max_pages = tables.shape
    _, G, ps, Dh = pool.shape
    gathered = pool[tables.long()]                # (B, max_pages, G, ps, Dh)
    return gathered.permute(0, 2, 1, 3, 4).reshape(B, G, max_pages * ps, Dh)


def kv_flash_paged_decode_ref(q, k_pool, k_scale, v_pool, v_scale, tables,
                              pos, spec: QuantSpec) -> torch.Tensor:
    """Gather every slot's pages into a contiguous cache, then the dense
    plain version; the pool's global (G, 1, Dh) scales broadcast over the
    gathered batch axis.

    q: (B, G, R, Dh); pools: (n_pages, G, ps, Dh); tables: (B, max_pages);
    pos: scalar or (B,) valid lengths.
    """
    k = gather_pages(k_pool, tables)
    v = gather_pages(v_pool, tables)
    return kv_flash_decode_ref(q, k, k_scale[None], v, v_scale[None], pos,
                               spec)
