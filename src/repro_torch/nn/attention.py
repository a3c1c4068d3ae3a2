"""GQA attention: chunked (flash-style) prefill, cache-based decode.

Port of the dense, single-device paths of ``repro/nn/attention.py``:

* prefill — ``flash_attention`` is plain torch with the reference's
  ``_divisor_chunk`` q/kv-chunk structure (forward only), so kv-chunk
  boundaries line up with the reference's (paged prefill relies on them).
  With a quantized cache, K/V are fake-quantized through the cache grid
  before attending, so prefill attends to exactly what decode reads back
  (the evict -> re-prefill resume contract).
* decode — the new token's K/V are quantized on write into the
  heads-major (B, G, S, Dh) layer cache IN PLACE (the reference's vmapped
  ``dynamic_update_slice``), then attended through ``kv_flash_decode`` or
  the dequantize-on-read fallback.

Tensor-parallel modes, cross-attention and the paged cache are later slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantizers import kv_dequantize, kv_quantize
from repro_torch.kernels.ops import KernelSet
from .layers import apply_rotary, matmul_param, rmsnorm, rotary_cos_sin

NEG_INF = -1e30


def _divisor_chunk(total: int, want: int) -> int:
    want = max(1, min(want, total))
    for c in range(want, 0, -1):
        if total % c == 0:
            return c
    return 1


def _blk_scores(q_blk, k_blk, scale, causal, qi, kvc, bias_offset, kj):
    """(masked) attention scores for one (q-chunk, kv-block) pair, f32."""
    s = torch.einsum("bqgrd,bkgd->bgrqk", q_blk.to(torch.float32),
                     k_blk.to(torch.float32)) * scale
    if causal:
        dev = s.device
        qpos = bias_offset + qi + torch.arange(q_blk.shape[1], device=dev)
        kpos = kj * kvc + torch.arange(kvc, device=dev)
        mask = kpos[None, :] <= qpos[:, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def _flash_fwd(causal, qc, kvc, bias_offset, q, k, v):
    """Online-softmax forward. Returns out (B, Sq, G, R, Dh) in q's dtype."""
    B, Sq, G, R, Dh = q.shape
    Skv = k.shape[1]
    scale = Dh ** -0.5
    outs = []
    for qi in range(0, Sq, qc):
        q_blk = q[:, qi:qi + qc]
        q_end = qi + qc + bias_offset
        kv_hi = Skv if not causal else min(Skv, ((q_end + kvc - 1) // kvc) * kvc)
        m = torch.full((B, G, R, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, G, R, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, G, R, qc, Dh), dtype=torch.float32, device=q.device)
        for kj in range(kv_hi // kvc):
            k_blk = k[:, kj * kvc:(kj + 1) * kvc]
            v_blk = v[:, kj * kvc:(kj + 1) * kvc]
            s = _blk_scores(q_blk, k_blk, scale, causal, qi, kvc, bias_offset, kj)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p.to(v_blk.dtype).to(torch.float32),
                v_blk.to(torch.float32))
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def flash_attention(q, k, v, *, causal: bool, q_chunk: int, kv_chunk: int,
                    bias_offset: int = 0) -> torch.Tensor:
    """Online-softmax chunked attention (forward). q: (B, Sq, G, R, Dh);
    k/v: (B, Skv, G, Dh). Causal q-chunks visit kv-chunks up to the
    diagonal only."""
    qc = _divisor_chunk(q.shape[1], q_chunk)
    kvc = _divisor_chunk(k.shape[1], kv_chunk)
    return _flash_fwd(causal, qc, kvc, bias_offset, q, k, v)


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """One-token attention against a heads-major (B, G, S, Dh) cache.

    q: (B, 1, G, R, Dh); ``pos`` is a scalar or (B,) valid-prefix length;
    entries at or beyond a slot's pos are masked.
    """
    S = k_cache.shape[2]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqgrd,bgsd->bgrqs", q.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    valid = torch.arange(S, device=q.device)[None, :] < \
        torch.as_tensor(pos, device=q.device).reshape(-1, 1)
    s = torch.where(valid[:, None, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqs,bgsd->bqgrd", p, v_cache.to(torch.float32))
    return o.to(q.dtype)


def attn_shapes(cfg) -> dict:
    """{name: (in_dim, out_dims)} of the attention weights."""
    d, H, G, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {"wq": (d, (H, Dh)), "wk": (d, (G, Dh)), "wv": (d, (G, Dh)),
            "wo": (H * Dh, (d,))}


def attn_forward(p: dict, x: torch.Tensor, cfg, rcfg, *,
                 positions: torch.Tensor, causal: bool = True,
                 cache: Optional[dict] = None, cache_pos=None,
                 kernels: Optional[KernelSet] = None, kv_spec=None,
                 kv_scales: Optional[dict] = None):
    """Full attention layer. Returns (y, new_kv).

    Decode (``cache`` given, one token): ``cache`` is the layer's
    {"k", "v"[, "k_scale", "v_scale"]} with heads-major (B, G, S, Dh) leaves;
    the new token's K/V (codes, for a quantized cache) are written in place
    at ``cache_pos`` (scalar or (B,)) and new_kv is ``cache``. Prefill:
    ``kv_scales`` (the cache's static scales) makes K/V round through the
    cache grid first; new_kv holds grouped (B, S, G, Dh) K/V or codes.
    """
    B, Sq, _ = x.shape
    Dh = cfg.d_head
    H = p["wq"].shape[-2]
    G = p["wk"].shape[-2]
    R = H // G
    q = matmul_param(x, p["wq"], kernels=kernels).reshape(B, Sq, G, R, Dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    cos, sin = rotary_cos_sin(positions, Dh, cfg.rope_theta)
    q = apply_rotary(q.reshape(B, Sq, H, Dh), cos, sin).reshape(B, Sq, G, R, Dh)
    k = matmul_param(x, p["wk"], kernels=kernels).reshape(B, Sq, G, Dh)
    v = matmul_param(x, p["wv"], kernels=kernels).reshape(B, Sq, G, Dh)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    k = apply_rotary(k, cos, sin)
    if cache is not None and Sq == 1:
        quant = kv_spec is not None and "k_scale" in cache
        k_upd = k[:, 0]                                   # (B, G, Dh)
        v_upd = v[:, 0]
        if quant:
            k_upd = kv_quantize(k_upd, kv_spec, cache["k_scale"][:, :, 0])
            v_upd = kv_quantize(v_upd, kv_spec, cache["v_scale"][:, :, 0])
        S = cache["k"].shape[2]
        pos_b = torch.as_tensor(cache_pos, device=x.device).reshape(-1).expand(B)
        bidx = torch.arange(B, device=x.device)
        # the reference clamps the write like dynamic_update_slice does
        widx = pos_b.clamp(max=S - 1)
        cache["k"][bidx, :, widx] = k_upd.to(cache["k"].dtype)
        cache["v"][bidx, :, widx] = v_upd.to(cache["v"].dtype)
        new_kv = cache
        if quant and kernels is not None:
            o = kernels.kv_flash_decode(q[:, 0], cache["k"], cache["k_scale"],
                                        cache["v"], cache["v_scale"],
                                        pos_b + 1, kv_spec)
            y = o[:, None].to(q.dtype)
        elif quant:
            kf = kv_dequantize(cache["k"], kv_spec, cache["k_scale"])
            vf = kv_dequantize(cache["v"], kv_spec, cache["v_scale"])
            y = decode_attention(q, kf, vf, pos_b + 1)
        else:
            y = decode_attention(q, cache["k"], cache["v"], pos_b + 1)
    else:
        if kv_spec is not None and kv_scales is not None:
            ks = kv_scales["k_scale"].transpose(1, 2)        # (B, 1, G, Dh)
            vs = kv_scales["v_scale"].transpose(1, 2)
            kc = kv_quantize(k, kv_spec, ks)
            vc = kv_quantize(v, kv_spec, vs)
            k = kv_dequantize(kc, kv_spec, ks, k.dtype)
            v = kv_dequantize(vc, kv_spec, vs, v.dtype)
            new_kv = {"k": kc, "v": vc}
        else:
            new_kv = {"k": k, "v": v}
        y = flash_attention(q, k, v, causal=causal, q_chunk=rcfg.attn_q_chunk,
                            kv_chunk=rcfg.attn_kv_chunk)
    y = y.reshape(B, Sq, H * Dh).to(x.dtype)
    return matmul_param(y, p["wo"], kernels=kernels), new_kv
