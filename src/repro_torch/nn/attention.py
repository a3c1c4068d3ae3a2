"""GQA attention: chunked (flash-style) prefill, cache-based decode.

Port of the dense, single-device paths of ``repro/nn/attention.py``:

* prefill and training — ``flash_attention`` is plain torch with the
  reference's ``_divisor_chunk`` q/kv-chunk structure, so kv-chunk
  boundaries line up with the reference's (paged prefill relies on them).
  When q, k or v needs a gradient it runs as ``_Flash``, a
  ``torch.autograd.Function`` holding the reference's custom VJP: the
  forward saves only q, k, v, out and the per-row log-sum-exp, and the
  backward rebuilds each (q-chunk, kv-chunk) probability block from them
  (``_flash_bwd``). Without a gradient the forward runs alone, with the
  same arithmetic.
  With a quantized cache, K/V are fake-quantized through the cache grid
  before attending, so prefill attends to exactly what decode reads back
  (the evict -> re-prefill resume contract).
* decode — the new token's K/V are quantized on write into the
  heads-major (B, G, S, Dh) layer cache IN PLACE (the reference's vmapped
  ``dynamic_update_slice``), then attended through ``kv_flash_decode`` or
  the dequantize-on-read fallback. A cache that is not quantized (a bf16
  cache, the paged fallback's gathered pages, the static cross cache)
  attends with q and p rounded to its dtype when
  ``rcfg.serve_bf16_compute`` is set (``decode_attention``'s
  ``bf16_compute``, where the reference passes it).
* paged cache — the layer cache is a page POOL ((n_pages, G, ps, Dh) codes,
  global (G, 1, Dh) scales) read and written through per-slot block
  tables. Decode writes the new token through the table in place and
  attends through ``kv_flash_paged_decode`` or the gather + dequantize
  fallback; the batch-1 admission prefill attends [shared prefix ;
  suffix] with ``bias_offset`` = prefix length and writes the suffix's
  codes through the slot's table row.
* cross-attention (the encdec decoder) — q from x with no rotary; K/V
  from the encoder states ``xa`` (non-causal flash attention over them),
  or at decode from a static cross cache that is read and never written.

Tensor parallelism (DESIGN.md §9): a rank holds H/tp query heads and G/tp
kv groups of wq/wk/wv (head counts come from the weight leaves, not the
config) and the matching rows of wo; every path returns through
``_out_proj``, whose ``tp.reduce_out`` (``psum`` without a gradient) is the
attention block's one all-reduce.
``attn_tp_mode`` is the reference's mode table; serving TP admits only a
tp that divides the kv heads (``nn.sharding``'s strict specs raise
otherwise), so the reference's training-only "rep"/"expand" layouts are
not served. Training on a grid places each leaf by its own spec (the
reference's lenient one): with the query heads cut over model, x (and the
encoder states) go in through ``tp.copy_in`` (their gradient summed over
the ranks' heads), and wk/wv may be whole where the model axis does not
divide the kv heads: the rank then computes the kv heads its own query
heads read (``_rank_kv``). Where it does not divide the query heads
either, the attention runs whole on every rank, with no collective, and
``_out_proj`` cuts the rank's rows of the output (``take_block``) before a
wo whose rows the model axis divides. Under sequence parallelism (``sp``)
x comes in as the rank's block along seq and is gathered whole
(``nn.sharding.seq_in``: ``gather_seq`` in ``copy_in``'s place), and the
output leaves as the rank's block (``seq_out``: ``scatter_seq`` in
``reduce_out``'s place), so rotary and the causal mask see every position.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantizers import QuantizedTensor, kv_dequantize, kv_quantize
from repro_torch.kernels.ops import KernelSet
from repro_torch.kernels.ref import empty_rows, gather_pages
from .layers import apply_rotary, matmul_param, rmsnorm, rotary_cos_sin
from .sharding import combine_partials, placed, seq_in, seq_out, take_block

NEG_INF = -1e30


def attn_tp_mode(n_heads: int, n_kv_heads: int, tp: int) -> str:
    """The reference's TP strategy for (H, G, tp):

    kv      G % tp == 0: shard the kv-head axis (zero redundancy)
    rep     R % tp == 0: shard the rep axis, replicate k/v per group
    expand  H % tp == 0: repeat k/v to H heads and shard the full head axis
    none    nothing divides: replicated attention
    """
    if tp <= 1:
        return "kv"
    if n_kv_heads % tp == 0:
        return "kv"
    if n_kv_heads and (n_heads // n_kv_heads) % tp == 0:
        return "rep"
    if n_heads % tp == 0:
        return "expand"
    return "none"


def attn_logical(cfg) -> dict:
    """Logical axes of the attention weights (``nn.sharding``'s rules)."""
    p = {
        "wq": ("p_embed", "heads", "head_dim"),
        "wk": ("p_embed", "kv_heads", "head_dim"),
        "wv": ("p_embed", "kv_heads", "head_dim"),
        "wo": ("mlp", "p_embed"),  # (H*Dh, d): row dim always tp-divisible
    }
    if cfg.qk_norm:
        p["q_norm"] = ("p_unsharded",)
        p["k_norm"] = ("p_unsharded",)
    return p


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


def _flash_fwd(causal, qc, kvc, bias_offset, q, k, v, with_lse=False):
    """Online-softmax forward. Returns out (B, Sq, G, R, Dh) in q's dtype,
    and with ``with_lse`` also lse = m + log(max(l, 1e-30)), (B, G, R, Sq)."""
    B, Sq, G, R, Dh = q.shape
    Skv = k.shape[1]
    scale = Dh ** -0.5
    outs, lses = [], []
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
        if with_lse:
            lses.append(m + torch.log(l.clamp_min(1e-30)))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    if not with_lse:
        return out
    return out, (torch.cat(lses, dim=-1) if len(lses) > 1 else lses[0])


def _flash_bwd(causal, qc, kvc, bias_offset, q, k, v, out, lse, dout):
    """The reference's ``_flash_bwd_rule``: P rebuilt per (q-chunk,
    kv-chunk) block from lse, the same causal kv limit per q-chunk; dq, dk
    and dv accumulate in f32 and return in the inputs' dtypes."""
    f32 = torch.float32
    B, Sq, G, R, Dh = q.shape
    Skv = k.shape[1]
    scale = Dh ** -0.5
    delta = (dout.to(f32) * out.to(f32)).sum(dim=-1)       # (B, Sq, G, R)
    delta = delta.permute(0, 2, 3, 1)                       # (B, G, R, Sq)
    dk = torch.zeros(k.shape, dtype=f32, device=k.device)
    dv = torch.zeros(v.shape, dtype=f32, device=v.device)
    dq_chunks = []
    for qi in range(0, Sq, qc):
        q_blk = q[:, qi:qi + qc]
        do_blk = dout[:, qi:qi + qc].to(f32)
        lse_blk = lse[..., qi:qi + qc]
        dlt_blk = delta[..., qi:qi + qc]
        q_end = qi + qc + bias_offset
        kv_hi = Skv if not causal else min(Skv, ((q_end + kvc - 1) // kvc) * kvc)
        dq_acc = torch.zeros((B, qc, G, R, Dh), dtype=f32, device=q.device)
        for kj in range(kv_hi // kvc):
            sl = slice(kj * kvc, (kj + 1) * kvc)
            k_blk, v_blk = k[:, sl], v[:, sl]
            s = _blk_scores(q_blk, k_blk, scale, causal, qi, kvc, bias_offset, kj)
            p = torch.exp(s - lse_blk[..., None])           # (B, G, R, qc, kvc)
            dv[:, sl] += torch.einsum("bgrqk,bqgrd->bkgd", p, do_blk)
            dp = torch.einsum("bqgrd,bkgd->bgrqk", do_blk, v_blk.to(f32))
            ds = p * (dp - dlt_blk[..., None]) * scale
            dq_acc += torch.einsum("bgrqk,bkgd->bqgrd",
                                   ds.to(k.dtype).to(f32), k_blk.to(f32))
            dk[:, sl] += torch.einsum("bgrqk,bqgrd->bkgd",
                                      ds.to(q.dtype).to(f32), q_blk.to(f32))
        dq_chunks.append(dq_acc)
    dq = torch.cat(dq_chunks, dim=1) if len(dq_chunks) > 1 else dq_chunks[0]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Flash attention with the recompute backward: saves q, k, v, out and
    lse only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, qc, kvc, bias_offset):
        out, lse = _flash_fwd(causal, qc, kvc, bias_offset, q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.chunks = (causal, qc, kvc, bias_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.chunks, *ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool, q_chunk: int, kv_chunk: int,
                    bias_offset: int = 0) -> torch.Tensor:
    """Online-softmax chunked attention with a flash (recompute) backward.
    q: (B, Sq, G, R, Dh); k/v: (B, Skv, G, Dh). Causal q-chunks visit
    kv-chunks up to the diagonal only; k positions lead q's by
    ``bias_offset``."""
    qc = _divisor_chunk(q.shape[1], q_chunk)
    kvc = _divisor_chunk(k.shape[1], kv_chunk)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, causal, qc, kvc, bias_offset)
    return _flash_fwd(causal, qc, kvc, bias_offset, q, k, v)


def decode_attention(q, k_cache, v_cache, pos, bf16_compute: bool = False,
                     with_lse: bool = False):
    """One-token attention against a heads-major (B, G, S, Dh) cache.

    q: (B, 1, G, R, Dh); ``pos`` is a scalar or (B,) valid-prefix length;
    entries at or beyond a slot's pos are masked. ``bf16_compute`` (the
    reference's ``serve_bf16_compute``) rounds q and the probabilities to
    the cache's dtype before their products, which are summed in f32: each
    product of two bf16 values is exact in f32, so the f32 einsum on the
    rounded values is the reference's bf16 dot with
    ``preferred_element_type=f32``. Off, q and p stay f32. ``with_lse``
    returns (the output in f32, each row's log-sum-exp of its masked
    scores (B, 1, G, R)): the partial of a block of the cache's positions
    that ``nn.sharding.combine_partials`` merges with the others'; a slot
    with no valid position there gives 0 and -inf (``empty_rows``).
    """
    S = k_cache.shape[2]
    scale = q.shape[-1] ** -0.5
    f32 = torch.float32

    def rounded(t):
        return t.to(k_cache.dtype).to(f32) if bf16_compute else t.to(f32)

    s = torch.einsum("bqgrd,bgsd->bgrqs", rounded(q), k_cache.to(f32)) * scale
    valid = torch.arange(S, device=q.device)[None, :] < \
        torch.as_tensor(pos, device=q.device).reshape(-1, 1)
    s = torch.where(valid[:, None, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqs,bgsd->bqgrd", rounded(p), v_cache.to(f32))
    if with_lse:
        lim = torch.as_tensor(pos, device=q.device).reshape(-1).expand(o.shape[0])
        return empty_rows(o, torch.logsumexp(s, dim=-1).permute(0, 3, 1, 2), lim)
    return o.to(q.dtype)


def _pool_scale_grouped(scale: torch.Tensor) -> torch.Tensor:
    """Paged pool scale (G, 1, Dh) -> (1, 1, G, Dh) for grouped K/V."""
    return scale.transpose(0, 1)[None]


def _paged_write(pool: dict, tables: torch.Tensor, positions: torch.Tensor,
                 k_vals: torch.Tensor, v_vals: torch.Tensor, page_size: int,
                 kv_spec) -> None:
    """Write per-token K/V through a block table into the pool, in place.

    pool: {"k"/"v": (n_pages, G, ps, Dh)[, "k_scale"/"v_scale": (G, 1, Dh)]};
    tables: one (max_pages,) row or (N, max_pages); positions: (N,) token
    indices aligned with k_vals/v_vals (N, G, Dh). Positions past the
    table's coverage go to the garbage page (page 0): a retired slot's
    zombie writes must not clobber a live page.
    """
    ps = page_size
    positions = positions.long()
    page_idx = positions // ps
    off = positions % ps
    row = tables if tables.ndim == 2 else tables[None].expand(
        positions.shape[0], tables.shape[0])
    max_pages = row.shape[1]
    safe = page_idx.clamp(max=max_pages - 1)
    pt = row.long().gather(1, safe[:, None])[:, 0]
    pt = torch.where(page_idx < max_pages, pt, torch.zeros_like(pt))
    for name, vals in (("k", k_vals), ("v", v_vals)):
        dst = pool[name]
        if kv_spec is not None and "k_scale" in pool:
            vals = kv_quantize(vals, kv_spec, pool[f"{name}_scale"][:, 0])
        dst[pt, :, off, :] = vals.to(dst.dtype)


def _paged_gather(pool: dict, tables: torch.Tensor, kv_spec):
    """Pages -> contiguous heads-major K/V (the fallback read path).

    Returns (k, v) shaped (B, G, max_pages * ps, Dh), dequantized when the
    pool holds codes: ``kernels.ref.gather_pages`` + dequantize, the paged
    kernel's plain version.
    """
    def one(name):
        flat = gather_pages(pool[name], tables)
        if kv_spec is not None and "k_scale" in pool:
            return kv_dequantize(flat, kv_spec, pool[f"{name}_scale"][None])
        return flat
    return one("k"), one("v")


def attn_shapes(cfg) -> dict:
    """{name: (in_dim, out_dims)} of the attention weights."""
    d, H, G, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {"wq": (d, (H, Dh)), "wk": (d, (G, Dh)), "wv": (d, (G, Dh)),
            "wo": (H * Dh, (d,))}


def _cross_attn(p: dict, q: torch.Tensor, cfg, rcfg, *, xa, cache,
                kernels: Optional[KernelSet], wk=None, wv=None, norm_w=None):
    """Cross-attention of q (B, Sq, G, R, Dh), no rotary anywhere: over the
    encoder states ``xa`` (K/V through ``wk``/``wv``, by default the
    layer's, non-causal; new_kv the grouped (B, Se, G, Dh) K/V), or over
    the static cross cache {"k_static", "v_static": (B, G, Se, Dh), "len"}
    for one token (new_kv None)."""
    if xa is None:
        if q.shape[1] != 1:
            raise ValueError(f"the static cross cache serves one token, got {q.shape[1]}")
        y = decode_attention(q, cache["k_static"], cache["v_static"], cache["len"],
                             bf16_compute=rcfg.serve_bf16_compute)
        return y, None
    B, Se = xa.shape[:2]
    G, Dh = q.shape[2], q.shape[4]
    wk = p["wk"] if wk is None else wk
    wv = p["wv"] if wv is None else wv
    k = matmul_param(xa, wk, kernels=kernels).reshape(B, Se, G, Dh)
    v = matmul_param(xa, wv, kernels=kernels).reshape(B, Se, G, Dh)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"] if norm_w is None else norm_w("k_norm"), cfg.norm_eps)
    y = flash_attention(q, k, v, causal=False, q_chunk=rcfg.attn_q_chunk,
                        kv_chunk=rcfg.attn_kv_chunk)
    return y, {"k": k, "v": v}


def attn_forward(p: dict, x: torch.Tensor, cfg, rcfg, *,
                 positions: torch.Tensor, causal: bool = True,
                 cache: Optional[dict] = None, cache_pos=None,
                 xa: Optional[torch.Tensor] = None,
                 kernels: Optional[KernelSet] = None, kv_spec=None,
                 kv_scales: Optional[dict] = None,
                 pages: Optional[torch.Tensor] = None,
                 page_size: Optional[int] = None,
                 paged_prefill: Optional[dict] = None, tp=None, sp=None, xsp=None,
                 kv_seq=None):
    """Full attention layer. Returns (y, new_kv).

    Decode (``cache`` given, one token): ``cache`` is the layer's
    {"k", "v"[, "k_scale", "v_scale"]} with heads-major (B, G, S, Dh) leaves;
    the new token's K/V (codes, for a quantized cache) are written in place
    at ``cache_pos`` (scalar or (B,)) and new_kv is ``cache``. Prefill:
    ``kv_scales`` (the cache's static scales) makes K/V round through the
    cache grid first; new_kv holds grouped (B, S, G, Dh) K/V or codes.

    Paged decode: ``cache`` is the layer's page pool, ``pages`` the
    (B, max_pages) block tables and ``page_size`` the tokens per page.
    Paged prefill: ``paged_prefill`` = {pool, row, prefix_len, page_size}
    (batch 1); the suffix attends to the ``prefix_len`` tokens already
    resident in the row's pages and writes its own codes through the row.
    Both update the pool in place and return it as new_kv.

    Cross-attention: ``xa`` (B, Se, d) encoder states, or a ``cache``
    holding "k_static", "v_static" and "len" (``_cross_attn``).

    ``tp`` (an ``nn.sharding.TPContext``, the model axis) all-reduces the
    output projection of a rank's heads. Under sequence parallelism (a
    training grid's ``sp``; ``xsp`` for the encoder states ``xa``) x is the
    rank's block along seq: the layer attends over the whole sequence
    (``seq_in``) and returns the rank's block (``_out_proj``).

    ``kv_seq`` (serving on a grid: the model axis, which cuts the cache's
    sequence) takes ``_grid_attn``'s path.
    """
    if kv_seq is not None:
        return _grid_attn(p, x, cfg, rcfg, positions=positions, causal=causal,
                          cache=cache, cache_pos=cache_pos, xa=xa, kernels=kernels,
                          kv_spec=kv_spec, kv_scales=kv_scales, tp=tp, kv_seq=kv_seq)
    Dh = cfg.d_head
    # the model axis where it cuts the query heads (None where they are whole)
    tp_h = placed(tp, p["wq"].shape[-2], cfg.n_heads)
    x = seq_in(x, sp, tp_h)
    if xa is not None:
        xa = seq_in(xa, xsp, tp_h)
    B, Sq, _ = x.shape
    wk, wv, G, R = _rank_kv(p, cfg, tp_h)
    H = G * R
    q = matmul_param(x, p["wq"], kernels=kernels).reshape(B, Sq, G, R, Dh)
    # a rank's heads give a partial gradient of the replicated norm weights
    norm_w = (lambda n: p[n]) if tp_h is None else (lambda n: tp_h.copy_in(p[n]))
    if cfg.qk_norm:
        q = rmsnorm(q, norm_w("q_norm"), cfg.norm_eps)
    if xa is not None or (cache is not None and "k_static" in cache):
        y, new_kv = _cross_attn(p, q, cfg, rcfg, xa=xa, cache=cache, kernels=kernels,
                                wk=wk, wv=wv, norm_w=norm_w)
        return _out_proj(p, y, x, cfg, kernels, tp, sp), new_kv
    cos, sin = rotary_cos_sin(positions, Dh, cfg.rope_theta)
    q = apply_rotary(q.reshape(B, Sq, H, Dh), cos, sin).reshape(B, Sq, G, R, Dh)
    k = matmul_param(x, wk, kernels=kernels).reshape(B, Sq, G, Dh)
    v = matmul_param(x, wv, kernels=kernels).reshape(B, Sq, G, Dh)
    if cfg.qk_norm:
        k = rmsnorm(k, norm_w("k_norm"), cfg.norm_eps)
    k = apply_rotary(k, cos, sin)
    if cache is not None and Sq == 1 and pages is not None:
        pos_b = torch.as_tensor(cache_pos, device=x.device).reshape(-1).expand(B)
        _paged_write(cache, pages, pos_b, k[:, 0], v[:, 0], page_size, kv_spec)
        new_kv = cache
        quant = kv_spec is not None and "k_scale" in cache
        if quant and kernels is not None:
            o = kernels.kv_flash_paged_decode(
                q[:, 0], cache["k"], cache["k_scale"], cache["v"],
                cache["v_scale"], pages, pos_b + 1, kv_spec)
            y = o[:, None].to(q.dtype)
        else:
            kf, vf = _paged_gather(cache, pages, kv_spec)
            y = decode_attention(q, kf, vf, pos_b + 1,
                                 bf16_compute=not quant and rcfg.serve_bf16_compute)
    elif cache is not None and Sq == 1:
        pos_b = torch.as_tensor(cache_pos, device=x.device).reshape(-1).expand(B)
        y = _dense_decode(q[:, 0], k[:, 0], v[:, 0], cache, pos_b, kv_spec, kernels,
                          rcfg)[:, None].to(q.dtype)
        new_kv = cache
    elif paged_prefill is not None:
        if B != 1:
            raise ValueError(f"paged prefill is batch-1 (admission), got B={B}")
        pool = paged_prefill["pool"]
        row = paged_prefill["row"]
        prefix_len = int(paged_prefill["prefix_len"])
        ps = int(paged_prefill["page_size"])
        quant = kv_spec is not None and "k_scale" in pool
        if quant:
            ks = _pool_scale_grouped(pool["k_scale"])
            vs = _pool_scale_grouped(pool["v_scale"])
            k = kv_dequantize(kv_quantize(k, kv_spec, ks), kv_spec, ks, k.dtype)
            v = kv_dequantize(kv_quantize(v, kv_spec, vs), kv_spec, vs, v.dtype)
        k_suf, v_suf = k, v
        if prefix_len > 0:
            # the shared prefix, read before the suffix writes (which land
            # at positions >= prefix_len only)
            ids = row[:-(-prefix_len // ps)].long()

            def grouped_prefix(name):
                t = pool[name][ids]                  # (npp, G, ps, Dh)
                if quant:
                    t = kv_dequantize(t, kv_spec, pool[f"{name}_scale"], k.dtype)
                t = t.transpose(1, 2).reshape(-1, G, Dh)
                return t[None, :prefix_len].to(k.dtype)

            k = torch.cat([grouped_prefix("k"), k], dim=1)
            v = torch.cat([grouped_prefix("v"), v], dim=1)
        positions_w = prefix_len + torch.arange(Sq, device=x.device)
        _paged_write(pool, row, positions_w, k_suf[0], v_suf[0], ps, kv_spec)
        new_kv = pool
        y = flash_attention(q, k, v, causal=causal, q_chunk=rcfg.attn_q_chunk,
                            kv_chunk=rcfg.attn_kv_chunk, bias_offset=prefix_len)
    else:
        k, v, new_kv = _prefill_kv(k, v, kv_spec, kv_scales)
        y = flash_attention(q, k, v, causal=causal, q_chunk=rcfg.attn_q_chunk,
                            kv_chunk=rcfg.attn_kv_chunk)
    return _out_proj(p, y, x, cfg, kernels, tp, sp), new_kv


def _prefill_kv(k, v, kv_spec, kv_scales):
    """(k, v, new_kv) of a prefill's K/V (B, S, G, Dh): with the cache's
    static scales ``kv_scales`` (a quantized cache) they round through its
    grid and new_kv holds their codes, else new_kv holds k and v."""
    if kv_spec is None or kv_scales is None:
        return k, v, {"k": k, "v": v}
    ks = kv_scales["k_scale"].transpose(1, 2)        # (B, 1, G, Dh)
    vs = kv_scales["v_scale"].transpose(1, 2)
    kc, vc = kv_quantize(k, kv_spec, ks), kv_quantize(v, kv_spec, vs)
    return (kv_dequantize(kc, kv_spec, ks, k.dtype), kv_dequantize(vc, kv_spec, vs, v.dtype),
            {"k": kc, "v": vc})


def _dense_decode(q, k, v, cache: dict, pos_b, kv_spec, kernels, rcfg, kv_seq=None):
    """One token against a dense heads-major cache {"k", "v"[, "k_scale",
    "v_scale"]} (B, G, S, Dh): the token's k, v (B, G, Dh) (codes, for a
    quantized cache) written in place at ``pos_b`` (B,), clamped to the
    cache's last position as the reference's ``dynamic_update_slice``,
    then q (B, G, R, Dh) attends to the positions before pos_b + 1
    (``_attend``). On a serving grid (``kv_seq``, the model axis, cuts the
    cache's sequence: rank r of M holds positions [r S_l, (r + 1) S_l)) the
    write lands only on the rank that owns the position, through
    ``torch.where`` so that no rank waits on the host. Returns
    (B, G, R, Dh)."""
    quant = kv_spec is not None and "k_scale" in cache
    S_l = cache["k"].shape[2]
    start, S = (0, S_l) if kv_seq is None else (kv_seq.rank * S_l, kv_seq.size * S_l)
    loc = pos_b.long().clamp(max=S - 1) - start
    own = None if kv_seq is None else ((loc >= 0) & (loc < S_l))[:, None, None]
    if own is not None:
        loc = loc.clamp(0, S_l - 1)
    bidx = torch.arange(q.shape[0], device=q.device)
    for name, t in (("k", k), ("v", v)):
        if quant:
            t = kv_quantize(t, kv_spec, cache[f"{name}_scale"][:, :, 0])
        dst = cache[name]
        t = t.to(dst.dtype)
        dst[bidx, :, loc] = t if own is None else torch.where(own, t, dst[bidx, :, loc])
    return _attend(q, cache["k"], cache["v"], cache if quant else None, pos_b + 1,
                   kv_spec, kernels, rcfg, kv_seq)


def _attend(q, kc, vc, scales, lim, kv_spec, kernels, rcfg, kv_seq=None):
    """q (B, G, R, Dh) against a heads-major cache kc, vc (B, G, S, Dh) of
    codes with the static ``scales`` (a dict holding "k_scale" and
    "v_scale") or of values (``scales`` None), to the positions before
    ``lim`` (B,): through ``kv_flash_decode`` where the kernels are on and
    the cache is quantized, else the plain form (``decode_attention``,
    rounding as ``rcfg.serve_bf16_compute`` on a cache of values). On a
    serving grid (``kv_seq``) the cache is rank r's block of positions
    [r S, (r + 1) S): it is attended with the local lengths
    clamp(lim - r S, 0, S) and its rows' log-sum-exps, and
    ``combine_partials`` merges the ranks' blocks. Returns (B, G, R, Dh)."""
    grid = kv_seq is not None
    if grid:
        S = kc.shape[2]
        lim = (torch.as_tensor(lim, device=q.device) - kv_seq.rank * S).clamp(0, S)
    if scales is not None and kernels is not None:
        r = kernels.kv_flash_decode(q, kc, scales["k_scale"], vc, scales["v_scale"], lim,
                                    kv_spec, with_lse=grid)
    else:
        if scales is not None:
            kc = kv_dequantize(kc, kv_spec, scales["k_scale"])
            vc = kv_dequantize(vc, kv_spec, scales["v_scale"])
        r = decode_attention(q[:, None], kc, vc, lim, with_lse=grid,
                             bf16_compute=scales is None and rcfg.serve_bf16_compute)
        r = (r[0][:, 0], r[1][:, 0]) if grid else r[:, 0]
    return combine_partials(*r, kv_seq) if grid else r


def _grid_attn(p: dict, x: torch.Tensor, cfg, rcfg, *, positions, causal, cache,
               cache_pos, xa, kernels, kv_spec, kv_scales, tp, kv_seq):
    """Attention served on a (pod, data, model) grid: x is the rank's rows,
    whole along d; wq holds the rank's query heads where the model axis
    ``tp`` cuts them, wk/wv the rank's kv heads where it cuts those, and
    the layer cache holds every kv head of the rank's block of positions
    (``kv_seq``, the model axis: rank r of M the positions [r S_l, (r+1)
    S_l) of a local length S_l). Returns (y, new_kv) as ``attn_forward``.

    Prefill (and cross-attention over the encoder states ``xa``): the
    rank's query heads attend over every position, to the kv heads they
    read; new_kv holds the K/V (codes, for a quantized cache) of every kv
    head (gathered over model where wk/wv are cut), of which the caller
    keeps its block of positions.

    Decode (one token, ``cache`` given): q of every head (gathered over
    model) and the new token's K/V of every kv head take the single card's
    ``_dense_decode`` with ``kv_seq`` (the token written on the rank that
    owns its position, every head attended over the rank's block, the
    blocks combined), and the output projection takes the rank's heads
    (wo's rows) before its all-reduce. The static cross cache (encdec) is
    read through ``_attend`` the same way, masked at its length."""
    Dh, H, G = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    B, Sq, _ = x.shape
    tp_h = placed(tp, p["wq"].shape[-2], H)
    q = matmul_param(x, p["wq"], kernels=kernels).reshape(B, Sq, -1, Dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    static = cache is not None and "k_static" in cache
    rot = None
    if xa is None and not static:
        rot = rotary_cos_sin(positions, Dh, cfg.rope_theta)
        q = apply_rotary(q, *rot)
    if cache is not None and Sq == 1:
        qa = (q if tp_h is None else tp_h.all_gather(q, 2)).reshape(B, G, H // G, Dh)
        if static:
            y = _attend(qa, cache["k_static"], cache["v_static"], None, cache["len"],
                        kv_spec, kernels, rcfg, kv_seq)
            new_kv = None
        else:
            k, v = _grid_kv(p, x, cfg, kernels, tp, rot)
            pos_b = torch.as_tensor(cache_pos, device=x.device).reshape(-1).expand(B)
            y = _dense_decode(qa, k[:, 0], v[:, 0], cache, pos_b, kv_spec, kernels, rcfg,
                              kv_seq)
            new_kv = cache
        return _out_proj(p, y[:, None].to(x.dtype), x, cfg, kernels, tp), new_kv
    k, v = _grid_kv(p, x if xa is None else xa, cfg, kernels, tp, rot)
    k, v, new_kv = _prefill_kv(k, v, kv_spec, kv_scales if xa is None else None)
    k, v, Gl, R = _heads_kv(k, v, cfg, tp_h, q.shape[2])
    y = flash_attention(q.reshape(B, Sq, Gl, R, Dh), k, v, causal=causal and xa is None,
                        q_chunk=rcfg.attn_q_chunk, kv_chunk=rcfg.attn_kv_chunk)
    return _out_proj(p, y, x, cfg, kernels, tp), new_kv


def _grid_kv(p: dict, h: torch.Tensor, cfg, kernels, tp, rot):
    """K and V of every kv head from ``h`` (B, S, d): gathered over model
    where the model axis ``tp`` cuts wk/wv; k normed (qk_norm) and, with
    ``rot`` (cos, sin), rotated."""
    B, S, _ = h.shape
    k = matmul_param(h, p["wk"], kernels=kernels).reshape(B, S, -1, cfg.d_head)
    v = matmul_param(h, p["wv"], kernels=kernels).reshape(B, S, -1, cfg.d_head)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if rot is not None:
        k = apply_rotary(k, *rot)
    tp_k = placed(tp, p["wk"].shape[-2], cfg.n_kv_heads)
    if tp_k is not None:
        k, v = tp_k.all_gather(k, 2), tp_k.all_gather(v, 2)
    return k, v


def _heads_kv(k, v, cfg, tp_h, Hl: int):
    """(k, v, G, R): of every kv head's K/V (B, S, G, Dh), those the rank's
    ``Hl`` query heads read (all of them where ``tp_h`` is None), in the
    (groups, heads a group) layout of ``_rank_groups``."""
    if tp_h is None:
        return k, v, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    sel, R = _rank_groups(cfg, tp_h, Hl)
    return k[:, :, sel], v[:, :, sel], len(sel), R


def _rank_groups(cfg, tp, H: int):
    """(the kv groups, heads a group) of the ``H`` query heads of ``tp``'s
    rank: one group for all of them when they share one, else one a head
    (its group repeated)."""
    r_full = cfg.n_heads // cfg.n_kv_heads
    groups = [h // r_full for h in range(tp.rank * H, (tp.rank + 1) * H)]
    return (groups[:1], H) if r_full % H == 0 else (groups, 1)


def _rank_kv(p: dict, cfg, tp):
    """(wk, wv, G, R): the kv weights a rank's query heads read and the
    (groups, heads a group) layout of its q. ``tp`` is the model axis where
    it cuts the query heads. The leaves as they are, except where wk/wv
    replicate while wq is sharded (a model axis that does not divide the kv
    heads, training only): then the columns of the kv groups of the rank's
    heads, one group for all of them when they share one, else one a head
    (each read through ``copy_in``, so the gradient of the whole leaf sums
    over the ranks)."""
    H, G = p["wq"].shape[-2], p["wk"].shape[-2]
    if tp is None or G != cfg.n_kv_heads:
        return p["wk"], p["wv"], G, H // G
    sel, R = _rank_groups(cfg, tp, H)
    return (_kv_columns(tp.copy_in(p["wk"]), sel), _kv_columns(tp.copy_in(p["wv"]), sel),
            len(sel), R)


def _kv_columns(w, sel):
    """The kv groups ``sel`` of a (d, G, Dh) weight; of a quantized one
    (served on a grid, the encoder's) its codes' and, where it varies
    along G, its scale's."""
    if not isinstance(w, QuantizedTensor):
        return w[:, sel]
    scale = w.scale if w.scale.shape[1] == 1 else w.scale[:, sel]
    return QuantizedTensor(w.codes[:, sel], scale, w.spec)


def _out_proj(p: dict, y: torch.Tensor, x: torch.Tensor, cfg,
              kernels: Optional[KernelSet], tp=None, sp=None) -> torch.Tensor:
    """Heads (B, Sq, G, R, Dh) -> (B, Sq, d) in x's dtype, through wo.
    Where the model axis ``tp`` cuts wo's rows, the partial products are
    summed over the ranks here (``reduce_out``, under sequence parallelism
    ``scatter_seq``: ``seq_out``), the attention block's one collective;
    heads that every rank computed whole are cut to the rank's rows first
    (``take_block``)."""
    y = y.reshape(*x.shape[:2], -1).to(x.dtype)
    tp_o = placed(tp, p["wo"].shape[0], cfg.n_heads * cfg.d_head)
    if tp_o is not None and y.shape[-1] > p["wo"].shape[0]:
        y = take_block(y, tp_o, -1)
    return seq_out(matmul_param(y, p["wo"], kernels=kernels), sp, tp_o)
