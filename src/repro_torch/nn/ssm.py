"""State-space sequence mixers: Mamba1 selective scan and Mamba2 SSD.

Port of ``repro/nn/ssm.py``; both mixers are plain PyTorch, chunk-parallel
as in the reference, so the (B, S, d_inner, state) tensor is never made
over the whole sequence:

* Mamba1 (falcon-mamba): per-channel diagonal A. Within a chunk of c steps
  the recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t is an associative
  scan (``_assoc_scan``, the reference's ``lax.associative_scan`` order);
  chunks follow each other in a loop (the reference's ``lax.scan``).
* Mamba2 (zamba2): one scalar A per head (SSD). Inside a chunk the decay
  mask L turns the recurrence into products, (C B^T * L) X plus the
  incoming state; the state passes from chunk to chunk. L's log decays
  are summed within each segment, where the reference subtracts
  cumulative sums: the same in exact arithmetic, closer in f32
  (``_ssd_chunk``).

Decode is the same code at S = 1 (one chunk of one step) against the
carried state: {"conv": (B, K-1, conv_dim), "ssm": (B, ...)}, both f32.
Only ``in_proj`` and ``out_proj`` take the kernel datapath; ``x_proj`` and
``dt_proj`` are dequantized and multiplied (``matmul_param`` without
kernels) even when the kernels are on, as in the reference. A_log,
dt_bias, D, the conv taps and the norm are never quantized.

On a training grid (``tp``, the model axis) each leaf holds the block that
the reference's training rules give it, and the mixer computes the rank's
channels (``nn.sharding``'s four passes between whole tensors and the
rank's blocks): in_proj's output is gathered whole where the model axis
cuts its columns (contiguous blocks across the packed x | z, or z | x B C
| dt). Mamba1 takes the rank's channels of x and z; conv, dt_proj's
columns, dt_bias, A_log and D are the rank's, x_proj's rows give a partial
(dt, B, C) summed over model, and out_proj's rows a partial output summed
over model. Mamba2 convolves the rank's block of x B C (gathered whole
after), runs the rank's heads (A_log, dt_bias, D) on the shared B and C,
takes the gated RMSNorm's mean square over every channel (its sum of
squares summed over model) and sums out_proj's rows' partial products.
A dim that the model axis does not divide is whole on every rank. Under
sequence parallelism (``sp``) the mixer's input is the rank's block along
seq: in_proj reads the whole sequence (``seq_in``), so the convolution and
the scan run over all of it as without ``sp``, and out_proj hands back the
rank's block (``seq_out``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import KernelSet
from .layers import matmul_param, param_value, rmsnorm
from .sharding import gather_replicated, placed, seq_in, seq_out, take_block

__all__ = ["mamba_init", "mamba_shapes", "mamba_init_cache", "mamba1_mix", "mamba1_forward",
           "mamba2_mix", "mamba2_forward", "mamba1_mix_ref", "mamba2_mix_ref",
           "softplus"]

_f32 = torch.float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)) (``F.softplus`` returns x itself above 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _chunk_len(S: int, chunk: int) -> int:
    """The reference's chunk rule: the largest c <= chunk dividing S."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


# ---------------------------------------------------------------------------
# init and cache
# ---------------------------------------------------------------------------


def mamba_init(cfg, *, gen: torch.Generator, device, dtype: torch.dtype,
               rule: Callable, prefix: str) -> dict:
    """One mixer's parameters (mamba1 for the ssm family, mamba2 for
    hybrid), drawn from ``gen`` as the reference's ``mamba{1,2}_init``
    distributes them; ``rule(name, leaf)`` applies the quantization policy
    to each leaf as it is made."""
    d, di, ds, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.conv_width

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=_f32)

    def leaf(name, w):
        return rule(prefix + name, w)

    def dense(name, i, o, scale=None):
        scale = i ** -0.5 if scale is None else scale
        return leaf(name, (randn(i, o) * scale).to(dtype))

    if cfg.family == "ssm":
        dr = cfg.dt_rank
        # A = -[1..ds] per channel (S4D-real), stored as its log
        a = torch.arange(1, ds + 1, dtype=_f32, device=device).expand(di, ds)
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(di, generator=gen, device=device, dtype=_f32) * (hi - lo) + lo
        return {
            "in_proj": dense("in_proj", d, 2 * di),
            "conv_w": leaf("conv_w", (randn(K, di) * 0.1).to(dtype)),
            "conv_b": leaf("conv_b", torch.zeros(di, dtype=dtype, device=device)),
            "x_proj": dense("x_proj", di, dr + 2 * ds),
            "dt_proj": dense("dt_proj", dr, di, scale=dr ** -0.5),
            "dt_bias": leaf("dt_bias", torch.log(torch.expm1(torch.exp(u)))),
            "A_log": leaf("A_log", torch.log(a).contiguous()),
            "D": leaf("D", torch.ones(di, dtype=_f32, device=device)),
            "out_proj": dense("out_proj", di, d),
        }
    nh = di // cfg.ssm_head_dim
    cd = di + 2 * ds
    # in_proj packs [z (di), x (di), B (ds), C (ds), dt (nh)]
    return {
        "in_proj": dense("in_proj", d, 2 * di + 2 * ds + nh),
        "conv_w": leaf("conv_w", (randn(K, cd) * 0.1).to(dtype)),
        "conv_b": leaf("conv_b", torch.zeros(cd, dtype=dtype, device=device)),
        "A_log": leaf("A_log", torch.log(torch.linspace(1.0, 16.0, nh, device=device))),
        "dt_bias": leaf("dt_bias", torch.zeros(nh, dtype=_f32, device=device)),
        "D": leaf("D", torch.ones(nh, dtype=_f32, device=device)),
        "norm_w": leaf("norm_w", torch.ones(di, dtype=dtype, device=device)),
        "out_proj": dense("out_proj", di, d),
    }


def mamba_shapes(cfg) -> dict:
    """{name: shape} of one mixer's leaves, as ``mamba_init`` makes them."""
    d, di, ds, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.conv_width
    if cfg.family == "ssm":
        dr = cfg.dt_rank
        return {"in_proj": (d, 2 * di), "conv_w": (K, di), "conv_b": (di,),
                "x_proj": (di, dr + 2 * ds), "dt_proj": (dr, di), "dt_bias": (di,),
                "A_log": (di, ds), "D": (di,), "out_proj": (di, d)}
    nh, cd = di // cfg.ssm_head_dim, di + 2 * ds
    return {"in_proj": (d, 2 * di + 2 * ds + nh), "conv_w": (K, cd), "conv_b": (cd,),
            "A_log": (nh,), "dt_bias": (nh,), "D": (nh,), "norm_w": (di,),
            "out_proj": (di, d)}


def mamba_init_cache(cfg, n_layers: int, batch: int, device) -> dict:
    """Zero recurrent state of ``n_layers`` mixers, f32:
    {"conv": (L, B, K-1, conv_dim), "ssm": (L, B, di, ds) for mamba1 or
    (L, B, nh, dh, ds) for mamba2}."""
    di, ds, K = cfg.d_inner, cfg.ssm_state, cfg.conv_width
    if cfg.family == "ssm":
        conv_dim, state = di, (di, ds)
    else:
        dh = cfg.ssm_head_dim
        conv_dim, state = di + 2 * ds, (di // dh, dh, ds)
    return {"conv": torch.zeros((n_layers, batch, K - 1, conv_dim), dtype=_f32,
                                device=device),
            "ssm": torch.zeros((n_layers, batch, *state), dtype=_f32, device=device)}


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over the sequence. x (B, S, d); w (K, d);
    state (B, K-1, d), the previous segment's trailing inputs. Returns
    (y in x's dtype, new state in the state's dtype). The state enters in
    x's dtype, so at bf16 activations a carried f32 state holds
    bf16-rounded values, as in the reference."""
    K = w.shape[0]
    B, S, d = x.shape
    if state is None:
        state = torch.zeros((B, K - 1, d), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = torch.zeros((B, S, d), dtype=_f32, device=x.device)
    for i in range(K):
        y = y + xp[:, i:i + S].to(_f32) * w[i].to(_f32)
    new_state = xp[:, S:].to(state.dtype)
    return (y + b.to(_f32)).to(x.dtype), new_state


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1], *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the linear recurrence's pairs:
    (a1, b1) then (a2, b2) compose to (a2 a1, a2 b1 + b2). The recursion
    of ``jax.lax.associative_scan``: combine adjacent pairs, scan those,
    then fill in the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b

    def comb(l, r):
        (a1, b1), (a2, b2) = l, r
        return a2 * a1, a2 * b1 + b2

    ra, rb = comb((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = comb((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = comb((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _chunk_scan_diag(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor):
    """h_t = dA_t * h_{t-1} + dBx_t within a chunk, diagonal dA.
    dA, dBx (B, c, ...); h0 (B, ...). Returns (h_all (B, c, ...), h_last).
    Every product stays in (0, 1] (dA = exp(dt A), A < 0)."""
    A, Bv = _assoc_scan(dA, dBx)
    h = A * h0[:, None] + Bv
    return h, h[:, -1]


# ---------------------------------------------------------------------------
# Mamba1 (falcon-mamba-7b)
# ---------------------------------------------------------------------------


def mamba1_mix(p: dict, xz: torch.Tensor, cfg, *, conv_state=None, ssm_state=None,
               chunk: Optional[int] = None, tp=None):
    """The mamba1 mixer after in_proj. xz (B, S, 2 di), whole. Returns (y
    (B, S, di) in xz's dtype, new conv state, new ssm state); with ``tp``
    (a training grid's model axis, where it cuts d_inner) y holds the
    rank's channels."""
    di, ds, dr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    x, z = torch.split(xz, di, dim=-1)
    tp = placed(tp, p["conv_w"].shape[-1], di)
    if tp is not None:
        x, z = take_block(x, tp, -1), take_block(z, tp, -1)
    x, new_conv = _causal_conv(x, param_value(p["conv_w"], _f32),
                               param_value(p["conv_b"], _f32), conv_state)
    x = F.silu(x)
    # the input-dependent dt, B, C: plain dequantize + matmul
    dbc = matmul_param(x, p["x_proj"])
    if tp is not None:
        # x_proj's rows are the rank's channels: a partial (dt, B, C), which
        # every channel of the rank then reads whole
        dbc = tp.copy_in(tp.reduce_out(dbc))
    dt, Bm, Cm = torch.split(dbc, [dr, ds, ds], dim=-1)
    dt = matmul_param(dt, p["dt_proj"]).to(_f32)
    dt = softplus(dt + p["dt_bias"].to(_f32))                   # (B, S, di)
    A = -torch.exp(p["A_log"].to(_f32))                         # (di, ds)
    B_, S_, _ = x.shape
    c = _chunk_len(S_, chunk or cfg.ssm_chunk)
    xf = x.to(_f32)
    dA = torch.exp(dt[..., None] * A)                           # (B, S, di, ds)
    dBx = (dt * xf)[..., None] * Bm.to(_f32)[..., None, :]
    Cf = Cm.to(_f32)
    h = (torch.zeros((B_, x.shape[-1], ds), dtype=_f32, device=xz.device)
         if ssm_state is None else ssm_state)
    ys = []
    for s in range(0, S_, c):
        h_all, h = _chunk_scan_diag(dA[:, s:s + c], dBx[:, s:s + c], h)
        ys.append(torch.einsum("bcds,bcs->bcd", h_all, Cf[:, s:s + c]))
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + xf * p["D"].to(_f32)
    y = y * F.silu(z.to(_f32))
    return y.to(xz.dtype), new_conv, h


def _in_proj(p: dict, x: torch.Tensor, width: int, kernels, tp, sp) -> torch.Tensor:
    """x @ in_proj, whole on every rank: where the model axis ``tp`` cuts
    in_proj's ``width`` columns, x goes in through ``copy_in`` (under
    ``sp``, ``gather_seq``) and the ranks' column blocks are gathered."""
    tp = placed(tp, p["in_proj"].shape[-1], width)
    y = matmul_param(seq_in(x, sp, tp), p["in_proj"], kernels=kernels)
    return y if tp is None else gather_replicated(y, tp, -1)


def _out_proj(p: dict, y: torch.Tensor, cfg, kernels, tp, sp) -> torch.Tensor:
    """y @ out_proj, summed over model where the model axis cuts its rows
    (y then holds the rank's channels); under ``sp`` the rank's block
    along seq (``seq_out``)."""
    out = matmul_param(y, p["out_proj"], kernels=kernels)
    return seq_out(out, sp, placed(tp, p["out_proj"].shape[0], cfg.d_inner))


def mamba1_forward(p: dict, x: torch.Tensor, cfg, *, cache: Optional[dict] = None,
                   kernels: Optional[KernelSet] = None, tp=None, sp=None):
    """The whole mamba1 mixer. x (B, S, d); cache {"conv", "ssm"} or None;
    ``tp``: the model axis of a training grid, ``sp`` that axis where
    sequence parallelism cuts x along seq. Returns (out (B, S, d), new
    cache or None)."""
    xz = _in_proj(p, x, 2 * cfg.d_inner, kernels, tp, sp)
    conv_s = cache["conv"] if cache else None
    ssm_s = cache["ssm"] if cache else None
    y, new_conv, new_ssm = mamba1_mix(p, xz, cfg, conv_state=conv_s, ssm_state=ssm_s,
                                      tp=tp)
    out = _out_proj(p, y, cfg, kernels, tp, sp)
    return out, ({"conv": new_conv, "ssm": new_ssm} if cache is not None else None)


# ---------------------------------------------------------------------------
# Mamba2 / SSD (zamba2)
# ---------------------------------------------------------------------------


def _ssd_chunk(x, dt, A, Bm, Cm, h0):
    """One SSD chunk. x (B, c, nh, dh); dt (B, c, nh); A (nh,) negative;
    Bm, Cm (B, c, ds); h0 (B, nh, dh, ds). Returns (y, h_last). With
    a_t = exp(dt_t A) per head:
      intra: y_t  = C_t . sum_{i<=t} (prod_{i<j<=t} a_j) dt_i B_i x_i
      inter: y_t += C_t . (prod_{i<=t} a_i) h0
    """
    c = x.shape[1]
    la = dt * A                                         # (B, c, nh), <= 0
    cum = torch.cumsum(la, dim=1)
    # L[t, i] = exp(seg[t, i]) for i <= t, else 0, with seg[t, i] =
    # sum_{i<j<=t} la_j summed within the segment. The reference takes
    # cum_t - cum_i, the same sum in exact arithmetic; in f32 the
    # difference of two cumulative sums of order 1e2-1e3 keeps only their
    # last bits, and the backward's reverse cumsums amplify that in the
    # gradients of dt_bias and A_log
    ltri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device), -1)
    seg = torch.cumsum(torch.where(ltri[None, :, :, None], la[:, :, None, :], 0.0), dim=1)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    Lm = torch.exp(torch.where(tri[None, :, :, None], seg,
                               torch.full_like(seg, -1e30)))  # (B, t, i, nh)
    CB = torch.einsum("bts,bis->bti", Cm, Bm)
    W = CB[..., None] * Lm                              # (B, t, i, nh)
    dx = dt[..., None] * x                              # (B, c, nh, dh)
    y = torch.einsum("btih,bihd->bthd", W, dx)
    decay0 = torch.exp(cum)
    y = y + torch.einsum("bts,bhds,bth->bthd", Cm, h0, decay0)
    w_last = Lm[:, -1]                                  # (B, c, nh)
    h_last = (torch.exp(cum[:, -1])[:, :, None, None] * h0
              + torch.einsum("bih,bihd,bis->bhds", w_last, dx, Bm))
    return y, h_last


def mamba2_mix(p: dict, zxbcdt: torch.Tensor, cfg, *, conv_state=None,
               ssm_state=None, chunk: Optional[int] = None, tp=None):
    """The mamba2 mixer after in_proj. zxbcdt (B, S, 2 di + 2 ds + nh),
    whole. Returns (y (B, S, di) after the gated RMSNorm, new conv state,
    new ssm state); with ``tp`` (a training grid's model axis) y holds the
    rank's channels where the model axis cuts d_inner."""
    di, ds, dh = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = di // dh
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * ds, nh], dim=-1)
    tp_c = placed(tp, p["conv_w"].shape[-1], di + 2 * ds)
    if tp_c is not None:
        xBC = take_block(xBC, tp_c, -1)
    xBC, new_conv = _causal_conv(xBC, param_value(p["conv_w"], _f32),
                                 param_value(p["conv_b"], _f32), conv_state)
    xBC = F.silu(xBC)
    if tp_c is not None:
        xBC = gather_replicated(xBC, tp_c, -1)
    x, Bm, Cm = torch.split(xBC, [di, ds, ds], dim=-1)
    tp_h = placed(tp, p["A_log"].shape[0], nh)
    if tp_h is not None:
        # the rank's heads (and their channels), on the B and C all share
        x, dt, z = (take_block(t, tp_h, -1) for t in (x, dt, z))
        Bm, Cm = tp_h.copy_in(Bm), tp_h.copy_in(Cm)
        nh = nh // tp_h.size
    Bsz, S, _ = x.shape
    dt = softplus(dt.to(_f32) + p["dt_bias"].to(_f32))
    A = -torch.exp(p["A_log"].to(_f32))                 # (nh,)
    xh = x.to(_f32).reshape(Bsz, S, nh, dh)
    Bf, Cf = Bm.to(_f32), Cm.to(_f32)
    c = _chunk_len(S, chunk or cfg.ssm_chunk)
    h = (torch.zeros((Bsz, nh, dh, ds), dtype=_f32, device=zxbcdt.device)
         if ssm_state is None else ssm_state)
    ys = []
    for s in range(0, S, c):
        y_c, h = _ssd_chunk(xh[:, s:s + c], dt[:, s:s + c], A, Bf[:, s:s + c],
                            Cf[:, s:s + c], h)
        ys.append(y_c)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + xh * p["D"].to(_f32)[None, None, :, None]
    y = y.reshape(Bsz, S, nh * dh)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z.to(_f32))
    tp_n = placed(tp, p["norm_w"].shape[0], di)
    if tp_n is None:
        return rmsnorm(y.to(zxbcdt.dtype), p["norm_w"], cfg.norm_eps), new_conv, h
    yf = y.to(zxbcdt.dtype).to(_f32)
    if tp_h is None:
        # every channel normalized on every rank, then the rank's
        yn = take_block(yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True)
                                         + cfg.norm_eps), tp_n, -1)
    else:
        # the mean square over every channel: the ranks' sums of squares
        var = tp_h.copy_in(tp_h.reduce_out(torch.sum(yf * yf, dim=-1, keepdim=True))) / di
        yn = yf * torch.rsqrt(var + cfg.norm_eps)
    return (yn * param_value(p["norm_w"], _f32)).to(zxbcdt.dtype), new_conv, h


def mamba2_forward(p: dict, x: torch.Tensor, cfg, *, cache: Optional[dict] = None,
                   kernels: Optional[KernelSet] = None, tp=None, sp=None):
    """The whole mamba2 mixer, as ``mamba1_forward``."""
    di, ds = cfg.d_inner, cfg.ssm_state
    zxbcdt = _in_proj(p, x, 2 * di + 2 * ds + di // cfg.ssm_head_dim, kernels, tp, sp)
    conv_s = cache["conv"] if cache else None
    ssm_s = cache["ssm"] if cache else None
    y, new_conv, new_ssm = mamba2_mix(p, zxbcdt, cfg, conv_state=conv_s, ssm_state=ssm_s,
                                      tp=tp)
    out = _out_proj(p, y, cfg, kernels, tp, sp)
    return out, ({"conv": new_conv, "ssm": new_ssm} if cache is not None else None)


# sequential references: one step a chunk (the correctness oracles) ---------


def mamba1_mix_ref(p: dict, xz: torch.Tensor, cfg):
    return mamba1_mix(p, xz, cfg, chunk=1)


def mamba2_mix_ref(p: dict, zxbcdt: torch.Tensor, cfg):
    return mamba2_mix(p, zxbcdt, cfg, chunk=1)
