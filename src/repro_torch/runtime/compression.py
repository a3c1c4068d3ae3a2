"""Posit-compressed cross-pod gradient mean.

Port of ``repro/runtime/compression.py``. The cross-pod gradient mean is
the slowest collective of multi-pod training; each pod

  1. (optionally) adds its error-feedback residual,
  2. scales the leaf by a power-of-two normalizer taken from its largest
     magnitude over the whole pod (over every rank that holds a shard of
     it: the maximum is all-reduced over them),
  3. encodes it to (N-1)-bit normalized posit codes (uint8 on the wire,
     ``core.normalized_posit.norm_encode_arith``),
  4. all-gathers the codes and the scale over the pod group, then decodes
     and takes the mean locally, in the reference's order: the sum over the
     pod index of ``codes' values * scale``, over the pod count.

Under error feedback the residual ``x - decode(encode(x))`` is returned
for the next step.

The reference maps over its parameter tree, whose ``blocks`` leaves stack
the layers; the port's leaves are per layer, so ``compressed_grad_transform``
takes each leaf's ``names`` (``core.policy.named_leaves``): the layers of
one reference leaf share the scale taken over all of them, and the codes
are the reference's.

The scale is the exact power of two at or above the maximum magnitude
(read from its float32 bits). The reference computes it with ``exp2(ceil(
log2(amax)))``, whose CPU ``exp2`` misses powers of two below 2^-12 and
above 2^12 by a few ulps; there its codes and means may differ from the
port's (ROADMAP Queue C item 4).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.normalized_posit import norm_decode, norm_encode_arith
from repro_torch.nn.sharding import TPContext

__all__ = ["pow2_scale", "posit_compressed_mean", "compressed_grad_transform"]

# elements a pass of the codec: its integer temporaries stay a few times
# this (an embedding table's gradient is 262M elements at full width)
CHUNK = 1 << 24


def pow2_scale(amax: torch.Tensor) -> torch.Tensor:
    """The least power of two at or above ``max(amax, 1e-30)``, f32: exact
    (the exponent of the float32 bits, one up unless the mantissa is 0)."""
    a = amax.to(torch.float32).clamp_min(1e-30)
    bits = a.view(torch.int32)
    up = ((bits & 0x7FFFFF) != 0).to(torch.int32)
    return ((((bits >> 23) & 0xFF) + up) << 23).view(torch.float32)


def _plus(x: torch.Tensor, residual: Optional[torch.Tensor]) -> torch.Tensor:
    xf = x.to(torch.float32)
    return xf if residual is None else xf + residual


def _chunks(n: int):
    return [slice(i, min(i + CHUNK, n)) for i in range(0, n, CHUNK)]


def _encode(xf: torch.Tensor, scale: torch.Tensor, N: int, ES: int) -> torch.Tensor:
    """uint8 codes of ``xf / scale``, a chunk at a time."""
    flat = xf.reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.uint8, device=xf.device)
    for sl in _chunks(flat.numel()):
        out[sl] = norm_encode_arith(flat[sl] / scale, N, ES).to(torch.uint8)
    return out.view(xf.shape)


def _decoded_sum(codes: torch.Tensor, scales: torch.Tensor, N: int, ES: int) -> torch.Tensor:
    """sum over the leading axis p of ``decode(codes[p]) * scales[p]``, in p
    order, a chunk at a time (f32)."""
    flat = codes.reshape(codes.shape[0], -1)
    out = torch.empty(flat.shape[1], dtype=torch.float32, device=codes.device)
    for sl in _chunks(flat.shape[1]):
        acc = norm_decode(flat[0, sl], N, ES) * scales[0]
        for p in range(1, flat.shape[0]):
            acc = acc + norm_decode(flat[p, sl], N, ES) * scales[p]
        out[sl] = acc
    return out.view(codes.shape[1:])


def posit_compressed_mean(x: torch.Tensor, group: TPContext, *, N: int = 8, ES: int = 2,
                          residual: Optional[torch.Tensor] = None,
                          amax: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The mean of ``x`` over the pods of ``group`` with posit-coded
    transport. ``amax``, if given, is the largest magnitude to scale by (the
    leaf's over every rank of the pod that holds a block of it, and over
    the layers of its reference leaf), else ``x + residual``'s own.
    Returns (mean, new_residual); new_residual is None iff residual is
    None."""
    xf = _plus(x, residual)
    scale = pow2_scale(xf.abs().amax() if amax is None else amax)
    codes = _encode(xf, scale, N, ES)
    new_residual = None
    if residual is not None:
        new_residual = xf.sub_(_decoded_sum(codes[None], scale.reshape(1), N, ES))
    del xf
    # uint8 codes and one f32 scalar cross between the pods
    g_codes = group.all_gather(codes[None], 0)
    g_scale = group.all_gather(scale.reshape(1), 0)
    mean = _decoded_sum(g_codes, g_scale, N, ES)
    return (mean / group.size).to(x.dtype), new_residual


def compressed_grad_transform(grads: Sequence[torch.Tensor], group: TPContext, *,
                              N: int = 8, ES: int = 2,
                              residuals: Optional[Sequence[torch.Tensor]] = None,
                              shards: Sequence[TPContext], names: Sequence[str]):
    """``posit_compressed_mean`` over a list of gradient leaves: ``shards``
    the group of the pod's ranks each leaf is split over (TPContext() where
    it is whole), ``names`` the reference leaf each belongs to (leaves of
    one name share one scale, from their largest magnitude). Returns
    (means, new residuals or None)."""
    res = list(residuals) if residuals is not None else [None] * len(grads)
    local: Dict = {}
    for g, r, name in zip(grads, res, names):
        a = _plus(g, r).abs().amax()
        local[name] = a if name not in local else torch.maximum(local[name], a)
    first = {}
    for name, s in zip(names, shards):
        first.setdefault(name, s)
    amax = {name: first[name].all_reduce(a, "max") for name, a in local.items()}
    pairs = [posit_compressed_mean(g, group, N=N, ES=ES, residual=r, amax=amax[name])
             for g, r, name in zip(grads, res, names)]
    means: List[torch.Tensor] = [m for m, _ in pairs]
    return means, (None if residuals is None else [r for _, r in pairs])
