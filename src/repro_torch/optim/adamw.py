"""AdamW with warmup+cosine schedule, global-norm clipping and
posit8-compressed moments.

Port of ``repro/optim/adamw.py``. It is not ``torch.optim.AdamW``: weight
decay applies only to leaves with ``ndim >= 2``, gradients are clipped by
their global norm, the learning rate follows the reference's warmup +
cosine schedule, and the moments m and v can be stored as Posit(8, 2)
codes with one power-of-two per-tensor scale (``quant="posit8"``: 1 byte
a moment instead of 4).

State layout: {"m": tree, "v": tree, "count": int32 scalar tensor}, where
each moment tree mirrors the parameter tree (one dict per layer in
``blocks``) and each leaf is an f32 tensor or, posit8, a
``QuantizedTensor`` (uint8 codes, a (1,)*ndim f32 scale).

The reference quantizes each moment leaf of its layer-stacked tree
whole, so every layer of one stacked leaf shares one scale. Here the
layers of one reference leaf (the parameters that ``named_leaves`` names
alike) form a group and share the scale taken over the whole group: the
codes are the reference's. ``apply_updates`` updates the parameters and
the moments IN PLACE (the reference's step is jitted with the state
donated), leaf by leaf and in chunks of ``CHUNK`` elements, so that only
one chunk's f32 temporaries live at a time. A posit8 group is walked
twice: once to update the parameters and find the new moments' largest
magnitude, once to encode them under the group's scale, recomputing the
same f32 moments from the old codes (no group's f32 moments are held).

Weight decay follows the reference's ``p.ndim >= 2`` on its stacked
leaves, whose layer axes count: a layer's norm weight (d,) decays as the
reference's (L, d) stack does.

On a training grid each rank holds its block of every leaf, and
``apply_updates(..., shards=)`` names, leaf by leaf, the group of ranks
over which the leaf is sharded (``TPContext()`` where it replicates): the
gradient and parameter norms sum each leaf's squares over its group (a
replicated leaf is counted once), and a posit8 group's moment maxima are
all-reduced with MAX over its group, so every rank's scales are the tp = 1
scales. Moments shard like their parameter; a posit8 scale replicates.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.fxp import compute_scale
from repro_torch.core.policy import named_leaves
from repro_torch.core.posit import posit_decode, posit_encode
from repro_torch.core.quantizers import QuantSpec, QuantizedTensor

__all__ = ["OptConfig", "init_opt_state", "apply_updates", "lr_schedule",
           "global_norm", "tree_leaves", "tree_map"]

_POSIT8 = QuantSpec(kind="posit", N=8, ES=2, scale_mode="tensor_pow2")
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quant: str = "none"          # none | posit8


def tree_leaves(tree) -> List[Any]:
    """Leaves of a parameter-like tree in ``named_leaves`` order (sorted
    dict keys, list items in order, a QuantizedTensor as one leaf)."""
    return [leaf for _, leaf in named_leaves(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the trees ``rest`` of the
    same structure), rebuilt in ``tree``'s structure; leaves are visited
    in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *r) for t, *r in zip(tree, *rest)]
    return fn(tree, *rest)


def lr_schedule(step: torch.Tensor, ocfg: OptConfig) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(ocfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - ocfg.warmup_steps)
                    / max(ocfg.total_steps - ocfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = ocfg.min_lr_frac + (1 - ocfg.min_lr_frac) * cos
    return ocfg.learning_rate * warm * frac


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree) if isinstance(tree, dict) else list(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))


def _zeros_like_moment(p: torch.Tensor, quant: str):
    if quant == "posit8":
        # quantize(zeros): codes 0, scale exp2(ceil(log2(1e-12)))
        scale = compute_scale(torch.zeros((1,) * p.ndim, device=p.device),
                              _POSIT8.scale_mode)
        return QuantizedTensor(torch.zeros(p.shape, dtype=_POSIT8.code_dtype(),
                                           device=p.device), scale, _POSIT8)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_opt_state(params, quant: str = "none") -> Dict[str, Any]:
    if quant not in ("none", "posit8"):
        raise ValueError(f"unknown moment format {quant!r} (none | posit8)")
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(lambda p: _zeros_like_moment(p, quant), params),
            "v": tree_map(lambda p: _zeros_like_moment(p, quant), params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@functools.lru_cache(maxsize=None)
def _posit8_values(device: torch.device) -> torch.Tensor:
    """f32 value of every Posit(8, 2) code: ``posit_decode`` as a table."""
    return posit_decode(torch.arange(256, device=device), _POSIT8.N, _POSIT8.ES)


def _load(x, sl: slice) -> torch.Tensor:
    """Elements ``sl`` of a flattened moment in f32 (``dequantize``)."""
    if isinstance(x, QuantizedTensor):
        vals = _posit8_values(x.codes.device)[x.codes.reshape(-1)[sl].long()]
        return vals * x.scale.reshape(())
    return x.reshape(-1)[sl]


def _stacked_axes(name: str) -> int:
    """The layer axes the reference stacks in front of leaf ``name``."""
    if name.startswith("blocks/dense/"):      # moe: (n_groups, moe_every - 1, ...)
        return 2
    return 1 if name.startswith(("blocks/", "enc_blocks/")) else 0


def _sq_norms(flat_g, flat_p, groups, shards) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad norm, param norm): the reference's sum runs over its stacked
    leaves (one term a group); on a grid each group's terms are summed over
    the ranks that hold the group's shards, one all-reduce a group of ranks."""
    f32 = torch.float32
    terms: Dict[Any, Any] = {}
    for idx in groups.values():
        key = None if shards is None else shards[idx[0]]
        g = sum(torch.sum(torch.square(flat_g[i].to(f32))) for i in idx)
        p = sum(torch.sum(torch.square(flat_p[i].to(f32))) for i in idx)
        tg, tp_ = terms.get(key, (0, 0))
        terms[key] = (tg + g, tp_ + p)
    gsq = psq = 0
    for key, (g, p) in terms.items():
        if key is not None and key.size > 1:
            g, p = key.all_reduce(torch.stack([g, p]))
        gsq, psq = gsq + g, psq + p
    return torch.sqrt(gsq), torch.sqrt(psq)


def apply_updates(params, grads, opt_state, ocfg: OptConfig, shards=None
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place. ``grads`` mirrors ``params`` (a tree or a
    list in ``tree_leaves`` order). ``shards`` (on a grid): for each leaf in
    ``tree_leaves`` order, the TPContext of the ranks its shards lie on.
    Returns (params, opt_state, metrics), the same objects, updated."""
    names_p = list(named_leaves(params))
    flat_g = tree_leaves(grads) if isinstance(grads, dict) else list(grads)
    flat_m = tree_leaves(opt_state["m"])
    flat_v = tree_leaves(opt_state["v"])
    groups: Dict[str, List[int]] = {}
    for i, (name, _) in enumerate(names_p):
        groups.setdefault(name, []).append(i)
    flat_p = [p for _, p in names_p]

    count = opt_state["count"] + 1
    lr = lr_schedule(count, ocfg)
    f32 = torch.float32
    gnorm, param_norm = _sq_norms(flat_g, flat_p, groups, shards)
    if ocfg.grad_clip > 0:
        clip = torch.clamp(ocfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        clip = torch.ones((), dtype=f32, device=gnorm.device)
    b1, b2 = ocfg.b1, ocfg.b2
    c1 = 1 - torch.pow(b1, count.to(f32))
    c2 = 1 - torch.pow(b2, count.to(f32))

    def moments(i, sl):
        g = flat_g[i].reshape(-1)[sl].to(f32) * clip
        mf = b1 * _load(flat_m[i], sl) + (1 - b1) * g
        vf = b2 * _load(flat_v[i], sl) + (1 - b2) * torch.square(g)
        return mf, vf

    def chunks(i):
        n = flat_p[i].numel()
        return [slice(j, min(j + CHUNK, n)) for j in range(0, n, CHUNK)]

    quant = ocfg.quant == "posit8"
    with torch.no_grad():
        for name, idx in groups.items():
            amax_m = amax_v = None
            for i in idx:
                p = flat_p[i]
                pf = p.view(-1)
                decay = ocfg.weight_decay and p.ndim + _stacked_axes(name) >= 2
                for sl in chunks(i):
                    mf, vf = moments(i, sl)
                    step = (mf / c1) / (torch.sqrt(vf / c2) + ocfg.eps)
                    if decay:
                        step = step + ocfg.weight_decay * pf[sl].to(f32)
                    pf[sl] = (pf[sl].to(f32) - lr * step).to(p.dtype)
                    if not quant:
                        flat_m[i].view(-1)[sl] = mf
                        flat_v[i].view(-1)[sl] = vf
                        continue
                    am, av = mf.abs().amax(), vf.abs().amax()
                    amax_m = am if amax_m is None else torch.maximum(amax_m, am)
                    amax_v = av if amax_v is None else torch.maximum(amax_v, av)
            if not quant:
                continue
            if shards is not None and shards[idx[0]].size > 1:
                amax_m, amax_v = shards[idx[0]].all_reduce(torch.stack([amax_m, amax_v]), "max")
            # the group's new scales, then its codes, from the same f32
            # moments recomputed (old codes are read before they are written)
            scale_m = compute_scale(amax_m.reshape(1), _POSIT8.scale_mode).reshape(())
            scale_v = compute_scale(amax_v.reshape(1), _POSIT8.scale_mode).reshape(())
            for i in idx:
                for sl in chunks(i):
                    mf, vf = moments(i, sl)
                    for qt, x, s in ((flat_m[i], mf, scale_m), (flat_v[i], vf, scale_v)):
                        qt.codes.view(-1)[sl] = posit_encode(
                            x / s, _POSIT8.N, _POSIT8.ES).to(qt.codes.dtype)
                flat_m[i].scale.copy_(scale_m.reshape(flat_m[i].scale.shape))
                flat_v[i].scale.copy_(scale_v.reshape(flat_v[i].scale.shape))
    opt_state["count"] = count
    metrics = {"lr": lr, "grad_norm": gnorm, "param_norm": param_norm}
    return params, opt_state, metrics
