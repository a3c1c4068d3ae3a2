"""Serving tensor parallelism: the rules table, rank shards, the all-reduce.

Port of the serving part of ``repro/nn/sharding.py`` (DESIGN.md §9). The
reference runs its model inside ``shard_map`` over a 1-D ("tp",) mesh with
a ``manual_tp_ctx``; here each rank is an OS process of its own that holds
only its shard of every leaf, and ``TPContext`` takes the ctx's place:

* ``_tp_rules`` shards ONLY the Megatron axes whose row-sharded
  contraction has an explicit ``psum`` in the model code: attention heads
  (wq/wk/wv columns, wo rows via "mlp"), MLP hidden, experts, and the
  decode KV cache's head axis ("kv_heads_c"). Everything else (embed,
  unembed, norms, router, the mamba mixers) replicates, so the residual
  stream never shards and the host scheduler never sees the rank count.
* ``shard_policy_params`` cuts a rank's shard out of a parameter tree:
  codes split along their logical axis, a scale splits with its codes
  where it varies there and replicates where it has size 1
  (``core.policy.validate_scale_sharding``). An indivisible dim and an
  incongruent scale RAISE: a replicated leaf whose psum still fires would
  multiply its result by the rank count.
* ``TPContext.psum`` is ``torch.distributed.all_reduce`` over the ranks'
  group (the identity at tp = 1), called once after each row-sharded
  projection: attention's ``wo``, the MLP's down-projection and the MoE
  expert combine.

The decode caches are never sharded after the fact: each rank allocates
``n_kv_heads // tp`` heads of codes and static scales itself
(``LM.init_cache``, ``LM.init_paged_cache``), so of the reference's two
cache-logical trees the port keeps only the rule that the head axis
("kv_heads_c") shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.core.policy import layer_prefixes, validate_scale_sharding
from repro_torch.core.quantizers import QuantizedTensor

__all__ = ["TP_AXIS", "TPContext", "shard_leaf", "shard_policy_params",
           "check_tp_shapes", "map_with_logical"]

TP_AXIS = "tp"


def _tp_rules() -> dict:
    """Megatron-style serving TP over the ("tp",) axis: attention heads,
    MLP hidden (also attention wo's row dim), experts and the decode
    cache's head axis."""
    tp = (TP_AXIS,)
    return {
        "heads": tp,
        "kv_heads": tp,
        "mlp": tp,                  # MLP hidden AND attention wo's row dim
        "experts": tp,
        "kv_heads_c": tp,           # decode-cache (B, G, S, Dh) head axis
    }


@dataclasses.dataclass(frozen=True)
class TPContext:
    """One rank's view of the tensor-parallel group: its ``rank`` of
    ``size``, the process ``group`` that the all-reduces run over, and
    ``host_group``, a gloo group for host-side agreement checks (the same
    group when the backend is gloo). ``TPContext()`` is tp = 1."""
    rank: int = 0
    size: int = 1
    group: Any = None
    host_group: Any = None
    backend: str = "none"

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum partial results over the ranks (the identity at tp = 1).

        Called exactly where a contraction dim was sharded by
        ``shard_policy_params``: attention wo, the MLP down-projection and
        the MoE expert combine. Every rank gets the same bits."""
        if self.size == 1:
            return x
        x = x.contiguous()
        torch.distributed.all_reduce(x, group=self.group)
        return x

    def check_equal(self, what: str, value) -> None:
        """Raise on every rank unless every rank holds the same ``value``
        (a numpy array or a picklable object) as rank 0: a rank whose
        streams part from rank 0's is an error, never a hang (the group's
        timeout ends a rank that stops calling)."""
        if self.size == 1:
            return
        got = [None] * self.size
        torch.distributed.all_gather_object(got, value, group=self.host_group)
        bad = [r for r in range(1, self.size) if not _same(got[r], got[0])]
        if bad:
            raise RuntimeError(
                f"tensor-parallel ranks {bad} diverged from rank 0 in {what}: "
                f"rank 0 {got[0]!r}, rank {bad[0]} {got[bad[0]]!r}")


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.shape == b.shape and bool((a == b).all()))
    return a == b


def _strict_spec(ctx: TPContext, logical, shape, name: str) -> Tuple:
    """The mesh axis (or None) each dim of ``shape`` shards along.
    Indivisibility is an error, not a replication fallback: the psum's
    correctness depends on the named dims being sharded."""
    if ctx.size == 1:
        return (None,) * len(shape)
    out = []
    for axname, dim in zip(logical, shape):
        axes = _tp_rules().get(axname) if axname else None
        if not axes:
            out.append(None)
            continue
        prod = ctx.size
        if dim % prod != 0:
            raise ValueError(
                f"cannot tensor-parallel {name!r}: the {'x'.join(axes)} "
                f"mesh axis ({prod} devices) does not divide dim "
                f"{axname!r} of size {dim}; pick a tp that divides it")
        out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out) + (None,) * (len(shape) - len(out))


def _slice(t: torch.Tensor, spec, ctx: TPContext) -> torch.Tensor:
    """Rank ``ctx.rank``'s contiguous block along every sharded dim, as a
    copy (so the full leaf's storage can go)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = t.shape[dim] // ctx.size
            t = t.narrow(dim, ctx.rank * n, n)
    return t.clone() if any(a is not None for a in spec) else t


def shard_leaf(leaf, logical, ctx: TPContext, name: str):
    """Rank ``ctx.rank``'s shard of one leaf (a tensor or a QuantizedTensor)
    whose dims are named by ``logical``."""
    if ctx.size == 1:
        return leaf
    shape = tuple(leaf.codes.shape if isinstance(leaf, QuantizedTensor) else leaf.shape)
    ax = tuple(logical) + (None,) * (len(shape) - len(logical))
    spec = _strict_spec(ctx, ax, shape, name)
    if not isinstance(leaf, QuantizedTensor):
        return _slice(leaf, spec, ctx)
    scale_spec = validate_scale_sharding(name, shape, tuple(leaf.scale.shape), spec)
    return QuantizedTensor(_slice(leaf.codes, spec, ctx),
                           _slice(leaf.scale, scale_spec, ctx), leaf.spec)


def map_with_logical(fn, params, logical, prefix: str = ""):
    """``fn(name, leaf, logical axes)`` over a tree's leaves in the
    reference's flatten order (dict keys sorted; the per-layer ``blocks``
    list under its stacked paths), rebuilt in the tree's structure."""
    if isinstance(params, dict):
        return {k: map_with_logical(fn, params[k], logical[k], f"{prefix}{k}/")
                for k in sorted(params)}
    if isinstance(params, list):
        return [map_with_logical(fn, p, ax, path) for p, ax, path
                in zip(params, logical, layer_prefixes(params, prefix))]
    return fn(prefix.rstrip("/"), params, logical)


def check_tp_shapes(shapes, logical, ctx: TPContext) -> None:
    """Raise the reference's error for the first leaf (in its flatten order)
    of a tree of shapes that ``ctx`` cannot shard."""
    map_with_logical(lambda name, shape, ax: _strict_spec(
        ctx, tuple(ax) + (None,) * (len(shape) - len(ax)), shape, name), shapes, logical)


def shard_policy_params(params, logical, ctx: TPContext):
    """Rank ``ctx.rank``'s shard of a (possibly policy-quantized) parameter
    tree whose dims ``logical`` names (``LM.logical()``): a new tree of the
    same structure. Raises, in the reference's order, where a dim does not
    divide or a scale is incongruent with its sharded codes."""
    if ctx.size == 1:
        return params
    return map_with_logical(lambda name, leaf, ax: shard_leaf(leaf, ax, ctx, name),
                            params, logical)

