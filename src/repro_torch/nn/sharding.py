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

Training runs over a (pod, data, model) process grid (``GridContext``,
made by ``launch.mesh.make_host_mesh``), one OS process a rank:

* ``train_rules`` is ``make_ctx``'s table word for word: batch over (pod,
  data), ``p_embed`` over data (FSDP); heads, kv_heads, mlp, experts, vocab
  and the mamba channel names (d_inner, d_inner2, d_inner_r, heads_r) over
  model; under ``sequence_parallel`` "seq" (the residual stream's sequence
  dim) over model too. ``GridContext.spec`` is the reference's lenient
  ``ShardingCtx.spec``: a dim that its mesh axes do not divide replicates,
  and a mesh axis shards one dim of a leaf at most. ``GridContext.shard``
  cuts a rank's block along every named axis (a dim over several axes
  indexes them row-major, as a mesh does), and ``unshard`` puts every
  rank's blocks back together.
* Each leaf is placed on its own: the model code reads from a leaf's
  shape whether the model axis cuts it (``placed``), never from the family.
  A tensor between two steps of a block is either the rank's block or
  whole on every model rank; a whole one carries its whole gradient on
  every rank, so a leaf that replicates gets its whole gradient on every
  rank and is never summed over model. Four functions pass between the
  two: ``TPContext.copy_in`` (Megatron's f: the identity forward, an
  all-reduce backward; where a column-sharded product, or any use of the
  rank's block, reads a whole tensor), ``take_block`` (the rank's block of
  a whole tensor; backward, the blocks' gradients gathered whole),
  ``TPContext.reduce_out`` (g: an all-reduce forward, the identity
  backward; after a row-sharded product) and ``gather_replicated`` (the
  ranks' blocks gathered whole; backward, the rank's slice). Without a
  gradient, ``reduce_out`` is ``psum``, so serving keeps its bits.
* ``fsdp_gather``: an all-gather of a leaf's shards along its data-sharded
  dim, whose backward is the reduce-scatter (the sum of every data rank's
  gradient, cut to the rank's block).
* ``vocab_parallel_ce``: the reference's cross-entropy on logits cut over
  the vocab, as GSPMD lowers its ``ce_loss`` on vocab-sharded logits: each
  rank's partial max, sum of exponentials and label logit, all-reduced
  over model; no rank gathers the logits.
* Megatron's sequence parallelism (``sequence_parallel`` on a model axis
  that divides the sequence): between blocks the residual stream is the
  rank's block along seq (dim 1), and the norms on it run on that block
  (their weights read through ``copy_in``: each rank's tokens give a
  partial gradient). ``gather_seq`` (an all-gather along seq; backward, the
  reduce-scatter) takes ``copy_in``'s place before a column-sharded
  product, ``scatter_seq`` (a reduce-scatter along seq; backward, the
  all-gather) ``reduce_out``'s after a row-sharded one. A product whose leaf
  the model axis does not cut reads the whole sequence through
  ``gather_replicated`` and hands its output back through ``take_block``,
  both along seq, so its gradient stays whole on every rank.

Serving runs on the same grid and rules (``LM.init``, ``init_cache``,
``prefill`` and ``decode_step`` of a model built with ``grid=``), without
a gradient and without sequence parallelism:

* a quantized leaf keeps its codes cut like the parameter and its scale
  whole, as the reference places them; ``gather_quantized`` is its FSDP
  gather (the codes' bytes over data) and cuts the scale to the columns of
  the rank's codes, so each product reads its own block of the scale;
* the decode cache's batch is over (pod, data) (``GridContext.rows``) and
  its sequence over model ("kv_seq"; its heads whole): rank r of M holds
  positions [r S/M, (r + 1) S/M). Each rank attends every head over its
  block and ``combine_partials`` merges the blocks' softmaxes across the
  model group from their log-sum-exps (the flash-decoding pattern the
  reference's GSPMD makes of the same rule), so no rank ever gathers the
  cache.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.policy import layer_prefixes, validate_scale_sharding
from repro_torch.core.quantizers import QuantizedTensor

__all__ = ["TP_AXIS", "GRID_AXES", "TPContext", "GridContext", "train_rules",
           "set_collective_hook", "fsdp_gather", "gather_quantized", "combine_partials",
           "merge_partials", "vocab_parallel_ce",
           "gather_replicated", "take_block", "gather_seq", "scatter_seq",
           "seq_in", "seq_out", "placed", "shard_leaf", "shard_policy_params",
           "check_tp_shapes", "map_with_logical"]

TP_AXIS = "tp"
GRID_AXES = ("pod", "data", "model")

# hook(kind, result, tp): a context manager around each collective of a
# TPContext, if set (``launch.op_cost.count_step`` counts a step's bytes on
# the wire with it, and takes the collective as one op: what the backend
# dispatches inside it, gloo's copies on the CPU, is the backend's own)
_collective_hook = None


def set_collective_hook(hook):
    """Install ``hook`` (or None) for every TPContext collective; returns the
    hook it replaces."""
    global _collective_hook
    prev, _collective_hook = _collective_hook, hook
    return prev


def _counted(kind: str, out: torch.Tensor, tp):
    """The hook's context around one collective of ``kind`` whose result is
    ``out`` (none without a hook)."""
    if _collective_hook is None:
        return contextlib.nullcontext()
    return _collective_hook(kind, out, tp)


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
    group when the backend is gloo). ``host_checks`` False turns those
    checks off: the dry run's fake world (backend "fake") has no peers to
    exchange objects with, so ``check_equal`` checks nothing and
    ``gather_objects`` raises. ``TPContext()`` is tp = 1."""
    rank: int = 0
    size: int = 1
    group: Any = None
    host_group: Any = None
    backend: str = "none"
    host_checks: bool = True

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum partial results over the ranks (the identity at tp = 1).

        Called exactly where a contraction dim was sharded by
        ``shard_policy_params``: attention wo, the MLP down-projection and
        the MoE expert combine. Every rank gets the same bits."""
        if self.size == 1:
            return x
        x = x.contiguous()
        with _counted("all-reduce", x, self):
            torch.distributed.all_reduce(x, group=self.group)
        return x

    def host(self) -> "TPContext":
        """The same ranks over their gloo group, for CPU tensors."""
        if self.size == 1:
            return self
        return dataclasses.replace(self, group=self.host_group, backend="gloo")

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: ``x`` summed (or its elementwise "max") over the
        ranks."""
        y = x.clone(memory_format=torch.contiguous_format)
        if self.size > 1:
            red = torch.distributed.ReduceOp.MAX if op == "max" else torch.distributed.ReduceOp.SUM
            with _counted("all-reduce", y, self):
                torch.distributed.all_reduce(y, op=red, group=self.group)
        return y

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return x
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((self.size * src.shape[0], *src.shape[1:]))
        with _counted("all-gather", out, self):
            torch.distributed.all_gather_into_tensor(out, src, group=self.group)
        return out.movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """``x`` summed over the ranks, and of the sum the rank's block along
        ``dim`` (``dim`` splits into ``size`` equal blocks)."""
        if self.size == 1:
            return x
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // self.size, *src.shape[1:]))
        with _counted("reduce-scatter", out, self):
            torch.distributed.reduce_scatter_tensor(out, src, group=self.group)
        return out.movedim(0, dim)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f: ``x`` as it is, whose gradient is all-reduced over
        the ranks (each rank's projections give a partial one). The
        identity at tp = 1 and without a gradient."""
        if self.size == 1 or not (torch.is_grad_enabled() and x.requires_grad):
            return x
        return _CopyIn.apply(x, self)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's g: the sum of the ranks' partial ``x``, whose gradient
        passes through as it is. Without a gradient it is ``psum``."""
        if self.size == 1:
            return x
        if not (torch.is_grad_enabled() and x.requires_grad):
            return self.psum(x)
        return _ReduceOut.apply(x, self)

    def gather_objects(self, value):
        """Every rank's ``value`` (picklable) in rank order on rank 0, None
        on the others, over the host group."""
        if self.size == 1:
            return [value]
        if not self.host_checks:
            raise RuntimeError("gather_objects: this group's host checks are off "
                               f"(backend {self.backend!r}: no peers to gather from)")
        out = [None] * self.size if self.rank == 0 else None
        dst = torch.distributed.get_global_rank(self.host_group, 0)
        torch.distributed.gather_object(value, out, dst=dst, group=self.host_group)
        return out

    def check_equal(self, what: str, value) -> None:
        """Raise on every rank unless every rank holds the same ``value``
        (a numpy array or a picklable object) as rank 0: a rank whose
        streams part from rank 0's is an error, never a hang (the group's
        timeout ends a rank that stops calling). Nothing is checked where
        ``host_checks`` is off."""
        if self.size == 1 or not self.host_checks:
            return
        got = [None] * self.size
        torch.distributed.all_gather_object(got, value, group=self.host_group)
        bad = [r for r in range(1, self.size) if not _same(got[r], got[0])]
        if bad:
            raise RuntimeError(
                f"tensor-parallel ranks {bad} diverged from rank 0 in {what}: "
                f"rank 0 {got[0]!r}, rank {bad[0]} {got[bad[0]]!r}")


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; backward: the reduce-scatter (``scatter``)
    or the rank's slice of a gradient every rank holds whole."""

    @staticmethod
    def forward(ctx, x, tp, dim, scatter):
        ctx.tp, ctx.dim, ctx.scatter, ctx.n = tp, dim, scatter, x.shape[dim]
        return tp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        tp, dim = ctx.tp, ctx.dim
        if ctx.scatter:
            return tp.reduce_scatter(g, dim), None, None, None
        return g.narrow(dim, tp.rank * ctx.n, ctx.n), None, None, None


def fsdp_gather(x: torch.Tensor, tp: TPContext, dim: int) -> torch.Tensor:
    """A leaf whole along ``dim`` from the data ranks' shards; the gradient
    of the gathered leaf is summed over the data ranks and cut back to the
    rank's shard (FSDP's reduce-scatter)."""
    if tp.size == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return tp.all_gather(x, dim)
    return _Gather.apply(x, tp, dim, True)


def gather_quantized(w: QuantizedTensor, spec, grid: "GridContext") -> QuantizedTensor:
    """A served leaf's codes whole along their data-sharded dims (FSDP's
    all-gather, of the code bytes), with the scale cut to the rank's block
    along each dim that the model axis cuts and the scale varies along (a
    column-sharded product reads the scale columns of its own codes). The
    scale is kept whole on every rank; a dim where it has size 1 needs no
    cut. No gradient: serving only."""
    codes, scale = w.codes, w.scale
    data = grid.axis("data")
    for dim, axes in enumerate(spec):
        if axes == "data" and data.size > 1:
            codes = data.all_gather(codes, dim)
        elif axes is not None and axes != "data" and scale.shape[dim] != 1:
            idx, n = grid._block(axes)
            m = scale.shape[dim] // n
            scale = scale.narrow(dim, idx * m, m)
    return QuantizedTensor(codes, scale, w.spec)


def combine_partials(out: torch.Tensor, lse: torch.Tensor,
                     tp: Optional[TPContext]) -> torch.Tensor:
    """The attention of rows over a cache whose positions are cut in blocks
    over ``tp``'s ranks, from each rank's attention over its own block:
    ``out`` (..., Dh) normalized over the block and ``lse`` (...) each
    row's log-sum-exp of its masked scores there. One all-gather brings
    every rank's (out, lse), which ``merge_partials`` merges; every rank
    gets the same bits. Returns f32; ``out`` as it is (in f32) off a model
    group."""
    out = out.to(torch.float32)
    if tp is None or tp.size == 1:
        return out
    both = tp.all_gather(torch.cat([out, lse.to(torch.float32)[..., None]], -1)[None], 0)
    return merge_partials(both[..., :-1], both[..., -1])


def merge_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """sum_r exp(lse_r - max) out_r / sum_r exp(lse_r - max) over the
    blocks of dim 0 (``outs`` (M, ..., Dh), ``lses`` (M, ...)), in block
    order, in f32. A block with no valid position (out 0, lse -inf:
    ``kv_flash_decode``'s and its plain form's) weighs exactly 0 beside one
    that has: every row sees at least its own token."""
    outs, lses = outs.to(torch.float32), lses.to(torch.float32)
    mx = lses.amax(0)
    num = torch.zeros_like(outs[0])
    den = torch.zeros_like(mx)
    for r in range(outs.shape[0]):
        w = torch.exp(lses[r] - mx)
        num = num + w[..., None] * outs[r]
        den = den + w
    return num / den[..., None]


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, tp: TPContext, *,
                      z_weight: float = 0.0) -> torch.Tensor:
    """The reference's ``ce_loss`` of logits whose last dim is cut in equal
    blocks over ``tp``'s ranks: ``logits`` (..., V / size) is the rank's
    block (vocab ids [rank * V / size, (rank + 1) * V / size)), ``labels``
    (...) the whole labels. Each reduction over V is the rank's partial
    over its block, in f32, combined by one all-reduce over the ranks (the
    row max, MAX; the sum of the exponentials and the label's logit, SUM):
    three all-reduces of a float a row, no gather, in either direction.
    The max is out of the gradient, as the reference's stop-gradient;
    ``z_weight`` adds z_weight * mean(lse^2). Every rank gets the same
    loss."""
    return _VocabCE.apply(logits, labels, tp, float(z_weight))


# logits a pass of ``vocab_parallel_ce`` takes to f32 at once (256 MiB of
# f32 temporaries): the rank's rows run in passes of this many elements
CE_PASS = 1 << 26


def _row_passes(rows: int, n: int):
    step = max(CE_PASS // max(n, 1), 1)
    return [slice(i, min(i + step, rows)) for i in range(0, rows, step)]


class _VocabCE(torch.autograd.Function):
    """``vocab_parallel_ce``; backward: (softmax - onehot + 2 z_weight lse
    softmax) g / N on the rank's block, the softmax recomputed from the
    saved logits as exp(logit - max) / sum, the reference's derivative of
    its log-sum-exp (exp(logit - lse) would round each entry up to
    |lse| ulps apart). The f32 temporaries take the rows in passes of
    CE_PASS elements; each row's sums are the same in any pass."""

    @staticmethod
    def forward(ctx, logits, labels, tp, z_weight):
        n = logits.shape[-1]
        flat = logits.reshape(-1, n)
        local = labels.to(logits.device).long().reshape(-1) - tp.rank * n
        inside = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        picked = flat.gather(-1, local[:, None])[:, 0].to(torch.float32)
        ll = tp.all_reduce(torch.where(inside, picked, torch.zeros_like(picked)))
        m = tp.all_reduce(flat.amax(-1).to(torch.float32), "max")
        part = torch.empty_like(m)
        for rows in _row_passes(flat.shape[0], n):
            lg = flat[rows].to(torch.float32, copy=True)
            part[rows] = lg.sub_(m[rows, None]).exp_().sum(-1)
        total = tp.all_reduce(part)
        lse = torch.log(total) + m
        nll = (lse - ll).mean()
        if z_weight:
            nll = nll + z_weight * torch.square(lse).mean()
        ctx.save_for_backward(logits, local, inside, m, total, lse)
        ctx.z_weight = z_weight
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, local, inside, m, total, lse = ctx.saved_tensors
        n = logits.shape[-1]
        flat = logits.reshape(-1, n)
        scale = g.to(torch.float32) / lse.numel()
        # d nll / d lse per row, over the row's sum of exponentials
        g_lse = scale * (1 + 2 * ctx.z_weight * lse) if ctx.z_weight else scale.expand_as(lse)
        coef = g_lse / total
        label = -(inside.to(torch.float32) * scale)
        grad = torch.empty_like(flat)
        for rows in _row_passes(flat.shape[0], n):
            p = flat[rows].to(torch.float32, copy=True).sub_(m[rows, None]).exp_()
            p.mul_(coef[rows, None])
            p.scatter_add_(-1, local[rows, None], label[rows, None])
            grad[rows] = p
        return grad.view_as(logits), None, None, None


def gather_replicated(x: torch.Tensor, tp: TPContext, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim``, for a use that
    every rank then runs alike: the gradient is the rank's slice."""
    if tp.size == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return tp.all_gather(x, dim)
    return _Gather.apply(x, tp, dim, False)


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        n = x.shape[dim] // tp.size
        return x.narrow(dim, tp.rank * n, n)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_gather(g, ctx.dim), None, None


def take_block(x: torch.Tensor, tp: TPContext, dim: int) -> torch.Tensor:
    """The rank's block along ``dim`` of a tensor that every rank holds
    whole, for a use of that block alone: the gradient of the whole tensor
    is the ranks' blocks' gradients gathered (Megatron's scatter)."""
    if tp.size == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        n = x.shape[dim] // tp.size
        return x.narrow(dim, tp.rank * n, n)
    return _TakeBlock.apply(x, tp, dim)


def gather_seq(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """Megatron-SP's all-gather: the whole sequence (dim 1) from the ranks'
    blocks of the residual, for a column-sharded product. Its backward is
    the reduce-scatter: the ranks' partial gradients of the whole sequence
    summed, and the rank's block kept (``copy_in``'s sum, cut to the
    block)."""
    if tp.size == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return tp.all_gather(x, 1)
    return _Gather.apply(x, tp, 1, True)


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.reduce_scatter(x, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_gather(g, 1), None


def scatter_seq(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """Megatron-SP's reduce-scatter: the sum of the ranks' partial ``x``
    (after a row-sharded product), of which the rank keeps its block along
    seq (dim 1). Its backward is the all-gather of the blocks'
    gradients."""
    if tp.size == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return tp.reduce_scatter(x, 1)
    return _ScatterSeq.apply(x, tp)


def seq_in(x: torch.Tensor, sp, tp) -> torch.Tensor:
    """The input of a product under sequence parallelism (``sp``, the model
    axis where it cuts the residual along seq): the whole sequence, through
    ``gather_seq`` where ``tp`` cuts the product's leaf (its gradient is
    partial, summed by the reduce-scatter), else ``gather_replicated``.
    Without ``sp``, x through ``copy_in`` where ``tp`` cuts the leaf."""
    if sp is not None:
        return gather_seq(x, sp) if tp is not None else gather_replicated(x, sp, 1)
    return x if tp is None else tp.copy_in(x)


def seq_out(y: torch.Tensor, sp, tp) -> torch.Tensor:
    """The output of a product, back to the residual's layout: summed over
    the ranks where ``tp`` cut its contraction (``scatter_seq`` under
    ``sp``, else ``reduce_out``), and under ``sp`` the rank's block along
    seq of an output every rank holds whole (``take_block``)."""
    if sp is not None:
        return scatter_seq(y, sp) if tp is not None else take_block(y, sp, 1)
    return y if tp is None else tp.reduce_out(y)


def placed(tp: Optional[TPContext], local: int, full: int) -> Optional[TPContext]:
    """``tp`` where a leaf's dim of ``full`` entries holds ``local`` of them
    on this rank (the model axis cuts it: its products take Megatron's
    pair), None where the rank holds it whole (it replicates: its products
    take no collective)."""
    return tp if tp is not None and tp.size > 1 and local < full else None


# -- training over a (pod, data, model) grid ----------------------------------


def train_rules(axis_names, sequence_parallel: bool = False) -> dict:
    """The training rules of the reference's ``make_ctx`` for a mesh with
    ``axis_names``, ``fsdp`` on: under ``sequence_parallel`` the residual
    stream's "seq" dim shards over model (Megatron-SP)."""
    names = set(axis_names)
    batch = tuple(a for a in ("pod", "data") if a in names)
    data = ("data",) if "data" in names else ()
    model = ("model",) if "model" in names else ()
    return {
        # activations
        "batch": batch,
        "seq": model if sequence_parallel else (),
        "seq_attn": (),
        "embed": (),
        "heads": model,
        "kv_heads": model,
        "head_dim": (),
        "head_dim_tp": model,
        "mlp": model,
        "experts": model,
        "vocab": model,
        "kv_seq": model,
        "kv_heads_c": (),
        "expert_cap": (),
        "d_inner": model,
        "d_inner2": model,
        "d_inner_r": model,
        "heads_r": model,
        # params
        "p_embed": data,
        "p_unsharded": (),
        "layers": (),
        "state": (),
        "conv": (),
    }


@dataclasses.dataclass(frozen=True)
class GridContext:
    """One rank's view of a training grid: the reference's mesh ``shape``
    and ``axis_names`` ((data, model), or (pod, data, model) with more than
    one pod), this process's ``rank`` (row-major over the shape), and
    ``groups``: a TPContext for each set of axes that the training step
    reads (``launch.mesh.GRID_SETS``; keyed by its axes of more than one
    rank, in GRID_AXES order). Without groups it is the layout
    alone (one rank, or a shape that is only reported)."""
    shape: Tuple[int, ...] = (1, 1)
    axis_names: Tuple[str, ...] = ("data", "model")
    rank: int = 0
    groups: Optional[Dict[Tuple[str, ...], TPContext]] = None
    backend: str = "none"

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> Dict[str, int]:
        out, r = {}, self.rank
        for name, n in reversed(list(self.sizes.items())):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def axis(self, *names: str) -> TPContext:
        """The group over ``names`` (those of size 1 dropped): TPContext()
        when that is one rank; on a layout without groups, the rank's place
        in it with no process group."""
        key = tuple(a for a in GRID_AXES if a in names and self.sizes.get(a, 1) > 1)
        if not key:
            return TPContext()
        if self.groups is None:
            idx, n = self._block(key)
            return TPContext(rank=idx, size=n)
        if key not in self.groups:
            raise KeyError(f"the grid makes no group over {key} (launch.mesh.GRID_SETS)")
        return self.groups[key]

    @property
    def model(self) -> TPContext:
        """The model axis: the TPContext the model code takes."""
        return self.axis("model")

    @property
    def rules(self) -> dict:
        return train_rules(self.axis_names)

    def spec(self, logical, shape, rules=None) -> Tuple:
        """The reference's ``ShardingCtx.spec``: for each dim the mesh axis
        (a name, a tuple of names, or None) it shards over, by ``rules``
        (``self.rules`` by default). A dim that the product of its axes does
        not divide replicates; an axis already used by an earlier dim of the
        leaf is skipped."""
        sizes = self.sizes
        rules = self.rules if rules is None else rules
        used: set = set()
        out = []
        for name, dim in zip(tuple(logical) + (None,) * (len(shape) - len(logical)), shape):
            axes = rules.get(name) if name else None
            picked = [a for a in (axes or ()) if a not in used and a in sizes]
            if not picked or dim % math.prod(sizes[a] for a in picked):
                out.append(None)
                continue
            used.update(picked)
            out.append(tuple(picked) if len(picked) > 1 else picked[0])
        return tuple(out)

    def _block(self, axes) -> Tuple[int, int]:
        """(this rank's block index, the block count) along a dim sharded
        over ``axes`` (row-major over them)."""
        axes = (axes,) if isinstance(axes, str) else axes
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * self.sizes[a] + self.coords[a], n * self.sizes[a]
        return idx, n

    def shard(self, t: torch.Tensor, spec, copy: bool = True) -> torch.Tensor:
        """The rank's block of ``t`` along every sharded dim of ``spec``, as
        a copy (so the whole leaf can go), or with ``copy`` False as a view
        of ``t``."""
        if all(a is None for a in spec):
            return t
        for dim, axes in enumerate(spec):
            if axes is not None:
                idx, n = self._block(axes)
                m = t.shape[dim] // n
                t = t.narrow(dim, idx * m, m)
        return t.clone() if copy else t

    def local_shape(self, spec, shape) -> Tuple[int, ...]:
        """The shape of the rank's block of a leaf of ``shape`` cut by
        ``spec``."""
        out = []
        for axes, d in zip(tuple(spec) + (None,) * (len(shape) - len(spec)), shape):
            if axes is not None:
                d //= self._block(axes)[1]
            out.append(d)
        return tuple(out)

    def rows(self, n: int) -> Tuple[int, int]:
        """(first row, rows) of this rank's block of a batch of ``n`` rows:
        the "batch" rule's (pod, data) block, or every row where the
        product of those axes does not divide ``n`` (it replicates)."""
        axes = self.spec(("batch",), (n,))[0]
        if axes is None:
            return 0, n
        idx, k = self._block(axes)
        return idx * (n // k), n // k

    def batch_group(self, n: int) -> TPContext:
        """The ranks that hold the other blocks of a batch of ``n`` rows
        (``rows``): the group over its axes, TPContext() where it
        replicates."""
        axes = self.spec(("batch",), (n,))[0]
        if axes is None:
            return TPContext()
        return self.axis(*((axes,) if isinstance(axes, str) else axes))

    def shard_axes(self, spec) -> Tuple[str, ...]:
        """The grid axes a leaf of ``spec`` is sharded over."""
        out = set()
        for axes in spec:
            if axes is not None:
                out.update((axes,) if isinstance(axes, str) else axes)
        return tuple(a for a in GRID_AXES if a in out)

    def unshard(self, blocks, spec):
        """The whole leaf from every rank's block (``blocks[r]`` rank r's,
        numpy arrays or tensors): the inverse of ``shard``."""
        cat = np.concatenate if isinstance(blocks[0], np.ndarray) else torch.cat

        def build(dims, fixed):
            if not dims:
                r = 0
                for a in self.axis_names:
                    r = r * self.sizes[a] + fixed.get(a, 0)
                return blocks[r]
            dim, axes = dims[0]
            axes = (axes,) if isinstance(axes, str) else axes
            parts = []
            for combo in itertools.product(*(range(self.sizes[a]) for a in axes)):
                parts.append(build(dims[1:], {**fixed, **dict(zip(axes, combo))}))
            return cat(parts, dim)

        return build([(d, a) for d, a in enumerate(spec) if a is not None], {})


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

