"""Mixture-of-Experts: top-k router + sort-based capacity dispatch.

Port of ``repro/nn/moe.py`` (``moe_forward``, the shapes of ``moe_init``
and ``router_aux_loss``, which ``LM.loss`` does not add, as in the
reference):

  1. router logits in f32 (the router weight is never quantized) -> softmax
     -> top-k ids and renormalised gates;
  2. a stable sort of the T*k (token, expert) assignments by expert;
  3. the position of each within its expert by ``searchsorted``; those at
     or past the capacity C drop (C = T*k at decode, S == 1: drop-free);
  4. dispatch into a fixed (E_loc*C + 1, d) buffer (the rank's experts'
     rows) whose last row takes the dropped ones and the other ranks'
     -> per-expert batched products -> gather back.

The expert products run on every expert's dequantized weights in plain
PyTorch, as the reference computes them outside any Pallas kernel; the
shared experts go through ``mlp_forward`` and so through the kernels.

Every shape is fixed by (T, k, E, C): no ``nonzero``, no boolean-mask
indexing, no ``.item()``, so a step adds no host wait. The combine does not
scatter-add (float atomics on the card would change the sum order from run
to run): the sorted contributions are put back in (token, choice) order, a
permutation, and summed over the k choices. In the backward, the dropped
assignments' last row is cut off before the expert products and their
gathers are masked, so their gradient is zero; the permutation's backward
is a gather, with nothing to accumulate.

On a training grid the rank routes the rows it holds, as one block of the
rows of the batch that the reference routes whole (its GSPMD forward sees
the global batch, or under the compressed pod mean the pod's): the
capacity C comes from that batch's T, and an assignment's position within
its expert is its position in the stable sort over all the batch's T * k
assignments, in row order, i.e. the local one plus the assignments to the
same expert of the ranks ahead (an exclusive prefix sum of the ranks'
per-expert counts, all-gathered over the ``batch`` group). Each token's
expert output depends on its own row alone, so the rank computes its own
rows of its experts' block of the global (E, C, d) dispatch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import KernelSet
from .layers import (activation, is_gated, mlp_forward, mlp_logical, mlp_shapes,
                     param_value)
from .sharding import placed, seq_in, seq_out

__all__ = ["moe_shapes", "moe_logical", "moe_capacity", "moe_forward",
           "router_aux_loss", "DROPPED"]

# a measurement's hook: while a list is set here, every call appends (the
# assignments it dropped at capacity (a tensor), the assignments it routed)
DROPPED = None


def moe_shapes(cfg) -> dict:
    """Shapes of one MoE layer's matmul weights: "experts" {name: (E, in,
    out)} (each expert weight stacked over the experts) and, with shared
    experts, "shared" as ``mlp_shapes`` gives them. The router is (d, E)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    out = {"experts": {n: (E, i, o[0])
                       for n, (i, o) in mlp_shapes(d, ff, cfg.act).items()}}
    if cfg.n_shared_experts:
        out["shared"] = mlp_shapes(d, ff * cfg.n_shared_experts, cfg.act)
    return out


def moe_logical(cfg) -> dict:
    """Logical axes of one MoE layer's weights: experts split along E under
    tensor parallelism, the router replicates."""
    p = {"router": ("p_unsharded", "p_unsharded")}
    if is_gated(cfg.act):
        p.update(wg=("experts", "p_embed", None), wu=("experts", "p_embed", None),
                 wo=("experts", None, "p_embed"))
    else:
        p.update(wi=("experts", "p_embed", None), wo=("experts", None, "p_embed"))
    if cfg.n_shared_experts:
        p["shared"] = mlp_logical(cfg.act)
    return p


def moe_capacity(T: int, S: int, cfg) -> int:
    """Tokens each expert takes: drop-free T*k at decode (S == 1), else the
    capacity factor's share, rounded as Python rounds (half to even)."""
    k, E = cfg.top_k, cfg.n_experts
    return T * k if S == 1 else int(max(1, round(T * k * cfg.capacity_factor / E)))


def moe_forward(p: dict, x: torch.Tensor, cfg,
                kernels: Optional[KernelSet] = None, tp=None, batch=None,
                sp=None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).

    Under tensor parallelism (``tp``, where the model axis cuts the
    experts) the expert leaves hold the rank's E_loc = E / tp experts, from
    e0 = rank * E_loc. Routing and capacity run over the global expert ids
    on every rank; the rank dispatches into and computes only its experts'
    (E_loc, C, d) rows, combines as at tp = 1 (the other experts'
    contributions zero) and all-reduces the combine (``reduce_out``; in training x and the
    router are read through ``copy_in``, since the combine's gradient
    reaches the gates of the rank's experts alone). The shared experts add
    in after that all-reduce (``mlp_forward`` reduces their own
    down-projection). ``batch`` (a TPContext, training on a grid): the
    ranks that each hold one block of the routed batch's rows, in row
    order. ``sp`` (sequence parallelism): x is the rank's block along seq;
    the layer gathers the whole sequence first (``seq_in``), so it routes
    exactly the tokens it routes without ``sp``, and returns the rank's
    block (``seq_out``); the shared experts take their own pair."""
    B, d = x.shape[0], x.shape[-1]
    E, k = cfg.n_experts, cfg.top_k
    dev = x.device
    xt = x.reshape(-1, d)
    tp_e = placed(tp, p["wo"].shape[0], E)
    # the routed tokens: the rank's rows, under sp gathered whole along seq
    xr = seq_in(xt, None, tp_e) if sp is None else seq_in(x, sp, tp_e).reshape(-1, d)
    T = xr.shape[0]
    S = T // B
    router = p["router"] if tp_e is None else tp_e.copy_in(p["router"])
    # 1. route in f32 (a flipped choice changes a token's output entirely)
    logits = torch.matmul(xr.to(torch.float32), param_value(router, torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, topk_idx = torch.topk(probs, k, dim=-1)            # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # 2. sort assignments by expert
    flat_expert = topk_idx.reshape(-1)                             # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    # 3. position within expert (among the whole routed batch's), capacity
    n_rows = batch.size if batch is not None else 1
    C = moe_capacity(T * n_rows, S, cfg)
    starts = torch.searchsorted(sorted_expert, torch.arange(E, device=dev))
    pos = torch.arange(T * k, device=dev) - starts[sorted_expert]
    if n_rows > 1:
        counts = torch.diff(starts, append=starts.new_full((1,), T * k))
        ahead = batch.all_gather(counts[None], 0)[:batch.rank].sum(0)
        pos = pos + ahead[sorted_expert]
    keep = pos < C
    if DROPPED is not None:
        DROPPED.append(((~keep).sum(), T * k))
    # 4. dispatch -> the rank's experts' rows (E_loc, C, d) of the global
    # (E, C, d) layout; the dropped assignments and those to the other
    # ranks' experts land (as zeros) on row E_loc*C
    E_loc = p["wo"].shape[0]
    e0 = tp_e.rank * E_loc if tp_e is not None else 0
    mine = keep & (sorted_expert >= e0) & (sorted_expert < e0 + E_loc)
    slot = torch.where(mine, (sorted_expert - e0) * C + pos, torch.full_like(pos, E_loc * C))
    token_of = order // k
    disp = torch.zeros((E_loc * C + 1, d), dtype=x.dtype, device=dev)
    disp[slot] = xr[token_of] * mine[:, None].to(x.dtype)
    disp_e = disp[:-1].reshape(E_loc, C, d)
    # 5. expert FFNs, batched over the rank's experts
    fn = activation(cfg.act)
    if is_gated(cfg.act):
        h = fn(torch.bmm(disp_e, param_value(p["wg"], x.dtype))) \
            * torch.bmm(disp_e, param_value(p["wu"], x.dtype))
    else:
        h = fn(torch.bmm(disp_e, param_value(p["wi"], x.dtype)))
    out_flat = torch.bmm(h, param_value(p["wo"], x.dtype)).reshape(E_loc * C, d)
    # 6. gather back, weight, and combine in (token, choice) order; the other
    # ranks' experts' contributions stay zero, and the all-reduce below sums
    # the disjoint partials into the full mixture
    gathered = torch.where(mine[:, None], out_flat[slot.clamp(0, E_loc * C - 1)],
                           torch.zeros((), dtype=out_flat.dtype, device=dev))
    gates_sorted = gate_vals.reshape(-1)[order]
    contrib = gathered * gates_sorted[:, None].to(x.dtype)
    unsorted = torch.empty_like(contrib)
    unsorted[order] = contrib
    # the MoE block's one expert-combine collective
    y = seq_out(unsorted.reshape(T, k, d).sum(dim=1).reshape(B, S, d), sp, tp_e)
    if cfg.n_shared_experts:
        tp_s = placed(tp, p["shared"]["wo"].shape[0], cfg.d_ff * cfg.n_shared_experts)
        # under sp the shared experts gather the sequence themselves
        shared = mlp_forward(p["shared"], xt if sp is None else x, cfg.act,
                             kernels=kernels, tp=tp_s, sp=sp)
        y = y + shared.reshape(y.shape)
    return y


def router_aux_loss(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style load-balancing loss, E * sum_e f_e P_e: f_e the share
    of the top-k choices that go to expert e, P_e its mean router
    probability, over the B * S tokens of x (B, S, d)."""
    T = x.shape[0] * x.shape[1]
    E = cfg.n_experts
    logits = torch.matmul(x.reshape(T, -1).to(torch.float32),
                          param_value(p["router"], torch.float32))
    probs = torch.softmax(logits, dim=-1)
    topk_idx = torch.topk(probs, cfg.top_k, dim=-1).indices
    frac = F.one_hot(topk_idx, E).to(torch.float32).mean(dim=(0, 1))
    return E * torch.sum(frac * probs.mean(0))
