"""Rank-side functions of the grid tests (``test_torch_train_grid*.py``,
``test_torch_compression.py`` and ``test_torch_serve_grid*.py``).

They run in the spawned processes of a ``launch.mesh.RankPool`` and import
torch and the port only (no JAX), so the ranks start in seconds. Each
returns numpy copies of what it made.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARCHS, RunConfig, smoke
from repro_torch.convert import rank_train_state_from_numpy, tensor_to_numpy
from repro_torch.core.quantizers import QuantizedTensor
from repro_torch.launch.train import make_train_step
from repro_torch.nn.models import build_model
from repro_torch.nn.sharding import TPContext
from repro_torch.optim import tree_map

F32 = dict(weight_dtype="f32", activation_dtype="f32")


def host(tree):
    """A state tree with numpy leaves (a QuantizedTensor of numpy arrays)."""
    def one(t):
        if isinstance(t, QuantizedTensor):
            return QuantizedTensor(tensor_to_numpy(t.codes), tensor_to_numpy(t.scale), t.spec)
        return tensor_to_numpy(t)
    return tree_map(one, tree)


def grid_model(grid, device, arch, run_kw, over=None):
    """The smoke ``arch`` (``over`` replacing config fields) at f32 on the
    grid."""
    cfg = smoke(ARCHS[arch])
    if over:
        cfg = dataclasses.replace(cfg, **over)
    return build_model(cfg, RunConfig(**F32, **run_kw), device=device, grid=grid)


def train_case(grid, device, case):
    """``case["batches"]`` steps of the port's train step on this rank from
    the reference's state ``case["init"]`` cut to the rank's shard. Returns
    {"metrics": each step's floats, "state": the rank's state (numpy),
    "probes": each step's ``probe`` (the pod branch's gradients before and
    after the compressed mean, numpy lists in ``tree_leaves`` order),
    "dropped": the assignments the rank's MoE layers dropped at capacity in
    the first step's forward}."""
    from repro_torch.nn import moe
    model = grid_model(grid, device, case["arch"], case["kw"], case.get("over"))
    state = rank_train_state_from_numpy(case["init"], model)
    step = make_train_step(model, grid)
    metrics, probes = [], []
    for s, b in enumerate(case["batches"]):
        probe = {}
        moe.DROPPED = [] if s == 0 else None
        try:
            state, met = step(state, b, probe=probe)
            if s == 0:
                # the backward's remat recompute repeats each call of the forward
                dropped = (sum(int(n) for n, _ in moe.DROPPED)
                           // (2 if model.rcfg.remat == "block" else 1))
        finally:
            moe.DROPPED = None
        metrics.append({k: float(v) for k, v in met.items()})
        probes.append({k: [g.numpy() for g in v] for k, v in probe.items()})
    return {"metrics": metrics, "state": host(state), "probes": probes, "dropped": dropped}


def grads_case(grid, device, case):
    """One forward and backward of the port's ``LM.loss`` on this rank's rows
    of ``case["batch"]`` (one microbatch), from the seed-0 state drawn on
    the grid (each rank its shard): (the loss, {leaf name: the rank's
    gradient block}, numpy), each name the leaf's reference path with its
    occurrence in ``named_leaves`` order ("blocks/ln1#1": the second
    layer's)."""
    from repro_torch.core.policy import named_leaves
    from repro_torch.launch.train import make_train_state, rank_microbatches, value_and_grad
    model = grid_model(grid, device, case["arch"], case["kw"], case.get("over"))
    params = make_train_state(model, 0)["params"]
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in case["batch"].items()}
    loss, grads = value_and_grad(model, params, rank_microbatches(model, batch, 1)[0])
    out, seen = {}, {}
    for (name, _), g in zip(named_leaves(params), grads):
        i = seen[name] = seen.get(name, -1) + 1
        out[f"{name}#{i}"] = g.numpy()
    return float(loss), out


def checkpoint_case(grid, device, case):
    """A grid's checkpoints: one step from ``case["init"]``, the state saved
    by every rank (``CheckpointManager.save(..., model=)``) under
    ``case["dir"]`` as step 1, a second step (the uninterrupted run); the
    checkpoint restored into a fresh state (``restore(..., model=)``) and
    its second step (the resumed run); and the reference's checkpoint
    under ``case["ref_dir"]`` restored onto the grid. Returns the rank's
    states (numpy): "saved", "restored", "uninterrupted", "resumed" and
    "from_reference", and the save's and restore's seconds."""
    import time
    from repro_torch.runtime import CheckpointManager
    model = grid_model(grid, device, case["arch"], case["kw"], case.get("over"))
    step = make_train_step(model, grid)
    first, second = case["batches"][:2]
    state, _ = step(rank_train_state_from_numpy(case["init"], model), first)
    manager = CheckpointManager(case["dir"], async_save=False)
    t0 = time.perf_counter()
    manager.save(1, state, model=model)
    out = {"save_s": time.perf_counter() - t0, "saved": host(state)}
    out["uninterrupted"] = host(step(state, second)[0])
    template = rank_train_state_from_numpy(case["init"], model)
    t0 = time.perf_counter()
    restored = manager.restore(template, 1, model=model)
    out["restore_s"] = time.perf_counter() - t0
    out["restored"] = host(restored)
    out["resumed"] = host(step(restored, second)[0])
    out["from_reference"] = host(CheckpointManager(case["ref_dir"]).restore(template,
                                                                             model=model))
    return out


def compressed_case(grid, device, xs, residuals, dims, names):
    """``runtime.compression.compressed_grad_transform`` over the pod axis:
    leaf i of pod p is ``xs[i][p]``, of which the rank holds its model block
    along ``dims[i]`` (the whole leaf where that is None); ``names`` as the
    function takes them. Returns (means, new residuals or None) of the
    rank's blocks, numpy."""
    from repro_torch.runtime.compression import compressed_grad_transform
    pod, model = grid.coords.get("pod", 0), grid.axis("model")

    def block(a, dim):
        t = torch.from_numpy(np.array(a[pod]))
        if dim is None or model.size == 1:
            return t
        n = t.shape[dim] // model.size
        return t.narrow(dim, model.rank * n, n).contiguous()

    grads = [block(x, d) for x, d in zip(xs, dims)]
    res = None if residuals is None else [block(r, d) for r, d in zip(residuals, dims)]
    shards = [model if d is not None else TPContext() for d in dims]
    means, new = compressed_grad_transform(grads, grid.axis("pod"), residuals=res,
                                           shards=shards, names=names)
    return ([m.numpy() for m in means], None if new is None else [r.numpy() for r in new])


def megatron_mlp(grid, device, w, x, probe):
    """A gated MLP whose wg/wu are column-sharded and wo row-sharded over
    model, between ``copy_in`` and ``reduce_out``: (the loss, the gradient of
    x, the rank's blocks of the weights' gradients), numpy."""
    from repro_torch.nn.layers import mlp_forward
    tp = grid.model
    n = w["wg"].shape[1] // tp.size
    cols = slice(tp.rank * n, (tp.rank + 1) * n)
    p = {"wg": torch.tensor(w["wg"][:, cols]), "wu": torch.tensor(w["wu"][:, cols]),
         "wo": torch.tensor(w["wo"][cols])}
    for t in p.values():
        t.requires_grad_()
    xt = torch.tensor(x, requires_grad=True)
    loss = (mlp_forward(p, xt, "silu", tp=tp) * torch.tensor(probe)).sum()
    loss.backward()
    return (loss.item(), xt.grad.numpy(), {k: t.grad.numpy() for k, t in p.items()})


def cost_case(grid, device, arch, run_kw, batch):
    """``op_cost.count_step`` of one ``make_train_step`` on this rank (the
    smoke ``arch`` at its default bf16 weights, ``run_kw`` its RunConfig's
    other fields) from the seed-0 state drawn on the grid, on ``batch``
    (the whole batch, tensors): the StepCost's counts (flops, bytes, bytes
    on the wire by kind, collectives), as the dry run's fake world is held
    to them. The caches the step reads are put in a first step's state
    first, as the dry run puts them (``dryrun.prepare_host_tables``)."""
    from repro_torch.launch.dryrun import prepare_host_tables
    from repro_torch.launch.op_cost import count_step
    from repro_torch.launch.train import make_train_state
    model = build_model(smoke(ARCHS[arch]), RunConfig(**run_kw), device=device, grid=grid)
    state = make_train_state(model, 0)
    prepare_host_tables()
    cost = count_step(make_train_step(model, grid), state, batch)
    return {"flops": cost.flops_per_device, "bytes": cost.bytes_per_device,
            "wire_by_kind": cost.wire_by_kind, "n_collectives": cost.n_collectives,
            "wire": cost.wire_bytes_per_device}


def vocab_loss_case(grid, device, arch, run_kw, over, z_weight, ce_pass, batch,
                    upstream=None):
    """The grid's loss on this rank's rows of ``batch`` (one microbatch)
    from the seed-0 state at f32 (the smoke ``arch``, ``over`` replacing
    config fields): ``vocab_parallel_ce`` of the rank's vocab block of the
    logits where the model axis cuts the vocab (``ce_loss`` of the whole
    logits where it does not), as ``LM.loss`` takes it, with ``z_weight``
    (and, where ``ce_pass`` is given, ``nn.sharding.CE_PASS`` set to it).

    Without ``upstream``: {"loss", "model_loss" (``LM.loss``'s, z_weight
    0), "sharded", "grads" (every leaf's, ``tree_leaves`` order), "logits"
    (the rank's rows' whole logits), "labels", "loss_cost" and "plain_cost"
    (``op_cost.count_step`` of the forward and backward of ``LM.loss``, and
    of the same up to the logits block with a plain sum in the loss's
    place)}, numpy. With ``upstream`` (each rank's gradient of its whole
    logits, in rank order): the leaves' gradients of sum(whole logits *
    the rank's upstream), the whole logits gathered over model."""
    from repro_torch.nn import sharding
    saved = sharding.CE_PASS
    sharding.CE_PASS = ce_pass or saved
    try:
        return _vocab_loss(grid, device, arch, run_kw, over, z_weight, batch, upstream)
    finally:
        sharding.CE_PASS = saved


def _vocab_loss(grid, device, arch, run_kw, over, z_weight, batch, upstream):
    from repro_torch.launch.op_cost import count_step
    from repro_torch.launch.train import make_train_state, rank_microbatches, value_and_grad
    from repro_torch.nn.models import ce_loss
    from repro_torch.nn.sharding import gather_replicated, vocab_parallel_ce
    from repro_torch.optim import tree_leaves, tree_map
    model = grid_model(grid, device, arch, run_kw, over)
    params = make_train_state(model, 0)["params"]
    mb = rank_microbatches(model, batch, 1)[0]
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(live)
    p = tree_map(lambda _: next(it), params)

    def block_logits(p):
        x, sp = model._trunk(p, mb["tokens"], mb.get("frames"))
        return model._grid_block_logits(p, model._final_norm(p, x, sp), sp)

    logits, sharded = block_logits(p)
    whole = gather_replicated(logits, model.tp, logits.ndim - 1) if sharded else logits
    if upstream is not None:
        up = torch.from_numpy(upstream[grid.rank])
        grads = torch.autograd.grad((whole * up).sum(), live)
        return [g.numpy() for g in grads]
    if sharded:
        loss = vocab_parallel_ce(logits, mb["labels"], model.tp, z_weight=z_weight)
    else:
        loss = ce_loss(logits, mb["labels"], z_weight=z_weight)
    grads = torch.autograd.grad(loss, live)

    def plain(params):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        it = iter(leaves)
        logits, _ = block_logits(tree_map(lambda _: next(it), params))
        return torch.autograd.grad(logits.sum(), leaves)

    loss_cost = count_step(lambda prm: value_and_grad(model, prm, mb), params)
    plain_cost = count_step(plain, params)
    return {"loss": float(loss), "model_loss": float(model.loss(p, mb)[0]),
            "sharded": sharded, "grads": [g.numpy() for g in grads],
            "logits": whole.detach().numpy(), "labels": mb["labels"].numpy(),
            "loss_cost": dataclasses.asdict(loss_cost),
            "plain_cost": dataclasses.asdict(plain_cost)}


def serve_case(grid, device, case):
    """Serving on the grid: the smoke ``case["arch"]`` at f32 activations
    (the runs of ``torch_bridge.pair``), the reference's weights
    ``case["tree"]`` cut to the rank's shard (``rank_params_from_numpy``),
    with ``case["kv"]`` and ``case["use_kernel"]``: a prefill and
    ``case["steps"]`` greedy decode steps. Returns numpy: "logits", the
    prefill's and each step's (every row's); "caches", the rank's KV cache
    leaves after the prefill and after the steps; "stream", the greedy
    tokens (B, steps)."""
    from repro_torch.convert import rank_params_from_numpy
    cfg = smoke(ARCHS[case["arch"]])
    model = build_model(cfg, RunConfig(remat="none", activation_dtype="f32"), device=device,
                        grid=grid, kv_spec=case["kv"], use_kernel=case["use_kernel"])
    params = rank_params_from_numpy(case["tree"], model)
    tokens = torch.from_numpy(case["tokens"])
    kw = {}
    if case.get("frames") is not None:
        kw["frames"] = torch.from_numpy(case["frames"])
    if case.get("length") is not None:
        kw["length"] = torch.from_numpy(case["length"])
    enc = {"enc_len": case["enc_len"]} if case.get("enc_len") else {}

    def kv(cache):
        group = "shared_kv" if "shared_kv" in cache else "kv"
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in cache.get(group, {}).items()}

    cache = model.init_cache(tokens.shape[0], case["max_len"], **enc)
    cache, logits = model.prefill(params, tokens, cache=cache, **kw)
    out, caches, stream = [logits.numpy()], [kv(cache)], []
    for _ in range(case["steps"]):
        nxt = logits.argmax(-1)[:, None]
        stream.append(nxt[:, 0].numpy())
        cache, logits = model.decode_step(params, cache, nxt)
        out.append(logits.numpy())
    caches.append(kv(cache))
    return {"logits": out, "caches": caches, "stream": np.stack(stream, 1)}
