"""Test-side helpers of the training-grid tests (``test_torch_train_grid*.py``):
the reference's trajectories that a grid is held to, the port's grid runs
through a ``RankPool``, and the checks of the posit8-compressed pod branch.

Each reference trajectory is composed of the reference's own functions,
each jitted once a process: its ``grads_plain`` (``value_and_grad`` of
``model.loss``, or its microbatch scan with f32 accumulators) and
``optim.apply_updates`` on the whole batch (the tp = 1 step of
``make_train_step``, whose single jit the port's tp = 1 step is held to in
the ``test_torch_train_steps_*.py`` files); under ``grad_compression``
"posit8*" its pod branch, the 2 pods under ``jax.vmap(axis_name="pod")``:
each pod's ``grads_plain``, ``runtime.compression.compressed_grad_transform``
over "pod" and the loss's pod mean, then ``apply_updates`` (the
reference's own shard_map path needs a process with several XLA devices,
which the suite does not use). A model is named by its arch and ``over``,
(field, value) pairs replacing fields of the smoke config.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_bridge import (assert_steps_match, reference_state, step_batches, step_kw,
                          to_numpy_tree, train_models, walk)
from repro_torch.configs import ARCHS, RunConfig, smoke
from repro_torch.convert import gather_train_state, params_from_numpy, params_to_numpy
from repro_torch.launch.mesh import grid_layout
from repro_torch.nn.models import build_model
from repro_torch.nn.sharding import GridContext
from repro_torch.optim import tree_leaves, tree_map


def layout(grid):
    """The grid's layout (rank 0's view, no process group)."""
    return GridContext(*grid_layout(*grid))


def layout_model(arch, grid, over=(), **run_kw):
    cfg = dataclasses.replace(smoke(ARCHS[arch]), **dict(over))
    return build_model(cfg, RunConfig(weight_dtype="f32", activation_dtype="f32", **run_kw),
                       device="cpu", grid=layout(grid))


def run_grid(pool, arch, grid, kw, ref, over=()):
    """The three steps on the grid's ranks from ``ref``'s initial state and
    batches: (the rank 0 metrics, the gathered state as the reference's
    numpy tree, the ranks' results)."""
    case = {"arch": arch, "kw": kw, "init": ref["init"], "batches": ref["batches"],
            "over": dict(over)}
    from grid_ranks import train_case
    res = pool.run(train_case, case, grid=grid)
    for r, got in enumerate(res[1:], 1):
        assert got["metrics"] == res[0]["metrics"], f"rank {r}'s metrics part from rank 0's"
    state = gather_train_state([r["state"] for r in res], layout_model(arch, grid, over, **kw))
    return res[0]["metrics"], state, res


def three_steps(pool, arch, grid, quant, micro, over=(), frames=False, run_kw=None,
                **bounds):
    """The three steps on ``grid`` against the reference's tp = 1 step, held
    by ``assert_steps_match`` (``bounds``: its exemptions; ``wild`` only
    with posit8 moments, against the parameters before the first step).
    ``run_kw``: more RunConfig fields of the port's run (``sequence_
    parallel``). Returns the ranks' results."""
    ref = reference(arch, "none", quant, micro, over, frames)
    tmet, got, res = run_grid(pool, arch, grid, step_kw(quant, micro, **(run_kw or {})),
                              ref, over)
    wild = bounds.pop("wild", None)
    assert_steps_match(quant, ref["jmet"], tmet, ref["m1"], ref["before"], ref["want"], got,
                       wild=wild if quant == "posit8" else None,
                       first=ref["init"]["params"], **bounds)
    return res


def check_init_gathers_back(arch, grid, over=()):
    """``LM.init`` (``make_train_state``, posit8 moments) on each rank of
    the grid's layout draws every whole leaf and keeps its block: the
    blocks gather back to the tp = 1 state bit for bit, and a rank's state
    is smaller than the whole."""
    from repro_torch.launch.train import make_train_state
    lay = layout_model(arch, grid, over, opt_state_quant="posit8")
    cfg, rcfg = lay.cfg, lay.rcfg
    states = [make_train_state(build_model(cfg, rcfg, device="cpu", grid=GridContext(
        lay.grid.shape, lay.grid.axis_names, rank=r)), 0) for r in range(lay.grid.size)]
    want = params_to_numpy(make_train_state(build_model(cfg, rcfg, device="cpu"), 0))
    leaves = list(walk(want, gather_train_state(states, lay)))
    for path, a, b in leaves:
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    size = sum(t.numel() for t in tree_leaves(states[0]["params"]))
    assert size < sum(a.size for p, a, _ in leaves if p.startswith("/params/"))


def partitioned_ce(logits, labels, blocks):
    """The reference's ``ce_loss`` (``repro/nn/models.py``) with each of its
    reductions over the vocab taken as ``blocks`` equal blocks' partials
    combined in block order (the max, the sum of the exponentials and the
    label's logit): what GSPMD lowers ``ce_loss`` on logits sharded over
    ``blocks`` devices to, and the order in which a grid whose model axis
    cuts the vocab sums (``nn.sharding.vocab_parallel_ce``;
    ``tests/sum_order_drift.py --loss-order`` measures the reference's
    trajectory under it)."""
    lg = logits.astype(jnp.float32)
    parts = jnp.split(lg, blocks, axis=-1)
    m = jax.lax.stop_gradient(functools.reduce(jnp.maximum, [jnp.max(p, axis=-1)
                                                             for p in parts]))
    s = functools.reduce(jnp.add, [jnp.sum(jnp.exp(p - m[..., None]), axis=-1) for p in parts])
    lse = jnp.log(s) + m
    onehot = jax.nn.one_hot(labels, lg.shape[-1], dtype=lg.dtype)
    return jnp.mean(lse - jnp.sum(lg * onehot, axis=-1))


@functools.lru_cache(maxsize=None)
def _grads_fn(arch, over, micro, pods, blocks=1):
    """The reference's ``grads_plain``, jitted; with ``pods`` each pod's
    under ``vmap(axis_name="pod")``, the loss pmean'd over "pod". With
    ``blocks`` > 1 its loss is ``jm.forward`` and ``partitioned_ce``."""
    jm, _ = train_models(arch, over, **step_kw("none", micro))
    n_micro = max(micro, 1)

    def loss_fn(params, batch):
        if blocks > 1:
            logits = jm.forward(params, batch["tokens"], frames=batch.get("frames"))
            return partitioned_ce(logits, batch["labels"], blocks)
        return jm.loss(params, batch)[0]

    def grads_plain(params, batch):
        if n_micro == 1:
            loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        else:
            b = batch["tokens"].shape[0] // n_micro
            mbs = jax.tree.map(lambda x: x.reshape(n_micro, b, *x.shape[1:]), batch)

            def step(acc, mb):
                loss, g = jax.value_and_grad(loss_fn)(params, mb)
                return jax.tree.map(lambda a, gg: a + gg.astype(jnp.float32) / n_micro,
                                    acc, g), loss

            zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
            grads, losses = jax.lax.scan(step, zeros, mbs)
            loss = jnp.mean(losses)
        return (jax.lax.pmean(loss, "pod") if pods else loss), grads

    if not pods:
        return jax.jit(grads_plain)
    return jax.jit(jax.vmap(grads_plain, in_axes=(None, 0), axis_name="pod"))


@functools.lru_cache(maxsize=None)
def compress_fn(use_ef):
    """The reference's ``compressed_grad_transform`` over "pod" under vmap
    (posit8_ef: with each pod's residuals); jitted."""
    from repro.runtime.compression import compressed_grad_transform

    def per_pod(grads, ef):
        return compressed_grad_transform(grads, "pod", N=8, ES=2,
                                         residuals=ef if use_ef else None)

    return jax.jit(jax.vmap(per_pod, axis_name="pod"))


@functools.lru_cache(maxsize=None)
def _update_fn(arch, over, quant):
    from repro.launch.train import opt_config_from_run
    from repro.optim import apply_updates
    ocfg = opt_config_from_run(train_models(arch, over, **step_kw(quant, 0))[0].rcfg)
    return jax.jit(lambda p, g, o: apply_updates(p, g, o, ocfg))


@functools.lru_cache(maxsize=None)
def reference(arch, comp, quant, micro, over=(), frames=False, steps=3, B=4, S=32, blocks=1):
    """The reference's trajectory (the module docstring's composition;
    ``comp`` "none": the tp = 1 step) from its seed-0 ``make_train_state``,
    on ``torch_bridge.step_batches``; ``blocks`` > 1: its loss summed in the
    partitioned order of ``blocks`` vocab blocks (``partitioned_ce``).
    Returns the fields of
    ``torch_bridge.reference_steps`` (with posit8 moments also "opt_steps":
    the optimizer state after each step), and for the pods "pod_grads1": each
    pod's first gradients (port leaf order) and, under posit8_ef, "ef": each
    pod's residuals after the last step."""
    jm, _ = train_models(arch, over, **step_kw(quant, micro, grad_compression=comp))
    pods, use_ef = comp != "none", comp == "posit8_ef"
    jstate = dict(reference_state(arch, quant, over))
    if use_ef:          # make_train_state's zero residuals
        jstate["ef"] = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jstate["params"])
    out = {"init": to_numpy_tree(jstate), "batches": step_batches(jm.cfg, steps, B, S, frames),
           "jmet": [], "m1": None}
    grads_fn, update = _grads_fn(arch, over, micro, pods, blocks), _update_fn(arch, over, quant)
    params, opt = jstate["params"], jstate["opt"]
    ef = jax.tree.map(lambda e: jnp.stack([e] * 2), jstate["ef"]) if use_ef else None
    for s, b in enumerate(out["batches"]):
        out["before"] = to_numpy_tree(params)
        if pods:
            pb = {k: jnp.asarray(v).reshape(2, B // 2, *v.shape[1:]) for k, v in b.items()}
            loss, grads = grads_fn(params, pb)
            if s == 0:
                out["pod_grads1"] = [port_leaves(jax.tree.map(lambda g: g[p], grads))
                                     for p in range(2)]
            grads, new_ef = compress_fn(use_ef)(grads, ef)
            grads, loss, ef = jax.tree.map(lambda g: g[0], grads), loss[0], new_ef
        else:
            loss, grads = grads_fn(params, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, met = update(params, grads, opt)
        if s == 0 and quant == "none":
            out["m1"] = to_numpy_tree(opt["m"])
        if quant == "posit8":
            out.setdefault("opt_steps", []).append(to_numpy_tree(opt))
        out["jmet"].append({"loss": float(loss), **{k: float(v) for k, v in met.items()}})
    out["want"] = to_numpy_tree({"params": params, "opt": opt})
    if use_ef:
        out["ef"] = [to_numpy_tree(jax.tree.map(lambda e: e[p], ef)) for p in range(2)]
    return out


def port_leaves(tree):
    """A reference parameter-like tree as numpy leaves in the port's
    ``tree_leaves`` order (layers unstacked)."""
    return [t.numpy() for t in tree_leaves(params_from_numpy(to_numpy_tree(tree), device="cpu"))]


def reference_tree(leaves, ref):
    """Port-order leaves as the reference's stacked parameter tree."""
    it = iter(leaves)
    port = tree_map(lambda _: torch.from_numpy(np.asarray(next(it))),
                    params_from_numpy(ref["init"]["params"], device="cpu"))
    return params_to_numpy(port)


def pod_ranks(res, p, per_pod):
    """The ranks' results with pod p's ranks first: ``GridContext.unshard``
    and ``gather_train_state`` read a pod-replicated leaf from pod 0's."""
    lo, hi = per_pod * p, per_pod * (p + 1)
    return res[lo:hi] + res[:lo] + res[hi:]


@functools.lru_cache(maxsize=None)
def reference_drops(arch, micro, over=(), B=4, S=32):
    """The assignments that the reference's MoE layers drop at capacity in
    the forward of its first step (each microbatch of the first of
    ``step_batches``, from its seed-0 state), counted on its own routing:
    ``moe_forward``'s capacity and positions re-run on each MoE layer's
    input, read out through ``jax.debug.callback``."""
    import repro.nn.transformer as JT
    from repro.nn.layers import param_value
    jm, _ = train_models(arch, over, **step_kw("none", micro))
    dropped = []
    orig = JT.moe_forward

    def counted(p, x, cfg, ctx, use_kernel=False):
        b, s, d = x.shape
        E, k, T = cfg.n_experts, cfg.top_k, b * s
        probs = jax.nn.softmax(x.reshape(T, d).astype(jnp.float32)
                               @ param_value(p["router"], jnp.float32), axis=-1)
        flat = jax.lax.top_k(probs, k)[1].reshape(-1)
        se = flat[jnp.argsort(flat, stable=True)]
        C = int(max(1, round(T * k * cfg.capacity_factor / E)))
        pos = jnp.arange(T * k) - jnp.searchsorted(se, jnp.arange(E))[se]
        jax.debug.callback(lambda n: dropped.append(int(n)), jnp.sum(pos >= C))
        return orig(p, x, cfg, ctx, use_kernel=use_kernel)

    JT.moe_forward = counted
    try:
        batch = step_batches(jm.cfg, 1, B, S)[0]
        params = reference_state(arch, "none", over)["params"]
        n = max(micro, 1)
        loss = jax.jit(lambda p, mb: jm.loss(p, mb)[0])
        for i in range(n):
            mb = {k: jnp.asarray(v[i * B // n:(i + 1) * B // n]) for k, v in batch.items()}
            jax.block_until_ready(loss(params, mb))
    finally:
        JT.moe_forward = orig
    jax.effects_barrier()
    return sum(dropped)


def check_pod_case(pool, arch, grid, comp, quant, micro, over=(), flips=None, ef_flips=None,
                   run_kw=None, blocks=1):
    """Three steps on a grid with pods under ``grad_compression`` ``comp``
    against the reference's pod composition.

    First step: each pod's gradients (before the mean, gathered over
    model) within 1e-5 of each leaf's largest entry of the reference's, and
    the port's compressed mean of them equal, bit for bit, to the
    reference's ``compressed_grad_transform`` under ``vmap`` of the same
    gradients (the layers of one stacked reference leaf share a scale).
    Then the three steps to ``assert_steps_match``'s bounds, with the
    parameters held to its posit8-moment bounds (at most 0.1 % of a leaf's
    entries past 3e-5, none past 5e-3) whatever the moment format: the two
    frameworks' gradients differ by rounding, an entry that lies that close
    to a rounding boundary of the transport's code grid codes one step (6
    to 12 %) apart, and Adam's later updates of it part by a few % of lr
    (up to 4.7e-5 with f32 moments). Under posit8_ef each pod's residuals
    (held by its ranks) against the composition's: a residual follows its
    gradient's rounding (after three steps 99.9 % of entries part by less
    than 1e-3 of the leaf's largest residual), and a code one step apart
    moves it by one code step, about twice the largest residual: at most
    0.1 % of entries past 2e-3 of the largest residual, none past twice
    it. ``flips`` goes to ``assert_steps_match``; ``ef_flips`` {leaf: n}
    lets a residual leaf hold n entries past 2e-3 beyond its 0.1 % (a
    leaf of a few hundred entries, one code step apart); every entry past
    2e-3 in such a leaf must mirror the reference's about 0 (their sum
    within 1 % of their difference): the value lay at a code's midpoint,
    which each side rounded to its own neighbour. ``run_kw``: more
    RunConfig fields of the port's run; ``blocks`` > 1: the reference's
    loss summed in the partitioned order of that many vocab blocks
    (``reference``'s ``blocks``)."""
    from repro_torch.launch.train import spec_leaves
    ref = reference(arch, comp, quant, micro, over, blocks=blocks)
    kw = step_kw(quant, micro, grad_compression=comp, **(run_kw or {}))
    tmet, got, res = run_grid(pool, arch, grid, kw, ref, over)
    model = layout_model(arch, grid, over, **kw)
    specs = spec_leaves(model)
    per_pod = len(res) // 2

    def leaf(key, i, p):
        return model.grid.unshard([r["probes"][0][key][i] for r in pod_ranks(res, p, per_pod)],
                                  specs[i])

    pods = [[leaf("pod_grads", i, p) for i in range(len(specs))] for p in range(2)]
    for p in range(2):
        for i, (a, b) in enumerate(zip(ref["pod_grads1"][p], pods[p])):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max(), err_msg=str(i))
    # the reference's transform of the port's gradients, on its stacked tree
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), reference_tree(pods[0], ref),
                           reference_tree(pods[1], ref))
    want = compress_fn(False)(stacked, None)[0]
    for p in range(2):
        w = port_leaves(jax.tree.map(lambda m: m[p], want))
        for i, a in enumerate(w):
            assert np.array_equal(a, leaf("mean_grads", i, p)), (p, i)
    # the transport's codes make the parameters' bounds the posit8 moments'
    assert_steps_match("posit8", ref["jmet"], tmet, None, ref["before"], ref["want"], got,
                       flips=flips)
    ef_flips = ef_flips or {}
    if comp != "posit8_ef":
        assert "ef" not in res[0]["state"]
        return
    for p in range(2):
        got_ef = gather_train_state([r["state"] for r in pod_ranks(res, p, per_pod)],
                                    model)["ef"]
        for path, a, b in walk(ref["ef"][p], got_ef):
            d, top = np.abs(a - b), np.abs(a).max()
            off = d > 2e-3 * top
            assert off.sum() <= 1e-3 * d.size + ef_flips.get(path, 0), (p, path, off.sum())
            assert d.max() <= 2 * top, (p, path, d.max(), top)
            if path in ef_flips:
                ra, rb = a[off], b[off]
                assert np.all(np.abs(ra + rb) <= 1e-2 * np.abs(ra - rb)), (p, path, ra, rb)
