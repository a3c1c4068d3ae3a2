"""Training the dense family across ranks: data, FSDP and tensor parallelism
over a (pod, data, model) process grid, on the CPU over gloo.

Every grid runs three steps of the port's ``make_train_step`` at the smoke
size (yi-9b: 4 heads, 2 kv heads), f32, with f32 and posit8 moments, with
and without 2 microbatches, from the reference's seed-0 state cut to each
rank's shard; the shards are gathered back (``convert.gather_train_state``)
and held to the reference's bounds (``torch_bridge.assert_steps_match``):

* plain grids, (model 2), (data 2), (pod 2) with the plain mean, (data 2,
  model 2) and (model 4: wk/wv replicate, as the 2 kv heads do not split
  four ways), against the reference's tp = 1 step: its ``grads_plain``
  and ``apply_updates``, each jitted once and shared with the pod cases
  (the reference's single-jit step is held against the port's tp = 1 in
  ``tests/test_torch_train.py``);
* (pod 2, model 2) under ``grad_compression`` "posit8" and "posit8_ef",
  against a composition of the reference's functions: each pod's
  ``jax.value_and_grad(model.loss)`` (its microbatch scan), then
  ``runtime.compression.compressed_grad_transform`` under
  ``jax.vmap(..., axis_name="pod")``, then ``optim.apply_updates`` (the
  reference's own shard_map path needs a process with several XLA
  devices, which this suite does not use); the error-feedback residuals of
  both pods are held as well.

Each reference trajectory is computed once for the module. The ranks are
one module-scoped ``RankPool`` of 4 CPU processes (rank-side functions in
``tests/grid_ranks.py``, which imports no JAX). Also: every param, moment,
``ef`` and batch spec against the reference's ``make_ctx`` specs on fake
meshes (the production ones included); shards drawn by ``LM.init`` on a
grid gather back to the tp = 1 leaves; indivisible heads or d_ff raise;
the Megatron pair gives tp = 1's gradients for a column -> row MLP.
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_bridge import (STEP_CASES, STEP_IDS, assert_steps_match, step_kw, to_numpy_tree,
                          torch_one_thread, walk)  # noqa: F401 (autouse)
from repro_torch.configs import ARCHS, RunConfig, smoke
from repro_torch.convert import gather_train_state, params_to_numpy
from repro_torch.launch.mesh import grid_layout, make_host_mesh, make_production_mesh
from repro_torch.launch.train import batch_shardings, make_train_state, state_shardings
from repro_torch.nn.models import build_model
from repro_torch.nn.sharding import GridContext

ARCH = "yi-9b"
PLAIN_GRIDS = {"model2": (1, 1, 2), "data2": (1, 2, 1), "pod2": (2, 1, 1),
               "data2-model2": (1, 2, 2), "model4": (1, 1, 4)}
POD_GRID = (2, 1, 2)
COMPRESSIONS = ("posit8", "posit8_ef")
# f32 moments: wk entries whose first step's gradient is rounding noise (see
# assert_steps_match) move by Adam's noise-driven first step; summed over the
# ranks in another order than the reference's, up to 3.42e-5 (model 2 and
# (data 2, model 2))
NOISE = {"/blocks/attn/wk": 4e-5}

@pytest.fixture(scope="module")
def pool():
    from repro_torch.launch.mesh import RankPool
    grids = list(PLAIN_GRIDS.values()) + [POD_GRID]
    with RankPool(4, "cpu", threads=1, grids=grids, timeout_s=120) as p:
        yield p
    assert not any(proc.is_alive() for proc in p._procs)


def layout(grid):
    """The grid's layout (rank 0's view, no process group)."""
    return GridContext(*grid_layout(*grid))


def layout_model(grid, **run_kw):
    return build_model(smoke(ARCHS[ARCH]), RunConfig(weight_dtype="f32",
                                                     activation_dtype="f32", **run_kw),
                       device="cpu", grid=layout(grid))


def run_grid(pool, grid, kw, ref):
    """The three steps on the grid's ranks from ``ref``'s initial state and
    batches: (the rank 0 metrics, the gathered state as the reference's
    numpy tree, the ranks' results)."""
    case = {"arch": ARCH, "kw": kw, "init": ref["init"], "batches": ref["batches"]}
    from grid_ranks import train_case
    res = pool.run(train_case, case, grid=grid)
    for r, got in enumerate(res[1:], 1):
        assert got["metrics"] == res[0]["metrics"], f"rank {r}'s metrics part from rank 0's"
    state = gather_train_state([r["state"] for r in res], layout_model(grid, **kw))
    return res[0]["metrics"], state, res


@pytest.mark.parametrize("quant,micro", STEP_CASES, ids=STEP_IDS)
@pytest.mark.parametrize("name", list(PLAIN_GRIDS))
def test_plain_grid_three_steps_match_reference(pool, name, quant, micro):
    """(model 2), (data 2), (pod 2, plain mean), (data 2, model 2) and
    (model 4, wk/wv replicated) against the reference's tp = 1 step."""
    ref = reference("none", quant, micro)
    tmet, got, _ = run_grid(pool, PLAIN_GRIDS[name], step_kw(quant, micro), ref)
    assert_steps_match(quant, ref["jmet"], tmet, ref["m1"], ref["before"], ref["want"], got,
                       noise=NOISE)


@functools.lru_cache(maxsize=None)
def _grads_fn(micro, pods):
    """The reference's ``grads_plain`` (``value_and_grad``, or its
    microbatch scan with f32 accumulators), jitted; with ``pods`` each
    pod's under ``vmap(axis_name="pod")``, the loss pmean'd over "pod"."""
    import jax
    import jax.numpy as jnp
    from torch_bridge import train_models
    jm, _ = train_models(ARCH, **step_kw("none", micro))
    n_micro = max(micro, 1)

    def loss_fn(params, batch):
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
def _compress_fn(use_ef):
    """The reference's ``compressed_grad_transform`` over "pod" under vmap
    (posit8_ef: with each pod's residuals); jitted."""
    import jax
    from repro.runtime.compression import compressed_grad_transform

    def per_pod(grads, ef):
        return compressed_grad_transform(grads, "pod", N=8, ES=2,
                                         residuals=ef if use_ef else None)

    return jax.jit(jax.vmap(per_pod, axis_name="pod"))


@functools.lru_cache(maxsize=None)
def _update_fn(quant):
    import jax
    from repro.launch.train import opt_config_from_run
    from repro.optim import apply_updates
    from torch_bridge import train_models
    ocfg = opt_config_from_run(train_models(ARCH, **step_kw(quant, 0))[0].rcfg)
    return jax.jit(lambda p, g, o: apply_updates(p, g, o, ocfg))


@functools.lru_cache(maxsize=None)
def reference(comp, quant, micro, steps=3, B=4, S=32):
    """The reference's training step composed of its functions, each jitted
    once for the module: its ``grads_plain`` then ``apply_updates`` on the
    whole batch (``comp`` "none": the tp = 1 step of ``make_train_step``,
    whose single jit the port's tp = 1 step is held to in
    tests/test_torch_train.py); else its pod branch, the 2 pods under
    ``jax.vmap(axis_name="pod")``: each pod's ``grads_plain``,
    ``compressed_grad_transform`` over "pod" and the loss's pod mean, then
    ``apply_updates``. From the reference's seed-0 ``make_train_state``, on
    ``torch_bridge.step_batches``. Returns the fields of
    ``torch_bridge.reference_steps``, and for the pods "pod_grads1": each
    pod's first gradients (port leaf order) and, under posit8_ef, "ef": each
    pod's residuals after the last step."""
    import jax
    import jax.numpy as jnp
    from torch_bridge import reference_state, step_batches, train_models
    jm, _ = train_models(ARCH, **step_kw(quant, micro, grad_compression=comp))
    pods, use_ef = comp != "none", comp == "posit8_ef"
    jstate = dict(reference_state(ARCH, quant))
    if use_ef:          # make_train_state's zero residuals
        jstate["ef"] = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jstate["params"])
    out = {"init": to_numpy_tree(jstate), "batches": step_batches(jm.cfg, steps, B, S),
           "jmet": [], "m1": None}
    grads_fn, update = _grads_fn(micro, pods), _update_fn(quant)
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
            grads, new_ef = _compress_fn(use_ef)(grads, ef)
            grads, loss, ef = jax.tree.map(lambda g: g[0], grads), loss[0], new_ef
        else:
            loss, grads = grads_fn(params, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, met = update(params, grads, opt)
        if s == 0 and quant == "none":
            out["m1"] = to_numpy_tree(opt["m"])
        out["jmet"].append({"loss": float(loss), **{k: float(v) for k, v in met.items()}})
    out["want"] = to_numpy_tree({"params": params, "opt": opt})
    if use_ef:
        out["ef"] = [to_numpy_tree(jax.tree.map(lambda e: e[p], ef)) for p in range(2)]
    return out


def port_leaves(tree):
    """A reference parameter-like tree as numpy leaves in the port's
    ``tree_leaves`` order (layers unstacked)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.optim import tree_leaves
    return [t.numpy() for t in tree_leaves(params_from_numpy(to_numpy_tree(tree), device="cpu"))]


def reference_tree(leaves, ref):
    """Port-order leaves as the reference's stacked parameter tree."""
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.optim import tree_map
    it = iter(leaves)
    port = tree_map(lambda _: torch.from_numpy(np.asarray(next(it))),
                    params_from_numpy(ref["init"]["params"], device="cpu"))
    return params_to_numpy(port)


def pod_ranks(res, p):
    """The ranks' results with pod p's ranks first: ``GridContext.unshard``
    and ``gather_train_state`` read a pod-replicated leaf from pod 0's."""
    return res[2 * p:2 * p + 2] + res[:2 * p] + res[2 * p + 2:]


@pytest.mark.parametrize("quant,micro", STEP_CASES, ids=STEP_IDS)
@pytest.mark.parametrize("comp", COMPRESSIONS)
def test_pod_grid_three_steps_match_reference(pool, comp, quant, micro):
    """(pod 2, model 2) with the posit8-compressed pod mean against the
    reference's composition.

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
    (held by its ranks) against
    the composition's: a residual follows its gradient's rounding (after
    three steps 99.9 % of entries part by less than 1e-3 of the leaf's
    largest residual), and a code one step apart moves it by one code
    step, about twice the largest residual: at most 0.1 % of entries past
    2e-3 of the largest residual, none past twice it."""
    import jax
    from repro_torch.launch.train import spec_leaves
    ref = reference(comp, quant, micro)
    kw = step_kw(quant, micro, grad_compression=comp)
    tmet, got, res = run_grid(pool, POD_GRID, kw, ref)
    model = layout_model(POD_GRID, **kw)
    specs = spec_leaves(model)

    def leaf(key, i, p):
        return model.grid.unshard([r["probes"][0][key][i] for r in pod_ranks(res, p)], specs[i])

    pods = [[leaf("pod_grads", i, p) for i in range(len(specs))] for p in range(2)]
    for p in range(2):
        for i, (a, b) in enumerate(zip(ref["pod_grads1"][p], pods[p])):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max(), err_msg=str(i))
    # the reference's transform of the port's gradients, on its stacked tree
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), reference_tree(pods[0], ref),
                           reference_tree(pods[1], ref))
    want = _compress_fn(False)(stacked, None)[0]
    for p in range(2):
        w = port_leaves(jax.tree.map(lambda m: m[p], want))
        for i, a in enumerate(w):
            assert np.array_equal(a, leaf("mean_grads", i, p)), (p, i)
    # the transport's codes make the parameters' bounds the posit8 moments'
    assert_steps_match("posit8", ref["jmet"], tmet, None, ref["before"], ref["want"], got)
    if comp != "posit8_ef":
        assert "ef" not in res[0]["state"]
        return
    for p in range(2):
        got_ef = gather_train_state([r["state"] for r in pod_ranks(res, p)], model)["ef"]
        for path, a, b in walk(ref["ef"][p], got_ef):
            d, top = np.abs(a - b), np.abs(a).max()
            assert (d > 2e-3 * top).mean() <= 1e-3, (p, path, (d > 2e-3 * top).mean())
            assert d.max() <= 2 * top, (p, path, d.max(), top)


# ---------------------------------------------------------------------------
# Specs, shards and refusals (this process, layouts without groups)
# ---------------------------------------------------------------------------

SPEC_GRIDS = [("yi-9b smoke", (1, 2, 2)), ("yi-9b smoke", (2, 2, 2)),
              ("yi-9b smoke", (1, 1, 4)), ("yi-9b", (1, 16, 16)), ("yi-9b", (2, 16, 16))]


def _fake_reference_model(cfg_name, grid, run_kw):
    """The reference's LM over a fake mesh with the grid's shape and axis
    names (``make_ctx`` and ``ShardingCtx.spec`` read only those)."""
    from repro.configs import ARCHS as J_ARCHS, RunConfig as JRunConfig, smoke as j_smoke
    from repro.nn.models import build_model as j_build
    shape, names = grid_layout(*grid)
    mesh = SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)
    jc = J_ARCHS["yi-9b"]
    jc = j_smoke(jc) if cfg_name.endswith("smoke") else jc
    return j_build(jc, JRunConfig(**run_kw), mesh=mesh)


def _leaf_specs(tree, is_leaf):
    """{path: spec} of a spec tree, stacked layer axes stripped."""
    import jax
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): s
            for path, s in flat}


def _port_specs(tree, path=""):
    """(reference path, spec) of the port's spec tree; every layer of the
    ``blocks`` list must agree (the reference stacks them)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _port_specs(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        layers = [dict(_port_specs(t, path)) for t in tree]
        assert all(lay == layers[0] for lay in layers), path
        yield from layers[0].items()
    else:
        yield path.lstrip("/"), tree


@pytest.mark.parametrize("cfg_name,grid", SPEC_GRIDS)
def test_state_and_batch_specs_match_reference_make_ctx(cfg_name, grid, monkeypatch):
    """Every param, posit8 moment (codes like the param, scale replicated),
    ``ef`` and batch leaf's spec equals the reference's ``state_shardings``
    and ``batch_shardings`` on a fake mesh of the grid's shape (a stacked
    leaf's layer axis replicated)."""
    import jax
    import jax.sharding
    from jax.sharding import PartitionSpec as P
    import repro.nn.sharding as j_sharding
    from repro.core.quantizers import QuantizedTensor as JQT
    from repro.launch.train import batch_shardings as j_batch, state_shardings as j_state
    from repro_torch.core.quantizers import QuantizedTensor
    fake = lambda mesh, spec: spec                        # noqa: E731
    monkeypatch.setattr(jax.sharding, "NamedSharding", fake)
    monkeypatch.setattr(j_sharding, "NamedSharding", fake)
    run_kw = dict(opt_state_quant="posit8", grad_compression="posit8_ef")
    jm = _fake_reference_model(cfg_name, grid, run_kw)
    cfg = smoke(ARCHS["yi-9b"]) if cfg_name.endswith("smoke") else ARCHS["yi-9b"]
    tm = build_model(cfg, RunConfig(**run_kw), device="cpu", grid=layout(grid))
    want = _leaf_specs(j_state(jm), lambda x: isinstance(x, (P, JQT)))
    got = dict(_port_specs(state_shardings(tm)))
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path]
        if isinstance(w, JQT):
            assert isinstance(g, QuantizedTensor) and tuple(w.scale) == (), path
            assert all(a is None for a in g.scale), path
            w, g = w.codes, g.codes
        w = tuple(w)
        if "blocks/" in path:
            assert w[0] is None, path
            w = w[1:]
        assert w == tuple(g), (path, w, g)
    B, S = 8 * grid[0] * grid[1], 16
    batch = {"tokens": np.zeros((B, S), np.int32), "labels": np.zeros((B, S), np.int32)}
    wb = j_batch(jm, {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()})
    assert {k: tuple(v) for k, v in wb.items()} == batch_shardings(tm, batch)


@pytest.mark.parametrize("grid", [(1, 2, 2), (1, 1, 4), (2, 1, 2)])
def test_grid_shards_gather_back_to_the_tp1_leaves(grid):
    """``LM.init`` on each rank of a grid draws every whole leaf and keeps
    its block: the blocks gather back to the tp = 1 leaves bit for bit; a
    state cut by ``rank_train_state_from_numpy`` gathers back to itself."""
    from repro_torch.convert import rank_train_state_from_numpy, train_state_from_numpy
    shape, names = grid_layout(*grid)
    kw = dict(opt_state_quant="posit8")
    lay = layout_model(grid, **kw)
    cfg = smoke(ARCHS[ARCH])
    states = []
    for r in range(lay.grid.size):
        m = build_model(cfg, RunConfig(weight_dtype="f32", activation_dtype="f32", **kw),
                        device="cpu", grid=GridContext(shape, names, rank=r))
        states.append(make_train_state(m, 0))
    one = build_model(cfg, RunConfig(weight_dtype="f32", activation_dtype="f32", **kw),
                      device="cpu")
    want = params_to_numpy(make_train_state(one, 0))
    got = gather_train_state(states, lay)
    leaves = list(walk(want, got))
    assert len(leaves) > 10
    for path, a, b in leaves:
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    assert states[0]["params"]["embed"].numel() < want["params"]["embed"].size
    ranks = [rank_train_state_from_numpy(want, build_model(
        cfg, RunConfig(weight_dtype="f32", activation_dtype="f32", **kw), device="cpu",
        grid=GridContext(shape, names, rank=r))) for r in range(lay.grid.size)]
    back = gather_train_state(ranks, lay)
    for path, a, b in walk(want, back):
        assert a.tobytes() == b.tobytes(), path
    assert train_state_from_numpy(want, device="cpu")["opt"]["count"].shape == ()


@pytest.mark.parametrize("over,grid,what", [
    ({}, (1, 1, 3), "n_heads = 4"),
    ({"d_ff": 250}, (1, 1, 4), "d_ff = 250"),
    ({"n_heads": 6, "n_kv_heads": 2}, (1, 2, 4), "n_heads = 6"),
])
def test_indivisible_heads_or_dff_raise(over, grid, what):
    """A model axis that does not divide n_heads or d_ff raises
    NotImplementedError naming ROADMAP A8c (never a wrong result)."""
    cfg = dataclasses.replace(smoke(ARCHS[ARCH]), **over)
    with pytest.raises(NotImplementedError, match=rf"{what}.*ROADMAP A8c"):
        build_model(cfg, RunConfig(), device="cpu", grid=layout(grid))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "zamba2-1.2b", "falcon-mamba-7b",
                                  "whisper-medium"])
def test_other_families_on_a_grid_raise(arch):
    with pytest.raises(NotImplementedError, match="dense family.*ROADMAP A8c"):
        build_model(smoke(ARCHS[arch]), RunConfig(), device="cpu", grid=layout((1, 2, 1)))


def test_meshes_report_the_reference_shapes():
    """``make_production_mesh`` outside a 256/512-rank world reports the
    reference's layout; ``make_host_mesh`` of one rank is a layout."""
    g = make_production_mesh()
    assert (g.shape, g.axis_names, g.groups) == ((16, 16), ("data", "model"), None)
    g = make_production_mesh(multi_pod=True)
    assert (g.shape, g.axis_names) == ((2, 16, 16), ("pod", "data", "model"))
    assert make_host_mesh().shape == (1, 1)
    assert grid_layout(2, 1, 2) == ((2, 1, 2), ("pod", "data", "model"))
    assert GridContext((2, 2, 2), ("pod", "data", "model"), rank=5).coords == {
        "pod": 1, "data": 0, "model": 1}
    with pytest.raises(ValueError, match="grid sizes must be >= 1"):
        grid_layout(1, 0, 2)


def test_megatron_pair_gives_tp1_gradients(pool):
    """A gated MLP, column-sharded wg/wu and row-sharded wo over model 2,
    between ``copy_in`` (f) and ``reduce_out`` (g): the loss, the input's
    gradient on every rank and the weights' gradient blocks equal tp = 1's
    autograd (f32, 1e-6 of each tensor's largest entry)."""
    from grid_ranks import megatron_mlp
    from repro_torch.nn.layers import mlp_forward
    rng = np.random.RandomState(0)
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("wg", (16, 8)), ("wu", (16, 8)), ("wo", (8, 16)))}
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    probe = rng.standard_normal((2, 3, 16)).astype(np.float32)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    xt = torch.tensor(x, requires_grad=True)
    terms = mlp_forward(p, xt, "silu") * torch.tensor(probe)
    loss = terms.sum()
    loss.backward()
    res = pool.run(megatron_mlp, w, x, probe, grid=(1, 1, 2))
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=0,   # noqa: E731
                                                    atol=1e-6 * np.abs(b).max())
    for r, (l, gx, gw) in enumerate(res):
        assert abs(l - loss.item()) <= 1e-6 * terms.detach().abs().sum().item()
        close(gx, xt.grad.numpy())
        close(gw["wg"], p["wg"].grad.numpy()[:, 4 * r:4 * r + 4])
        close(gw["wu"], p["wu"].grad.numpy()[:, 4 * r:4 * r + 4])
        close(gw["wo"], p["wo"].grad.numpy()[4 * r:4 * r + 4])
