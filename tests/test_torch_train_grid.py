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
meshes, for every family (the production ones included); shards drawn by
``LM.init`` on a grid gather back to the tp = 1 leaves; the Megatron pair
gives tp = 1's gradients for a column -> row MLP. The other families' grids
are held in ``test_torch_train_grid_{moe,ssm,hybrid,encdec}.py``, sequence
parallelism in ``test_torch_train_grid_sp*.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import grid_bridge
from grid_bridge import check_pod_case, layout, reference, run_grid
from torch_bridge import jax_compile_cache  # noqa: F401 (autouse)
from torch_bridge import (STEP_CASES, STEP_IDS, assert_steps_match, step_kw,
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


def layout_model(grid, **run_kw):
    return grid_bridge.layout_model(ARCH, grid, **run_kw)


@pytest.mark.parametrize("quant,micro", STEP_CASES, ids=STEP_IDS)
@pytest.mark.parametrize("name", list(PLAIN_GRIDS))
def test_plain_grid_three_steps_match_reference(pool, name, quant, micro):
    """(model 2), (data 2), (pod 2, plain mean), (data 2, model 2) and
    (model 4, wk/wv replicated) against the reference's tp = 1 step."""
    ref = reference(ARCH, "none", quant, micro)
    tmet, got, _ = run_grid(pool, ARCH, PLAIN_GRIDS[name], step_kw(quant, micro), ref)
    assert_steps_match(quant, ref["jmet"], tmet, ref["m1"], ref["before"], ref["want"], got,
                       noise=NOISE)


@pytest.mark.parametrize("quant,micro", STEP_CASES, ids=STEP_IDS)
@pytest.mark.parametrize("comp", COMPRESSIONS)
def test_pod_grid_three_steps_match_reference(pool, comp, quant, micro):
    """(pod 2, model 2) with the posit8-compressed pod mean against the
    reference's composition (``grid_bridge.check_pod_case``)."""
    check_pod_case(pool, ARCH, POD_GRID, comp, quant, micro)


# ---------------------------------------------------------------------------
# Specs, shards and refusals (this process, layouts without groups)
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b", "falcon-mamba-7b",
                "zamba2-1.2b", "whisper-medium")
SPEC_GRIDS = [("yi-9b smoke", (1, 2, 2)), ("yi-9b smoke", (2, 2, 2)),
              ("yi-9b smoke", (1, 1, 4)), ("yi-9b", (1, 16, 16)), ("yi-9b", (2, 16, 16))] + [
    (f"{arch} smoke", grid) for arch in FAMILY_ARCHS
    for grid in ((1, 2, 2), (2, 2, 2), (1, 1, 4))] + [
    ("zamba2-1.2b smoke", (1, 1, 16))] + [
    (arch, grid) for arch in FAMILY_ARCHS for grid in ((1, 16, 16), (2, 16, 16))]


def _config(cfg_name, archs, smoke_fn):
    """``cfg_name`` ("<arch>" or "<arch> smoke") from an ARCHS table."""
    arch, *rest = cfg_name.split()
    return smoke_fn(archs[arch]) if rest else archs[arch]


def _fake_reference_model(cfg_name, grid, run_kw):
    """The reference's LM over a fake mesh with the grid's shape and axis
    names (``make_ctx`` and ``ShardingCtx.spec`` read only those)."""
    from repro.configs import ARCHS as J_ARCHS, RunConfig as JRunConfig, smoke as j_smoke
    from repro.nn.models import build_model as j_build
    shape, names = grid_layout(*grid)
    mesh = SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)
    return j_build(_config(cfg_name, J_ARCHS, j_smoke), JRunConfig(**run_kw), mesh=mesh)


def _leaf_specs(tree, is_leaf):
    """{path: spec} of a spec tree, stacked layer axes stripped."""
    import jax
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): s
            for path, s in flat}


def _port_specs(tree, path=""):
    """(reference path, spec) of the port's spec tree; the layers of a list
    that the reference stacks under one path must agree."""
    from repro_torch.core.policy import layer_prefixes
    if isinstance(tree, dict):
        for k in tree:
            yield from _port_specs(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        stacks = {}
        for t, pre in zip(tree, layer_prefixes(tree, path + "/")):
            stacks.setdefault(pre, []).append(dict(_port_specs(t, pre.rstrip("/"))))
        for pre, layers in stacks.items():
            assert all(lay == layers[0] for lay in layers), pre
            yield from layers[0].items()
    else:
        yield path.lstrip("/"), tree


@pytest.mark.parametrize("cfg_name,grid", SPEC_GRIDS)
def test_state_and_batch_specs_match_reference_make_ctx(cfg_name, grid, monkeypatch):
    """Every param, posit8 moment (codes like the param, scale replicated),
    ``ef`` and batch leaf's spec equals the reference's ``state_shardings``
    and ``batch_shardings`` on a fake mesh of the grid's shape (a stacked
    leaf's layer axes replicated), for every family at the smoke size and
    at full size on the production meshes; zamba2's smoke in_proj (552
    columns) replicates at model 16, its other mixer leaves shard."""
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
    cfg = _config(cfg_name, ARCHS, smoke)
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
        depth = 2 if "blocks/dense/" in path else int("blocks/" in path)
        assert all(a is None for a in w[:depth]), path
        w = w[depth:]
        assert w == tuple(g), (path, w, g)
    B, S = 8 * grid[0] * grid[1], 16
    batch = {"tokens": np.zeros((B, S), np.int32), "labels": np.zeros((B, S), np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = np.zeros((B, S, cfg.d_model), np.float32)
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
