"""The dry run (``repro_torch.launch.dryrun``, ``hlo_analysis``, ``op_cost``)
against the reference's ``repro.launch.dryrun`` and ``hlo_analysis``.

* ``analytic_model_flops`` and ``TRAIN_KNOBS`` equal the reference's for
  every architecture and shape;
* ``roofline_terms`` gives the reference's dict on the same inputs, with
  the port's H100 constants set to the reference's v5e ones;
* ``wire_bytes`` equals the reference's ``parse_collectives`` on synthetic
  HLO lines of each of the five kinds at group sizes 2, 4 and 16;
* every architecture's per-rank leaf shapes and dtypes on both production
  grids equal the reference's: the train state (``abstract_train_state``:
  params and the knob's moments) against ``model.abstract_params()``-style
  abstract states placed by ``make_ctx(AbstractMesh(...))``; a serve cell's
  quantized params and decode cache (``serve_arguments``) against the
  reference's ``apply_policy`` and ``init_cache`` placed the same way;
* ``op_cost.count_step``'s rules on small real steps, and one full-size
  cell: yi-9b train_4k as rank 0 of (16, 16).

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 devices on import: the
fixture starts JAX first (its device count is fixed then) and puts the
variable back afterwards, so that later JAX tests and subprocesses of the
same worker see the count they expect.
"""
import math
import os
import time

import numpy as np
import pytest
import torch

from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)
from repro_torch.configs import ARCHS, LONG_CONTEXT_ARCHS, RunConfig
from repro_torch.configs.base import SHAPES
from repro_torch.core.policy import QuantPolicy, layer_prefixes
from repro_torch.core.quantizers import QuantizedTensor
from repro_torch.launch import dryrun, hlo_analysis, op_cost
from repro_torch.launch.mesh import grid_layout
from repro_torch.launch.train import abstract_train_state
from repro_torch.nn.models import build_model
from repro_torch.nn.sharding import GridContext, TPContext

GRIDS = {"single": (1, 16, 16), "multi": (2, 16, 16)}


@pytest.fixture(scope="module")
def jdry():
    import jax
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jd


def test_model_flops_and_knobs_match_reference(jdry):
    from repro.configs import ARCHS as J_ARCHS
    from repro.configs.base import SHAPES as J_SHAPES
    assert dryrun.TRAIN_KNOBS == jdry.TRAIN_KNOBS
    assert set(ARCHS) == set(J_ARCHS) and set(SHAPES) == set(J_SHAPES)
    for arch in ARCHS:
        for name in SHAPES:
            got = dryrun.analytic_model_flops(ARCHS[arch], SHAPES[name])
            assert got == jdry.analytic_model_flops(J_ARCHS[arch], J_SHAPES[name]), (arch, name)
    assert dryrun._cell_path("d", "yi-9b", "train_4k", "multi", "attn/*=pofx8,*=bf16") == \
        jdry._cell_path("d", "yi-9b", "train_4k", "multi", "attn/*=pofx8,*=bf16")


@pytest.mark.parametrize("inputs", [(3.1e14, 2.2e12, 4.0e10, 8.0e16, 256),
                                    (1e12, 9e13, 1e9, 2e15, 512), (5e13, 1e11, 7e12, 1e16, 256),
                                    (0.0, 1e9, 0.0, 1e12, 256)])
def test_roofline_terms_match_reference(monkeypatch, inputs):
    from repro.launch import hlo_analysis as jh
    monkeypatch.setattr(hlo_analysis, "PEAK_FLOPS_BF16", jh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(hlo_analysis, "HBM_BW", jh.HBM_BW)
    monkeypatch.setattr(hlo_analysis, "NET_BW", jh.ICI_BW)
    got, want = hlo_analysis.roofline_terms(*inputs), jh.roofline_terms(*inputs)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k


def test_roofline_splits_wire_bytes_over_nvlink_and_network():
    r = hlo_analysis.roofline_terms(0.0, 0.0, 9e9, 1.0, 8, wire_bytes_in_node=4.5e9)
    assert r["collective_s"] == 4.5e9 / hlo_analysis.NVLINK_BW + 4.5e9 / hlo_analysis.NET_BW
    assert r["bound"] == "collective"
    assert hlo_analysis.in_node(range(8)) and hlo_analysis.in_node([8, 15])
    assert not hlo_analysis.in_node(range(16)) and not hlo_analysis.in_node([7, 8])


_HLO = {
    "all-gather": "%ag = bf16[64,1024]{1,0} all-gather(bf16[{n},1024]{1,0} %p), "
                  "replica_groups=[{r},{g}]<=[512], dimensions={0}",
    "all-reduce": "%ar = f32[8,4096]{1,0} all-reduce(f32[8,4096]{1,0} %p), "
                  "replica_groups=[{r},{g}]<=[512], to_apply=%add",
    "reduce-scatter": "%rs = f32[{n},1024]{1,0} reduce-scatter(f32[64,1024]{1,0} %p), "
                      "replica_groups=[{r},{g}]<=[512], dimensions={0}, to_apply=%add",
    "all-to-all": "%aa = (bf16[16,512]{1,0}, bf16[16,512]{1,0}) all-to-all(bf16[16,512]{1,0} "
                  "%p, bf16[16,512]{1,0} %q), replica_groups=[{r},{g}]<=[512]",
    "collective-permute": "%cp = bf16[32,256]{1,0} collective-permute(bf16[32,256]{1,0} %p), "
                          "source_target_pairs={{0,1},{1,0}}",
}
_RESULT_BYTES = {"all-gather": lambda g: 64 * 1024 * 2, "all-reduce": lambda g: 8 * 4096 * 4,
                 "reduce-scatter": lambda g: 64 // g * 1024 * 4,
                 "all-to-all": lambda g: 2 * 16 * 512 * 2, "collective-permute": lambda g: 32 * 256 * 2}


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("kind", hlo_analysis.KINDS)
def test_wire_bytes_match_reference_parse_collectives(kind, g):
    from repro.launch.hlo_analysis import parse_collectives
    line = "  " + _HLO[kind].replace("{n}", str(64 // g)).replace("{r}", str(512 // g)).replace(
        "{g}", str(g))
    stats = parse_collectives(line)
    assert len(stats.ops) == 1 and stats.ops[0]["kind"] == kind
    nbytes = stats.ops[0]["bytes"]
    assert nbytes == _RESULT_BYTES[kind](g)
    assert hlo_analysis.wire_bytes(kind, nbytes, g) == stats.wire_bytes_per_device
    assert hlo_analysis.wire_bytes(kind, nbytes, 1) == 0.0


# ---------------------------------------------------------------------------
# per-rank shapes against the reference's rules
# ---------------------------------------------------------------------------


def _ref_ctx(grid, sequence_parallel):
    from jax.sharding import AbstractMesh
    from repro.nn.sharding import make_ctx
    shape, names = grid_layout(*grid)
    return make_ctx(AbstractMesh(shape, names), sequence_parallel=sequence_parallel), \
        dict(zip(names, shape))


def _ref_local(ctx, sizes, logical, shape):
    spec = tuple(ctx.spec(tuple(logical), tuple(shape)))
    out = []
    for i, d in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        if axes is not None:
            axes = (axes,) if isinstance(axes, str) else axes
            d //= math.prod(sizes[a] for a in axes)
        out.append(d)
    return tuple(out)


def _ref_leaves(tree, logical, ctx, sizes):
    """{path: (rank shape, dtype name)} of a reference tree placed by its
    logical axes; a QuantizedTensor's codes like its leaf, its scale
    whole."""
    import jax
    from repro.core.quantizers import QuantizedTensor as JQT
    is_leaf = lambda x: isinstance(x, JQT) or (hasattr(x, "shape") and not isinstance(x, dict))  # noqa: E731
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    lflat = jax.tree_util.tree_structure(tree, is_leaf=is_leaf).flatten_up_to(logical)
    out = {}
    for (path, leaf), ax in zip(flat, lflat):
        name = "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        if isinstance(leaf, JQT):
            out[name + "#codes"] = (_ref_local(ctx, sizes, ax, leaf.codes.shape),
                                    np.dtype(leaf.codes.dtype).name)
            out[name + "#scale"] = (tuple(leaf.scale.shape), np.dtype(leaf.scale.dtype).name)
        else:
            out[name] = (_ref_local(ctx, sizes, ax, leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _shape_dtype(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _port_leaves(tree, path=""):
    """(reference path, (shape, dtype)) of a port tree; each layer of a list
    under the path that the reference stacks it under."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _port_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for t, pre in zip(tree, layer_prefixes(tree, path + "/")):
            yield from _port_leaves(t, pre.rstrip("/"))
    elif isinstance(tree, QuantizedTensor):
        yield path.lstrip("/") + "#codes", _shape_dtype(tree.codes)
        yield path.lstrip("/") + "#scale", _shape_dtype(tree.scale)
    else:
        yield path.lstrip("/"), _shape_dtype(tree)


def _stack_depth(path):
    """The layer axes the reference stacks in front of a leaf: moe's dense
    layers (n_groups, moe_every - 1), any other layer's one."""
    parts = path.split("#")[0].split("/")
    if "blocks" in parts and "dense" in parts:
        return 2
    return 1 if ("blocks" in parts or "enc_blocks" in parts) else 0


def _assert_same_rank_leaves(want, got_pairs, kv_layers=False):
    """Each reference leaf's rank shape (its stacked layer axes taken off)
    and dtype equal to every port layer's, with as many port layers as the
    stack holds. ``kv_layers``: the port's cache keeps every attention
    layer on one L axis, which the moe reference splits into "moe" and
    "dense" stacks."""
    got = {}
    for path, sd in got_pairs:
        got.setdefault(path, []).append(sd)
    for path, layers in got.items():
        assert all(sd == layers[0] for sd in layers), path
    matched = set()
    cache_count = {}
    for path, (shape, dtype) in want.items():
        if kv_layers:
            parts = path.split("/")
            depth = 2 if "dense" in parts else (1 if "moe" in parts else 0)
            port = "/".join(p for p in parts if p not in ("moe", "dense"))
            if depth:
                gshape, gdtype = got[port][0]
                assert (gshape[1:], gdtype) == (shape[depth:], dtype), (path, gshape, shape)
                cache_count[port] = cache_count.get(port, 0) + math.prod(shape[:depth])
                matched.add(port)
                continue
        else:
            port, depth = path, _stack_depth(path)
        assert port in got, (path, sorted(got)[:8])
        matched.add(port)
        layers = got[port]
        assert layers[0] == (shape[depth:], dtype), (path, layers[0], shape, dtype)
        if path.startswith("opt/") and path.endswith("#scale") and depth:
            # a stacked posit8 moment's one scale is every layer's (the port
            # holds it in each layer's QuantizedTensor)
            assert shape[:depth] == (1,) * depth, (path, shape)
            continue
        assert len(layers) == math.prod(shape[:depth]), (path, len(layers), shape)
    for port, n in cache_count.items():
        assert got[port][0][0][0] == n, (port, got[port][0], n)
    assert matched == set(got), sorted(set(got) - matched)


@pytest.mark.parametrize("mesh", list(GRIDS))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_state_rank_shapes_match_reference(jdry, arch, mesh):
    """Every leaf of the train state (params, the knob's moments, count) of
    rank 0 on a production grid, against the reference's abstract state
    placed by ``make_ctx``'s specs (moments like their parameter, a posit8
    scale whole)."""
    import jax
    from repro.configs import ARCHS as J_ARCHS, RunConfig as JRunConfig
    from repro.launch.train import make_train_state as j_state
    from repro.nn.models import build_model as j_build
    rcfg = dryrun.train_run_config(arch)
    knobs = jdry.TRAIN_KNOBS[arch]
    jr = JRunConfig(remat="block", microbatch=knobs["microbatch"],
                    sequence_parallel=knobs["sequence_parallel"], opt_state_quant=knobs["opt"])
    jm = j_build(J_ARCHS[arch], jr)
    ctx, sizes = _ref_ctx(GRIDS[mesh], knobs["sequence_parallel"])
    js = jax.eval_shape(lambda: j_state(jm, jax.random.PRNGKey(0)))
    lg = jm.logical()
    want = {}
    want.update({f"params/{k}": v for k, v in _ref_leaves(js["params"], lg, ctx, sizes).items()})
    for mom in ("m", "v"):
        want.update({f"opt/{mom}/{k}": v
                     for k, v in _ref_leaves(js["opt"][mom], lg, ctx, sizes).items()})
    want["opt/count"] = ((), np.dtype(js["opt"]["count"].dtype).name)
    model = build_model(ARCHS[arch], rcfg, device="cpu",
                        grid=GridContext(*grid_layout(*GRIDS[mesh])))
    state = abstract_train_state(model)
    _assert_same_rank_leaves(want, _port_leaves(state))


SERVE_CELLS = [(arch, "decode_32k") for arch in ARCHS] + [
    (arch, "long_500k") for arch in sorted(LONG_CONTEXT_ARCHS)]


@pytest.mark.parametrize("mesh", list(GRIDS))
@pytest.mark.parametrize("arch,shape", SERVE_CELLS)
def test_serve_arguments_rank_shapes_match_reference(jdry, arch, shape, mesh):
    """A serve cell's rank arguments: the pofx8 params (codes placed like
    the parameter, the scale whole), the decode cache (its sequence over
    model, its rows over the batch axes) and the batch, against the
    reference's ``apply_policy`` and ``init_cache`` placed by ``make_ctx``."""
    import jax
    from repro.configs import ARCHS as J_ARCHS, RunConfig as JRunConfig
    from repro.configs.base import SHAPES as J_SHAPES
    from repro.core.policy import QuantPolicy as JQP
    from repro.nn.models import apply_policy as j_apply, build_model as j_build
    quant = "pofx8"
    cell = SHAPES[shape]
    kv = JQP.from_string(quant).kv_spec if ARCHS[arch].family != "encdec" else None
    jm = j_build(J_ARCHS[arch], JRunConfig(remat="none", sequence_parallel=False,
                                           serve_bf16_compute=True), kv_spec=kv)
    ctx, sizes = _ref_ctx(GRIDS[mesh], False)
    jp = jax.eval_shape(lambda: j_apply(jm.init(jax.random.PRNGKey(0)), JQP.from_string(quant)))
    jc = jax.eval_shape(lambda: jm.init_cache(cell.global_batch, cell.seq_len))
    model = build_model(ARCHS[arch], RunConfig(remat="none", serve_bf16_compute=True),
                        device="cpu", kv_spec=None)
    grid = GridContext(*grid_layout(*GRIDS[mesh]))
    args = dryrun.serve_arguments(model, cell, quant, grid)
    _assert_same_rank_leaves(_ref_leaves(jp, jm.logical(), ctx, sizes),
                             _port_leaves(args["params"]))
    _assert_same_rank_leaves(_ref_leaves(jc, jm.cache_logical(), ctx, sizes),
                             _port_leaves(args["cache"]), kv_layers=True)
    batch = jax.tree.map(lambda s: _ref_local(ctx, sizes, ("batch",), s.shape),
                         {"tokens": jax.ShapeDtypeStruct((cell.global_batch, 1), np.int32)})
    assert {k: tuple(v.shape) for k, v in args["batch"].items()} == batch
    assert dryrun.spec_bytes(args) == sum(dryrun.spec_bytes(v) for v in args.values()) > 0


# ---------------------------------------------------------------------------
# op_cost's rules, the host checks, cells
# ---------------------------------------------------------------------------


def test_count_step_rules_on_real_tensors():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    c = op_cost.count_step(lambda x, y: x @ y, a, b)
    assert c.flops_per_device == 2 * 8 * 16 * 4
    assert c.bytes_per_device == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert c.argument_bytes == (8 * 16 + 16 * 4) * 4 and c.output_bytes == 8 * 4 * 4
    assert c.peak_bytes == c.argument_bytes + c.output_bytes and c.alias_bytes == 0
    big, upd = torch.zeros(64, 32), torch.ones(4, 32)
    c = op_cost.count_step(lambda x, u: x[8:12].copy_(u), big, upd)
    assert c.bytes_per_device == 2 * 4 * 32 * 4 and c.flops_per_device == 0
    assert c.alias_bytes == c.output_bytes == 64 * 32 * 4
    idx = torch.tensor([1, 5, 7])
    c = op_cost.count_step(lambda x, i: x.index_select(0, i).t(), big, idx)
    assert c.bytes_per_device == 2 * 3 * 32 * 4
    c = op_cost.count_step(lambda x: torch.zeros_like(x), big)
    assert c.bytes_per_device == 64 * 32 * 4

    def temp(x):
        y = x * 2
        return (y + 1).sum()
    c = op_cost.count_step(temp, big)
    assert c.peak_bytes == 3 * 64 * 32 * 4 + 4    # x, y, y + 1 and the sum live at once


def test_collectives_count_ring_wire_bytes_in_a_fake_world():
    import torch.distributed as dist
    x = torch.ones(6, 10)
    with dryrun.fake_world(0, 16):
        world = TPContext(rank=0, size=16, group=dist.group.WORLD, backend="fake",
                          host_checks=False)
        node = dist.new_group(list(range(8)))
        local = TPContext(rank=0, size=8, group=node, backend="fake", host_checks=False)

        def step(t):
            g = world.all_gather(t, 0)
            r = local.reduce_scatter(g, 0)
            return world.all_reduce(r)
        c = op_cost.count_step(step, x)
        with pytest.raises(RuntimeError, match="host checks are off"):
            world.gather_objects(1)
        world.check_equal("nothing to compare in a fake world", 1)
    ag, rs, ar = 96 * 10 * 4, 12 * 10 * 4, 12 * 10 * 4
    assert c.n_collectives == 3
    assert c.wire_by_kind == {"all-gather": ag * 15 / 16, "reduce-scatter": rs * 7,
                              "all-reduce": 2 * ar * 15 / 16}
    assert c.wire_bytes_in_node == rs * 7
    assert c.wire_bytes_per_device == ag * 15 / 16 + rs * 7 + 2 * ar * 15 / 16
    assert not dist.is_initialized()


def test_serve_and_skipped_cells_fill_their_records():
    """The long-context cell of a full-attention arch is skipped with the
    reference's reason; a serve cell runs its decode step as one rank of
    the (2, 16, 16) grid: it fits in 80 GiB, its model flops are 2 N D,
    and its argument bytes are ``serve_arguments``' (the rank's arguments
    as the reference places them), beside the traced step's own (the
    params and cache the same, the whole batch's tokens)."""
    rec = dryrun.run_cell("llama3-405b", "long_500k", "single", verbose=False, device="cpu")
    assert rec["skipped"] and not rec["ok"] and "sub-quadratic" in rec["reason"]
    assert rec["quant"] == "pofx8"
    rec = dryrun.run_cell("zamba2-1.2b", "decode_32k", "multi", verbose=False, device="cpu")
    assert rec["ok"] and not rec.get("skipped") and rec["fits"] and rec["n_devices"] == 512
    mem, cell = rec["memory"], SHAPES["decode_32k"]
    assert 0 < mem["peak_memory_in_bytes"] <= 80 * 2**30
    assert rec["model_flops"] == 2 * ARCHS["zamba2-1.2b"].active_param_count() * cell.global_batch
    model = build_model(ARCHS["zamba2-1.2b"], dryrun.serve_run_config(), device="cpu",
                        kv_spec=QuantPolicy.from_string("pofx8").kv_spec)
    grid = GridContext(*grid_layout(*GRIDS["multi"]))
    args = dryrun.serve_arguments(model, cell, "pofx8", grid)
    parts = mem["arguments_by_part"]
    assert parts == {k: dryrun.spec_bytes(v) for k, v in args.items()}
    assert mem["argument_size_in_bytes"] == dryrun.spec_bytes(args) == sum(parts.values())
    assert parts["params"] > 0 and parts["cache"] > 0
    tokens = cell.global_batch * 4
    assert mem["traced_argument_bytes"] == parts["params"] + parts["cache"] + tokens
    assert rec["collectives"]["n_ops"] > 0 and rec["cost"]["flops_per_device"] > 0
    assert rec["run_config"]["serve_bf16_compute"] and not rec["run_config"]["use_kernel"]


def test_yi9b_train_cell_on_the_single_pod_grid(tmp_path):
    """The full-size cell, rank 0 of 256 on (16, 16): it traces, its peak
    holds its arguments, its roofline is priced and its record is saved."""
    t0 = time.perf_counter()
    assert dryrun.main(["--arch", "yi-9b", "--shape", "train_4k", "--mesh", "single",
                        "--device", "cpu", "--out", str(tmp_path)]) == 0
    wall = time.perf_counter() - t0
    import json
    rec = json.loads((tmp_path / "yi-9b__train_4k__single__bf16.json").read_text())
    assert rec["ok"] and rec["n_devices"] == 256 and rec["run_config"]["sequence_parallel"]
    mem = rec["memory"]
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert mem["alias_size_in_bytes"] > 0
    assert mem["live_bytes_per_device"] == mem["peak_memory_in_bytes"]
    r = rec["roofline"]
    assert r["bound"] in ("compute", "memory", "collective") and 0 < r["mfu_bound"] < 1
    # forward, remat's forward and backward: more flops than 6 N T, fewer than 10 N T
    assert 0.6 < r["useful_flops_ratio"] < 1.0
    assert rec["collectives"]["n_ops"] > 0 and rec["collectives"]["wire_bytes_in_node"] == 0.0
    assert set(rec["collectives"]["by_kind"]) == {"all-gather", "all-reduce", "reduce-scatter"}
    assert rec["trace_s"] <= wall
    import torch.distributed as dist
    assert not dist.is_initialized()
    assert "yi-9b | single" in dryrun.summary(str(tmp_path))
