"""The dry run's fake world counts what real ranks count.

Each case runs one ``make_train_step`` of a smoke-size model on the (data 2,
model 2) grid twice: as four real gloo ranks (a module-scoped
``launch.mesh.RankPool``; rank side ``grid_ranks.cost_case``) on real
tensors, and as rank r of a fake world of 4 (``launch.dryrun.fake_world``,
the groups of ``launch.mesh.grid_groups`` over the "fake" backend) on fake
tensors (``dryrun.dry_train_step``), both under ``launch.op_cost.count_step``.
Per rank the flops, HBM bytes, bytes on the wire by kind and the count of
collectives must be equal, for each family (dense, moe, ssm, hybrid,
encdec) and for dense with sequence parallelism.

The same pool holds the grid's vocab-parallel loss
(``nn.sharding.vocab_parallel_ce``) against the reference's ``ce_loss`` on
the whole logits, and a fake world shows that ``train_step`` moves only a
rank's rows of the batch to the device.
"""
import math

import numpy as np
import pytest
import torch

from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)
from repro_torch.configs import ARCHS, RunConfig, smoke
from repro_torch.launch.dryrun import dry_train_step, fake_world
from repro_torch.launch.mesh import grid_groups, grid_layout
from repro_torch.nn.models import TensorSpec, build_model
from repro_torch.nn.sharding import GridContext

GRID = (1, 2, 2)
B, S = 8, 16
CASES = {
    "dense": ("yi-9b", dict(opt_state_quant="posit8")),
    "dense-sp": ("yi-9b", dict(sequence_parallel=True, microbatch=2)),
    "moe": ("moonshot-v1-16b-a3b", dict(opt_state_quant="posit8")),
    "ssm": ("falcon-mamba-7b", dict()),
    "hybrid": ("zamba2-1.2b", dict(opt_state_quant="posit8")),
    "encdec": ("whisper-medium", dict(sequence_parallel=True)),
}


@pytest.fixture(scope="module")
def pool():
    from repro_torch.launch.mesh import RankPool
    with RankPool(4, "cpu", threads=1, grids=[GRID], timeout_s=120) as p:
        yield p
    assert not any(proc.is_alive() for proc in p._procs)


def _specs(cfg):
    specs = {"tokens": TensorSpec((B, S), torch.int32), "labels": TensorSpec((B, S), torch.int32)}
    if cfg.family == "encdec":
        specs["frames"] = TensorSpec((B, S, cfg.d_model), torch.bfloat16)
    return specs


def _batch(specs):
    rng = np.random.default_rng(0)
    out = {}
    for k, s in specs.items():
        if s.dtype == torch.int32:
            out[k] = torch.from_numpy(rng.integers(0, 500, s.shape, dtype=np.int32))
        else:
            out[k] = torch.from_numpy(rng.standard_normal(s.shape, dtype=np.float32)).to(s.dtype)
    return out


def _fake_cost(arch, run_kw, rank, specs):
    shape, names = grid_layout(*GRID)
    with fake_world(rank, math.prod(shape)):
        grid = GridContext(shape, names, rank, grid_groups(shape, names, rank, "fake"), "fake")
        model = build_model(smoke(ARCHS[arch]), RunConfig(**run_kw), device="cpu", grid=grid)
        cost, _ = dry_train_step(model, specs, grid)
    return {"flops": cost.flops_per_device, "bytes": cost.bytes_per_device,
            "wire_by_kind": cost.wire_by_kind, "n_collectives": cost.n_collectives,
            "wire": cost.wire_bytes_per_device}


@pytest.mark.parametrize("case", list(CASES))
def test_fake_world_counts_what_real_ranks_count(pool, case):
    import grid_ranks
    arch, run_kw = CASES[case]
    specs = _specs(smoke(ARCHS[arch]))
    real = pool.run(grid_ranks.cost_case, arch, run_kw, _batch(specs), grid=GRID)
    for rank, want in enumerate(real):
        got = _fake_cost(arch, run_kw, rank, specs)
        assert want["n_collectives"] > 0 and want["flops"] > 0, (case, rank, want)
        for key in ("flops", "bytes", "wire_by_kind", "n_collectives", "wire"):
            assert got[key] == want[key], (case, rank, key, got[key], want[key])


# (arch, RunConfig fields, config fields, z_weight, CE_PASS or None) of the
# vocab-parallel loss's cases: two take the rank's 64 rows in passes of 5
# (CE_PASS of 5 rows of a vocab block of 256); the last keeps a tied
# embedding's vocab whole (posit8 compression replicates it, as the
# reference's LM.logical does), so the loss there is ce_loss of the whole
# logits
LOSS_CASES = {
    "yi-9b": ("yi-9b", {}, None, 0.0, None),
    "moonshot": ("moonshot-v1-16b-a3b", {}, None, 0.0, None),
    "whisper": ("whisper-medium", {}, None, 0.0, 5 * 256),
    "yi-9b-sp": ("yi-9b", dict(sequence_parallel=True), None, 0.0, None),
    "tied": ("yi-9b", {}, {"tie_embeddings": True}, 0.0, None),
    "z-weight": ("yi-9b", {}, None, 1e-4, 5 * 256),
    "tied-replicated": ("yi-9b", dict(grad_compression="posit8"), {"tie_embeddings": True},
                        0.0, None),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_vocab_parallel_loss_matches_the_references_ce_loss(pool, case):
    """The grid's loss on each rank's vocab block (``vocab_parallel_ce``) at
    f32 against the reference's ``ce_loss`` on the rank's rows' whole
    logits: the loss within 1e-6 relative, and every gradient leaf within
    1e-5 of its largest entry of the gradient that the reference's
    d ce_loss / d logits gives through the same model (each rank's whole
    logits times that gradient, summed, differentiated). The loss adds
    three all-reduces of a float a row to the step and no gather
    (``op_cost.count_step`` of the step against the same step with a plain
    sum of the logits block in the loss's place); a vocab the model axis
    does not cut adds none."""
    import grid_ranks
    import jax
    import jax.numpy as jnp
    from repro.nn.models import ce_loss as j_ce_loss
    from repro_torch.launch.hlo_analysis import wire_bytes
    arch, run_kw, over, z, ce_pass = LOSS_CASES[case]
    cfg = smoke(ARCHS[arch])
    batch = _batch(_specs(cfg))
    res = pool.run(grid_ranks.vocab_loss_case, arch, run_kw, over, z, ce_pass, batch,
                   grid=GRID)
    ref = jax.jit(jax.value_and_grad(lambda lg, lb: j_ce_loss(lg, lb, z_weight=z)))
    ups = []
    for rank, r in enumerate(res):
        assert r["sharded"] == (case != "tied-replicated"), (case, rank)
        want, dlogits = ref(jnp.asarray(r["logits"]), jnp.asarray(r["labels"]))
        assert abs(r["loss"] - float(want)) <= 1e-6 * abs(float(want)), (case, rank, r["loss"])
        if not z:
            assert r["model_loss"] == r["loss"], (case, rank)
        ups.append(np.asarray(dlogits))
        got, plain = r["loss_cost"], r["plain_cost"]
        rows = r["labels"].size
        extra = 3 if r["sharded"] else 0
        assert got["n_collectives"] - plain["n_collectives"] == extra, (case, rank)
        kinds = set(got["wire_by_kind"]) | set(plain["wire_by_kind"])
        for kind in kinds:
            added = got["wire_by_kind"].get(kind, 0.0) - plain["wire_by_kind"].get(kind, 0.0)
            want_added = extra * wire_bytes("all-reduce", rows * 4, GRID[2]) \
                if kind == "all-reduce" else 0.0
            assert added == want_added, (case, rank, kind, added, want_added)
    # each rank's gradient of its whole logits, sent back through the model
    back = pool.run(grid_ranks.vocab_loss_case, arch, run_kw, over, z, ce_pass, batch, ups,
                    grid=GRID)
    for rank_grads, r in zip(back, res):
        assert len(rank_grads) == len(r["grads"]) > 10
        for i, (a, b) in enumerate(zip(rank_grads, r["grads"])):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, (case, i)
            assert np.isfinite(b).all(), (case, i)
            assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), (case, i)


def test_train_step_moves_only_the_ranks_rows(monkeypatch):
    """``train_step`` cuts the global batch where it lies (the dry run's:
    on the "meta" device, the host's) and copies to the device only the
    rank's rows of each microbatch: whisper (frames too) with 2
    microbatches on (data 2, model 2), ranks 0 and 3 of a fake world of
    4, 2 of the 8 rows a copy; the dry run's arguments are the rank's
    state and its 4 rows, no more."""
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import abstract_mode
    from repro_torch.launch.op_cost import _storage_bytes
    from repro_torch.launch.train import abstract_train_state
    moved = []
    real = train._on_device

    def spy(batch, device):
        out = real(batch, device)
        moved.append({k: (tuple(v.shape), v.device.type) for k, v in out.items()})
        return out

    monkeypatch.setattr(train, "_on_device", spy)
    cfg = smoke(ARCHS["whisper-medium"])
    specs = _specs(cfg)
    row_bytes = sum(math.prod(s.shape[1:]) * s.dtype.itemsize for s in specs.values())
    shape, names = grid_layout(*GRID)
    for rank in (0, 3):                 # (data 0, model 0) and (data 1, model 1)
        moved.clear()
        with fake_world(rank, math.prod(shape)):
            grid = GridContext(shape, names, rank, grid_groups(shape, names, rank, "fake"),
                               "fake")
            model = build_model(cfg, RunConfig(microbatch=2), device="cpu", grid=grid)
            cost, _ = dry_train_step(model, specs, grid)
            with abstract_mode() as mode:
                state_bytes = sum(_storage_bytes(abstract_train_state(model, mode)).values())
        assert len(moved) == 2, (rank, moved)
        for mb in moved:
            assert set(mb) == set(specs), mb
            for k, (shp, dev) in mb.items():
                assert shp == (B // 4,) + tuple(specs[k].shape[1:]) and dev == "cpu", (k, shp)
        assert cost.argument_bytes == state_bytes + (B // 2) * row_bytes, (rank, cost)
