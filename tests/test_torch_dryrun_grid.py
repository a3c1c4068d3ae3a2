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


@pytest.mark.parametrize("arch", ["yi-9b", "moonshot-v1-16b-a3b", "whisper-medium"])
def test_chunked_grid_loss_matches_the_whole_gather(pool, arch):
    """The grid's loss gathered a chunk of positions at a time (here 5
    positions of the smoke vocab a chunk, 4 * 16 rows a rank: 13 chunks)
    against the loss gathered whole, at f32: the loss within 1e-6, every
    gradient leaf within 1e-5 of its largest entry (the gathered chunk's
    layout changes the order of a row's sums, so the bits may part), and
    some leaves' bits apart, so the chunked path did run."""
    import grid_ranks
    cfg = smoke(ARCHS[arch])
    chunk = 5 * cfg.padded_vocab
    res = pool.run(grid_ranks.chunked_loss_case, arch, chunk, _batch(_specs(cfg)), grid=GRID)
    apart = 0
    for rank, ((loss, grads), (c_loss, c_grads)) in enumerate(res):
        assert len(grads) == len(c_grads) > 10
        for i, (a, b) in enumerate(zip(grads, c_grads)):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, (arch, rank, i)
            assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), (arch, rank, i)
            apart += a.tobytes() != b.tobytes()
        assert abs(c_loss - loss) <= 1e-6 * abs(loss), (arch, rank, loss, c_loss)
    assert apart > 0
