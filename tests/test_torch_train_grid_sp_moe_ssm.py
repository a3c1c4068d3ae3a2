"""Megatron sequence parallelism on a training grid for the moe and ssm
families, on the CPU over gloo.

Each runs three steps of the port's ``make_train_step`` with
``RunConfig(sequence_parallel=True)`` on (data 2, model 2) at the smoke
size, f32, with f32 moments and 2 microbatches and with posit8 moments
and one, from the reference's seed-0 state cut to each rank's shard,
gathered back and held to the reference's tp = 1 step under
``torch_bridge.assert_steps_match``'s bounds, with each family's
exemptions as its grid file names them (``grid_bridge`` has the
reference's trajectories):

* moonshot-v1-16b-a3b: the MoE layer gathers the whole sequence before it
  routes, so with 2 microbatches the ranks of one model coordinate drop,
  between them, exactly the assignments the reference drops;
* falcon-mamba-7b: each mixer's convolution and scan run over the whole
  sequence (in_proj reads it through ``gather_seq``).

The hybrid and encdec families: ``test_torch_train_grid_sp_hybrid_encdec.py``;
what the families share (the rules, every leaf's gradient against the grid
without sequence parallelism): ``test_torch_train_grid_sp.py``.
"""
import pytest

from grid_bridge import reference_drops, three_steps
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)
import test_torch_train_grid_moe as moe

GRID = (1, 2, 2)
SP = {"sequence_parallel": True}
CASES = [("none", 2), ("posit8", 0)]
IDS = [f"{q}-mb{m}" for q, m in CASES]


@pytest.fixture(scope="module")
def pool():
    from repro_torch.launch.mesh import RankPool
    with RankPool(4, "cpu", threads=1, grids=[GRID], timeout_s=120) as p:
        yield p
    assert not any(proc.is_alive() for proc in p._procs)


@pytest.mark.parametrize("quant,micro", CASES, ids=IDS)
def test_moe_sp_grid_matches_reference_and_its_drops(pool, quant, micro):
    res = three_steps(pool, moe.ARCH, GRID, quant, micro, run_kw=SP, noise=moe.NOISE,
                      wild=moe.WILD if micro == 0 else None)
    assert sum(r["dropped"] for r in res[::GRID[2]]) == reference_drops(moe.ARCH, micro)


@pytest.mark.parametrize("quant,micro", CASES, ids=IDS)
def test_ssm_sp_grid_matches_reference(pool, quant, micro):
    three_steps(pool, "falcon-mamba-7b", GRID, quant, micro, run_kw=SP)
