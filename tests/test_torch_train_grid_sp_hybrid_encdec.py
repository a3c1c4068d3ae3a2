"""Megatron sequence parallelism on a training grid for the hybrid and
encdec families, on the CPU over gloo.

Each runs three steps of the port's ``make_train_step`` with
``RunConfig(sequence_parallel=True)`` on (data 2, model 2) at the smoke
size, f32, with f32 moments and 2 microbatches and with posit8 moments
and one, from the reference's seed-0 state cut to each rank's shard,
gathered back and held to the reference's tp = 1 step under
``torch_bridge.assert_steps_match``'s bounds, with each family's
exemptions as its grid file names them (``grid_bridge`` has the
reference's trajectories):

* zamba2-1.2b: each mamba2 mixer's convolution and scan run over the
  whole sequence, and the shared attention + MLP block runs on the mamba
  layers' layout (the rank's block along seq between them);
* whisper-medium: the encoder runs on the rank's block of the frames, and
  each decoder layer's cross-attention gathers the encoder states.

The moe and ssm families: ``test_torch_train_grid_sp_moe_ssm.py``.
"""
import pytest

from grid_bridge import three_steps
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)
import test_torch_train_grid_encdec as encdec
import test_torch_train_grid_hybrid as hybrid

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
def test_hybrid_sp_grid_matches_reference(pool, quant, micro):
    three_steps(pool, hybrid.ARCH, GRID, quant, micro, run_kw=SP, **hybrid.bounds(quant))


@pytest.mark.parametrize("quant,micro", CASES, ids=IDS)
def test_encdec_sp_grid_matches_reference(pool, quant, micro):
    three_steps(pool, encdec.ARCH, GRID, quant, micro, frames=True, run_kw=SP,
                **({"noise": encdec.NOISE} if quant == "none" else {}))
