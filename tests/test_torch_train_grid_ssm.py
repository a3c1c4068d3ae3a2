"""Training the ssm family across ranks: mamba1's channels over model,
FSDP over data, the batch over data, on the CPU over gloo.

Three steps of the port's ``make_train_step`` for falcon-mamba-7b at the
smoke size (2 mamba1 layers, d_inner 256) on (model 2) and (data 2, model
2), f32 and posit8 moments, with and without 2 microbatches, from the
reference's seed-0 state cut to each rank's shard, gathered back and held
to the reference's tp = 1 step within ``torch_bridge.assert_steps_match``'s
bounds (``grid_bridge`` has the reference's trajectories). Every mixer leaf
holds the block the reference's training rules give it: in_proj's 512
columns in contiguous blocks (at model 2, rank 0 all of x's and rank 1 all
of z's), the rank's channels of conv, dt_proj, dt_bias, A_log and D, and
the rank's rows of x_proj (its partial (dt, B, C) summed over model) and
out_proj.
"""
import pytest

from grid_bridge import check_init_gathers_back, layout_model, three_steps
from torch_bridge import STEP_CASES, STEP_IDS
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

ARCH = "falcon-mamba-7b"
GRIDS = {"model2": (1, 1, 2), "data2-model2": (1, 2, 2)}


@pytest.fixture(scope="module")
def pool():
    from repro_torch.launch.mesh import RankPool
    with RankPool(4, "cpu", threads=1, grids=list(GRIDS.values()), timeout_s=120) as p:
        yield p
    assert not any(proc.is_alive() for proc in p._procs)


@pytest.mark.parametrize("quant,micro", STEP_CASES, ids=STEP_IDS)
@pytest.mark.parametrize("name", list(GRIDS))
def test_ssm_grid_three_steps_match_reference(pool, name, quant, micro):
    three_steps(pool, ARCH, GRIDS[name], quant, micro)


def test_mixer_leaves_take_the_training_rules_blocks():
    """At (data 2, model 2) every mamba1 leaf's spec names model on its
    channel dim (and data on d_model), as ``make_ctx`` has it."""
    mix = layout_model(ARCH, (1, 2, 2)).specs()["blocks"][0]["mix"]
    assert mix == {"A_log": ("model", None), "D": ("model",), "conv_b": ("model",),
                   "conv_w": (None, "model"), "dt_bias": ("model",),
                   "dt_proj": (None, "model"), "in_proj": ("data", "model"),
                   "out_proj": ("model", "data"), "x_proj": ("model", None)}


@pytest.mark.parametrize("grid", [(1, 2, 2), (1, 1, 4)])
def test_grid_init_gathers_back_to_the_tp1_state(grid):
    check_init_gathers_back(ARCH, grid)
