"""Training the hybrid family across ranks: mamba2's channels and heads over
model, the shared attention + MLP block as the dense family's, FSDP over
data, on the CPU over gloo.

Three steps of the port's ``make_train_step`` for zamba2-1.2b at the smoke
size (3 mamba2 layers, two applications of the shared block; in_proj 552
columns = z 256 | x B C 288 | dt 8) from the reference's seed-0 state cut
to each rank's shard, gathered back and held to the reference's tp = 1
step within ``torch_bridge.assert_steps_match``'s bounds (``grid_bridge``
has the reference's trajectories):

* (model 2) and (data 2, model 2), f32 and posit8 moments, with and
  without 2 microbatches;
* (model 4), where every mixer dim divides (552 = 4 x 138);
* (model 4) with d_inner 192 (6 heads; in_proj 422 columns, conv 224):
  the layout the full size's smoke config takes at model 16. in_proj and
  the heads' leaves (A_log, dt_bias, D) replicate while conv and the
  d_inner leaves (norm_w, out_proj) shard: the ranks run every head and
  normalize every channel, then keep their own.
"""
import pytest

from grid_bridge import check_init_gathers_back, layout_model, three_steps
from torch_bridge import STEP_CASES, STEP_IDS
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

ARCH = "zamba2-1.2b"
GRIDS = {"model2": (1, 1, 2), "data2-model2": (1, 2, 2)}
MIXED = (("d_inner", 192),)
# f32 moments: leaves holding an entry whose first step's gradient is
# rounding noise (see assert_steps_match), each bound over the grids and
# microbatch counts; readings: in_proj 8.10e-5 (as at tp = 1,
# tests/test_torch_train_steps_hybrid.py), out_proj 3.32e-5, embed 3.54e-5;
# d_inner 192 at model 4: the shared block's wo 9.89e-5 and wi 4.43e-5
NOISE = {"/blocks/mix/in_proj": 9e-5, "/blocks/mix/out_proj": 4e-5, "/embed": 4e-5}
MIXED_NOISE = {"/shared/attn/wo": 1e-4, "/shared/mlp/wi": 5e-5}
# posit8 moments: one of norm_w's 768 entries (3 layers x 256) a moment code
# step apart (1.17e-4)
FLIPS = {"/blocks/mix/norm_w": 1}


@pytest.fixture(scope="module")
def pool():
    from repro_torch.launch.mesh import RankPool
    grids = list(GRIDS.values()) + [(1, 1, 4)]
    with RankPool(4, "cpu", threads=1, grids=grids, timeout_s=120) as p:
        yield p
    assert not any(proc.is_alive() for proc in p._procs)


def bounds(quant):
    return {"noise": NOISE} if quant == "none" else {"flips": FLIPS}


@pytest.mark.parametrize("quant,micro", STEP_CASES, ids=STEP_IDS)
@pytest.mark.parametrize("name", list(GRIDS))
def test_hybrid_grid_three_steps_match_reference(pool, name, quant, micro):
    three_steps(pool, ARCH, GRIDS[name], quant, micro, **bounds(quant))


@pytest.mark.parametrize("quant", ("none", "posit8"))
def test_model4_three_steps_match_reference(pool, quant):
    three_steps(pool, ARCH, (1, 1, 4), quant, 0, **bounds(quant))


def test_replicated_in_proj_and_heads_with_sharded_channels(pool):
    """d_inner 192 at (model 4), f32 moments: in_proj (422 columns), A_log,
    dt_bias and D whole on every rank, conv_w (224 channels), norm_w and
    out_proj cut."""
    mix = layout_model(ARCH, (1, 1, 4), MIXED).specs()["blocks"][0]["mix"]
    assert mix == {"A_log": (None,), "D": (None,), "conv_b": ("model",),
                   "conv_w": (None, "model"), "dt_bias": (None,),
                   "in_proj": ("data", None), "norm_w": ("model",),
                   "out_proj": ("model", "data")}
    three_steps(pool, ARCH, (1, 1, 4), "none", 0, MIXED, noise=MIXED_NOISE)


@pytest.mark.parametrize("grid", [(1, 2, 2), (1, 1, 4)])
def test_grid_init_gathers_back_to_the_tp1_state(grid):
    check_init_gathers_back(ARCH, grid)
