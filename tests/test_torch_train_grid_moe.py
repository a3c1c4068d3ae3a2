"""Training the moe family across ranks: experts over model, FSDP over data,
the batch over (pod, data), on the CPU over gloo.

Three steps of the port's ``make_train_step`` on each grid at the smoke
size, f32, from the reference's seed-0 state cut to each rank's shard,
gathered back and held to the reference's bounds
(``torch_bridge.assert_steps_match``; ``grid_bridge`` has the reference's
trajectories):

* moonshot-v1-16b-a3b (every layer MoE, top-2 of 4, 2 shared experts) on
  (model 2) and (data 2, model 2), f32 and posit8 moments, with and
  without 2 microbatches, against the reference's tp = 1 step; a data
  rank routes its rows as a block of the reference's batch (its capacity,
  its positions after the ranks ahead), so with 2 microbatches of 2 rows
  the reference's step drops assignments at capacity, and the ranks drop
  as many between them;
* (pod 2, model 2) under ``grad_compression`` "posit8" and "posit8_ef"
  against the reference's pod composition (each pod routes its own rows);
* llama4-maverick-400b-a17b (a dense layer, then an MoE layer, top-1 of 4,
  1 shared expert) on (model 2); and at (model 4) with 6 query heads,
  which the model axis does not divide: wq, wk and wv replicate, wo's 192
  rows shard.
"""
import pytest

from grid_bridge import (check_init_gathers_back, check_pod_case, layout_model,
                         reference_drops, three_steps)
from torch_bridge import STEP_CASES, STEP_IDS
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

ARCH = "moonshot-v1-16b-a3b"
LLAMA4 = "llama4-maverick-400b-a17b"
GRIDS = {"model2": (1, 1, 2), "data2-model2": (1, 2, 2)}
POD_GRID = (2, 1, 2)
HEADS6 = (("n_heads", 6),)
# f32 moments: leaves holding an entry whose first step's gradient is
# rounding noise (see assert_steps_match), each bound over both grids and
# microbatch counts; readings: moonshot's shared wg 3.10e-5; llama4's (as at
# tp = 1, tests/test_torch_train_steps_llama4.py) dense wo 1.20e-4, moe wv
# 8.66e-5, shared wo 7.57e-5, and with 6 heads at model 4 shared wg 3.01e-5
NOISE = {"/blocks/moe/moe/shared/wg": 4e-5}
LLAMA4_NOISE = {"/blocks/dense/attn/wo": 2e-4, "/blocks/moe/attn/wv": 9e-5,
                "/blocks/moe/moe/shared/wo": 2e-4, "/blocks/moe/moe/shared/wg": 4e-5}
# top-1 routing: the router's gradient is zero in exact arithmetic
LLAMA4_ZERO = ("/blocks/moe/moe/router",)
# posit8 moments, one microbatch: six unembed entries take the wild step at
# the second update (v coded to 0) from gradients near zero, whose rounding
# the ranks' sums change; the third step's loss reads 1.18e-6 (model 2) and
# 1.09e-6 (data 2, model 2) relative off the reference's, and with those six
# entries set to the tp = 1 port's values the model-2 grid's loss equals the
# tp = 1 port's to 1e-9
WILD = {"/unembed": 2e-6}
# (pod 2, model 2) posit8_ef: one of ln2's 256 residual entries a code step
# apart (f32 moments with 2 microbatches, posit8 moments with one); with the
# vocab-parallel loss, one of ln_f's 128 (posit8 moments, one microbatch;
# pod 1's entry 8: 6.0492e-5 in the reference summed as the grid's two
# vocab blocks, 6.0455e-5 in the reference on whole logits, -6.0710e-5 on
# the grid): the value lay within 1.3e-7 of a code's midpoint, which each
# side rounded to its own neighbour (check_pod_case holds every such entry
# to that mirror). Against the partitioned-order reference this is the one
# entry past the gates besides ln2's (``python tests/sum_order_drift.py
# --ef-flips``; test_moe_pod_ef_flips_against_the_partitioned_reference)
EF_FLIPS = {"/blocks/moe/ln2": 1, "/ln_f": 1}


@pytest.fixture(scope="module")
def pool():
    from repro_torch.launch.mesh import RankPool
    grids = list(GRIDS.values()) + [POD_GRID, (1, 1, 4)]
    with RankPool(4, "cpu", threads=1, grids=grids, timeout_s=120) as p:
        yield p
    assert not any(proc.is_alive() for proc in p._procs)


@pytest.mark.parametrize("quant,micro", STEP_CASES, ids=STEP_IDS)
@pytest.mark.parametrize("name", list(GRIDS))
def test_moe_grid_three_steps_match_reference(pool, name, quant, micro):
    """moonshot on (model 2) and (data 2, model 2) against the reference's
    tp = 1 step; the ranks of one model coordinate drop, between them, the
    assignments the reference drops in its first step."""
    grid = GRIDS[name]
    res = three_steps(pool, ARCH, grid, quant, micro, noise=NOISE,
                      wild=WILD if micro == 0 else None)
    per_model = grid[2]
    assert sum(r["dropped"] for r in res[::per_model]) == reference_drops(ARCH, micro)


def test_capacity_trap_is_exercised():
    """With 2 microbatches of 2 rows (64 tokens, capacity 40 a expert) the
    reference's first step drops assignments, so a data rank that took its
    capacity from its own 32 tokens would drop others than the reference."""
    assert reference_drops(ARCH, 2) > 0


@pytest.mark.parametrize("quant,micro", STEP_CASES, ids=STEP_IDS)
@pytest.mark.parametrize("comp", ("posit8", "posit8_ef"))
def test_moe_pod_grid_three_steps_match_reference(pool, comp, quant, micro):
    """(pod 2, model 2) with the posit8-compressed pod mean against the
    reference's composition (``grid_bridge.check_pod_case``), each pod
    routing its own rows."""
    check_pod_case(pool, ARCH, POD_GRID, comp, quant, micro, ef_flips=EF_FLIPS)


def test_moe_pod_ef_flips_against_the_partitioned_reference(pool):
    """posit8_ef, posit8 moments, one microbatch against the reference with
    its loss summed as the grid's two vocab blocks
    (``grid_bridge.partitioned_ce``), the order in which the grid sums it:
    the same gates and exemptions as against the reference on whole
    logits."""
    check_pod_case(pool, ARCH, POD_GRID, "posit8_ef", "posit8", 0, ef_flips=EF_FLIPS, blocks=2)


@pytest.mark.parametrize("micro", (0, 2))
def test_llama4_model2_three_steps_match_reference(pool, micro):
    """llama4's interleaved dense and MoE layers on (model 2), f32 moments."""
    three_steps(pool, LLAMA4, (1, 1, 2), "none", micro, noise=LLAMA4_NOISE,
                zero_leaves=LLAMA4_ZERO)


def test_indivisible_heads_replicate_and_wo_shards(pool):
    """llama4 with 6 query heads (2 kv heads) at (model 4), f32 moments:
    the model axis divides neither, so every rank computes the attention
    whole and cuts its 48 of wo's 192 rows before the product, summed over
    model."""
    spec = layout_model(LLAMA4, (1, 1, 4), HEADS6).specs()["blocks"][0]["attn"]
    assert spec["wq"] == ("data", None, None) and spec["wo"] == ("model", "data")
    three_steps(pool, LLAMA4, (1, 1, 4), "none", 0, HEADS6, noise=LLAMA4_NOISE,
                zero_leaves=LLAMA4_ZERO)


@pytest.mark.parametrize("arch,grid", [(ARCH, (1, 2, 2)), (ARCH, (2, 1, 2)),
                                       (LLAMA4, (1, 1, 4))])
def test_grid_init_gathers_back_to_the_tp1_state(arch, grid):
    check_init_gathers_back(arch, grid)
