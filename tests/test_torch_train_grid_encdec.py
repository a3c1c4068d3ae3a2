"""Training the encdec family across ranks, and checkpoints of a grid's
state, on the CPU over gloo.

Three steps of the port's ``make_train_step`` for whisper-medium at the
smoke size (2 encoder + 2 decoder layers) on (model 2) and (data 2, model
2), f32 and posit8 moments, with and without 2 microbatches, on batches
with frames (their rows cut over the batch ranks like the tokens'), from
the reference's seed-0 state cut to each rank's shard, gathered back and
held to the reference's tp = 1 step within ``torch_bridge.
assert_steps_match``'s bounds (``grid_bridge`` has the reference's
trajectories). The encoder layers and ``enc_ln`` gather their data shards
inside each remat unit; the decoder's cross-attention reads the encoder
states through ``copy_in`` into its column-sharded wk and wv.

Checkpoints (``runtime.checkpoint.CheckpointManager`` with ``model=``) on
(data 2, model 2), posit8 moments: every rank saves, rank 0 writes the
gathered state, whose files equal a tp = 1 save's byte for byte; a restore
gives each rank its shard bit for bit, the reference's own checkpoint of
its state restores onto the grid as that state, and the resumed step
equals the uninterrupted one bit for bit.
"""
import filecmp
import os

import numpy as np
import pytest

from grid_bridge import check_init_gathers_back, layout_model, reference, three_steps
from torch_bridge import jax_compile_cache  # noqa: F401 (autouse)
from torch_bridge import (STEP_CASES, STEP_IDS, step_kw, torch_one_thread,  # noqa: F401
                          walk)
from repro_torch.convert import gather_train_state, params_to_numpy, train_state_from_numpy
from repro_torch.runtime import CheckpointManager

ARCH = "whisper-medium"
GRIDS = {"model2": (1, 1, 2), "data2-model2": (1, 2, 2)}
CKPT_GRID = (1, 2, 2)
# f32 moments: wk holds entries whose first step's gradient is rounding noise
# (see assert_steps_match), as at tp = 1 (tests/test_torch_train_steps_
# encdec.py); reading over the grids and microbatch counts 5.18e-5
NOISE = {"/blocks/attn/wk": 6e-5}


@pytest.fixture(scope="module")
def pool():
    from repro_torch.launch.mesh import RankPool
    with RankPool(4, "cpu", threads=1, grids=list(GRIDS.values()), timeout_s=120) as p:
        yield p
    assert not any(proc.is_alive() for proc in p._procs)


@pytest.mark.parametrize("quant,micro", STEP_CASES, ids=STEP_IDS)
@pytest.mark.parametrize("name", list(GRIDS))
def test_encdec_grid_three_steps_match_reference(pool, name, quant, micro):
    three_steps(pool, ARCH, GRIDS[name], quant, micro, frames=True,
                **({"noise": NOISE} if quant == "none" else {}))


@pytest.mark.parametrize("grid", [(1, 2, 2), (2, 1, 2)])
def test_grid_init_gathers_back_to_the_tp1_state(grid):
    check_init_gathers_back(ARCH, grid)


@pytest.fixture(scope="module")
def checkpoints(pool, tmp_path_factory):
    """The ranks' ``grid_ranks.checkpoint_case`` on (data 2, model 2) with
    posit8 moments, from the reference's state after one of its steps,
    which the reference's own manager saved under "ref"."""
    import jax
    from repro.runtime import CheckpointManager as JManager
    from grid_ranks import checkpoint_case
    from torch_bridge import reference_state
    root = tmp_path_factory.mktemp("grid_ckpt")
    ref = reference(ARCH, "none", "posit8", 0, frames=True)
    JManager(str(root / "ref"), async_save=False).save(
        0, jax.tree.map(np.asarray, reference_state(ARCH, "posit8")))
    case = {"arch": ARCH, "kw": step_kw("posit8", 0), "init": ref["init"],
            "batches": ref["batches"], "dir": str(root / "grid"), "ref_dir": str(root / "ref")}
    res = pool.run(checkpoint_case, case, grid=CKPT_GRID)
    return root, ref, res, layout_model(ARCH, CKPT_GRID, **step_kw("posit8", 0))


def test_grid_checkpoint_files_equal_a_tp1_save(checkpoints):
    """Rank 0 alone wrote step 1, and its manifest, leaf and scale files
    equal, byte for byte, those of a tp = 1 save of the gathered state."""
    root, _, res, lay = checkpoints
    state = train_state_from_numpy(gather_train_state([r["saved"] for r in res], lay),
                                   device="cpu")
    CheckpointManager(str(root / "tp1"), async_save=False).save(1, state)
    a, b = root / "grid" / "step_00000001", root / "tp1" / "step_00000001"
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and len(files) > 40
    for f in files:
        assert filecmp.cmp(a / f, b / f, shallow=False), f
    assert os.listdir(root / "grid") == ["step_00000001"]


def test_grid_restore_gives_each_rank_its_shard(checkpoints):
    """Every rank's restored state equals its saved shards bit for bit, and
    the reference's checkpoint of its own state restores onto the grid as
    that state."""
    _, ref, res, lay = checkpoints
    for r in res:
        for path, a, b in walk(params_to_numpy(r["saved"]), params_to_numpy(r["restored"])):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    got = gather_train_state([r["from_reference"] for r in res], lay)
    for path, a, b in walk(ref["init"], got):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path


def test_resumed_step_equals_the_uninterrupted_one(checkpoints):
    _, _, res, _ = checkpoints
    for r in res:
        pairs = list(walk(params_to_numpy(r["uninterrupted"]), params_to_numpy(r["resumed"])))
        assert len(pairs) > 40
        for path, a, b in pairs:
            assert a.tobytes() == b.tobytes(), path
