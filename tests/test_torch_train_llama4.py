"""Training llama4-maverick-400b-a17b's family shape in the port against
the reference (JAX), at the smoke size: a dense layer, then an MoE layer
(top-1 of 4, one shared expert), remat'd together as the reference's
``scan_blocks`` body remats its group of ``moe_every`` layers.

Logits and every gradient leaf of ``LM.loss`` against ``jax.grad``; remat
on = off; a checkpoint round trip (posit8 moments: one scale for each of
the reference's {"moe", "dense"} stacked leaves). Tolerances as in
``tests/test_torch_train_moe.py``; three train steps are in
``tests/test_torch_train_steps_llama4.py``.
"""
import pytest

from torch_bridge import jax_compile_cache  # noqa: F401 (autouse)
from torch_bridge import (check_logits_and_grads, check_remat_equal, checkpoint_round_trip,
                          one_thread, train_batch, train_models)

ARCH = "llama4-maverick-400b-a17b"
# top-1 routing: the gate renormalises to exactly 1, so the router's
# gradient is zero in exact arithmetic (rounding noise in both frameworks)
ZERO = ("/blocks/moe/moe/router",)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def test_logits_and_loss_gradients_match_reference():
    jm, tm = train_models(ARCH, remat="block")
    assert [("moe" in lp) for lp in tm.init(0)["blocks"]] == [False, True]
    assert check_logits_and_grads(jm, tm, train_batch(tm.cfg, 2, 24, seed=1),
                                  zero_leaves=ZERO) > 10


def test_remat_gives_equal_gradients():
    check_remat_equal(ARCH)


def test_checkpoint_round_trip_equals_reference(tmp_path):
    checkpoint_round_trip(ARCH, tmp_path)
