"""Training the hybrid family in the port against the reference (JAX), at
the smoke size: zamba2-1.2b (3 mamba2 layers; ONE shared attention + MLP
block, ``params["shared"]``, applied before each chunk of 2 layers and
remat'd on its own at each application, as the reference's
``_hybrid_forward`` does; its gradient sums over the applications).

Logits and every gradient leaf of ``LM.loss`` against ``jax.grad``; remat
on = off; a checkpoint round trip (the unstacked shared block's posit8
moments take a scale of their own). Tolerances as in
``tests/test_torch_train_ssm.py``; three train steps are in
``tests/test_torch_train_steps_hybrid.py``.
"""
import pytest

from torch_bridge import jax_compile_cache  # noqa: F401 (autouse)
from torch_bridge import (check_logits_and_grads, check_remat_equal, checkpoint_round_trip,
                          one_thread, train_batch, train_models)

ARCH = "zamba2-1.2b"


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def test_logits_and_loss_gradients_match_reference():
    jm, tm = train_models(ARCH, remat="block")
    assert tm._hybrid_chunks() == [2, 1]
    assert check_logits_and_grads(jm, tm, train_batch(tm.cfg, 2, 24, seed=1)) > 10


def test_remat_gives_equal_gradients():
    check_remat_equal(ARCH)


def test_checkpoint_round_trip_equals_reference(tmp_path):
    checkpoint_round_trip(ARCH, tmp_path)
