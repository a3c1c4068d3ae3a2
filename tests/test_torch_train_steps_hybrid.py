"""Three steps of the port's ``make_train_step`` against the reference's
jitted step (JAX) for the hybrid family (zamba2-1.2b; the unstacked
shared block's posit8 moments take a scale of their own), at the smoke
size: f32 and posit8 moments, with and without 2 microbatches. Both
packages run f32 weights and activations; the parameters and metrics are
held to the bounds of ``tests/test_torch_train.py`` and the exceptions
that ``torch_bridge.assert_steps_match`` names and asserts. The rest of
the family's training tests are in ``tests/test_torch_train_hybrid.py``.
"""
import pytest

from torch_bridge import jax_compile_cache  # noqa: F401 (autouse)
from torch_bridge import STEP_CASES, STEP_IDS, assert_steps_match, one_thread, three_steps

ARCH = "zamba2-1.2b"
# f32 moments: the leaf holding entries whose first step's gradient is
# rounding noise (see assert_steps_match): two entries, 5.28e-5 (one
# microbatch) and 5.30e-5 (two)
NOISE = {"/blocks/mix/in_proj": 6e-5}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.mark.parametrize("quant,micro", STEP_CASES, ids=STEP_IDS)
def test_three_train_steps_match_reference(quant, micro):
    assert_steps_match(quant, *three_steps(ARCH, quant, micro), noise=NOISE)
