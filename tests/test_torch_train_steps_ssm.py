"""Three steps of the port's ``make_train_step`` against the reference's
jitted step (JAX) for the ssm family (falcon-mamba-7b, 2 mamba1 layers),
at the smoke size: f32 and posit8 moments, with and without 2
microbatches. Both packages run f32 weights and activations; the
parameters and metrics are held to the bounds of
``tests/test_torch_train.py`` and the exceptions that
``torch_bridge.assert_steps_match`` names and asserts. The rest of the
family's training tests are in ``tests/test_torch_train_ssm.py``.
"""
import pytest

from torch_bridge import jax_compile_cache  # noqa: F401 (autouse)
from torch_bridge import STEP_CASES, STEP_IDS, assert_steps_match, one_thread, three_steps

ARCH = "falcon-mamba-7b"


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.mark.parametrize("quant,micro", STEP_CASES, ids=STEP_IDS)
def test_three_train_steps_match_reference(quant, micro):
    assert_steps_match(quant, *three_steps(ARCH, quant, micro))
