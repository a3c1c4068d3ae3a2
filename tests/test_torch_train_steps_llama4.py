"""Three steps of the port's ``make_train_step`` against the reference's
jitted step (JAX) for llama4-maverick-400b-a17b's family shape (a dense
layer, then an MoE layer, top-1 of 4; posit8 moments take one scale for
each of the reference's {"moe", "dense"} stacked leaves), at the smoke
size: f32 and posit8 moments, with and without 2 microbatches. Both
packages run f32 weights and activations; the parameters and metrics are
held to the bounds of ``tests/test_torch_train.py`` and the exceptions
that ``torch_bridge.assert_steps_match`` names and asserts. The rest of
the family's training tests are in ``tests/test_torch_train_llama4.py``.
"""
import pytest

from torch_bridge import jax_compile_cache  # noqa: F401 (autouse)
from torch_bridge import STEP_CASES, STEP_IDS, assert_steps_match, one_thread, three_steps

ARCH = "llama4-maverick-400b-a17b"
# top-1 routing: the gate renormalises to exactly 1, so the router's
# gradient is zero in exact arithmetic (rounding noise in both frameworks)
ZERO = ("/blocks/moe/moe/router",)
# f32 moments: leaves holding an entry whose first step's gradient is
# rounding noise (see assert_steps_match), with the bound over both
# microbatch counts; readings 1.72e-4, 6.01e-5 (one microbatch) and
# 1.13e-4, 5.64e-5 (two), one entry each
NOISE = {"/blocks/dense/attn/wo": 2e-4, "/blocks/moe/attn/wv": 7e-5,
         "/blocks/moe/moe/shared/wo": 2e-4, "/blocks/moe/moe/shared/wu": 6e-5}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.mark.parametrize("quant,micro", STEP_CASES, ids=STEP_IDS)
def test_three_train_steps_match_reference(quant, micro):
    assert_steps_match(quant, *three_steps(ARCH, quant, micro), zero_leaves=ZERO,
                       noise=NOISE)
