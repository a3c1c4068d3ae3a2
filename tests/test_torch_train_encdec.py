"""Training the encdec family in the port against the reference (JAX), at
the smoke size: whisper-medium (2 encoder and 2 decoder layers), whose
batches carry encoder ``frames`` (B, Se, d_model).

* ``LM.forward`` logits and every gradient leaf of ``LM.loss`` against
  ``jax.grad(model.loss)``, with fewer frames than tokens in small
  attention chunks (the non-causal flash backward of the cross-attention
  at Sq != Skv, several kv chunks); remat on = off;
* the CLI, which, as the reference's, feeds no frames: both stop at the
  forward's assertion, in the same words;
* a checkpoint round trip.

Both packages run f32 weights and activations. Three train steps on
batches with frames are in ``tests/test_torch_train_steps_encdec.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.launch import train as j_train_cli
from repro_torch.launch import train as train_cli
from torch_bridge import jax_compile_cache  # noqa: F401 (autouse)
from torch_bridge import (check_logits_and_grads, check_remat_equal, checkpoint_round_trip,
                          one_thread, train_batch, train_models)

ARCH = "whisper-medium"


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def test_logits_and_loss_gradients_match_reference():
    """24 tokens over 20 frames, chunks of 8 (q) and 5 (kv)."""
    jm, tm = train_models(ARCH, remat="block", attn_q_chunk=8, attn_kv_chunk=8)
    batch = train_batch(tm.cfg, 2, 24, seed=1, frames=True)
    batch["frames"] = batch["frames"][:, :20]
    assert check_logits_and_grads(jm, tm, batch) > 10


def test_remat_gives_equal_gradients():
    check_remat_equal(ARCH, frames=True)


def test_forward_without_frames_stops_as_the_reference():
    jm, tm = train_models(ARCH)
    toks = np.zeros((1, 4), np.int64)
    with pytest.raises(AssertionError, match="encdec forward needs encoder frames") as ej:
        jm.forward(jax.jit(jm.init)(jax.random.PRNGKey(0)), toks)
    with pytest.raises(AssertionError) as et:
        tm.forward(tm.init(0), torch.from_numpy(toks))
    assert str(et.value) == str(ej.value)


def test_cli_refuses_whisper_where_the_reference_does():
    argv = ["--arch", ARCH, "--smoke", "--steps", "1", "--batch", "2", "--seq", "8"]
    with pytest.raises(AssertionError, match="encdec forward needs encoder frames"):
        j_train_cli.main(argv)
    with pytest.raises(AssertionError, match="encdec forward needs encoder frames"):
        train_cli.main(argv + ["--device", "cpu"])


def test_checkpoint_round_trip_equals_reference(tmp_path):
    checkpoint_round_trip(ARCH, tmp_path, frames=True)
