"""The port's AdamW (``repro_torch/optim/adamw.py``) against the
reference's ``repro/optim/adamw.py`` at the smoke size.

The reference's yi-9b smoke parameters (f32) and one reference step's
optimizer state are carried across with ``convert``; both packages then
take the same step on the same random gradients. f32 moments agree to
1e-6. posit8 moments: the codes are the reference's except one-step
flips at rounding boundaries (two frameworks' f32 moments differ by an
ulp), on at most 0.1 % of entries, and the parameters stay allclose.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, RunConfig as JRunConfig, smoke as j_smoke
from repro.nn.models import build_model as j_build_model
from repro.optim import (OptConfig as JOpt, apply_updates as j_apply,
                         global_norm as j_global_norm, init_opt_state as j_init,
                         lr_schedule as j_lr)
from repro_torch.convert import params_from_numpy, params_to_numpy, train_state_from_numpy
from repro_torch.core.quantizers import QuantizedTensor
from repro_torch.optim import (OptConfig, apply_updates, global_norm, init_opt_state,
                               lr_schedule, tree_leaves)
from torch_bridge import to_numpy_tree
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

TOL = 1e-6


@pytest.fixture(scope="module")
def ref_params():
    jm = j_build_model(j_smoke(J_ARCHS["yi-9b"]), JRunConfig(weight_dtype="f32"))
    return jax.jit(jm.init)(jax.random.PRNGKey(0))


def _grads(params, seed, scale=1e-2):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
                        params)


@pytest.mark.parametrize("step", [0, 1, 5, 50, 99, 100, 101, 500, 999, 1000, 2000])
def test_lr_schedule(step):
    for kw in ({}, {"warmup_steps": 0, "total_steps": 10}, {"min_lr_frac": 0.0}):
        want = float(j_lr(jnp.asarray(step, jnp.int32), JOpt(**kw)))
        got = float(lr_schedule(torch.tensor(step, dtype=torch.int32), OptConfig(**kw)))
        assert got == pytest.approx(want, rel=TOL, abs=1e-12), kw


def test_global_norm(ref_params):
    g = _grads(ref_params, 3)
    tp = params_from_numpy(to_numpy_tree(g), device="cpu")
    assert float(global_norm(tp)) == pytest.approx(float(j_global_norm(g)), rel=TOL)


def _one_step_both(ref_params, quant, **okw):
    """The reference's state after one step, carried across; then one more
    step in both packages. Returns (reference state, port state, metrics)."""
    jo = JOpt(learning_rate=1e-3, warmup_steps=1, total_steps=10, quant=quant, **okw)
    to = OptConfig(**dataclasses.asdict(jo))
    j_step = jax.jit(lambda p, g, o: j_apply(p, g, o, jo))
    p1, o1, _ = j_step(ref_params, _grads(ref_params, 1), j_init(ref_params, quant))
    t_state = train_state_from_numpy(to_numpy_tree({"params": p1, "opt": o1}), device="cpu")
    g2 = _grads(ref_params, 2, scale=1.0)
    p2, o2, jm = j_step(p1, g2, o1)
    tg = params_from_numpy(to_numpy_tree(g2), device="cpu")
    _, _, tm = apply_updates(t_state["params"], tg, t_state["opt"], to)
    return to_numpy_tree({"params": p2, "opt": o2}), params_to_numpy(t_state), jm, tm


def _pairs(a, b, path=""):
    if isinstance(a, dict) and set(a) == {"codes", "scale", "spec"}:
        yield path, a, b
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_apply_updates_f32_moments(ref_params, clip):
    want, got, jm, tm = _one_step_both(ref_params, "none", grad_clip=clip)
    for k in ("lr", "grad_norm", "param_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=TOL), k
    for path, a, b in _pairs(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL * np.abs(a).max(), err_msg=path)


def test_apply_updates_posit8_moments(ref_params):
    want, got, jm, tm = _one_step_both(ref_params, "posit8")
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=TOL)
    flips = total = 0
    for path, a, b in _pairs(want, got):
        if isinstance(a, dict):
            assert a["spec"] == b["spec"] == "posit8es2@tensor", path
            assert a["codes"].dtype == b["codes"].dtype == np.uint8, path
            # one scale over the reference's whole stacked leaf, kept whole
            assert a["scale"].shape == b["scale"].shape == (1,) * a["codes"].ndim, path
            np.testing.assert_allclose(b["scale"], a["scale"], rtol=TOL, err_msg=path)
            # posit codes order like two's-complement integers: a step is +-1 as int8
            step = np.abs(a["codes"].view(np.int8).astype(int) - b["codes"].view(np.int8))
            assert step.max() <= 1, (path, step.max())
            flips += int((step != 0).sum())
            total += step.size
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=path)
    assert flips <= 1e-3 * total, (flips, total)


def test_decay_counts_the_reference_stacked_axes(ref_params):
    """A layer's norm weight (d,) decays as the reference's (L, d) stack
    does; ln_f (d,) is not stacked and does not."""
    tp = params_from_numpy(to_numpy_tree(ref_params), device="cpu")
    before = {k: v.clone() for k, v in (("ln1", tp["blocks"][0]["ln1"]), ("ln_f", tp["ln_f"]))}
    zero = [torch.zeros_like(p) for p in tree_leaves(tp)]
    apply_updates(tp, zero, init_opt_state(tp), OptConfig(warmup_steps=0, weight_decay=0.5))
    assert not torch.equal(tp["blocks"][0]["ln1"], before["ln1"])
    assert torch.equal(tp["ln_f"], before["ln_f"])


@pytest.mark.parametrize("quant", ["none", "posit8"])
def test_chunked_update_is_bit_identical(ref_params, quant, monkeypatch):
    """The update walks each leaf in chunks; the chunk size moves no bit."""
    from repro_torch.optim import adamw
    outs = []
    for chunk in (adamw.CHUNK, 1000):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        tp = params_from_numpy(to_numpy_tree(ref_params), device="cpu")
        g = params_from_numpy(to_numpy_tree(_grads(ref_params, 4)), device="cpu")
        opt = init_opt_state(tp, quant)
        for _ in range(2):
            apply_updates(tp, g, opt, OptConfig(quant=quant, warmup_steps=1))
        outs.append(params_to_numpy({"params": tp, "opt": opt}))
    for path, a, b in _pairs(*outs):
        if isinstance(a, dict):
            assert np.array_equal(a["codes"], b["codes"]) and np.array_equal(
                a["scale"], b["scale"]), path
        else:
            assert np.array_equal(a, b), path


def test_init_opt_state_matches_reference(ref_params):
    tp = params_from_numpy(to_numpy_tree(ref_params), device="cpu")
    for quant in ("none", "posit8"):
        want = to_numpy_tree(j_init(ref_params, quant))
        got = params_to_numpy({"params": tp, "opt": init_opt_state(tp, quant)})["opt"]
        for path, a, b in _pairs(want, got):
            if isinstance(a, dict):
                assert np.array_equal(a["codes"], b["codes"]), path
                np.testing.assert_allclose(b["scale"], a["scale"], rtol=TOL)
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b), path
    posit8 = init_opt_state(tp, "posit8")
    assert all(isinstance(m, QuantizedTensor) and m.codes.dtype == torch.uint8
               for m in tree_leaves(posit8["m"]))
    with pytest.raises(ValueError, match="moment format"):
        init_opt_state(tp, "posit7")
