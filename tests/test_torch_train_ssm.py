"""Training the ssm family in the port against the reference (JAX), at
the smoke size: falcon-mamba-7b (2 mamba1 layers), and both mamba mixers'
gradients (zamba2-1.2b, the hybrid family, is trained in
``tests/test_torch_train_hybrid.py``).

* the mixers' gradients (``mamba1_mix``, ``mamba2_mix``: the chunked
  associative scan and SSD, the chunk loop that carries h, softplus as
  ``logaddexp(x, 0)``) against ``jax.grad`` of the reference's, at one
  chunk and at several, from a carried state; and finite gradients where
  the reference's SSD decay mask covers overflowing entries, against
  the port's mixer in f64;
* ``LM.forward`` logits and every gradient leaf of ``LM.loss`` against
  ``jax.grad(model.loss)``; remat on = off;
* a checkpoint round trip (three train steps are in
  ``tests/test_torch_train_steps_ssm.py``).

Both packages run f32 weights and activations; tolerances as in
``tests/test_torch_train_moe.py``; a mixer's gradients, like the model's,
within 1e-4 of each leaf's largest entry (a leaf such as A_log sums
B x S x d_inner terms).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, smoke as j_smoke
from repro.nn import ssm as J
from repro_torch.configs import ARCHS, smoke
from repro_torch.convert import params_from_numpy
from repro_torch.nn import ssm
from torch_bridge import jax_compile_cache  # noqa: F401 (autouse)
from torch_bridge import (check_logits_and_grads, check_remat_equal, checkpoint_round_trip,
                          one_thread, to_numpy_tree, train_batch, train_models)

ARCH = "falcon-mamba-7b"
# one f32 mixer's gradients in two frameworks, of each leaf's largest entry
GRAD_TOL = 1e-4
VARIANTS = {"mamba1": ("falcon-mamba-7b", J.mamba1_init, J.mamba1_mix, ssm.mamba1_mix),
            "mamba2": ("zamba2-1.2b", J.mamba2_init, J.mamba2_mix, ssm.mamba2_mix)}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _mixer_grads(variant, S, *, carried, a_log_shift=0.0, t_dtype=torch.float32):
    """Gradients of sum(y * w) + sum(h_last * u) with respect to the input
    and every weight, in both frameworks (smoke chunk 16); the port's
    leaves and inputs in ``t_dtype``."""
    arch, j_init, j_mix, t_mix = VARIANTS[variant]
    jcfg, tcfg = j_smoke(J_ARCHS[arch]), smoke(ARCHS[arch])
    jp = dict(j_init(jax.random.PRNGKey(1), jcfg))
    jp["A_log"] = jp["A_log"] + a_log_shift
    tp = params_from_numpy(to_numpy_tree(jp), device="cpu")
    di, ds = tcfg.d_inner, tcfg.ssm_state
    width = 2 * di if variant == "mamba1" else 2 * di + 2 * ds + di // tcfg.ssm_head_dim
    rng = np.random.RandomState(S)
    xz = rng.standard_normal((2, S, width)).astype(np.float32)
    cache = ssm.mamba_init_cache(tcfg, 1, 2, "cpu")
    conv = (0.5 * rng.standard_normal(cache["conv"].shape[1:])).astype(np.float32)
    h0 = (0.5 * rng.standard_normal(cache["ssm"].shape[1:])).astype(np.float32)
    w = rng.standard_normal((2, S, di)).astype(np.float32)
    u = rng.standard_normal(h0.shape).astype(np.float32)
    kw = (lambda c, h: {"conv_state": c, "ssm_state": h}) if carried else (lambda c, h: {})

    def jf(p, xz, c, h):
        y, _, hl = j_mix(p, xz, jcfg, **kw(c, h))
        return jnp.sum(y * w) + jnp.sum(hl * u)
    jg = jax.grad(jf, argnums=(0, 1, 2, 3))(jp, jnp.asarray(xz), jnp.asarray(conv),
                                           jnp.asarray(h0))
    leaves = {k: v.to(t_dtype).requires_grad_() for k, v in tp.items()}
    ins = [torch.from_numpy(a).to(t_dtype).requires_grad_() for a in (xz, conv, h0)]
    y, _, hl = t_mix(leaves, ins[0], tcfg, **kw(ins[1], ins[2]))
    ((y * torch.from_numpy(w).to(t_dtype)).sum()
     + (hl * torch.from_numpy(u).to(t_dtype)).sum()).backward()
    want = dict(jg[0], xz=jg[1], conv=jg[2], h0=jg[3])
    got = dict({k: v.grad for k, v in leaves.items()}, xz=ins[0].grad, conv=ins[1].grad,
               h0=ins[2].grad)
    return want, got


@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
@pytest.mark.parametrize("S,carried", [(16, False), (33, True)])
def test_mixer_gradients_match_reference(variant, S, carried):
    """S = 16: one chunk; 33: three chunks of 11, carrying h."""
    want, got = _mixer_grads(variant, S, carried=carried)
    for k, a in want.items():
        a = np.asarray(a)
        if (not carried and k in ("conv", "h0")) or k in ("in_proj", "out_proj"):
            # the fresh states are not inputs; the projections are outside the mixer
            assert got[k] is None and not a.any(), k
            continue
        g = got[k]
        assert g is not None and torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), a, rtol=0, atol=GRAD_TOL * np.abs(a).max(),
                                   err_msg=k)


def test_ssd_gradients_finite_where_the_mask_covers_overflow(monkeypatch):
    """A = -exp(A_log + 6): within a chunk of 16 the log decays sum to
    about -1e4, so the masked i > t entries of the reference's SSD exponent
    (cum_t - cum_i) are about +1e4, whose exp would overflow; the mask
    comes before the exp, so no inf * 0 reaches the gradient. The i <= t
    differences keep only the cumulative sums' ulps: the reference's f32
    A_log gradient is 0 where the exact one, the port's mixer evaluated in
    f64, is 4.1e-10 (one head). The port sums each segment's decays
    itself; its every gradient is finite and within GRAD_TOL of each
    leaf's largest entry of the f64 one and of the reference's, but for
    A_log, which the reference's cancellation zeroes."""
    want, got = _mixer_grads("mamba2", 32, carried=True, a_log_shift=6.0)
    monkeypatch.setattr(ssm, "_f32", torch.float64)
    monkeypatch.setattr(ssm, "rmsnorm", lambda x, w, eps: (
        x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w))
    _, exact = _mixer_grads("mamba2", 32, carried=True, a_log_shift=6.0,
                            t_dtype=torch.float64)
    for k, a in want.items():
        a = np.asarray(a)
        if k in ("in_proj", "out_proj"):
            continue
        e = exact[k].numpy()
        assert np.isfinite(a).all() and torch.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k].numpy(), e, rtol=0,
                                   atol=GRAD_TOL * np.abs(e).max() + 1e-30, err_msg=k)
        if k == "A_log":
            assert not a.any() and np.abs(e).max() > 1e-10, (a, e)
            continue
        np.testing.assert_allclose(got[k].numpy(), a, rtol=0,
                                   atol=GRAD_TOL * np.abs(a).max() + 1e-30, err_msg=k)


def test_logits_and_loss_gradients_match_reference():
    jm, tm = train_models(ARCH, remat="block")
    # 24 tokens: two chunks of 12 at the smoke chunk of 16
    assert check_logits_and_grads(jm, tm, train_batch(tm.cfg, 2, 24, seed=1)) > 10


def test_remat_gives_equal_gradients():
    check_remat_equal(ARCH)


def test_checkpoint_round_trip_equals_reference(tmp_path):
    checkpoint_round_trip(ARCH, tmp_path)
