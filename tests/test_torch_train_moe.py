"""Training the moe family in the port against the reference (JAX), at
the smoke size: moonshot-v1-16b-a3b (every layer MoE, top-2 of 4, shared
experts; llama4-maverick-400b-a17b, which interleaves dense and MoE
layers, is in ``tests/test_torch_train_llama4.py``).

* ``moe_forward``'s gradients with dropped assignments against
  ``jax.grad`` of the reference's (a token whose choices all drop gets no
  gradient), and ``router_aux_loss`` on the inputs of
  ``tests/test_moe.py``'s imbalance test;
* ``LM.forward`` logits and every gradient leaf of ``LM.loss`` against
  ``jax.grad(model.loss)`` (remat per group of ``moe_every`` layers);
  remat on = off;
* the CLI.

Both packages run f32 weights and activations. Three train steps against
the reference's jitted step are in ``tests/test_torch_train_steps_moe.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, smoke as j_smoke
from repro.nn import moe as J
from repro.nn.sharding import make_ctx
from repro_torch.configs import ARCHS, smoke
from repro_torch.convert import params_from_numpy
from repro_torch.nn import moe
from torch_bridge import jax_compile_cache  # noqa: F401 (autouse)
from torch_bridge import (check_logits_and_grads, check_remat_equal, cli_trains, one_thread,
                          to_numpy_tree, train_batch, train_models)

ARCH = "moonshot-v1-16b-a3b"
# one f32 MoE layer in two frameworks (as test_torch_moe's MOE_TOL)
MOE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _layer(capacity_factor):
    jcfg = dataclasses.replace(j_smoke(J_ARCHS["moonshot-v1-16b-a3b"]), n_shared_experts=0,
                               capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(smoke(ARCHS["moonshot-v1-16b-a3b"]), n_shared_experts=0,
                               capacity_factor=capacity_factor)
    jp = J.moe_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(to_numpy_tree(jp), device="cpu")


def test_moe_forward_gradients_with_drops_match_reference():
    jcfg, tcfg, jp, tp = _layer(capacity_factor=0.5)
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    # 64 assignments into 4 experts of capacity round(32 * 2 * 0.5 / 4) = 8
    assert moe.moe_capacity(32, 16, tcfg) == 8
    ctx = make_ctx(None)
    jg, jgx = jax.grad(lambda p, x: jnp.sum(J.moe_forward(p, x, jcfg, ctx) * w),
                       argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    (moe.moe_forward(leaves, xt, tcfg) * torch.from_numpy(w)).sum().backward()
    for k in sorted(leaves):
        a = np.asarray(jg[k])
        np.testing.assert_allclose(leaves[k].grad.numpy(), a, rtol=0,
                                   atol=MOE_TOL * np.abs(a).max(), err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=MOE_TOL * np.abs(np.asarray(jgx)).max())
    # tokens whose every choice dropped: no gradient at all, in both
    dead_j = np.all(np.asarray(jgx) == 0, axis=-1)
    dead_t = torch.all(xt.grad == 0, dim=-1).numpy()
    assert dead_t.any() and (dead_j == dead_t).all()


def test_router_aux_loss_matches_reference():
    jcfg, tcfg, jp, tp = _layer(capacity_factor=100.0)
    x = np.array(jnp.abs(jax.random.normal(jax.random.PRNGKey(4), (2, 32, jcfg.d_model))))
    p_imb = dict(jp, router=jnp.zeros_like(jp["router"]).at[:, 0].set(100.0))
    t_imb = dict(tp, router=torch.from_numpy(np.array(p_imb["router"])))
    for jpp, tpp in ((jp, tp), (p_imb, t_imb)):
        want = float(J.router_aux_loss(jpp, jnp.asarray(x), jcfg))
        got = moe.router_aux_loss(tpp, torch.from_numpy(x), tcfg)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6)
    assert float(moe.router_aux_loss(t_imb, torch.from_numpy(x), tcfg)) > \
        tcfg.n_experts / tcfg.top_k * 0.5


def test_logits_and_loss_gradients_match_reference():
    jm, tm = train_models(ARCH, remat="block")
    assert check_logits_and_grads(jm, tm, train_batch(tm.cfg, 2, 24, seed=1)) > 10


def test_remat_gives_equal_gradients():
    check_remat_equal(ARCH)


def test_cli_trains_the_moe_family(capsys):
    cli_trains(ARCH, capsys)
