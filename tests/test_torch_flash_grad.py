"""The port's flash attention backward (``nn/attention.py::_Flash``)
against ``jax.grad`` of the reference's ``flash_attention`` (its custom
VJP, ``_flash_bwd_rule``) at f32, and the serving forward unchanged by it.

Same inputs from numpy seeds; causal and not, several q/kv chunkings, a
``bias_offset`` (k positions leading q's, prefill against a prefix).
Two frameworks sum in different orders: atol/rtol 5e-5 at f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.attention import flash_attention as j_flash
from repro.nn.sharding import make_ctx
from repro_torch.nn import attention as A
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

CTX = make_ctx(None)
TOL = 5e-5

CASES = [  # (Sq, Skv, q_chunk, kv_chunk, bias_offset)
    (16, 16, 4, 8, 0),
    (16, 16, 16, 16, 0),
    (12, 20, 4, 5, 8),
    (8, 24, 3, 6, 16),
    (15, 15, 4, 6, 0),      # chunks that do not divide: _divisor_chunk picks 3 and 5
]


def _inputs(seed, Sq, Skv, B=2, G=2, R=3, Dh=8):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, Sq, G, R, Dh), f(B, Skv, G, Dh), f(B, Skv, G, Dh), f(B, Sq, G, R, Dh)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_flash_grads_match_reference(causal, case):
    Sq, Skv, qc, kvc, off = case
    q, k, v, do = _inputs(sum(case), Sq, Skv)

    def j_out(q, k, v):
        return j_flash(q, k, v, causal=causal, q_chunk=qc, kv_chunk=kvc, ctx=CTX,
                       mode="kv", bias_offset=off)

    jo = j_out(q, k, v)
    jg = jax.grad(lambda *a: jnp.sum(j_out(*a) * do), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    to = A.flash_attention(tq, tk, tv, causal=causal, q_chunk=qc, kv_chunk=kvc,
                           bias_offset=off)
    to.backward(torch.from_numpy(do))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    for name, t, j in zip("qkv", (tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=TOL, atol=TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES[:3])
def test_forward_bits_do_not_depend_on_grad(case):
    """Serving runs the forward alone (no_grad); training runs it inside
    the Function: the same arithmetic, the same bits, at f32 and bf16."""
    Sq, Skv, qc, kvc, off = case
    q, k, v, _ = _inputs(1, Sq, Skv)
    for dt in (torch.float32, torch.bfloat16):
        args = [torch.from_numpy(a).to(dt) for a in (q, k, v)]
        kw = dict(causal=True, q_chunk=qc, kv_chunk=kvc, bias_offset=off)
        with torch.no_grad():
            plain = A.flash_attention(*args, **kw)
        graded = A.flash_attention(*(a.clone().requires_grad_() for a in args), **kw)
        assert graded.grad_fn is not None
        assert torch.equal(plain, graded.detach())


def test_backward_saves_only_q_k_v_out_lse():
    q, k, v, _ = _inputs(2, 16, 16)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = A.flash_attention(tq, tk, tv, causal=True, q_chunk=4, kv_chunk=4)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        (2, 16, 2, 3, 8), (2, 16, 2, 8), (2, 16, 2, 8), (2, 16, 2, 3, 8), (2, 2, 3, 16)]
