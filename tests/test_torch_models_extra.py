"""The two dense configs with features of their own, against the reference
at the smoke size: chameleon-34b (``qk_norm``: RMSNorm over each head's
q and k) and nemotron-4-340b (``act="relu2"``: the plain two-matrix MLP
with a squared ReLU).

* prefill and four decode steps' logits for every KV-cache format, kernel
  datapath on and off, as ``tests/test_torch_models.py`` holds yi-9b;
* ``LM.loss`` and every gradient leaf against ``jax.grad(model.loss)`` at
  f32;
* nemotron at its own head dim, ``d_head=192`` (the flash-decode kernels'
  Dh = 192 path), with an fxp8 cache and the kernels on: decode logits of
  the dense cache and of the paged one (prefill_paged, then paged decode
  steps) against the reference's, whose kernels run in interpret mode.

Weights are drawn by the reference and carried across; both packages run
at f32 activations.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import parse_spec
from torch_bridge import jax_compile_cache  # noqa: F401 (autouse)
from torch_bridge import check_logits_and_grads, one_thread, pair, train_batch, train_models

ARCHS = ["chameleon-34b", "nemotron-4-340b"]
# f32 logits of a 2-layer model in two frameworks (as test_torch_models)
RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _dh192(cfg):
    return dataclasses.replace(cfg, d_head=192)


def _assert_codes_close(tc, jc):
    """Caches agree up to rounding-boundary flips (as test_torch_models):
    one step on at most 0.1 % of the entries; scales exact."""
    for name, leaf in tc["kv"].items():
        got = leaf.float().numpy()
        want = np.asarray(jc["kv"][name]).astype(np.float32)
        assert got.shape == want.shape, name
        if name.endswith("_scale"):
            np.testing.assert_array_equal(got, want)
            continue
        assert (got != want).mean() <= 1e-3, name
        if leaf.dtype in (torch.int8, torch.uint8):
            assert np.abs(got - want).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def _prefill_and_decode(jm, jp, tm, tp, steps=4):
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 512, (2, 11))
    jc, jl = jax.jit(lambda p, t, c: jm.prefill(p, t, cache=c))(
        jp, jnp.asarray(toks), jm.init_cache(2, 20))
    tc, tl = tm.prefill(tp, torch.from_numpy(toks), cache=tm.init_cache(2, 20))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    _assert_codes_close(tc, jc)
    j_decode = jax.jit(jm.decode_step)
    for _ in range(steps):
        nxt = np.argmax(np.asarray(jl), axis=-1)[:, None]
        jc, jl = j_decode(jp, jc, jnp.asarray(nxt))
        tc, tl = tm.decode_step(tp, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    _assert_codes_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv", [None, "fxp8", "pofx8es2"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_logits_match(arch, kv, use_kernel):
    spec = parse_spec(kv) if kv else None
    jm, jp, tm, tp = pair(kv=spec, use_kernel=use_kernel, arch=arch)
    assert tm.cfg.qk_norm == (arch == "chameleon-34b")
    assert tm.cfg.act == ("relu2" if arch == "nemotron-4-340b" else "silu")
    _prefill_and_decode(jm, jp, tm, tp)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_reference(arch):
    jm, tm = train_models(arch, remat="block")
    n = check_logits_and_grads(jm, tm, train_batch(tm.cfg, 2, 24, seed=1))
    # embed, unembed, ln_f, and per layer ln1, ln2, wq, wk, wv, wo, the MLP's
    # (wi, wo for relu2; wg, wu, wo for silu) and qk_norm's q_norm, k_norm
    assert n == 3 + 6 + (2 if arch == "nemotron-4-340b" else 3 + 2)


def test_nemotron_dh192_dense_decode_matches_reference():
    jm, jp, tm, tp = pair(kv=parse_spec("fxp8"), use_kernel=True, arch="nemotron-4-340b",
                          cfg_fn=_dh192)
    assert tm.cfg.d_head == 192 and tm.cfg.n_heads // tm.cfg.n_kv_heads == 2
    _prefill_and_decode(jm, jp, tm, tp)


def test_nemotron_dh192_paged_decode_matches_reference():
    """Two slots prefill 7- and 5-token contexts into 4-token pages, then
    four paged decode steps; logits against the reference's, the pool's
    codes one step apart on at most 0.1 % of the entries."""
    jm, jp, tm, tp = pair(kv=parse_spec("fxp8"), use_kernel=True, arch="nemotron-4-340b",
                          cfg_fn=_dh192)
    ps, max_len = 4, 16
    rng = np.random.RandomState(2)
    jc = jm.init_paged_cache(2, max_len, n_pages=9, page_size=ps)
    tc = tm.init_paged_cache(2, max_len, n_pages=9, page_size=ps)
    last = []
    for slot, (P, row) in enumerate(((7, [1, 2, 3, 4]), (5, [5, 6, 7, 8]))):
        toks = rng.randint(0, 512, (1, P))
        jc["pages"] = jc["pages"].at[slot].set(jnp.asarray(row, jnp.int32))
        tc["pages"][slot] = torch.tensor(row, dtype=torch.int32)
        jc, jl = jm.prefill_paged(jp, jnp.asarray(toks), cache=jc, slot=jnp.asarray(slot),
                                  length=jnp.asarray(P), prefix_len=0)
        tc, tl = tm.prefill_paged(tp, torch.from_numpy(toks), cache=tc, slot=slot,
                                  length=P, prefix_len=0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
        last.append(np.argmax(np.asarray(jl), -1))
    _assert_codes_close(tc, jc)
    tok = np.stack(last, 0).reshape(2, 1)
    j_decode = jax.jit(jm.decode_step)
    for _ in range(4):
        jc, jls = j_decode(jp, jc, jnp.asarray(tok))
        tc, tls = tm.decode_step(tp, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tls.numpy(), np.asarray(jls), rtol=RTOL, atol=ATOL)
        tok = np.argmax(np.asarray(jls), -1).reshape(2, 1)
    _assert_codes_close(tc, jc)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
