"""``RunConfig.serve_bf16_compute`` in decode attention, on the CPU.

The reference's ``decode_attention(..., bf16_compute=True)`` rounds q and
the probabilities to the cache's dtype and sums their products in f32 (a
bf16 x bf16 dot with ``preferred_element_type=f32``), and passes the flag
at three sites: the static cross-attention cache, the paged fallback (a
cache that is not quantized) and the bf16 cache; the dequantize-on-read
fallback of a quantized cache takes none. Its own bf16 dot cannot run on
the CPU backend, so the flag's formula is written out here in numpy.

* Off, the port's ``decode_attention`` equals the reference's (bf16 and
  f32 caches, per-slot lengths and the cross cache's scalar length).
* On, it equals the formula: q and p rounded to bf16, each product exact
  in f32 and summed in f32; and it parts from the f32 result by more than
  the check's tolerance, so the check sees the rounding.
* The sites: decode steps of the dense, paged and encdec models read the
  flag where the reference does (every call of ``decode_attention``
  recorded), quantized caches never take it.
"""
import numpy as np
import pytest
import torch

from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)
from repro_torch.configs import ARCHS, RunConfig, smoke
from repro_torch.core.policy import parse_kv_spec
from repro_torch.nn import attention
from repro_torch.nn.models import build_model

CASES = [("bf16", "slots"), ("f32", "slots"), ("bf16", "scalar"), ("f32", "scalar")]


def inputs(cache, pos_kind, seed=0, B=2, G=2, R=3, S=24, Dh=16):
    """q (B, 1, G, R, Dh) f32 and a heads-major (B, G, S, Dh) cache in the
    ``cache`` dtype, and the valid lengths: per slot, or one scalar (the
    cross cache's "len")."""
    rng = np.random.RandomState(seed)
    dt = torch.bfloat16 if cache == "bf16" else torch.float32
    q = torch.from_numpy(rng.standard_normal((B, 1, G, R, Dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, G, S, Dh)).astype(np.float32)).to(dt)
    v = torch.from_numpy(rng.standard_normal((B, G, S, Dh)).astype(np.float32)).to(dt)
    pos = torch.tensor([17, 24]) if pos_kind == "slots" else torch.tensor(19)
    return q, k, v, pos


def bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (to nearest, ties to even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16) \
        .to(torch.float32).numpy()


def formula(q, k, v, pos, rounded):
    """The reference's decode attention written out in numpy f32: scores of
    q (rounded to bf16 with ``rounded``) against k, masked at ``pos``, a
    softmax, the probabilities (rounded likewise) against v."""
    q, k, v = (t.to(torch.float32).numpy() for t in (q, k, v))
    rnd = bf16 if rounded else (lambda a: a)
    S, Dh = k.shape[2], q.shape[-1]
    s = np.einsum("bqgrd,bgsd->bgrqs", rnd(q), k).astype(np.float32) * np.float32(Dh ** -0.5)
    valid = np.arange(S)[None, :] < np.asarray(pos).reshape(-1, 1)
    s = np.where(valid[:, None, None, None, :], s, np.float32(-1e30))
    e = np.exp(s - s.max(-1, keepdims=True))
    p = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return np.einsum("bgrqs,bgsd->bqgrd", rnd(p), v).astype(np.float32)


@pytest.mark.parametrize("cache,pos_kind", CASES)
def test_flag_off_equals_the_reference(cache, pos_kind):
    import jax.numpy as jnp
    from repro.nn.attention import decode_attention as j_decode
    from repro.nn.sharding import make_ctx
    q, k, v, pos = inputs(cache, pos_kind)
    jdt = jnp.bfloat16 if cache == "bf16" else jnp.float32
    want = np.asarray(j_decode(jnp.asarray(q.numpy()),
                               jnp.asarray(k.to(torch.float32).numpy()).astype(jdt),
                               jnp.asarray(v.to(torch.float32).numpy()).astype(jdt),
                               jnp.asarray(pos.numpy()), make_ctx(None), "kv"))
    got = attention.decode_attention(q, k, v, pos)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())
    # the default is the flag off, bit for bit
    assert torch.equal(got, attention.decode_attention(q, k, v, pos, bf16_compute=False))


@pytest.mark.parametrize("pos_kind", ["slots", "scalar"])
def test_flag_on_computes_the_reference_formula(pos_kind):
    """A bf16 cache: q and p rounded to bf16, products summed in f32. The
    port's f32 einsums sum in another order than numpy's, so the check is
    to 1e-5 of the output's largest entry; the rounding moves the output
    by far more than that (asserted)."""
    q, k, v, pos = inputs("bf16", pos_kind)
    got = attention.decode_attention(q, k, v, pos, bf16_compute=True).numpy()
    want = formula(q, k, v, pos, rounded=True)
    top = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * top)
    unrounded = formula(q, k, v, pos, rounded=False)
    assert np.abs(unrounded - want).max() > 20 * 1e-5 * top


def test_flag_on_an_f32_cache_changes_nothing():
    """The rounding is to the cache's dtype: an f32 cache keeps f32 q and p,
    as the reference's ``qdt = k_cache.dtype``."""
    q, k, v, pos = inputs("f32", "slots")
    assert torch.equal(attention.decode_attention(q, k, v, pos, bf16_compute=True),
                       attention.decode_attention(q, k, v, pos))


@pytest.fixture
def calls(monkeypatch):
    """Every ``bf16_compute`` that the model code passes to
    ``decode_attention``, in call order."""
    seen = []
    orig = attention.decode_attention

    def spy(*args, bf16_compute=False, **kw):
        seen.append(bool(bf16_compute))
        return orig(*args, bf16_compute=bf16_compute, **kw)

    monkeypatch.setattr(attention, "decode_attention", spy)
    return seen


def _model(arch, flag, kv=None):
    cfg = smoke(ARCHS[arch])
    rcfg = RunConfig(weight_dtype="f32", activation_dtype="f32", serve_bf16_compute=flag)
    m = build_model(cfg, rcfg, device="cpu", kv_spec=parse_kv_spec(kv) if kv else None)
    return m, m.init(0)


STEPS = 3


def _decode(m, params, paged, tokens):
    """STEPS decode steps from an empty cache, each fed ``tokens`` (so the
    last attends over STEPS positions); the last step's logits."""
    B = tokens.shape[0]
    if paged:
        cache = m.init_paged_cache(B, 16, n_pages=9, page_size=4)
        for b in range(B):
            cache["pages"][b] = torch.arange(1 + 4 * b, 5 + 4 * b)
    else:
        cache = m.init_cache(B, 16)
    for _ in range(STEPS):
        cache, logits = m.decode_step(params, cache, tokens)
    return logits


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("flag", [False, True])
def test_bf16_cache_sites_take_the_flag(calls, flag, paged):
    """yi-9b's bf16 KV cache, dense and paged (the reference's :515 and
    :460-461): each layer's decode attention takes the flag as it is set;
    the flag moves the logits by the rounding alone."""
    m, params = _model("yi-9b", flag)
    tokens = torch.tensor([[3], [7]])
    logits = _decode(m, params, paged, tokens)
    assert calls == [flag] * (m.cfg.n_layers * STEPS)
    if flag:
        off, _ = _model("yi-9b", False)
        base = _decode(off, params, paged, tokens)
        d = (logits - base).abs().max().item()
        assert 0 < d < 1e-2 * base.abs().max().item()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_quantized_cache_fallbacks_take_no_flag(calls, paged):
    """An fxp8 cache read without the kernels (the dequantize-on-read
    fallbacks, the reference's :509 and its paged ``not quant``) computes
    in f32 whatever the flag."""
    m, params = _model("yi-9b", True, kv="fxp8")
    _decode(m, params, paged, torch.tensor([[3], [7]]))
    assert calls == [False] * (m.cfg.n_layers * STEPS)


def test_cross_cache_takes_the_flag(calls):
    """whisper's decode step: each decoder layer's self-attention reads its
    bf16 cache and its cross-attention the static cross cache (the
    reference's :426), both with the flag."""
    m, params = _model("whisper-medium", True)
    B, Se = 2, 8
    frames = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (B, Se, m.cfg.d_model)).astype(np.float32))
    cache = m.init_cache(B, 16, enc_len=Se)
    cache, _ = m.prefill(params, torch.tensor([[1, 2, 3], [4, 5, 6]]), cache=cache,
                         frames=frames)
    assert calls == []
    m.decode_step(params, cache, torch.tensor([[3], [7]]))
    assert calls == [True, True] * m.cfg.n_layers
