"""The port's dense LM against the reference at the smoke size.

Weights are drawn by the reference, quantized by its policy and carried
across; both packages run at f32 activations (bf16 rounds at different
points in the two frameworks). Prefill logits and four decode steps must
agree with ``allclose`` for every KV-cache format, with and without the
kernel datapath.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import parse_spec
from repro_torch.configs import ARCHS, RunConfig, smoke
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantizers import QuantizedTensor
from repro_torch.nn.models import apply_policy, build_model, kv_decode_bytes_per_token
from repro.nn.models import kv_decode_bytes_per_token as j_kv_bytes
from repro.configs import ARCHS as J_ARCHS
from torch_bridge import pair, tspec
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

# f32 logits of a 2-layer model computed in two frameworks (different
# summation orders, libm cos/sin/exp/rsqrt): a few ulps of |logit| <~ 4
RTOL, ATOL = 1e-4, 1e-4


@pytest.mark.parametrize("kv", [None, "fxp8", "pofx8es2"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("policy", ["pofx8", "attn/*=pofx8es2,mlp/*=fxp8f7,*=bf16"])
def test_prefill_and_decode_logits_match(kv, use_kernel, policy):
    spec = parse_spec(kv) if kv else None
    jm, jp, tm, tp = pair(policy=policy, kv=spec, use_kernel=use_kernel)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 512, (2, 11))
    j_prefill = jax.jit(lambda p, t, c: jm.prefill(p, t, cache=c))
    j_decode = jax.jit(jm.decode_step)
    jc, jl = j_prefill(jp, jnp.asarray(toks), jm.init_cache(2, 20))
    tc, tl = tm.prefill(tp, torch.from_numpy(toks), cache=tm.init_cache(2, 20))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    _assert_cache_close(tc, jc)
    jc = dict(jc, pos=jnp.asarray([11, 11], jnp.int32))
    tc = dict(tc, pos=torch.tensor([11, 11], dtype=torch.int32))
    for _ in range(4):
        nxt = np.argmax(np.asarray(jl), axis=-1)[:, None]
        jc, jl = j_decode(jp, jc, jnp.asarray(nxt))
        tc, tl = tm.decode_step(tp, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()


def _assert_cache_close(tc, jc):
    """Caches agree up to rounding-boundary flips: a K/V value that differs
    by an ulp between the frameworks may round to the neighbouring bf16
    value or code. Allow one step on at most 0.1% of the entries."""
    for name, leaf in tc["kv"].items():
        got = leaf.float().numpy()
        want = np.asarray(jc["kv"][name]).astype(np.float32)
        if name.endswith("_scale"):
            np.testing.assert_array_equal(got, want)
            continue
        diff = got != want
        assert diff.mean() <= 1e-3, (name, diff.mean())
        if leaf.dtype in (torch.int8, torch.uint8):
            assert np.abs(got - want).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def test_bucketed_prefill_length_matches():
    jm, jp, tm, tp = pair(kv=parse_spec("fxp8"))
    toks = np.random.RandomState(1).randint(0, 512, (1, 12))
    toks[0, 9:] = 0
    jc, jl = jax.jit(lambda p, t, c: jm.prefill(p, t, cache=c, length=jnp.int32(9)))(
        jp, jnp.asarray(toks), jm.init_cache(1, 16))
    tc, tl = tm.prefill(tp, torch.from_numpy(toks), cache=tm.init_cache(1, 16),
                        length=torch.tensor(9))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [9]


def test_cache_layout_mismatch_raises():
    _, _, tm, tp = pair(kv=parse_spec("fxp8"))
    with pytest.raises(ValueError, match="cache layout"):
        tm.prefill(tp, torch.zeros(1, 4, dtype=torch.long),
                   cache=tm.init_cache(1, 8, kv_spec=None))


def test_init_quantizes_each_leaf_like_apply_policy():
    cfg = smoke(ARCHS["yi-9b"])
    m = build_model(cfg, RunConfig(remat="none"), device="cpu")
    policy = QuantPolicy.from_string("attn/*=pofx8es2,mlp/*=fxp8f7,*=bf16")
    fused = m.init(3, policy=policy)
    later = apply_policy(m.init(3), policy)
    assert len(fused["blocks"]) == cfg.n_layers
    for a, b in zip(_leaves(fused), _leaves(later)):
        if isinstance(a, QuantizedTensor):
            assert a.spec == b.spec
            assert torch.equal(a.codes, b.codes) and torch.equal(a.scale, b.scale)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)
    wq = fused["blocks"][0]["attn"]["wq"]
    assert wq.spec.kind == "pofx" and wq.codes.dtype == torch.uint8
    assert tuple(wq.scale.shape) == (1, 1, cfg.d_head)
    assert fused["blocks"][0]["mlp"]["wg"].spec.kind == "fxp"
    assert fused["unembed"].dtype == torch.bfloat16
    assert fused["blocks"][0]["ln1"].dtype == torch.bfloat16


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def test_kv_decode_bytes_per_token_matches():
    for arch in ("yi-9b", "zamba2-1.2b", "falcon-mamba-7b"):
        for kv in (None, parse_spec("fxp8")):
            assert kv_decode_bytes_per_token(ARCHS[arch], 96, tspec(kv)) == \
                j_kv_bytes(J_ARCHS[arch], 96, kv)


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke(ARCHS["yi-9b"])
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg, RunConfig(remat="none"))
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--smoke"])


def test_other_families_are_not_silently_served():
    """encdec (whisper) builds, but the engine refuses it as the
    reference's does: its encoder needs per-batch frames, which the
    one-shot loop of the serving CLI supplies."""
    from repro_torch.launch.engine import ServeEngine
    m = build_model(smoke(ARCHS["whisper-medium"]), RunConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="one-shot"):
        ServeEngine(m, m.init(0), n_slots=2, max_len=16)
