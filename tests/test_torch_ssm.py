"""The port's SSM mixers and its ssm and hybrid models against the
reference's (JAX).

* ``mamba1_mix`` and ``mamba2_mix`` on the same numpy inputs and weights
  as ``repro.nn.ssm``: at S = 16, 17, 18, 33 and 64 with the smoke chunk
  of 16, i.e. one chunk, chunks of 1, 9 and 11 steps, and several chunks;
  from zero states, from carried conv and ssm states, and through the
  ``chunk=1`` oracles; then step-by-step decode against the whole
  sequence (as ``tests/test_ssm.py``), and the conv state at bf16;
* prefill and decode logits and caches of the smoke-size falcon-mamba
  (2 mamba1 layers) and zamba2 (3 mamba2 layers, the shared block every
  2: chunks of 2 and 1) with pofx8 weights, zamba2 also with an fxp8 KV
  cache, against the reference, with the weights carried across by
  ``convert.params_from_numpy``;
* ``init``'s leaves and the storage report against ``apply_policy``;
* the refusals: ``prefill(length=)`` and the paged cache.

Both packages run at f32 activations; the tolerance of a mixer is 1e-5
(rtol and atol), of the logits that of ``tests/test_torch_models.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, RunConfig as JRunConfig, smoke as j_smoke
from repro.core.policy import QuantPolicy as JPolicy, parse_spec
from repro.core.policy import storage_report as j_storage_report
from repro.nn import ssm as J
from repro.nn.models import build_model as j_build_model
from repro_torch.configs import ARCHS, RunConfig, smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import QuantPolicy, named_leaves, storage_report
from repro_torch.core.quantizers import QuantizedTensor
from repro_torch.nn import ssm
from repro_torch.nn.models import apply_policy, build_model
from torch_bridge import _jax_params, pair, port_leaves, reference_leaves, to_numpy_tree
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

SSM_ARCHS = ["falcon-mamba-7b", "zamba2-1.2b"]
MIXED = "attn/*=pofx8es2,mlp/*=fxp8f7,*=bf16"
# one f32 mixer in two frameworks (as test_torch_moe's MOE_TOL)
MIX_TOL = 1e-5
# f32 logits of a small model in two frameworks (as test_torch_models)
RTOL, ATOL = 1e-4, 1e-4

VARIANTS = {
    "mamba1": ("falcon-mamba-7b", J.mamba1_init, J.mamba1_mix, J.mamba1_mix_ref,
               ssm.mamba1_mix, ssm.mamba1_mix_ref),
    "mamba2": ("zamba2-1.2b", J.mamba2_init, J.mamba2_mix, J.mamba2_mix_ref,
               ssm.mamba2_mix, ssm.mamba2_mix_ref),
}


@functools.lru_cache(maxsize=None)
def _mixer(variant):
    """(jax cfg, port cfg, jax weights, port weights, in_proj width), drawn
    once a variant for the module's cases."""
    arch, j_init = VARIANTS[variant][:2]
    jcfg, tcfg = j_smoke(J_ARCHS[arch]), smoke(ARCHS[arch])
    jp = j_init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(to_numpy_tree(jp), device="cpu")
    di, ds = tcfg.d_inner, tcfg.ssm_state
    width = 2 * di if variant == "mamba1" else 2 * di + 2 * ds + di // tcfg.ssm_head_dim
    return jcfg, tcfg, jp, tp, width


def _states(variant, cfg, B, seed):
    """Random carried (conv, ssm) states, f32, the cache's shapes."""
    cache = ssm.mamba_init_cache(cfg, 1, B, "cpu")
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal(cache["conv"].shape[1:]).astype(np.float32)
    # an ssm state of the size a recurrence of decays in (0, 1] reaches
    h = 0.5 * rng.standard_normal(cache["ssm"].shape[1:]).astype(np.float32)
    return conv, h


def _close(got, want, tol=MIX_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("S", [16, 17, 18, 33, 64])
@pytest.mark.parametrize("mode", ["fresh", "carried", "chunk1"])
def test_mixer_matches_reference(variant, S, mode):
    jcfg, tcfg, jp, tp, width = _mixer(variant)
    _, _, j_mix, j_ref, t_mix, t_ref = VARIANTS[variant]
    xz = np.random.default_rng(S).standard_normal((2, S, width)).astype(np.float32)
    if mode == "chunk1":
        want, got = j_ref(jp, jnp.asarray(xz), jcfg), t_ref(tp, torch.from_numpy(xz), tcfg)
    elif mode == "carried":
        conv, h = _states(variant, tcfg, 2, S)
        want = j_mix(jp, jnp.asarray(xz), jcfg, conv_state=jnp.asarray(conv),
                     ssm_state=jnp.asarray(h))
        got = t_mix(tp, torch.from_numpy(xz), tcfg, conv_state=torch.from_numpy(conv),
                    ssm_state=torch.from_numpy(h))
    else:
        want, got = j_mix(jp, jnp.asarray(xz), jcfg), t_mix(tp, torch.from_numpy(xz), tcfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        _close(g, w)


def test_chunk_rule_is_the_reference_rule():
    """min(chunk, S), stepped down until it divides S: at the smoke chunk
    of 16, S = 17 runs 17 chunks of one step, 18 two of 9, 33 three of 11;
    falcon's 128 makes a 64-token prefill one chunk."""
    assert [ssm._chunk_len(S, 16) for S in (16, 17, 18, 33, 64)] == [16, 1, 9, 11, 16]
    assert ssm._chunk_len(64, ARCHS["falcon-mamba-7b"].ssm_chunk) == 64
    assert ssm._chunk_len(1, 128) == 1


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_streaming_decode_matches_full_sequence(variant):
    """Step-by-step decode with the carried cache == the whole sequence."""
    _, tcfg, _, tp, width = _mixer(variant)
    mix = VARIANTS[variant][4]
    xz = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, width)).astype(np.float32))
    full, _, h_full = mix(tp, xz, tcfg)
    cache = ssm.mamba_init_cache(tcfg, 1, 2, "cpu")
    conv, h = cache["conv"][0], cache["ssm"][0]
    outs = []
    for t in range(16):
        y, conv, h = mix(tp, xz[:, t:t + 1], tcfg, conv_state=conv, ssm_state=h)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(h, h_full, rtol=2e-5, atol=2e-5)
    assert conv.dtype == h.dtype == torch.float32


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_conv_state_is_bf16_rounded_like_the_reference(variant):
    """At bf16 activations the f32 conv state enters in bf16 and is cast
    back: it stays f32 and holds the reference's bf16-rounded bits."""
    jcfg, tcfg, jp, tp, width = _mixer(variant)
    _, _, j_mix, _, t_mix, _ = VARIANTS[variant]
    rng = np.random.default_rng(4)
    xz = rng.standard_normal((2, 5, width)).astype(np.float32)
    conv, h = _states(variant, tcfg, 2, 5)
    jy, jconv, _ = j_mix(jp, jnp.asarray(xz, jnp.bfloat16), jcfg,
                         conv_state=jnp.asarray(conv), ssm_state=jnp.asarray(h))
    ty, tconv, _ = t_mix(tp, torch.from_numpy(xz).to(torch.bfloat16), tcfg,
                         conv_state=torch.from_numpy(conv), ssm_state=torch.from_numpy(h))
    assert tconv.dtype == torch.float32 and jconv.dtype == jnp.float32
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
    assert torch.equal(tconv, tconv.to(torch.bfloat16).float())
    # one decode step: the carried state's tail rows become bf16 too
    _, conv1, _ = t_mix(tp, torch.from_numpy(xz[:, :1]).to(torch.bfloat16), tcfg,
                        conv_state=torch.from_numpy(conv), ssm_state=torch.from_numpy(h))
    torch.testing.assert_close(conv1[:, :-1], torch.from_numpy(conv[:, 1:]).to(
        torch.bfloat16).float(), rtol=0, atol=0)


def test_softplus_is_logaddexp():
    """Equal to jax.nn.softplus, also past 20 where F.softplus returns x;
    atol covers one subnormal result (at -100), which XLA flushes to 0."""
    x = torch.tensor([-100.0, -20.0, -1.0, 0.0, 1.0, 19.0, 21.0, 50.0, 100.0])
    np.testing.assert_allclose(ssm.softplus(x).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))),
                               rtol=1e-7, atol=torch.finfo(torch.float32).tiny)


# ---------------------------------------------------------------------------
# models: prefill and decode against the reference
# ---------------------------------------------------------------------------


def _assert_states_close(tc, jc, tol):
    for name in ("conv", "ssm"):
        got, want = tc["ssm"][name], np.asarray(jc["ssm"][name])
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def _assert_kv_close(tc, jc):
    """As test_torch_models: scales exact; codes one step apart on at most
    0.1 % of the entries (rounding-boundary flips between frameworks)."""
    if "shared_kv" not in tc:
        assert "kv" not in tc and "shared_kv" not in jc
        return
    for name, leaf in tc["shared_kv"].items():
        got = leaf.float().numpy()
        want = np.asarray(jc["shared_kv"][name]).astype(np.float32)
        assert got.shape == want.shape, name
        if name.endswith("_scale"):
            np.testing.assert_array_equal(got, want)
            continue
        diff = got != want
        assert diff.mean() <= 1e-3, (name, diff.mean())
        if leaf.dtype in (torch.int8, torch.uint8):
            assert np.abs(got - want).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("arch,kv", [("falcon-mamba-7b", None), ("zamba2-1.2b", None),
                                     ("zamba2-1.2b", "fxp8")])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_logits_match(arch, kv, use_kernel):
    spec = parse_spec(kv) if kv else None
    jm, jp, tm, tp = pair(kv=spec, use_kernel=use_kernel, arch=arch)
    cfg = tm.cfg
    assert len(tp["blocks"]) == cfg.n_layers and ("shared" in tp) == (arch == "zamba2-1.2b")
    toks = np.random.RandomState(0).randint(0, 512, (2, 11))
    j_prefill = jax.jit(lambda p, t, c: jm.prefill(p, t, cache=c))
    j_decode = jax.jit(jm.decode_step)
    jc, jl = j_prefill(jp, jnp.asarray(toks), jm.init_cache(2, 20))
    tc, tl = tm.prefill(tp, torch.from_numpy(toks), cache=tm.init_cache(2, 20))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    _assert_states_close(tc, jc, RTOL)
    _assert_kv_close(tc, jc)
    jc = dict(jc, pos=jnp.asarray([11, 11], jnp.int32))
    tc = dict(tc, pos=torch.tensor([11, 11], dtype=torch.int32))
    for _ in range(4):
        nxt = np.argmax(np.asarray(jl), axis=-1)[:, None]
        jc, jl = j_decode(jp, jc, jnp.asarray(nxt))
        tc, tl = tm.decode_step(tp, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    _assert_states_close(tc, jc, RTOL)
    _assert_kv_close(tc, jc)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_cache_layout_matches_reference(arch):
    """The same leaves, shapes and dtypes as the reference's init_cache;
    the recurrent state does not grow with max_len, hybrid's shared KV
    does (one cache per chunk: (2, 1) at the smoke size)."""
    jm, _, tm, _ = pair(kv=parse_spec("fxp8"), arch=arch)
    tc, jc = tm.init_cache(2, 24), jm.init_cache(2, 24)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]}
    ours = {f"{g}/{n}": leaf for g, sub in tc.items() if isinstance(sub, dict)
            for n, leaf in sub.items()}
    assert set(ours) == set(flat) - {"pos"}
    for name, leaf in ours.items():
        assert tuple(leaf.shape) == flat[name].shape, name
        assert str(leaf.dtype).replace("torch.", "") == flat[name].dtype.name, name
    big = tm.init_cache(2, 96)
    for name in ("conv", "ssm"):
        assert big["ssm"][name].shape == tc["ssm"][name].shape
    if arch == "zamba2-1.2b":
        assert tm._hybrid_chunks() == [2, 1]
        assert tc["shared_kv"]["k"].shape[0] == 2
        assert big["shared_kv"]["k"].shape[3] == 96


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_bucketed_prefill_and_paging_are_refused(arch):
    _, _, tm, tp = pair(arch=arch)
    toks = torch.zeros(1, 6, dtype=torch.long)
    with pytest.raises(ValueError, match="attention-family only"):
        tm.prefill(tp, toks, cache=tm.init_cache(1, 8), length=torch.tensor(4))
    with pytest.raises(ValueError, match="dense/moe"):
        tm.init_paged_cache(2, 16, n_pages=9, page_size=4)


# ---------------------------------------------------------------------------
# init and the policy's leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("policy", ["pofx8", MIXED])
def test_init_quantizes_the_reference_leaves(arch, policy):
    """blocks/mix/* and shared/* are named as the reference names them:
    in_proj, out_proj, x_proj and dt_proj quantize; A_log, dt_bias, D, the
    conv taps, norm_w and ln never do; hybrid's shared block takes the
    attn/* and mlp/* rules. The storage reports are equal."""
    jcfg = j_smoke(J_ARCHS[arch])
    jp = _jax_params(jcfg, JPolicy.from_string(policy), 0)
    cfg = smoke(ARCHS[arch])
    tp = build_model(cfg, RunConfig(remat="none"), device="cpu").init(2, policy=policy)
    want, got = reference_leaves(jp), port_leaves(tp)
    assert got == want
    for name in ("A_log", "dt_bias", "D"):
        assert got[f"blocks/mix/{name}"][0] == "float32"
    for name in ("conv_w", "conv_b"):
        assert got[f"blocks/mix/{name}"][0] == "bfloat16"
    if policy == "pofx8":
        for name in ("in_proj", "out_proj"):
            assert got[f"blocks/mix/{name}"][0] == "pofx8es2"
        if cfg.family == "ssm":
            assert got["blocks/mix/x_proj"][0] == got["blocks/mix/dt_proj"][0] == "pofx8es2"
    elif cfg.family == "hybrid":
        assert got["shared/attn/wq"][0] == "pofx8es2" and got["shared/mlp/wi"][0] == "fxp8"
        assert got["blocks/mix/in_proj"][0] == "bfloat16"
    assert storage_report(tp, QuantPolicy.from_string(policy)) == \
        j_storage_report(jp, JPolicy.from_string(policy))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_quantizes_each_leaf_like_apply_policy(arch):
    m = build_model(smoke(ARCHS[arch]), RunConfig(remat="none"), device="cpu")
    policy = QuantPolicy.from_string(MIXED)
    fused = m.init(3, policy=policy)
    later = apply_policy(m.init(3), policy)
    for (na, a), (nb, b) in zip(named_leaves(fused), named_leaves(later)):
        assert na == nb
        if isinstance(a, QuantizedTensor):
            assert a.spec == b.spec
            assert torch.equal(a.codes, b.codes) and torch.equal(a.scale, b.scale)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_convert_unstacks_mamba_layers_and_keeps_the_shared_block():
    jm, jp, tm, tp = pair(arch="zamba2-1.2b")
    assert [set(b) for b in tp["blocks"]] == [{"ln", "mix"}] * 3
    np.testing.assert_array_equal(tp["blocks"][2]["mix"]["in_proj"].codes.numpy(),
                                  np.asarray(jp["blocks"]["mix"]["in_proj"].codes[2]))
    np.testing.assert_array_equal(tp["blocks"][1]["mix"]["A_log"].numpy(),
                                  np.asarray(jp["blocks"]["mix"]["A_log"][1]))
    np.testing.assert_array_equal(tp["shared"]["attn"]["wq"].codes.numpy(),
                                  np.asarray(jp["shared"]["attn"]["wq"].codes))
    assert j_build_model(jm.cfg, JRunConfig())._hybrid_chunks() == tm._hybrid_chunks()


def test_full_configs_shapes():
    """The serving widths: falcon's in_proj 4096 x 16384 (x_proj 8192 x
    288, dt_proj 256 x 8192, plain); zamba2's in_proj 2048 x 8384 (a
    ragged last 128-column tile) and 7 shared-block applications over 38
    layers."""
    f, z = ARCHS["falcon-mamba-7b"], ARCHS["zamba2-1.2b"]
    assert (f.n_layers, f.d_model, f.d_inner, f.ssm_state, f.dt_rank) == (64, 4096, 8192, 16, 256)
    assert f.dt_rank + 2 * f.ssm_state == 288
    nh = z.d_inner // z.ssm_head_dim
    assert 2 * z.d_inner + 2 * z.ssm_state + nh == 8384 and 8384 % 128 == 64
    tm = build_model(dataclasses.replace(z, d_model=64), RunConfig(remat="none"), device="cpu")
    assert tm._hybrid_chunks() == [6, 6, 6, 6, 6, 6, 2]
