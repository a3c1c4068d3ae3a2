"""The port's MoE layer and MoE models against the reference's (JAX).

* ``moe_forward`` against ``repro.nn.moe.moe_forward`` on the same numpy
  inputs and weights (pofx8 experts, f32 router): at decode (S == 1,
  drop-free), at prefill with dropped assignments (asserted present, and
  at a capacity that Python rounds half to even), and on a padded bucket,
  with and without shared experts, through every datapath;
* prefill and decode logits and KV caches of the smoke-size moonshot
  (every layer MoE, top-2 of 4, shared experts) and llama4 (dense and MoE
  layers interleaved, top-1) against the reference, with the weights
  carried across by ``convert.params_from_numpy``;
* ``init``'s quantized leaves (names, formats, code and scale shapes, the
  storage report) against the reference's ``apply_policy``.

Both packages run at f32 activations; tolerances as in
``tests/test_torch_models.py``.
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
from repro.core.quantizers import QuantizedTensor as JQT
from repro.nn.models import apply_policy as j_apply_policy, build_model as j_build_model
from repro.nn.moe import moe_forward as j_moe_forward, moe_init as j_moe_init
from repro.nn.sharding import make_ctx
from repro_torch.configs import ARCHS, RunConfig, smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import QuantPolicy, named_leaves, storage_report
from repro_torch.core.quantizers import QuantizedTensor
from repro_torch.kernels.ops import KERNELS, PLAIN
from repro_torch.nn.models import apply_policy, build_model
from repro_torch.nn.moe import moe_capacity, moe_forward
from torch_bridge import _jax_params, pair, port_leaves, reference_leaves, to_numpy_tree
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

MOE_ARCHS = ["moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"]
MIXED = "attn/*=pofx8es2,mlp/*=fxp8f7,*=bf16"
# f32 logits of a 2-layer model in two frameworks (as test_torch_models)
RTOL, ATOL = 1e-4, 1e-4
# one f32 MoE layer in two frameworks: sums of d products in other orders
MOE_TOL = 1e-5


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------


def _moe_cfgs(shared: bool):
    jcfg = j_smoke(J_ARCHS["moonshot-v1-16b-a3b"])
    tcfg = smoke(ARCHS["moonshot-v1-16b-a3b"])
    n = jcfg.n_shared_experts if shared else 0
    return (dataclasses.replace(jcfg, n_shared_experts=n),
            dataclasses.replace(tcfg, n_shared_experts=n))


@functools.lru_cache(maxsize=None)
def _moe_weights(jcfg):
    """The reference's MoE layer weights, pofx8-quantized (router kept f32),
    as (jax tree, port tree); drawn once a config for the module's cases."""
    jp = j_moe_init(jax.random.PRNGKey(5), jcfg)
    jp = j_apply_policy(jp, "*=pofx8es2")
    assert isinstance(jp["wg"], JQT) and not isinstance(jp["router"], JQT)
    return jp, params_from_numpy(to_numpy_tree(jp), device="cpu")


def _moe_input(case, d):
    """(B, S, d) f32 inputs. "decode": 4 tokens of one step. "drops": 36
    tokens near one point, so every token picks the same experts and all but
    C of them drop; C = round(36 * 2 * 1.25 / 4) = round(22.5) = 22 (half
    to even). "bucket": a 9-token prompt right-padded to 12 with the pad
    token's row."""
    rng = np.random.default_rng({"decode": 0, "drops": 1, "bucket": 2}[case])
    if case == "decode":
        return rng.standard_normal((4, 1, d)).astype(np.float32)
    if case == "drops":
        base = rng.standard_normal((1, 1, d))
        return (base + 0.05 * rng.standard_normal((2, 18, d))).astype(np.float32)
    x = rng.standard_normal((1, 12, d)).astype(np.float32)
    x[:, 9:] = rng.standard_normal(d).astype(np.float32)
    return x


def _dropped(tp, x, cfg):
    """Assignments the port's routing drops (recomputed from its router)."""
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax(x.reshape(T, -1) @ tp["router"], -1)
    counts = torch.bincount(torch.topk(probs, cfg.top_k, -1).indices.reshape(-1),
                            minlength=cfg.n_experts)
    C = moe_capacity(T, x.shape[1], cfg)
    return int((counts - C).clamp_min(0).sum())


@functools.lru_cache(maxsize=None)
def _moe_reference(case, shared, use_kernel):
    """The reference's ``moe_forward`` output, once for the cases that hold
    the port to the same run (the plain and kernel paths both against its
    kernel path)."""
    jcfg, tcfg = _moe_cfgs(shared)
    jp, _ = _moe_weights(jcfg)
    x = _moe_input(case, tcfg.d_model)
    return np.asarray(j_moe_forward(jp, jnp.asarray(x), jcfg, make_ctx(None),
                                    use_kernel=use_kernel))


@pytest.mark.parametrize("case", ["decode", "drops", "bucket"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("path", ["none", "plain", "kernels"])
def test_moe_forward_matches_reference(case, shared, path):
    jcfg, tcfg = _moe_cfgs(shared)
    _, tp = _moe_weights(jcfg)
    x = _moe_input(case, tcfg.d_model)
    want = _moe_reference(case, shared, path != "none")
    kset = {"none": None, "plain": PLAIN, "kernels": KERNELS}[path]
    got = moe_forward(tp, torch.from_numpy(x), tcfg, kernels=kset)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=MOE_TOL, atol=MOE_TOL)
    if case == "drops":
        assert moe_capacity(36, 18, tcfg) == 22
        assert _dropped(tp, torch.from_numpy(x), tcfg) > 0
    if case == "decode":
        assert _dropped(tp, torch.from_numpy(x), tcfg) == 0


def test_moe_capacity_rounds_like_the_reference():
    cfg = ARCHS["moonshot-v1-16b-a3b"]
    assert moe_capacity(64, 64, cfg) == 8        # 7.5 -> 8
    assert moe_capacity(192, 64, cfg) == 22      # 22.5 -> 22 (half to even)
    assert moe_capacity(4, 1, cfg) == 24         # decode: T * k, drop-free
    for T in range(1, 300):
        assert moe_capacity(T, 2, cfg) == int(max(1, round(T * 6 * 1.25 / 64)))


def test_moe_forward_is_deterministic_and_row_local_at_decode():
    """Two calls give the same bits, and at decode (drop-free) a token's
    output does not depend on the other tokens of the step."""
    jcfg, tcfg = _moe_cfgs(True)
    _, tp = _moe_weights(jcfg)
    x = torch.from_numpy(_moe_input("decode", tcfg.d_model))
    y = moe_forward(tp, x, tcfg)
    assert torch.equal(moe_forward(tp, x, tcfg), y)
    for b in range(x.shape[0]):
        torch.testing.assert_close(moe_forward(tp, x[b:b + 1], tcfg), y[b:b + 1],
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# models: prefill and decode against the reference
# ---------------------------------------------------------------------------


def _flat_cache(jkv, moe_every):
    """The reference's nested MoE cache {"moe": (ng, ...), "dense": (ng,
    moe_every - 1, ...)} in the port's layer-major execution order."""
    out = {}
    for name, leaf in jkv["moe"].items():
        layers = []
        for g in range(leaf.shape[0]):
            if "dense" in jkv:
                layers += [np.asarray(jkv["dense"][name][g, i]) for i in range(moe_every - 1)]
            layers.append(np.asarray(leaf[g]))
        out[name] = np.stack(layers)
    return out


def _assert_cache_close(tc, jc, moe_every):
    """As test_torch_models: scales exact; codes one step apart on at most
    0.1 % of the entries (rounding-boundary flips between frameworks)."""
    want_kv = _flat_cache(jc["kv"], moe_every)
    for name, leaf in tc["kv"].items():
        got = leaf.float().numpy()
        want = want_kv[name].astype(np.float32)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("kv", [None, "fxp8", "pofx8es2"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_moe_prefill_and_decode_logits_match(arch, kv, use_kernel):
    spec = parse_spec(kv) if kv else None
    jm, jp, tm, tp = pair(kv=spec, use_kernel=use_kernel, arch=arch)
    cfg = tm.cfg
    assert len(tp["blocks"]) == cfg.n_layers
    assert [("moe" in b) for b in tp["blocks"]] == [
        (i + 1) % cfg.moe_every == 0 for i in range(cfg.n_layers)]
    toks = np.random.RandomState(0).randint(0, 512, (2, 11))
    j_prefill = jax.jit(lambda p, t, c: jm.prefill(p, t, cache=c))
    j_decode = jax.jit(jm.decode_step)
    jc, jl = j_prefill(jp, jnp.asarray(toks), jm.init_cache(2, 20))
    tc, tl = tm.prefill(tp, torch.from_numpy(toks), cache=tm.init_cache(2, 20))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    _assert_cache_close(tc, jc, cfg.moe_every)
    jc = dict(jc, pos=jnp.asarray([11, 11], jnp.int32))
    tc = dict(tc, pos=torch.tensor([11, 11], dtype=torch.int32))
    for _ in range(4):
        nxt = np.argmax(np.asarray(jl), axis=-1)[:, None]
        jc, jl = j_decode(jp, jc, jnp.asarray(nxt))
        tc, tl = tm.decode_step(tp, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    _assert_cache_close(tc, jc, cfg.moe_every)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_bucketed_prefill_length_matches(arch):
    """A 9-token prompt right-padded to 12: the pad tokens are routed too
    and take capacity after the real ones, in both packages."""
    jm, jp, tm, tp = pair(kv=parse_spec("fxp8"), arch=arch)
    toks = np.random.RandomState(1).randint(0, 512, (1, 12))
    toks[0, 9:] = 0
    jc, jl = jax.jit(lambda p, t, c: jm.prefill(p, t, cache=c, length=jnp.int32(9)))(
        jp, jnp.asarray(toks), jm.init_cache(1, 16))
    tc, tl = tm.prefill(tp, torch.from_numpy(toks), cache=tm.init_cache(1, 16),
                        length=torch.tensor(9))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [9]


# ---------------------------------------------------------------------------
# init and the policy's leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("policy", ["pofx8", MIXED])
def test_init_quantizes_the_reference_leaves(arch, policy):
    """The port's init names every leaf by the reference's path, so the
    policy picks the same leaves in the same formats with the same scale
    shapes: an (E, in, out) expert leaf has one scale per output column
    shared by the experts, blocks/moe/moe/shared/* matches no mlp/* rule,
    the router is never quantized. The storage reports are equal."""
    jcfg = j_smoke(J_ARCHS[arch])
    jp = _jax_params(jcfg, JPolicy.from_string(policy), 0)
    cfg = smoke(ARCHS[arch])
    tm = build_model(cfg, RunConfig(remat="none"), device="cpu")
    tp = tm.init(2, policy=policy)
    want, got = reference_leaves(jp), port_leaves(tp)
    assert got == want
    assert j_build_model(jcfg, JRunConfig()).n_groups == tm.n_groups
    assert got["blocks/moe/moe/router"][0] == "float32"
    if policy == MIXED:       # the experts match no mlp/* rule: *=bf16
        assert got["blocks/moe/moe/wg"][0] == got["blocks/moe/moe/shared/wg"][0] == "bfloat16"
        assert got["blocks/moe/attn/wq"][0] == "pofx8es2"
        if cfg.moe_every > 1:
            assert got["blocks/dense/mlp/wg"][0] == "fxp8"
    else:
        assert got["blocks/moe/moe/wg"][:3] == ("pofx8es2", (cfg.n_experts, cfg.d_model, cfg.d_ff),
                                                (1, 1, cfg.d_ff))
    assert storage_report(tp, QuantPolicy.from_string(policy)) == \
        j_storage_report(jp, JPolicy.from_string(policy))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_quantizes_each_leaf_like_apply_policy(arch):
    cfg = smoke(ARCHS[arch])
    m = build_model(cfg, RunConfig(remat="none"), device="cpu")
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


def test_convert_orders_llama4_layers_by_execution():
    """A group of the reference's llama4 stack runs its dense layer first,
    then its MoE layer: the port's blocks list follows that order, and each
    layer carries its own slice of the stacked codes and scales."""
    jm, jp, tm, tp = pair(arch="llama4-maverick-400b-a17b")
    blocks = tp["blocks"]
    assert ["moe" in b for b in blocks] == [False, True]
    np.testing.assert_array_equal(blocks[0]["attn"]["wq"].codes.numpy(),
                                  np.asarray(jp["blocks"]["dense"]["attn"]["wq"].codes[0, 0]))
    np.testing.assert_array_equal(blocks[1]["moe"]["wo"].scale.numpy(),
                                  np.asarray(jp["blocks"]["moe"]["moe"]["wo"].scale[0]))
    assert blocks[1]["moe"]["router"].dtype == torch.float32
