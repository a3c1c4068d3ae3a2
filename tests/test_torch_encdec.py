"""The port's encdec family (whisper) and the one-shot ``--legacy`` loop
against the reference's (JAX).

* ``core.prng``'s ``split`` and ``randint`` equal ``jax.random``'s bit for
  bit; ``normal`` ends in XLA's f32 ``erf_inv`` polynomial after a
  ``log1p``, where XLA's CPU ``log1p`` and torch's differ by an ulp on a
  few percent of inputs: it is held to NORMAL_ULPS ulps (3 measured over
  (4, 64, 1024) draws at three seeds);
* init's leaves and the storage report against ``apply_policy``; the
  cache's leaves against ``init_cache``; ``convert`` of ``enc_blocks``;
* ``_encode``, the prefill logits and the self and cross caches at the
  smoke size with Se != Sq, then decode steps, with the reference's
  weights carried across, kernels off and on;
* the one-shot loop (``launch.serve.legacy_loop``) token for token
  against the reference CLI's jitted prefill + decode loop on the
  reference CLI's prompts and frames: whisper with kernels off and on,
  yi-9b under ``--legacy`` with an fxp8 KV cache at a scalar position;
* the refusals (the engine, a quantized encdec cache, ``--paged``) and
  the CLI.

Both packages run at f32 activations. The caches are bf16 (the reference's
``kv_cache_dtype``), so an entry whose f32 value differs by an ulp between
the frameworks may round to the neighbouring bf16 value: one step on at
most 0.1 % of the entries is allowed (as ``tests/test_torch_models.py``).
Prefill logits are held to RTOL/ATOL; decode logits too where both sides
decode from the same (the reference's) cache, and to DECODE_TOL from
their own caches, whose one-step bf16 flips move a logit by up to ~3e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, smoke as j_smoke
from repro.core.policy import QuantPolicy as JPolicy, parse_spec
from repro.core.policy import storage_report as j_storage_report
from repro_torch.configs import ARCHS, RunConfig, smoke
from repro_torch.core import prng
from repro_torch.core.policy import QuantPolicy, storage_report
from repro_torch.launch import serve
from repro_torch.launch.engine import ServeEngine
from repro_torch.nn.models import build_model
from torch_bridge import _jax_params, pair, port_leaves, reference_leaves, tspec
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

ARCH = "whisper-medium"
MIXED = "attn/*=pofx8es2,mlp/*=fxp8f7"
# f32 logits of a small model in two frameworks (as test_torch_models)
RTOL, ATOL = 1e-4, 1e-4
# decode logits from each framework's own bf16 caches (module docstring)
DECODE_TOL = 1e-3
NORMAL_ULPS = 4
SEEDS = [0, 1, 2, 2**31 - 1]


# ---------------------------------------------------------------------------
# the reference CLI's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_randint_match_jax_bit_for_bit(seed):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.split(key, 3).numpy(),
                                  np.asarray(jax.random.split(jkey, 3)).astype(np.int64))
    for shape in [(1,), (4, 64), (3, 5, 7)]:
        for lo, hi in [(0, 512), (0, 51865), (0, 51968), (7, 8), (9, 3), (-100, 2**17 + 3),
                       (0, 2**31 - 1), (-2**31, 2**31 - 1)]:
            got = prng.randint(key, shape, lo, hi)
            want = np.asarray(jax.random.randint(jkey, shape, lo, hi))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{shape} [{lo}, {hi})")
    with pytest.raises(ValueError, match="int32"):
        prng.randint(key, (2,), 0, 2**31)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place of f32 (monotone integer view)."""
    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("seed", [2, 0, 5])
def test_normal_matches_jax_within_ulps(seed):
    shape = (4, 64, 1024)
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _ulps(got, want).max() <= NORMAL_ULPS
    x = np.float32([-1.0, -0.75, 0.0, 0.3, 0.9999999, 1.0])
    np.testing.assert_array_equal(prng.erf_inv(torch.from_numpy(x))[[0, 2, 5]].numpy(),
                                  np.float32([-np.inf, 0.0, np.inf]))
    assert _ulps(prng.erf_inv(torch.from_numpy(x)).numpy(),
                 np.asarray(jax.scipy.special.erfinv(x))).max() <= NORMAL_ULPS


def test_legacy_inputs_are_the_reference_draws():
    cfg = ARCHS[ARCH]
    prompts, frames = serve.legacy_inputs(cfg, 4, 64)
    np.testing.assert_array_equal(
        prompts.numpy(), np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 64), 0,
                                                       cfg.vocab_size)))
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (4, 64, cfg.d_model),
                                        jnp.float32))
    assert frames.shape == (4, 64, 1024)
    assert _ulps(frames.numpy(), want).max() <= NORMAL_ULPS
    assert serve.legacy_inputs(ARCHS["yi-9b"], 2, 8)[1] is None


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["pofx8", MIXED])
def test_init_quantizes_the_reference_leaves(policy):
    """enc_blocks/* and blocks/xattn/* are named as the reference names
    them: the attn/* and mlp/* rules reach the encoder, and the cross
    attention only through a rule that matches "xattn" (a pattern starts at
    a path segment, so attn/* does not); ln_x and enc_ln never quantize.
    The storage reports are equal."""
    cfg = smoke(ARCHS[ARCH])
    jp = _jax_params(j_smoke(J_ARCHS[ARCH]), JPolicy.from_string(policy), 0)
    tp = build_model(cfg, RunConfig(remat="none"), device="cpu").init(2, policy=policy)
    want, got = reference_leaves(jp), port_leaves(tp)
    assert got == want
    assert got["enc_blocks/attn/wq"][3] == cfg.n_enc_layers
    assert got["blocks/xattn/wk"][3] == cfg.n_layers
    assert got["blocks/ln_x"][2] is None and got["enc_ln"][2] is None    # no scale: kept
    if policy == MIXED:
        assert got["enc_blocks/attn/wq"][0] == "pofx8es2" and got["enc_blocks/mlp/wi"][0] == "fxp8"
        assert got["blocks/xattn/wo"][0] == "bfloat16"      # no rule matches it
    assert storage_report(tp, QuantPolicy.from_string(policy)) == \
        j_storage_report(jp, JPolicy.from_string(policy))


def test_convert_unstacks_the_encoder_and_the_cross_attention():
    _, jp, _, tp = pair(arch=ARCH)
    assert len(tp["enc_blocks"]) == len(tp["blocks"]) == 2
    assert set(tp["blocks"][0]) == {"ln1", "attn", "ln_x", "xattn", "ln2", "mlp"}
    assert set(tp["enc_blocks"][1]) == {"ln1", "attn", "ln2", "mlp"}
    np.testing.assert_array_equal(tp["enc_blocks"][1]["mlp"]["wi"].codes.numpy(),
                                  np.asarray(jp["enc_blocks"]["mlp"]["wi"].codes[1]))
    np.testing.assert_array_equal(tp["blocks"][1]["xattn"]["wv"].scale.numpy(),
                                  np.asarray(jp["blocks"]["xattn"]["wv"].scale[1]))
    np.testing.assert_array_equal(tp["enc_ln"].float().numpy(),
                                  np.asarray(jp["enc_ln"]).astype(np.float32))


def test_cache_layout_matches_reference():
    jm, _, tm, _ = pair(arch=ARCH)
    tc, jc = tm.init_cache(2, 24, enc_len=9), jm.init_cache(2, 24, enc_len=9)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]}
    ours = {f"{g}/{n}": leaf for g, sub in tc.items() if isinstance(sub, dict)
            for n, leaf in sub.items()}
    ours.update(pos=tc["pos"], xlen=tc["xlen"])
    assert set(ours) == set(flat)
    for name, leaf in ours.items():
        assert tuple(leaf.shape) == flat[name].shape, name
        assert str(leaf.dtype).replace("torch.", "") == flat[name].dtype.name, name
    assert tm.init_cache(1, 8)["cross"]["k"].shape[3] == 8


# ---------------------------------------------------------------------------
# the forward against the reference
# ---------------------------------------------------------------------------


def _inputs(B=2, Sq=7, Se=9, d=128):
    rng = np.random.RandomState(0)
    return rng.randint(0, 512, (B, Sq)), rng.randn(B, Se, d).astype(np.float32)


def _assert_bf16_close(got_t, want_j, name):
    """One bf16 step on at most 0.1 % of the entries (module docstring)."""
    got = got_t.float().numpy()
    want = np.asarray(want_j).astype(np.float32)
    assert got.shape == want.shape, name
    assert (got != want).mean() <= 1e-3, (name, (got != want).mean())
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_encode_prefill_and_decode_match(use_kernel):
    jm, jp, tm, tp = pair(arch=ARCH, use_kernel=use_kernel)
    toks, frames = _inputs()
    np.testing.assert_allclose(
        tm._encode(tp, torch.from_numpy(frames)).numpy(),
        np.asarray(jax.jit(jm._encode)(jp, jnp.asarray(frames))), rtol=RTOL, atol=ATOL)
    j_prefill = jax.jit(lambda p, t, c, f: jm.prefill(p, t, cache=c, frames=f))
    j_decode = jax.jit(jm.decode_step)
    jc, jl = j_prefill(jp, jnp.asarray(toks), jm.init_cache(2, 13, enc_len=9),
                       jnp.asarray(frames))
    tc, tl = tm.prefill(tp, torch.from_numpy(toks), cache=tm.init_cache(2, 13, enc_len=9),
                        frames=torch.from_numpy(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    for group in ("kv", "cross"):
        for name in ("k", "v"):
            _assert_bf16_close(tc[group][name], jc[group][name], f"{group}/{name}")
    assert int(tc["xlen"]) == int(jc["xlen"]) == 9 and int(tc["pos"]) == 7
    # one step from the reference's own cache: the decode math alone
    nxt = np.argmax(np.asarray(jl), axis=-1)[:, None]
    same = {g: {n: torch.from_numpy(np.asarray(jc[g][n]).astype(np.float32)).to(torch.bfloat16)
                for n in ("k", "v")} for g in ("kv", "cross")}
    same.update(pos=torch.tensor(7, dtype=torch.int32), xlen=torch.tensor(9, dtype=torch.int32))
    _, jl1 = j_decode(jp, jc, jnp.asarray(nxt))
    _, tl1 = tm.decode_step(tp, same, torch.from_numpy(nxt))
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), rtol=RTOL, atol=ATOL)
    # the cross cache passes through decode unchanged
    cross = {n: tc["cross"][n].clone() for n in ("k", "v")}
    for _ in range(3):
        nxt = np.argmax(np.asarray(jl), axis=-1)[:, None]
        jc, jl = j_decode(jp, jc, jnp.asarray(nxt))
        tc, tl = tm.decode_step(tp, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=DECODE_TOL, atol=DECODE_TOL)
    assert all(torch.equal(tc["cross"][n], cross[n]) for n in ("k", "v"))
    assert int(tc["pos"]) == int(jc["pos"]) == 10


def test_prefill_without_frames_or_cross_cache_raises():
    _, _, tm, tp = pair(arch=ARCH)
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="frames"):
        tm.prefill(tp, toks, cache=tm.init_cache(1, 8))
    bare = {k: v for k, v in tm.init_cache(1, 8).items() if k != "cross"}
    with pytest.raises(ValueError, match="cross-attention cache"):
        tm.prefill(tp, toks, cache=bare, frames=torch.zeros(1, 4, 128))


# ---------------------------------------------------------------------------
# the one-shot loop
# ---------------------------------------------------------------------------


def _reference_loop(jm, jp, prompts, frames, gen):
    """The reference CLI's ``_legacy_main`` loop (jitted prefill with the
    frames as an argument, jitted decode, greedy)."""
    B, P = prompts.shape
    cache = jm.init_cache(B, P + gen, enc_len=P)
    cache, logits = jax.jit(lambda p, c, t, f: jm.prefill(p, t, cache=c, frames=f))(
        jp, cache, prompts, frames)
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits, axis=-1)[:, None]
    outs = [tok]
    for _ in range(gen - 1):
        cache, logits = decode(jp, cache, tok)
        tok = jnp.argmax(logits, axis=-1)[:, None]
        outs.append(tok)
    return np.asarray(jnp.concatenate(outs, axis=1))


@pytest.mark.parametrize("arch,kv,use_kernel", [(ARCH, None, False), (ARCH, None, True),
                                                ("yi-9b", "fxp8", False),
                                                ("yi-9b", "fxp8", True)])
def test_one_shot_loop_is_token_identical_to_the_reference(arch, kv, use_kernel):
    """6 greedy tokens a sequence on the reference CLI's draws (B = 2, P =
    8); the kernels' plain versions on the CPU against the Pallas kernels
    in interpret mode."""
    spec = parse_spec(kv) if kv else None
    jm, jp, tm, tp = pair(arch=arch, kv=spec, use_kernel=use_kernel)
    prompts, frames = serve.legacy_inputs(tm.cfg, 2, 8)
    jprompts = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0, jm.cfg.vocab_size)
    jframes = None
    if frames is not None:
        jframes = jax.random.normal(jax.random.PRNGKey(2), (2, 8, jm.cfg.d_model), jnp.float32)
    want = _reference_loop(jm, jp, jprompts, jframes, 6)
    got, logits, _, _ = serve.legacy_loop(tm, tp, prompts, frames, 6)
    assert got.shape == (2, 6) and torch.isfinite(logits).all()
    np.testing.assert_array_equal(got, want)


def test_one_shot_loop_on_its_own_frames_is_token_identical():
    """The port's loop on the reference's exact frames (numpy, passed to
    both): the ulps ``normal`` may differ by do not decide a token."""
    jm, jp, tm, tp = pair(arch=ARCH)
    prompts, _ = serve.legacy_inputs(tm.cfg, 2, 8)
    frames = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (2, 8, 128), jnp.float32))
    want = _reference_loop(jm, jp, jnp.asarray(prompts.numpy()), jnp.asarray(frames), 6)
    got = serve.legacy_loop(tm, tp, prompts, torch.from_numpy(frames.copy()), 6)[0]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# refusals and the CLI
# ---------------------------------------------------------------------------


def test_encdec_refusals():
    _, _, tm, tp = pair(arch=ARCH)
    with pytest.raises(NotImplementedError, match="one-shot"):
        ServeEngine(tm, tp, n_slots=2, max_len=16)
    quant = dataclasses.replace(tm, kv_spec=tspec(parse_spec("fxp8")))
    with pytest.raises(ValueError, match="not supported for encdec"):
        quant.init_cache(2, 16)
    with pytest.raises(ValueError, match="dense/moe"):
        tm.init_paged_cache(2, 16, n_pages=9, page_size=4)


def test_encdec_serve_cli(capsys):
    """The CLI serves whisper at the smoke size through the one-shot loop
    on the reference's prompts, drops the fxp8 KV spec with the
    reference's message and refuses --paged."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--use-kernel", "--kv-quant",
            "fxp8", "--prompt-len", "8", "--gen", "4", "--temperature", "0.5"]
    run = serve.main(argv)
    out = capsys.readouterr().out
    assert run.engine is None and run.done == [] and run.model.kv_spec is None
    leg = run.legacy
    assert leg.tokens.shape == (4, 4) and ((0 <= leg.tokens) & (leg.tokens < 512)).all()
    assert leg.frames.shape == (4, 8, 128) and leg.prefill_s > 0 and leg.decode_s > 0
    np.testing.assert_array_equal(
        leg.prompts.numpy(),
        np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0, 512)))
    for line in ("(encdec: quantized KV cache unsupported on the legacy one-shot path; "
                 "serving with a bf16 cache)", "(encdec: engine unsupported, using one-shot path)",
                 "(legacy path is greedy fixed-batch; ignoring --temperature)",
                 "prefill: 4x8 tokens in", "decode:  3 steps x 4 seqs in",
                 "total:   4 tokens/seq x 4 seqs", "sample (4 tokens):"):
        assert line in out, line
    with pytest.raises(SystemExit):
        serve.main(argv + ["--paged"])
    assert "--paged needs the engine path (not --legacy / encdec)" in capsys.readouterr().err


def test_legacy_flag_serves_a_decoder_family(capsys):
    argv = ["--arch", "yi-9b", "--smoke", "--device", "cpu", "--kv-quant", "fxp8",
            "--legacy", "--batch", "2", "--prompt-len", "6", "--gen", "3"]
    run = serve.main(argv)
    out = capsys.readouterr().out
    assert run.engine is None and run.legacy.frames is None and run.legacy.tokens.shape == (2, 3)
    assert "engine unsupported" not in out and "kv cache @" in out
    with pytest.raises(SystemExit):
        serve.main(argv + ["--paged"])
