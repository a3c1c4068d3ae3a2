"""Test-side helpers of the grid-serving tests (``test_torch_serve_grid*.py``):
the reference's prefill and decode at ``mesh=None`` on the smoke weights, the
port's tp = 1 run on the same weights, and the grid's ranks through a
``RankPool`` (``grid_ranks.serve_case``), held against both.

Each case draws its weights with the reference (seed 0, quantized by the
case's policy) and carries them across (``torch_bridge.pair``). The
reference runs its plain path (``use_kernel=False``: no Pallas interpret
mode); the port's ranks and its tp = 1 run take the kernels' datapath
(``use_kernel``, by default), whose wrappers compute their plain versions
on the CPU (``kv_flash_decode_ref`` with its lse included). Each side
decodes STEPS greedy steps; the grid's tokens must be the reference's and
the tp = 1 port's, so every step's logits compare.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.policy import parse_spec
from torch_bridge import pair, to_numpy_tree, tspec

# f32 logits of a small model in two frameworks (tests/test_torch_models.py)
RTOL, ATOL = 1e-4, 1e-4
# decode logits from each side's own cache: a K/V value an ulp apart (the
# grid's products run on other column blocks than tp = 1's) may round to
# the neighbouring code or bf16 value, one step on at most 0.1 % of the
# entries (the caches' check below); such a flip moves a logit by up to
# ~3e-4 (bf16, tests/test_torch_encdec.py) or 6.1e-4 (one fxp8 K code of
# yi-9b on (data 2, model 2), layer 1, row 3, position 14, read with a
# 16-position cache and 6 steps)
DECODE_TOL = 1e-3
B, PROMPT, STEPS = 4, 9, 8


def host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy (bf16 as f32)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def inputs(arch, cfg, ragged=False):
    """(tokens (B, PROMPT), per-row lengths or None, frames or None)."""
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (B, PROMPT))
    length = np.array([9, 5, 7, 3], dtype=np.int32) if ragged else None
    frames = (rng.randn(B, 8, cfg.d_model).astype(np.float32)
              if cfg.family == "encdec" else None)
    return toks, length, frames


@functools.lru_cache(maxsize=None)
def reference(arch, policy, kv, max_len, ragged=False, use_kernel=True):
    """The reference's greedy run and the port's tp = 1 greedy run of one
    case: {"case": what the ranks take, "logits": the reference's prefill
    and decode logits, "tokens": its greedy tokens (B, STEPS), "tp1": the
    port's greedy tokens and its KV caches after the prefill and after the
    steps}."""
    spec = parse_spec(kv) if kv else None
    jm, jp, tm, tp = pair(policy, kv=spec, arch=arch)
    toks, length, frames = inputs(arch, jm.cfg, ragged)
    enc = {"enc_len": frames.shape[1]} if frames is not None else {}
    kw = {} if frames is None else {"frames": jnp.asarray(frames)}
    if length is not None:
        kw["length"] = jnp.asarray(length)
    jc, jl = jax.jit(lambda p, t, c, kw: jm.prefill(p, t, cache=c, **kw))(
        jp, jnp.asarray(toks), jm.init_cache(B, max_len, **enc), kw)
    step = jax.jit(jm.decode_step)
    logits, tokens = [np.asarray(jl)], []
    for _ in range(STEPS):
        nxt = np.argmax(logits[-1], axis=-1).astype(np.int32)
        tokens.append(nxt)
        jc, jl = step(jp, jc, jnp.asarray(nxt[:, None]))
        logits.append(np.asarray(jl))
    tkw = {} if frames is None else {"frames": torch.from_numpy(frames)}
    if length is not None:
        tkw["length"] = torch.from_numpy(length)
    tm = dataclasses.replace(tm, use_kernel=use_kernel)
    group = "shared_kv" if jm.cfg.family == "hybrid" else "kv"
    tc, tl = tm.prefill(tp, torch.from_numpy(toks), cache=tm.init_cache(B, max_len, **enc),
                        **tkw)
    caches, stream = [{k: host(v) for k, v in tc.get(group, {}).items()}], []
    for _ in range(STEPS):
        nxt = tl.argmax(-1)[:, None]
        stream.append(nxt[:, 0].numpy())
        tc, tl = tm.decode_step(tp, tc, nxt)
    caches.append({k: host(v) for k, v in tc.get(group, {}).items()})
    case = {"arch": arch, "tree": to_numpy_tree(jp), "kv": tspec(spec),
            "use_kernel": use_kernel, "tokens": toks, "length": length,
            "frames": frames, "enc_len": enc.get("enc_len"), "max_len": max_len,
            "steps": STEPS}
    return {"case": case, "logits": logits, "tokens": np.stack(tokens, 1),
            "tp1": {"caches": caches, "stream": np.stack(stream, 1)}}


def check_grid(pool, grid, arch, policy="pofx8", kv="fxp8", max_len=20, ragged=False,
               use_kernel=True):
    """Every rank's greedy tokens equal the reference's and the port's tp
    = 1 ones; its logits against the reference's (the prefill's to
    RTOL/ATOL, the decode steps' to DECODE_TOL), the same on every rank;
    each rank's KV cache block against the port's tp = 1 cache (the rank's
    rows and positions), after the prefill and after the steps: codes
    within one step on at most 0.1 % of the entries; bf16 values after the
    prefill within one bf16 step (on at most 0.1 % of them), after the
    steps, whose K/V come from each side's own cache, to DECODE_TOL."""
    from repro_torch.nn.sharding import GridContext
    from repro_torch.launch.mesh import grid_layout
    ref = reference(arch, policy, kv, max_len, ragged, use_kernel)
    from grid_ranks import serve_case
    res = pool.run(serve_case, ref["case"], grid=grid)
    shape, names = grid_layout(*grid)
    M = grid[2]
    for r, got in enumerate(res):
        lay = GridContext(shape, names, rank=r)
        r0, nb = lay.rows(B)
        for when, (cache, tp1) in enumerate(zip(got["caches"], ref["tp1"]["caches"])):
            for name, leaf in cache.items():
                want = tp1[name][:, r0:r0 + nb]
                if not name.endswith("_scale"):
                    S_l = want.shape[3] // M
                    m = lay.coords["model"]
                    want = want[:, :, :, m * S_l:(m + 1) * S_l]
                assert leaf.shape == want.shape, (name, leaf.shape, want.shape)
                got_f, want_f = leaf.astype(np.float32), want.astype(np.float32)
                what = f"rank {r}, {name} after {'the steps' if when else 'the prefill'}"
                if leaf.dtype in (np.int8, np.uint8) or name.endswith("_scale"):
                    assert (got_f != want_f).mean() <= 1e-3, what
                    assert np.abs(got_f - want_f).max() <= 1, what
                elif when == 0:
                    assert (got_f != want_f).mean() <= 1e-3, what
                    np.testing.assert_allclose(got_f, want_f, rtol=2 ** -7, atol=1e-6,
                                               err_msg=what)
                else:
                    np.testing.assert_allclose(got_f, want_f, rtol=2 ** -7, atol=DECODE_TOL,
                                               err_msg=what)
        np.testing.assert_array_equal(got["stream"], ref["tp1"]["stream"])
        np.testing.assert_array_equal(got["stream"], ref["tokens"])
        for s, (a, b) in enumerate(zip(got["logits"], ref["logits"])):
            tol = RTOL if s == 0 else DECODE_TOL
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                       err_msg=f"rank {r}, step {s}")
            np.testing.assert_array_equal(a, res[0]["logits"][s])
    return res
