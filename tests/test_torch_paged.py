"""The port's paged serving path against the reference's (JAX) one.

* the paged flash-decode wrapper (its plain version on the CPU) against the
  reference's Pallas kernel in interpret mode and its gather oracle, over
  ragged scrambled block tables with garbage-page tails;
* ``prefill_paged`` logits and pool codes against the reference's, with
  and without a shared prefix (one ending inside a page);
* the paged engine's greedy token streams against the reference's paged
  engine and the port's dense engine, with prefix sharing, copy-on-write,
  evict -> resume and pool pressure, and its paging stats against the
  reference's.

Weights are drawn by the reference and carried across; activations are f32
in both packages.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential import assert_token_identical
from repro.core.policy import parse_spec
from repro.core.quantizers import kv_quantize as j_kv_quantize
from repro.kernels.kv_flash_paged_decode import kv_flash_paged_decode as j_paged
from repro.kernels.ref import gather_pages as j_gather_pages
from repro.kernels.ref import kv_flash_paged_decode_ref as j_paged_ref
from repro.launch.engine import Request as JRequest, ServeEngine as JEngine
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.kv_flash_paged_decode import kv_flash_paged_decode
from repro_torch.kernels.ref import gather_pages, kv_flash_paged_decode_ref
from repro_torch.launch.engine import Request, ServeEngine
from torch_bridge import pair, tspec
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

# the kernel's plain version against the reference's kernel: f32 softmax
# attention over <= 20 positions computed in another order
RTOL, ATOL = 1e-5, 1e-6
# f32 logits of a 2-layer model in two frameworks (as test_torch_models)
LOGIT_TOL = 1e-4


def _paged_inputs(spec_s, ps, pos, B=3, G=2, R=4, Dh=32, S=20, seed=0):
    """Random pools and ragged, scrambled block tables: slot b owns
    ceil(pos[b] / ps) pages, none contiguous in the pool, and points the
    rest of its row at the garbage page 0 (which holds junk too)."""
    spec = parse_spec(spec_s)
    rng = np.random.default_rng(seed + ps)
    max_pages = -(-S // ps)
    n_pages = B * max_pages + 3
    ks = np.exp2(rng.integers(-1, 2, (G, 1, Dh))).astype(np.float32)
    vs = np.exp2(rng.integers(-1, 2, (G, 1, Dh))).astype(np.float32)
    kf = rng.normal(0, 0.6, (n_pages, G, ps, Dh)).astype(np.float32)
    vf = rng.normal(0, 0.6, (n_pages, G, ps, Dh)).astype(np.float32)
    kc = np.array(j_kv_quantize(jnp.asarray(kf), spec, jnp.asarray(ks)))
    vc = np.array(j_kv_quantize(jnp.asarray(vf), spec, jnp.asarray(vs)))
    q = rng.normal(0, 1, (B, G, R, Dh)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((B, max_pages), np.int32)
    used = 0
    for b in range(B):
        n = min(-(-max(int(pos[b]), 1) // ps), max_pages)
        tables[b, :n] = perm[used:used + n]
        used += n
    return spec, q, kc, ks, vc, vs, tables, np.asarray(pos, np.int32)


@pytest.mark.parametrize("spec_s", ["fxp8", "pofx8es2"])
@pytest.mark.parametrize("ps", [1, 4, 5])
def test_paged_decode_plain_matches_reference_kernel(spec_s, ps):
    spec, *arrays = _paged_inputs(spec_s, ps, [7, 13, 20])
    want = np.asarray(j_paged(*map(jnp.asarray, arrays), spec, interpret=True))
    want_ref = np.asarray(j_paged_ref(*map(jnp.asarray, arrays), spec))
    args = [torch.from_numpy(a) for a in arrays]
    before = dict(LAUNCHES)
    got = kv_flash_paged_decode(*args, tspec(spec))
    assert LAUNCHES == before                       # CPU tensors: plain version
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, kv_flash_paged_decode_ref(*args, tspec(spec)))
    for pool in (arrays[1], arrays[3]):
        np.testing.assert_array_equal(
            gather_pages(torch.from_numpy(pool), args[5]).numpy(),
            np.asarray(j_gather_pages(jnp.asarray(pool), jnp.asarray(arrays[5]))))


def test_paged_decode_pos_zero_and_scalar_pos_match_reference():
    """pos <= 0 masks every position of the slot: the reference (kernel and
    oracle) then averages V over all max_pages * ps rows, garbage pages
    included, and so must the port. A scalar pos broadcasts."""
    spec, *arrays = _paged_inputs("fxp8", 4, [0, 9, 20])
    want = np.asarray(j_paged(*map(jnp.asarray, arrays), spec, interpret=True))
    got = kv_flash_paged_decode(*[torch.from_numpy(a) for a in arrays], tspec(spec))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    arrays[-1] = np.int32(11)
    want = np.asarray(j_paged(*map(jnp.asarray, arrays), spec, interpret=True))
    got = kv_flash_paged_decode(*[torch.as_tensor(a) for a in arrays], tspec(spec))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_paged_decode_layout_errors_raise_in_both():
    spec = parse_spec("fxp8")
    G, R, Dh, ps = 2, 2, 8, 4
    q = np.zeros((1, G, R, Dh), np.float32)
    pool = np.zeros((4, G, ps, Dh), np.int8)
    good = np.ones((G, 1, Dh), np.float32)
    tables = np.zeros((1, 2), np.int32)
    pos = np.asarray([3], np.int32)
    bad = [
        ("global per-head-dim-channel", (q, pool, np.ones((1, G, 1, Dh), np.float32),
                                         pool, good, tables, pos)),
        ("global per-head-dim-channel", (q, pool, good, pool,
                                         np.ones((G, Dh), np.float32), tables, pos)),
        ("pool shape mismatch", (q, pool, good, np.zeros((5, G, ps, Dh), np.int8),
                                 good, tables, pos)),
        ("does not match queries", (q, np.zeros((4, G + 1, ps, Dh), np.int8), good,
                                    np.zeros((4, G + 1, ps, Dh), np.int8), good,
                                    tables, pos)),
        ("tables must be", (q, pool, good, pool, good, np.zeros((3,), np.int32), pos)),
        ("tables must be", (q, pool, good, pool, good, np.zeros((2, 2), np.int32), pos)),
    ]
    for match, arrays in bad:
        with pytest.raises(ValueError, match=match):
            j_paged(*map(jnp.asarray, arrays), spec, interpret=True)
        with pytest.raises(ValueError, match=match):
            kv_flash_paged_decode(*map(torch.from_numpy, arrays), tspec(spec))


# ---------------------------------------------------------------------------
# prefill_paged against the reference
# ---------------------------------------------------------------------------


def _assert_pool_close(tc, jc):
    """Pools agree up to rounding-boundary flips, as in test_torch_models:
    one code step on at most 0.1 % of the entries; scales and tables exact."""
    for name, leaf in tc["kv"].items():
        got = leaf.float().numpy()
        want = np.asarray(jc["kv"][name]).astype(np.float32)
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
    np.testing.assert_array_equal(tc["pages"].numpy(), np.asarray(jc["pages"]))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("kv", [None, "fxp8", "pofx8es2"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_paged_matches_reference(kv, use_kernel):
    """Slot 0 prefills a 7-token context into pages 1..; slot 1 shares its
    first page in full and, by a copy-on-write copy, the first two tokens of
    its second page (a 6-token prefix ending inside a page), and prefills
    the one-token suffix. Logits, pools and positions match the reference,
    and the suffix prefill's logits match the full prefill's. Then three
    paged decode steps of both slots match too."""
    spec = parse_spec(kv) if kv else None
    jm, jp, tm, tp = pair(kv=spec, use_kernel=use_kernel)
    P, ps, max_len, prefix = 7, 4, 16, 6
    toks = np.random.RandomState(0).randint(0, 512, (1, P))
    row0 = np.array([1, 2, 3, 4], np.int32)
    row1 = np.array([1, 5, 6, 7], np.int32)
    jc = jm.init_paged_cache(2, max_len, n_pages=9, page_size=ps)
    tc = tm.init_paged_cache(2, max_len, n_pages=9, page_size=ps)
    jc["pages"] = jc["pages"].at[0].set(jnp.asarray(row0))
    tc["pages"][0] = torch.from_numpy(row0)
    jc, jl = jm.prefill_paged(jp, jnp.asarray(toks), cache=jc, slot=jnp.asarray(0),
                              length=jnp.asarray(P), prefix_len=0)
    tc, tl = tm.prefill_paged(tp, torch.from_numpy(toks), cache=tc, slot=0,
                              length=P, prefix_len=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # copy-on-write of page 2 into page 5, then the suffix prefill of slot 1
    for name in ("k", "v"):
        jc["kv"][name] = jc["kv"][name].at[:, 5].set(jc["kv"][name][:, 2])
        tc["kv"][name][:, 5] = tc["kv"][name][:, 2]
    jc["pages"] = jc["pages"].at[1].set(jnp.asarray(row1))
    tc["pages"][1] = torch.from_numpy(row1)
    jc, jl1 = jm.prefill_paged(jp, jnp.asarray(toks[:, prefix:]), cache=jc,
                               slot=jnp.asarray(1), length=jnp.asarray(P - prefix),
                               prefix_len=prefix)
    tc, tl1 = tm.prefill_paged(tp, torch.from_numpy(toks[:, prefix:]), cache=tc,
                               slot=1, length=P - prefix, prefix_len=prefix)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    if spec is not None:        # the sharing invariant: prefix codes = full prefill's
        np.testing.assert_allclose(tl1.numpy(), tl.numpy(), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    _assert_pool_close(tc, jc)
    for _ in range(3):
        nxt = np.argmax(np.asarray(jl1), -1)
        tok = np.stack([np.argmax(np.asarray(jl), -1), nxt], 0).reshape(2, 1)
        jc, jls = jm.decode_step(jp, jc, jnp.asarray(tok))
        tc, tls = tm.decode_step(tp, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tls.numpy(), np.asarray(jls), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        jl, jl1 = jls[:1], jls[1:]
    _assert_pool_close(tc, jc)


def test_paged_cache_layout_and_rejections():
    _, _, tm, tp = pair(kv=parse_spec("pofx8es2"))
    cfg = tm.cfg
    cache = tm.init_paged_cache(2, 24, n_pages=9, page_size=4)
    assert cache["kv"]["k"].dtype == torch.uint8
    assert tuple(cache["kv"]["k"].shape) == (cfg.n_layers, 9, cfg.n_kv_heads, 4, cfg.d_head)
    assert tuple(cache["kv"]["k_scale"].shape) == (cfg.n_layers, cfg.n_kv_heads, 1, cfg.d_head)
    assert tuple(cache["pages"].shape) == (2, 6) and cache["pages"].dtype == torch.int32
    with pytest.raises(ValueError, match="page_size"):
        tm.init_paged_cache(1, 8, n_pages=4, page_size=0)
    bad = dict(cache, kv=dict(cache["kv"], k_scale=torch.ones(cfg.n_layers, 2, cfg.n_kv_heads,
                                                              1, cfg.d_head)))
    with pytest.raises(ValueError, match="global per layer"):
        tm.decode_step(tp, bad, torch.zeros(2, 1, dtype=torch.long))
    _, _, plain, _ = pair()
    with pytest.raises(ValueError, match="cache layout"):
        plain.decode_step(tp, cache, torch.zeros(2, 1, dtype=torch.long))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_paged_non_pageable_families_refused(arch, capsys):
    """The reference pages dense and moe only: ssm and hybrid models build
    and serve dense, but refuse a paged cache, and serve --paged refuses
    them, with the reference's messages."""
    from repro_torch.configs import ARCHS, RunConfig, smoke
    from repro_torch.launch import serve
    from repro_torch.nn.models import build_model
    model = build_model(smoke(ARCHS[arch]), RunConfig(), device="cpu")
    with pytest.raises(ValueError, match="attention-only families"):
        model.init_paged_cache(2, 16, n_pages=9, page_size=4)
    with pytest.raises(SystemExit):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--paged"])
    assert "--paged supports dense/moe families" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# engines: port paged == reference paged == port dense
# ---------------------------------------------------------------------------

VOCAB = 512
PAGING_KEYS = ("resident_pages", "free_pages", "prefix_queries", "prefix_hits",
               "prefix_hit_tokens", "prefix_hit_rate", "pages_freed",
               "pages_reclaimed", "cow_copies", "index_holdings",
               "index_resident_tokens")


def _shared_requests(cls):
    """rid 1 repeats rid 0's prompt (an 11-token hit capped at 10, ending
    inside a 4-token page: copy-on-write), rid 2 shares its first 6 tokens,
    rid 3 shares nothing."""
    base = np.random.RandomState(7).randint(0, VOCAB, 11)
    prompts = [base, base, np.concatenate([base[:6], np.random.RandomState(8).randint(
        0, VOCAB, 4)]), np.random.RandomState(9).randint(0, VOCAB, 9)]
    return [cls(rid=i, prompt=p, max_new=6, arrival=float(i)) for i, p in enumerate(prompts)]


def _pressure_requests(cls):
    return [cls(rid=i, prompt=np.random.RandomState(i).randint(0, VOCAB, 8),
                max_new=4, arrival=float(2 * i)) for i in range(4)]


# name: (requests, engine kwargs, request evicted once after a chunk)
WORKLOADS = {
    "shared": (_shared_requests, dict(max_len=40, page_size=4), 1),
    "pressure": (_pressure_requests, dict(max_len=24, page_size=4, n_pages=7), None),
    "bucketed": (_shared_requests, dict(max_len=40, page_size=4, prompt_bucket=4), 1),
}


def _drive(engine, requests, evict_rid):
    for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
        engine.submit(r)
    evicted = evict_rid is None
    while engine.pending_rids or engine.active_rids:
        engine.admit_ready()
        if not engine.active_rids:
            engine.clock = max(engine.clock, min(
                r.arrival for r in requests if r.rid in engine.pending_rids))
            continue
        engine.step()
        if not evicted and evict_rid in engine.active_rids:
            engine.evict(evict_rid)
            evicted = True
    assert evicted
    return {rid: st.out for rid, st in engine._states.items()}


def _engine_kw(workload):
    kw = dict(WORKLOADS[workload][1])
    return kw, {k: kw.pop(k) for k in ("page_size", "n_pages") if k in kw}


@functools.lru_cache(maxsize=16)
def _reference(workload, kv, use_kernel):
    make, _, evict = WORKLOADS[workload]
    jm, jp, _, _ = pair(kv=parse_spec(kv) if kv else None, use_kernel=use_kernel)
    kw, paging = _engine_kw(workload)
    eng = JEngine(jm, jp, n_slots=2, chunk=3, paged=True, **kw, **paging)
    out = _drive(eng, make(JRequest), evict)
    eng._pager.check()
    return out, {k: eng.stats()[k] for k in PAGING_KEYS}


@pytest.mark.parametrize("kv", [None, "fxp8", "pofx8es2"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("workload", ["shared", "pressure"])
def test_paged_engine_matches_reference_and_dense(workload, kv, use_kernel):
    make, _, evict = WORKLOADS[workload]
    _, _, tm, tp = pair(kv=parse_spec(kv) if kv else None, use_kernel=use_kernel)
    kw, paging = _engine_kw(workload)
    eng = ServeEngine(tm, tp, n_slots=2, chunk=3, paged=True, **kw, **paging)
    before = dict(LAUNCHES)
    got = _drive(eng, make(Request), evict)
    assert LAUNCHES == before                       # CPU: no kernel launches
    eng._pager.check()
    want, want_stats = _reference(workload, kv, use_kernel)
    assert_token_identical(got, want, "port paged", "reference paged")
    st = eng.stats()
    assert {k: st[k] for k in PAGING_KEYS} == want_stats
    dense = _drive(ServeEngine(tm, tp, n_slots=2, chunk=3, **kw), make(Request), evict)
    assert_token_identical(got, dense, "port paged", "port dense")
    assert all(len(out) == make(Request)[0].max_new for out in got.values())
    if workload == "shared":
        assert st["cow_copies"] >= 1 and st["prefix_hits"] >= 2
        assert eng._states[1].n_evictions == 1
    else:
        assert st["pages_reclaimed"] > 0


def test_paged_bucketed_engine_aligns_hits_like_reference():
    """prompt_bucket > 1 page-aligns prefix hits (no copy-on-write at
    admission); streams and paging stats still match."""
    make, _, evict = WORKLOADS["bucketed"]
    _, _, tm, tp = pair(kv=parse_spec("fxp8"))
    kw, paging = _engine_kw("bucketed")
    eng = ServeEngine(tm, tp, n_slots=2, chunk=3, paged=True, **kw, **paging)
    got = _drive(eng, make(Request), evict)
    want, want_stats = _reference("bucketed", "fxp8", False)
    assert_token_identical(got, want, "port paged", "reference paged")
    assert {k: eng.stats()[k] for k in PAGING_KEYS} == want_stats
    assert want_stats["prefix_hit_tokens"] % 4 == 0
    dense = _drive(ServeEngine(tm, tp, n_slots=2, chunk=3, **kw), make(Request), evict)
    assert_token_identical(got, dense, "port paged", "port dense")


def test_paged_stats_surface_and_cli(capsys):
    from repro_torch.launch import serve
    run = serve.main(["--smoke", "--device", "cpu", "--paged", "--page-size", "4",
                      "--kv-quant", "fxp8", "--use-kernel", "--batch", "2",
                      "--requests", "3", "--prompt-len", "6", "--gen", "3"])
    st = run.engine.stats()
    for key in PAGING_KEYS:
        assert key in st, key
    assert run.engine.paged and run.engine.n_pages == 2 * 3 + 2 + 1
    assert "paging:" in capsys.readouterr().out
    run.engine._pager.check()
    dense = serve.main(["--smoke", "--device", "cpu", "--kv-quant", "fxp8",
                        "--use-kernel", "--batch", "2", "--requests", "3",
                        "--prompt-len", "6", "--gen", "3"])
    assert "prefix_hit_rate" not in dense.engine.stats()
    assert [s.out for s in run.done] == [s.out for s in dense.done]
