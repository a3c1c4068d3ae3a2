"""The port's PRNG and sampler against the reference's: the same keys, bits,
uniforms and tokens, and sampled engine streams equal to the JAX engine's.

Keys, fold_in, random bits and uniforms are integer or exact float
arithmetic and must equal ``jax.random``'s bit for bit. ``gumbel`` ends in
two ``log``s, where XLA's CPU log and torch's differ by an ulp on about a
seventh of the inputs, so it is held to rtol=1e-6 with atol=1e-6 (where
gumbel is near 0, the outer log of a value near 1 turns an ulp of the
inner log into an absolute error of ~1e-7). Tokens drawn from such values
differ only where two candidates' gumbel + logit scores are within that
error of each other: the helper below records any such near-tie and fails
on every other difference. The data here are fixed; none is re-seeded.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from differential import assert_token_identical
from repro.core.policy import parse_spec
from repro.launch.engine import (Request as JRequest, SamplingParams as JSampling,
                                 ServeEngine as JEngine,
                                 sample_tokens as j_sample_tokens)
from repro_torch.core import prng
from repro_torch.launch.engine import (Request, SamplingParams, ServeEngine,
                                       sample_tokens)
from torch_bridge import pair
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

SEEDS = [0, 1, 42, 2**31 - 1]
SHAPES = [(1,), (7,), (3, 5), (4, 64000)]
NEAR_TIE = 1e-5     # score gap (gumbel + logit) below which two draws may part


def _key_np(jkey):
    return np.asarray(jkey).astype(np.int64)


def _tkey(jkey):
    return torch.from_numpy(_key_np(jkey))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bit_exact(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    assert tk.tolist() == _key_np(jk).tolist()
    for data in (0, 1, 7, 123456, 2**31 - 1, 0xFFFFFFFF):
        want = _key_np(jax.random.fold_in(jk, np.uint32(data)))
        assert prng.fold_in(tk, data).tolist() == want.tolist(), data
    # batched, as the engine's vmap(fold_in)(keys, pos) over int32 positions
    keys = jnp.stack([jax.random.fold_in(jk, i) for i in range(4)])
    pos = np.array([0, 5, 70, 2**31 - 1], np.int32)
    want = _key_np(jax.vmap(jax.random.fold_in)(keys, jnp.asarray(pos)))
    got = prng.fold_in(_tkey(keys), torch.from_numpy(pos))
    assert got.tolist() == want.tolist()
    # the engine's filler stream: fold_in(fold_in(base, 0xFFFFFFFF), i)
    filler = jax.random.fold_in(jk, np.uint32(0xFFFFFFFF))
    want = _key_np(jnp.stack([jax.random.fold_in(filler, i) for i in range(3)]))
    got = prng.fold_in(prng.fold_in(tk, 0xFFFFFFFF).expand(3, 2), torch.arange(3))
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_and_uniform_bit_exact(seed, shape):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    want = np.asarray(jprng.threefry_random_bits(jk, 32, shape)).astype(np.int64)
    assert np.array_equal(prng.random_bits(tk, shape).numpy(), want)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        for lo in (0.0, float(jnp.finfo(jdt).tiny)):
            want = np.asarray(jax.random.uniform(jk, shape, jdt, minval=lo)
                              .astype(jnp.float32))
            got = prng.uniform(tk, shape, tdt, minval=lo).float().numpy()
            assert np.array_equal(got, want), (jdt, lo)


def test_threefry_2x32_hash_matches_reference():
    """The reference hashes the two halves of a flat count array as the
    word pairs; the port's hash on those halves gives the same words."""
    count = np.random.default_rng(0).integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    for seed in (9, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jprng.threefry_2x32(key, jnp.asarray(count))).astype(np.int64)
        k = _tkey(key)
        c = torch.from_numpy(count.astype(np.int64))
        y0, y1 = prng.threefry_2x32(k[0], k[1], c[:32], c[32:])
        assert torch.cat([y0, y1]).tolist() == want.tolist()
        assert prng.threefry_seed(7).tolist() == [0, 7]


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_an_ulp_of_the_logs(seed):
    shape = (4, 64000)
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _assert_tokens_equal_or_near_tie(got, want, keys, scaled):
    """Equal tokens, except where the reference's and the port's winners
    score within NEAR_TIE of each other under the port's gumbel noise."""
    got, want = np.asarray(got), np.asarray(want)
    ties = []
    for b in np.nonzero(got != want)[0]:
        score = (prng.gumbel(keys[b], scaled.shape[-1:]) + scaled[b]).double()
        gap = abs(score[int(got[b])] - score[int(want[b])]).item()
        assert gap < NEAR_TIE, f"row {b}: {got[b]} vs {want[b]}, score gap {gap}"
        ties.append((int(b), gap))
    return ties


def _mix_case(seed, V=512, B=6):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    order = np.argsort(logits[4])
    logits[4, order[-6]] = logits[4, order[-5]]    # a tie at the 5th largest
    temps = np.array([0.0, 0.7, 1.0, 0.7, 0.9, 1e-9], np.float32)
    topks = np.array([0, 0, 5, 1, 5, 3], np.int32)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(seed), 10 + b) for b in range(B)])
    return logits, temps, topks, keys


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_categorical_matches_reference(seed):
    logits, _, _, keys = _mix_case(seed)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits)))
    got = prng.categorical(_tkey(keys), torch.from_numpy(logits))
    _assert_tokens_equal_or_near_tie(got, want, _tkey(keys), torch.from_numpy(logits))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("use_topk", [True, False])
def test_sample_tokens_matches_reference(seed, use_topk):
    """Greedy, temperature-only and top-k slots in one batch; row 4's 5th
    and 6th largest logits are equal, so top-5 keeps six (every tie with
    the k-th)."""
    logits, temps, topks, keys = _mix_case(seed)
    if not use_topk:
        topks[:] = 0
    row = logits[4]
    kth = np.sort(row)[-5]
    assert (row == kth).sum() == 2 and (row >= kth).sum() == 6
    want = np.asarray(j_sample_tokens(jnp.asarray(logits), keys, jnp.asarray(temps),
                                      jnp.asarray(topks), use_topk=use_topk))
    tl, tt, tk = (torch.from_numpy(logits), torch.from_numpy(temps),
                  torch.from_numpy(topks))
    got = sample_tokens(tl, _tkey(keys), tt, tk, use_topk=use_topk)
    assert got[0] == int(np.argmax(logits[0]))       # greedy slot
    if use_topk:
        assert row[int(got[4])] >= kth
    filt = tl.clone()
    if use_topk:
        for b in range(len(topks)):
            if topks[b] > 0:
                kb = torch.sort(tl[b]).values[-topks[b]]
                filt[b] = torch.where(tl[b] < kb, -1e30, tl[b])
    sampled = temps > 0
    _assert_tokens_equal_or_near_tie(
        got.numpy()[sampled], want[sampled], _tkey(keys)[sampled],
        (filt / tt.clamp_min(1e-6)[:, None])[sampled])


def test_sample_tokens_on_bf16_logits_divides_in_f32():
    """bf16 logits over f32 temperatures promote to f32 in both packages."""
    logits, temps, topks, keys = _mix_case(5)
    jl = jnp.asarray(logits).astype(jnp.bfloat16)
    tl = torch.from_numpy(logits).to(torch.bfloat16)
    want = np.asarray(j_sample_tokens(jl, keys, jnp.asarray(temps), jnp.asarray(topks)))
    got = sample_tokens(tl, _tkey(keys), torch.from_numpy(temps), torch.from_numpy(topks))
    assert got.tolist() == want.tolist()


# -- engine streams -----------------------------------------------------------

VOCAB = 512


def _requests(cls, scls, top_k):
    """4 requests, staggered; rid 2 greedy, the rest at temperature 0.7."""
    return [cls(rid=i, prompt=np.random.RandomState(i).randint(0, VOCAB, 5 + 3 * i),
                max_new=6, arrival=2.0 * i,
                sampling=scls(temperature=0.0 if i == 2 else 0.7, top_k=top_k))
            for i in range(4)]


def _drive(engine, requests, evict_rid=1):
    """Serve with ``evict_rid`` preempted once after a chunk, then resumed."""
    for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
        engine.submit(r)
    evicted = False
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


def _engine_kw(paged):
    return dict(n_slots=2, max_len=40, chunk=3, seed=3,
                **(dict(paged=True, page_size=4) if paged else {}))


@functools.lru_cache(maxsize=8)
def _reference_tokens(kv, top_k, paged):
    jm, jp, _, _ = pair(kv=parse_spec(kv) if kv else None)
    return _drive(JEngine(jm, jp, **_engine_kw(paged)),
                  _requests(JRequest, JSampling, top_k))


@pytest.mark.parametrize("kv", [None, "fxp8"])
@pytest.mark.parametrize("top_k", [0, 5])
@pytest.mark.parametrize("paged", [False, True])
def test_sampled_engine_streams_equal_reference(kv, top_k, paged):
    """temperature 0.7 (top-k off or 5) beside a greedy request, staggered
    arrivals, one request evicted and resumed: every stream is the
    reference engine's, dense or paged."""
    _, _, tm, tp = pair(kv=parse_spec(kv) if kv else None)
    eng = ServeEngine(tm, tp, **_engine_kw(paged))
    got = _drive(eng, _requests(Request, SamplingParams, top_k))
    want = _reference_tokens(kv, top_k, paged)
    assert_token_identical(got, want, "port", "reference")
    assert all(len(out) == 6 for out in got.values())
    assert eng._states[1].n_evictions == 1
    if paged:
        eng._pager.check()


def test_sampled_streams_do_not_depend_on_batch_or_paging():
    """The same sampled requests alone on one slot, together on two, and
    paged: a request's stream depends on its key and positions only."""
    _, _, tm, tp = pair(kv=parse_spec("fxp8"))
    reqs = _requests(Request, SamplingParams, 5)
    one = ServeEngine(tm, tp, n_slots=1, max_len=40, chunk=4, seed=3).run(reqs)
    two = ServeEngine(tm, tp, **_engine_kw(False)).run(reqs)
    paged = ServeEngine(tm, tp, **_engine_kw(True)).run(reqs)
    streams = [{s.req.rid: s.out for s in run} for run in (one, two, paged)]
    assert streams[0] == streams[1] == streams[2]
    other = ServeEngine(tm, tp, n_slots=2, max_len=40, chunk=3, seed=4).run(reqs)
    assert {s.req.rid: s.out for s in other} != streams[0]


def test_serve_cli_samples(capsys):
    from repro_torch.launch import serve
    argv = ["--smoke", "--device", "cpu", "--use-kernel", "--kv-quant", "fxp8",
            "--batch", "2", "--requests", "3", "--prompt-len", "5", "--gen", "4",
            "--temperature", "0.8", "--top-k", "40"]
    run = serve.main(argv)
    assert all(s.req.sampling == SamplingParams(0.8, 40) for s in run.done)
    greedy = serve.main(argv[:-4])
    assert [s.out for s in run.done] != [s.out for s in greedy.done]
    assert [s.out for s in serve.main(argv).done] == [s.out for s in run.done]
    assert "decode:" in capsys.readouterr().out
