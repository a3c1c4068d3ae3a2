"""The port's engines serving the MoE family against the reference's.

Smoke-size moonshot (every layer MoE) and llama4 (dense and MoE layers
interleaved), weights drawn by the reference and carried across, f32
activations. Every stream must be the reference engine's, token for token:

* dense engine, greedy and sampled, with staggered arrivals, a prompt
  bucket of 4 (pad tokens are routed too) and one request evicted and
  resumed (its re-prefill routes a longer context, with its own drops);
* paged engine against the reference's paged engine on a shared-prefix
  workload: prefix hits prefill only the suffix (another T, so other
  drops than a dense prefill of the whole context, as in the reference),
  copy-on-write, and one evict -> resume; paging stats equal too;
* the serving CLI, dense and ``--paged``.
"""
import functools

import numpy as np
import pytest

from differential import assert_token_identical
from repro.core.policy import parse_spec
from repro.launch.engine import (Request as JRequest, SamplingParams as JSampling,
                                 ServeEngine as JEngine)
from repro_torch.launch.engine import Request, SamplingParams, ServeEngine
from torch_bridge import pair
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

VOCAB = 512
MOE_ARCHS = ["moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"]
PAGING_KEYS = ("resident_pages", "prefix_queries", "prefix_hits", "prefix_hit_tokens",
               "pages_freed", "pages_reclaimed", "cow_copies")


def _requests(cls, scls, temperature):
    """4 staggered requests; rid 2 greedy, the others at ``temperature``."""
    return [cls(rid=i, prompt=np.random.RandomState(i).randint(0, VOCAB, 5 + 3 * i),
                max_new=6, arrival=2.0 * i,
                sampling=scls(temperature=0.0 if i == 2 else temperature, top_k=40))
            for i in range(4)]


def _shared_requests(cls, scls, temperature):
    """rid 1 repeats rid 0's prompt (a hit ending inside a 4-token page:
    copy-on-write), rid 2 shares its first 6 tokens, rid 3 nothing."""
    base = np.random.RandomState(7).randint(0, VOCAB, 11)
    prompts = [base, base, np.concatenate([base[:6], np.random.RandomState(8).randint(
        0, VOCAB, 4)]), np.random.RandomState(9).randint(0, VOCAB, 9)]
    return [cls(rid=i, prompt=p, max_new=6, arrival=float(i),
                sampling=scls(temperature=temperature, top_k=40))
            for i, p in enumerate(prompts)]


WORKLOADS = {"staggered": (_requests, dict(prompt_bucket=4)),
             "shared": (_shared_requests, {})}


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


def _engine_kw(workload, paged):
    return dict(n_slots=2, max_len=40, chunk=3, seed=3, **WORKLOADS[workload][1],
                **(dict(paged=True, page_size=4) if paged else {}))


@functools.lru_cache(maxsize=16)
def _reference(arch, kv, use_kernel, workload, temperature, paged):
    jm, jp, _, _ = pair(kv=parse_spec(kv) if kv else None, use_kernel=use_kernel, arch=arch)
    eng = JEngine(jm, jp, **_engine_kw(workload, paged))
    out = _drive(eng, WORKLOADS[workload][0](JRequest, JSampling, temperature))
    stats = {k: eng.stats()[k] for k in PAGING_KEYS} if paged else None
    return out, stats


def _check(arch, kv, use_kernel, workload, temperature, paged):
    _, _, tm, tp = pair(kv=parse_spec(kv) if kv else None, use_kernel=use_kernel, arch=arch)
    eng = ServeEngine(tm, tp, **_engine_kw(workload, paged))
    got = _drive(eng, WORKLOADS[workload][0](Request, SamplingParams, temperature))
    want, want_stats = _reference(arch, kv, use_kernel, workload, temperature, paged)
    assert_token_identical(got, want, "port", "reference")
    assert all(len(out) == 6 for out in got.values())
    assert eng._states[1].n_evictions == 1
    if paged:
        eng._pager.check()
        assert {k: eng.stats()[k] for k in PAGING_KEYS} == want_stats
    return eng


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("kv,use_kernel", [(None, False), ("fxp8", True)])
def test_moe_engine_greedy_streams_equal_reference(arch, kv, use_kernel):
    _check(arch, kv, use_kernel, "staggered", 0.0, paged=False)


@pytest.mark.parametrize("arch,paged", [("moonshot-v1-16b-a3b", False),
                                        ("llama4-maverick-400b-a17b", True)])
def test_moe_engine_sampled_streams_equal_reference(arch, paged):
    """temperature 0.8, top-k 40 beside a greedy request (dense), or on
    the shared-prefix workload (paged)."""
    _check(arch, "fxp8", True, "shared" if paged else "staggered", 0.8, paged)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("kv,use_kernel", [(None, False), ("fxp8", True)])
def test_moe_paged_engine_equals_reference_paged(arch, kv, use_kernel):
    """Prefix hits, copy-on-write and an evict -> resume that re-attaches
    its pages: the reference's paged streams and paging stats."""
    eng = _check(arch, kv, use_kernel, "shared", 0.0, paged=True)
    st = eng.stats()
    assert st["cow_copies"] >= 1 and st["prefix_hits"] >= 2


def test_moe_serve_cli_dense_and_paged(capsys):
    """The CLI serves moonshot at the smoke size, dense and --paged: random
    prompts give no prefix hit, so the paged streams are the dense ones."""
    from repro_torch.launch import serve
    argv = ["--arch", "moonshot-v1-16b-a3b", "--smoke", "--device", "cpu", "--use-kernel",
            "--kv-quant", "fxp8", "--batch", "2", "--requests", "3", "--prompt-len", "6",
            "--gen", "4"]
    dense = serve.main(argv)
    paged = serve.main(argv + ["--paged", "--page-size", "4"])
    assert dense.model.cfg.family == "moe" and paged.engine.paged
    assert all(len(s.out) == 4 for s in dense.done)
    assert [s.out for s in paged.done] == [s.out for s in dense.done]
    assert paged.engine.stats()["prefix_hits"] == 0
    paged.engine._pager.check()
    out = capsys.readouterr().out
    assert "paging:" in out and "*=pofx8es2" in out
