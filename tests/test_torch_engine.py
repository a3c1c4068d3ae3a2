"""The port's ServeEngine against the reference engine: identical greedy
token streams.

One workload drives both engines the same way: 2 slots, staggered
arrivals, a prompt bucket of 4 (right-padded bucketed prefill), and one
running request evicted and later resumed. The reference engine runs at
f32 activations with the weights carried across; the port's engine must
emit the reference's tokens request by request, for every KV-cache format,
with and without the kernel datapath.
"""
import functools

import numpy as np
import pytest

from differential import assert_token_identical
from repro.core.policy import parse_spec
from repro.launch.engine import Request as JRequest, ServeEngine as JEngine
from repro_torch.launch.engine import (Request, SamplingParams, ServeEngine)
from torch_bridge import pair

VOCAB = 512


def _requests(cls):
    return [cls(rid=i, prompt=np.random.RandomState(i).randint(0, VOCAB, 5 + 3 * i),
                max_new=6, arrival=2.0 * i) for i in range(4)]


def _drive(engine, requests, evict_rid=1):
    """``engine.run`` with one eviction: ``evict_rid`` is preempted the
    first time it is running after a decode chunk, then resumes."""
    for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
        engine.submit(r)
    evicted = False
    finished = []
    while engine.pending_rids or engine.active_rids:
        engine.admit_ready()
        if not engine.active_rids:
            engine.clock = max(engine.clock, min(
                r.arrival for r in requests if r.rid in engine.pending_rids))
            continue
        finished += engine.step()
        if not evicted and evict_rid in engine.active_rids:
            engine.evict(evict_rid)
            evicted = True
    assert evicted
    return {s.req.rid: s.out for s in finished}


@functools.lru_cache(maxsize=8)
def _reference_tokens(kv, use_kernel):
    jm, jp, _, _ = pair(kv=parse_spec(kv) if kv else None, use_kernel=use_kernel)
    eng = JEngine(jm, jp, n_slots=2, max_len=40, chunk=3, prompt_bucket=4)
    return _drive(eng, _requests(JRequest))


@pytest.mark.parametrize("kv", [None, "fxp8", "pofx8es2"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_engine_streams_equal_reference(kv, use_kernel):
    _, _, tm, tp = pair(kv=parse_spec(kv) if kv else None, use_kernel=use_kernel)
    got = _drive(ServeEngine(tm, tp, n_slots=2, max_len=40, chunk=3,
                             prompt_bucket=4), _requests(Request))
    want = _reference_tokens(kv, use_kernel)
    assert_token_identical(got, want, "port", "reference")
    assert all(len(out) == 6 for out in got.values())


def test_engine_stats_and_run():
    _, _, tm, tp = pair(kv=parse_spec("fxp8"))
    eng = ServeEngine(tm, tp, n_slots=2, max_len=40, chunk=4)
    done = eng.run(_requests(Request))
    assert [s.req.rid for s in done] == [0, 1, 2, 3]
    st = eng.stats()
    assert st["generated_tokens"] == 24 and st["prefill_sampled_tokens"] == 4
    assert st["decode_tokens"] == 20
    assert all(s.finish_reason == "length" and s.slot == -1 for s in done)


def test_temperature_raises_naming_roadmap_item():
    _, _, tm, tp = pair()
    eng = ServeEngine(tm, tp, n_slots=1, max_len=16)
    with pytest.raises(ValueError, match="A6"):
        eng.submit(Request(rid=0, prompt=np.arange(4), max_new=2,
                           sampling=SamplingParams(temperature=0.7)))


def test_submit_validation():
    _, _, tm, tp = pair()
    eng = ServeEngine(tm, tp, n_slots=1, max_len=8)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(rid=0, prompt=np.arange(8)))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request(rid=1, prompt=np.arange(0)))
    eng.submit(Request(rid=2, prompt=np.arange(3)))
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(Request(rid=2, prompt=np.arange(3)))


def test_serve_cli_returns_what_it_served(capsys):
    from repro_torch.launch import serve
    run = serve.main(["--smoke", "--device", "cpu", "--use-kernel",
                      "--kv-quant", "fxp8", "--batch", "2", "--requests", "3",
                      "--prompt-len", "5", "--gen", "3"])
    assert run.model.device.type == "cpu" and run.engine.n_slots == 2
    assert [s.req.rid for s in run.done] == [0, 1, 2]
    assert all(len(s.out) == 3 for s in run.done)
    assert [list(r.prompt) for r in run.requests] == [
        list(r.prompt) for r in serve.make_requests(run.model.cfg.vocab_size, 3, 5, 3)]
    assert run.engine.stats()["generated_tokens"] == 9
    assert "decode:" in capsys.readouterr().out
