"""The port's engine serving the ssm and hybrid families against the
reference's.

Smoke-size falcon-mamba (2 mamba1 layers) and zamba2 (3 mamba2 layers,
the shared attention block before layers 0 and 2), weights drawn by the
reference and carried across, f32 activations. Every stream must be the
reference engine's, token for token, greedy and sampled (temperature 0.8,
top-k 40), with staggered arrivals and one request evicted and resumed.
The resume re-prefills the whole context, and a re-prefilled recurrent
state is not bit for bit the one decode steps carried, in either
framework, so it is held against the reference engine's own evict ->
resume. Then the refusals (prompt bucket > 1, the paged engine, the CLI's
``--paged``) and the CLI itself.
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
SSM_ARCHS = ["falcon-mamba-7b", "zamba2-1.2b"]


def _requests(cls, scls, temperature):
    """4 staggered requests; rid 2 greedy, the others at ``temperature``."""
    return [cls(rid=i, prompt=np.random.RandomState(i).randint(0, VOCAB, 5 + 3 * i),
                max_new=6, arrival=2.0 * i,
                sampling=scls(temperature=0.0 if i == 2 else temperature, top_k=40))
            for i in range(4)]


def _drive(engine, requests, evict_rid):
    """Serve; ``evict_rid`` (None: nobody) is preempted once after a chunk
    and resumed."""
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


ENGINE_KW = dict(n_slots=2, max_len=40, chunk=3, seed=3)


@functools.lru_cache(maxsize=16)
def _reference(arch, kv, use_kernel, temperature, evict_rid):
    jm, jp, _, _ = pair(kv=parse_spec(kv) if kv else None, use_kernel=use_kernel, arch=arch)
    return _drive(JEngine(jm, jp, **ENGINE_KW),
                  _requests(JRequest, JSampling, temperature), evict_rid)


def _check(arch, kv, use_kernel, temperature, evict_rid=None):
    _, _, tm, tp = pair(kv=parse_spec(kv) if kv else None, use_kernel=use_kernel, arch=arch)
    eng = ServeEngine(tm, tp, **ENGINE_KW)
    got = _drive(eng, _requests(Request, SamplingParams, temperature), evict_rid)
    want = _reference(arch, kv, use_kernel, temperature, evict_rid)
    assert_token_identical(got, want, "port", "reference")
    assert all(len(out) == 6 for out in got.values())
    if evict_rid is not None:
        assert eng._states[evict_rid].n_evictions == 1
    return eng


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("kv,use_kernel", [(None, False), ("fxp8", True)])
def test_ssm_engine_greedy_streams_equal_reference(arch, kv, use_kernel):
    _check(arch, kv, use_kernel, 0.0)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_engine_sampled_streams_equal_reference(arch):
    """temperature 0.8, top-k 40 beside a greedy request."""
    _check(arch, "fxp8", True, 0.8)


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_ssm_engine_evict_resume_equals_reference_evict_resume(arch, temperature):
    """rid 1 evicted after its first chunk and resumed: its context (prompt
    + generated prefix) is prefilled again into a fresh recurrent state,
    and the stream goes on as the reference's evict -> resume does."""
    _check(arch, "fxp8", True, temperature, evict_rid=1)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_engine_refusals(arch):
    """A prompt bucket > 1 (right-padding runs into the recurrent state)
    and the paged engine (nothing to page) are refused, as in the
    reference."""
    _, _, tm, tp = pair(arch=arch)
    with pytest.raises(ValueError, match="prompt_bucket"):
        ServeEngine(tm, tp, n_slots=2, max_len=16, prompt_bucket=4)
    with pytest.raises(ValueError, match="dense/moe"):
        ServeEngine(tm, tp, n_slots=2, max_len=16, paged=True, page_size=4)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_serve_cli(arch, capsys):
    """The CLI serves the smoke size with the kernel datapath and an fxp8
    KV cache, and refuses --paged with the reference's message."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--use-kernel", "--kv-quant",
            "fxp8", "--batch", "2", "--requests", "3", "--prompt-len", "6", "--gen", "4"]
    run = serve.main(argv)
    assert run.model.cfg.family == ("ssm" if arch == "falcon-mamba-7b" else "hybrid")
    assert all(len(s.out) == 4 and all(0 <= t < VOCAB for t in s.out) for s in run.done)
    assert "*=pofx8es2" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(argv + ["--paged"])
    assert "--paged supports dense/moe families" in capsys.readouterr().err
