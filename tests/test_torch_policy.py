"""The port's quantization-policy grammar and storage report against the
reference: every preset and grammar string parses to equal specs, and the
storage report of converted parameters is the reference's text."""
import dataclasses

import pytest

from repro.core import policy as jpol
from repro_torch.core import policy as tpol
from torch_bridge import pair

SPECS = ["fp32", "bf16", "fxp8", "fxp8f7", "fxp16", "fxp7f6", "posit8es2",
         "posit6es1", "posit8", "pofx8es2", "pofx8", "pofx6es1m8-direct",
         "pofx8es2@tensor", "fxp8@none", "posit8es2@tensor", "keep", "skip",
         "f32", "bfloat16", "pofx7es3m16-viafxp"]
POLICIES = ["attn/*=pofx8es2,mlp/*=fxp8f7,*=bf16",
            "attn/wq=posit8es2,attn/*=pofx8es2,mlp/*=fxp8f7,*=bf16",
            "embed=bf16,kv=fxp8,*=pofx8es2", "pofx8", "*embed*=keep,*=fxp8",
            " attn/* = pofx6es1 , *=bf16 ", "kv=pofx8es2,*=keep",
            *sorted(jpol.PRESETS)]


def _same(tspec, jspec):
    if jspec is None:
        return tspec is None
    return dataclasses.asdict(tspec) == dataclasses.asdict(jspec)


@pytest.mark.parametrize("s", SPECS)
def test_spec_parse_and_format_match(s):
    t, j = tpol.parse_spec(s), jpol.parse_spec(s)
    assert _same(t, j)
    assert tpol.format_spec(t) == jpol.format_spec(j)
    assert _same(tpol.parse_spec(tpol.format_spec(t)), j)


@pytest.mark.parametrize("bad", ["pofx", "int8", "fxp8q3", "pofx8es2@bogus",
                                 "posit8-direct", ""])
def test_spec_parse_rejects_what_reference_rejects(bad):
    with pytest.raises(ValueError):
        jpol.parse_spec(bad)
    with pytest.raises(ValueError):
        tpol.parse_spec(bad)


@pytest.mark.parametrize("s", POLICIES)
def test_policy_rules_match(s):
    t, j = tpol.QuantPolicy.from_string(s), jpol.QuantPolicy.from_string(s)
    assert len(t.rules) == len(j.rules)
    for (tp, ts), (jp, js) in zip(t.rules, j.rules):
        assert tp == jp and _same(ts, js)
    assert t.to_string() == j.to_string()
    assert _same(t.kv_spec, j.kv_spec)
    for name in ("embed", "unembed", "ln_f", "blocks/attn/wq", "blocks/mlp/wo",
                 "blocks/ln1", "kv"):
        assert _same(t.match(name), j.match(name))
    for flag in ("auto", "none", "fxp8", "pofx8es2"):
        assert _same(tpol.resolve_kv_spec(flag, t), jpol.resolve_kv_spec(flag, j))


def test_policy_errors_match():
    for bad in ("kv=fxp8,kv=fxp8", "", "kv=posit8", "kv=fxp16"):
        with pytest.raises(ValueError):
            jpol.QuantPolicy.from_string(bad)
        with pytest.raises(ValueError):
            tpol.QuantPolicy.from_string(bad)
    assert tpol.PRESETS == jpol.PRESETS
    assert tpol.GRAMMAR_HELP == jpol.GRAMMAR_HELP


@pytest.mark.parametrize("policy", ["pofx8", "attn/*=pofx8es2,mlp/*=fxp8f7,*=bf16",
                                    "paper-table6", "uniform-posit8", None])
def test_storage_report_text_matches(policy):
    _, jp, _, tp = pair(policy=policy)
    pj = None if policy is None else jpol.QuantPolicy.from_string(policy)
    pt = None if policy is None else tpol.QuantPolicy.from_string(policy)
    assert tpol.storage_report(tp, pt) == jpol.storage_report(jp, pj)
    assert tpol.storage_report(tp) == jpol.storage_report(jp)
