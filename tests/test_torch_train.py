"""The port's training path against the reference's at the smoke size,
dense family (yi-9b; the other families: ``tests/test_torch_train_*.py``):
``ce_loss``, ``LM.forward``/``LM.loss`` and their gradients (flash
backward, block remat, the embedding's scatter), three steps of
``make_train_step`` against the reference's jitted step, and the CLI.

The reference's weights (f32) are carried across with ``convert``; both
packages run f32 weights and activations. Logits agree to 1e-4, every
gradient leaf to 1e-4 of its largest entry, the loss to 1e-6.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, RunConfig as JRunConfig, smoke as j_smoke
from repro.data import DataConfig, synthetic_batch
from repro.launch.train import make_train_state as j_make_state, make_train_step as j_make_step
from repro.nn.models import build_model as j_build_model, ce_loss as j_ce_loss
from repro_torch.configs import ARCHS, RunConfig, smoke
from repro_torch.convert import params_from_numpy, params_to_numpy, train_state_from_numpy
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import make_train_state, make_train_step, value_and_grad
from repro_torch.nn import transformer as T
from repro_torch.nn.models import build_model, ce_loss
from repro_torch.optim import tree_leaves, tree_map
from torch_bridge import to_numpy_tree
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(weight_dtype="f32", activation_dtype="f32")


def _models(tie=False, **rkw):
    jc = dataclasses.replace(j_smoke(J_ARCHS["yi-9b"]), tie_embeddings=tie)
    tc = dataclasses.replace(smoke(ARCHS["yi-9b"]), tie_embeddings=tie)
    return (j_build_model(jc, JRunConfig(**F32, **rkw)),
            build_model(tc, RunConfig(**F32, **rkw), device="cpu"))


def _walk(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _walk(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def test_ce_loss_values_and_grads():
    rng = np.random.RandomState(0)
    logits = (rng.standard_normal((2, 5, 70)) * 4).astype(np.float32)
    labels = rng.randint(0, 70, (2, 5))
    for z in (0.0, 1e-2):
        jl, jg = jax.value_and_grad(lambda x: j_ce_loss(x, jnp.asarray(labels), z_weight=z))(
            jnp.asarray(logits))
        x = torch.tensor(logits, requires_grad=True)
        tl = ce_loss(x, torch.from_numpy(labels), z_weight=z)
        tl.backward()
        assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    # bf16 logits are lifted to f32 first
    lb = torch.tensor(logits).to(torch.bfloat16)
    assert ce_loss(lb, torch.from_numpy(labels)).dtype == torch.float32


@pytest.mark.parametrize("tie", [False, True])
def test_forward_logits_and_loss_grads_match_reference(tie):
    jm, tm = _models(tie=tie, remat="block")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(to_numpy_tree(jp), device="cpu")
    assert ("unembed" in tp) != tie
    rng = np.random.RandomState(1)
    toks = rng.randint(0, 512, (2, 17))
    toks[0, :6] = 7                        # repeated tokens: the embedding's scatter adds
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl = jax.jit(jm.forward)(jp, jnp.asarray(batch["tokens"]))
    with torch.no_grad():
        tl = tm.forward(tp, torch.from_numpy(batch["tokens"]))
    assert tl.shape == (2, 16, tm.cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tg = value_and_grad(tm, tp, batch)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-6)
    it = iter(tg)
    got = params_to_numpy(tree_map(lambda _: next(it), tp))
    for path, a, b in _walk(to_numpy_tree(jg), got):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * np.abs(a).max(), err_msg=path)


def test_remat_gives_equal_gradients():
    _, on = _models(remat="block")
    _, off = _models(remat="none")
    params = on.init(0)
    batch = synthetic_batch(DataConfig(vocab_size=512, seq_len=16, global_batch=2), 0)
    l1, g1 = value_and_grad(on, params, batch)
    l2, g2 = value_and_grad(off, params, batch)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_embedding_backward_adds_repeated_tokens():
    g = torch.Generator().manual_seed(0)
    emb = torch.randn((10, 4), generator=g, requires_grad=True)
    toks = torch.tensor([[3, 3, 1], [3, 0, 1]])
    up = torch.randn((2, 3, 4), generator=g)
    (T.embed_tokens(emb, toks, torch.float32) * up).sum().backward()
    want = np.zeros((10, 4), np.float32)
    np.add.at(want, toks.numpy(), up.numpy())
    np.testing.assert_allclose(emb.grad.numpy(), want, rtol=1e-6, atol=1e-6)


# -- three train steps against the reference's jitted step ---------------------

STEPS = 3


@pytest.fixture(scope="module", params=[("none", 0), ("none", 2), ("posit8", 0),
                                        ("posit8", 2)], ids=lambda p: f"{p[0]}-mb{p[1]}")
def three_steps(request):
    quant, micro = request.param
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_steps=1, remat="block",
              microbatch=micro, opt_state_quant=quant)
    jm = j_build_model(j_smoke(J_ARCHS["yi-9b"]), JRunConfig(**F32, **kw))
    tm = build_model(smoke(ARCHS["yi-9b"]), RunConfig(**F32, **kw), device="cpu")
    jstate = jax.jit(lambda k: j_make_state(jm, k))(jax.random.PRNGKey(0))
    tstate = train_state_from_numpy(to_numpy_tree(jstate), device="cpu")
    jstep, tstep = jax.jit(j_make_step(jm)), make_train_step(tm)
    dc = DataConfig(vocab_size=512, seq_len=32, global_batch=4)
    jmet, tmet = [], []
    for s in range(STEPS):
        b = synthetic_batch(dc, s)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm_ = tstep(tstate, b)
        jmet.append({k: float(v) for k, v in jm_.items()})
        tmet.append({k: float(v) for k, v in tm_.items()})
    return quant, jmet, tmet, to_numpy_tree(jstate), params_to_numpy(tstate)


def test_train_steps_metrics_match(three_steps):
    _, jmet, tmet, _, _ = three_steps
    for j, t in zip(jmet, tmet):
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-6)
        assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-5)
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6)
    assert tmet[-1]["loss"] < tmet[0]["loss"]


def test_train_steps_params_match(three_steps):
    """f32 moments: every entry within 3 % of one step's update (lr = 1e-3;
    the sign of a near-zero gradient entry may differ between the two
    frameworks' sums). posit8: a moment code that flips at a rounding
    boundary moves that entry's update, so at most 0.1 % of the entries
    may differ by more, and by at most 5 updates."""
    quant, _, _, want, got = three_steps
    for path, a, b in _walk(want["params"], got["params"]):
        d = np.abs(a - b)
        if quant == "none":
            assert d.max() <= 3e-5, (path, d.max())
        else:
            assert (d > 3e-5).mean() <= 1e-3 and d.max() <= 5e-3, (path, d.max())


# -- state and CLI ---------------------------------------------------------------------


def test_make_train_state_layout():
    model = build_model(smoke(ARCHS["yi-9b"]),
                        RunConfig(opt_state_quant="posit8", grad_compression="posit8_ef"),
                        device="cpu")
    state = make_train_state(model, 0)
    assert set(state) == {"params", "opt", "ef"}
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert [p.shape for p in tree_leaves(state["opt"]["m"])] == \
        [p.shape for p in tree_leaves(state["params"])]
    assert int(state["opt"]["count"]) == 0
    assert all(e.dtype == torch.float32 for e in tree_leaves(state["ef"]))


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--smoke", "--steps", "1"])


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16", "--log-every", "1",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--opt-quant", "posit8"]
    first = train_cli.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert first["steps"] == [0, 1, 2] and all(np.isfinite(first["loss"]))
    assert "step     2 loss" in out and "stragglers=" in out and "train: {" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000000", "step_00000002"]
    again = train_cli.main(argv + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "resuming from step 2" in out and again["steps"] == [3, 4]
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--help"],
                          cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    for flag in ("--arch", "--smoke", "--steps", "--batch", "--seq", "--lr", "--microbatch",
                 "--ckpt-dir", "--ckpt-every", "--opt-quant", "--log-every", "--device"):
        assert flag in proc.stdout, flag
