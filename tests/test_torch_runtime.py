"""The port's runtime pieces against the reference's: checkpoints
(``runtime/checkpoint.py``, byte for byte), the data pipeline, the
straggler monitor, the numpy posit codec behind posit-packed leaves, and
``convert``'s way back to the reference's stacked layout."""
import filecmp
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, RunConfig as JRunConfig, smoke as j_smoke
from repro.core import normalized_posit as j_np, posit as j_posit
from repro.core.quantizers import QuantSpec as JSpec
from repro.data import (DataConfig as JData, TokenFileReader as JReader,
                        synthetic_batch as j_batch, synthetic_batches as j_batches,
                        write_token_file as j_write)
from repro.launch.train import make_train_state as j_make_state
from repro.nn.models import apply_policy as j_apply_policy, build_model as j_build_model
from repro.runtime import CheckpointManager as JManager, StepTimeMonitor as JMonitor
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import normalized_posit as t_np, posit as t_posit
from repro_torch.core.quantizers import QuantSpec, QuantizedTensor
from repro_torch.data import (DataConfig, TokenFileReader, synthetic_batch,
                              synthetic_batches, write_token_file)
from repro_torch.runtime import CheckpointManager, StepTimeMonitor
from torch_bridge import _jax_params, to_numpy_tree
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

# -- numpy posit codec ---------------------------------------------------------

CONFIGS = [(8, 2), (8, 0), (6, 1), (5, 3), (16, 2), (12, 1)]


@pytest.mark.parametrize("N,ES", CONFIGS)
def test_numpy_posit_codec_equals_reference(N, ES):
    rng = np.random.RandomState(N * 10 + ES)
    codes = np.arange(1 << N)
    np.testing.assert_array_equal(t_posit.posit_decode_np(codes, N, ES),
                                  j_posit.posit_decode_np(codes, N, ES))
    x = rng.standard_normal(20000) * np.exp2(rng.uniform(-30, 30, 20000))
    x[:4] = [0.0, -0.0, np.nan, np.inf]
    for allow_zero in (True, False):
        np.testing.assert_array_equal(t_posit.posit_encode_np(x, N, ES, allow_zero),
                                      j_posit.posit_encode_np(x, N, ES, allow_zero))
    norm = np.clip(rng.standard_normal(20000) * 0.3, -1.5, 1.5)
    got = t_np.norm_encode_np(norm, N, ES)
    np.testing.assert_array_equal(got, j_np.norm_encode_np(norm, N, ES))
    stored = np.arange(1 << (N - 1))
    np.testing.assert_array_equal(t_np.norm_decode_np(stored, N, ES),
                                  j_np.norm_decode_np(stored, N, ES))
    for k in (N - 1, N, 3, 8):
        c = rng.randint(0, 1 << k, 1001)
        packed = t_np.pack_bits(c, k)
        np.testing.assert_array_equal(packed, j_np.pack_bits(c, k))
        np.testing.assert_array_equal(t_np.unpack_bits(packed, k, c.size), c)


@pytest.mark.parametrize("chunk", [8, 16, 1 << 20])
def test_pack_bits_in_chunks_equals_reference(chunk, monkeypatch):
    """pack_bits and unpack_bits walk the codes in chunks of PACK_CHUNK (a
    multiple of 8): the bytes are the reference's at every chunk size."""
    monkeypatch.setattr(t_np, "PACK_CHUNK", chunk)
    rng = np.random.RandomState(chunk)
    for k in (1, 3, 7, 8, 9, 16):
        for n in (1, 7, 8, 9, 1000, 4099):
            c = rng.randint(0, 1 << k, n)
            packed = t_np.pack_bits(c, k)
            np.testing.assert_array_equal(packed, j_np.pack_bits(c, k))
            np.testing.assert_array_equal(t_np.unpack_bits(packed, k, n), c)


# -- data pipeline and straggler monitor -------------------------------------


@pytest.mark.parametrize("kw", [dict(vocab_size=512, seq_len=32, global_batch=4),
                                dict(vocab_size=64000, seq_len=128, global_batch=8, seed=3),
                                dict(vocab_size=100, seq_len=7, global_batch=6, motif_len=3,
                                     motif_prob=0.5, zipf_alpha=1.1)])
def test_synthetic_batches_equal_reference(kw):
    jd, td = JData(**kw), DataConfig(**kw)
    for step in (0, 1, 17):
        for host, n in ((0, 1), (1, 2)):
            a = j_batch(jd, step, host_id=host, n_hosts=n)
            b = synthetic_batch(td, step, host_id=host, n_hosts=n)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (step, k)
    ja, ta = j_batches(jd, start_step=5), synthetic_batches(td, start_step=5)
    for _ in range(2):
        assert np.array_equal(next(ja)["tokens"], next(ta)["tokens"])


@pytest.mark.parametrize("top", [70000, 60000])
def test_token_file_bytes_and_reader_equal_reference(tmp_path, top):
    toks = (np.arange(5000) * 7919) % top
    write_token_file(str(tmp_path / "t.bin"), toks)
    j_write(str(tmp_path / "j.bin"), toks)
    assert filecmp.cmp(tmp_path / "t.bin", tmp_path / "j.bin", shallow=False)
    for host, n in ((0, 1), (1, 3)):
        t = TokenFileReader(str(tmp_path / "t.bin"), seq_len=64, batch=4, host_id=host,
                            n_hosts=n)
        j = JReader(str(tmp_path / "j.bin"), seq_len=64, batch=4, host_id=host, n_hosts=n)
        for step in (0, 1, 30):
            a, b = j.read_batch(step), t.read_batch(step)
            assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
    with open(tmp_path / "bad.bin", "wb") as f:
        f.write(b"NOPE" + bytes(16))
    with pytest.raises(ValueError, match="bad token file"):
        TokenFileReader(str(tmp_path / "bad.bin"), seq_len=4, batch=1)


def test_straggler_monitor_equal_events():
    rng = np.random.RandomState(0)
    durs = list(0.1 + 0.005 * rng.standard_normal(40))
    durs[12] = durs[25] = durs[26] = durs[27] = 0.5
    kw = dict(window=16, z_threshold=4.0, abort_ratio=2.0, warmup=4)
    j, t = JMonitor(**kw), StepTimeMonitor(**kw)
    for i, d in enumerate(durs):
        a, b = j.record(i, d), t.record(i, d)
        assert (a is None) == (b is None), i
        if a is not None:
            assert (a.step, a.duration, a.zscore) == (b.step, b.duration, b.zscore)
        assert j.should_restart() == t.should_restart()
    assert j.report() == t.report() and t.should_restart()
    with pytest.raises(RuntimeError):
        StepTimeMonitor().stop()


# -- convert: the way back ----------------------------------------------------


@pytest.mark.parametrize("arch", ["yi-9b", "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
                                  "zamba2-1.2b", "whisper-medium"])
@pytest.mark.parametrize("policy", [None, "pofx8"])
def test_params_to_numpy_inverts_params_from_numpy(arch, policy):
    ref = to_numpy_tree(_jax_params(j_smoke(J_ARCHS[arch]), policy, 0))
    back = params_to_numpy(params_from_numpy(ref, device="cpu"))

    def same(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, str):
            assert a == b, path
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), path
    same(ref, back)


# -- checkpoints -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_state(quant, weight_dtype):
    """The reference's seed-0 yi-9b smoke train state with one step's worth
    of noise in its moments, made once a (quant, weight dtype) for the
    module's cases (they read it, and build their own trees from it)."""
    jm = j_build_model(j_smoke(J_ARCHS["yi-9b"]),
                       JRunConfig(weight_dtype=weight_dtype, opt_state_quant=quant))
    state = jax.jit(lambda k: j_make_state(jm, k))(jax.random.PRNGKey(0))
    # non-trivial moments and count: one reference step's worth of noise
    rng = np.random.RandomState(1)
    if quant == "none":
        state["opt"]["m"] = jax.tree.map(
            lambda m: jnp.asarray(rng.standard_normal(m.shape).astype(np.float32)),
            state["opt"]["m"])
    state["opt"]["count"] = jnp.asarray(7, jnp.int32)
    return state


def _files(d):
    return sorted(f for f in os.listdir(d) if f != "treedef.pkl")


def _same_dirs(a, b):
    assert _files(a) == _files(b)
    for f in _files(a):
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


@pytest.mark.parametrize("case", ["f32_moments", "posit8_moments", "bf16_params",
                                  "param_compress", "pofx_params_policy"])
def test_checkpoint_bytes_equal_reference_and_restore(tmp_path, case):
    quant = "posit8" if case == "posit8_moments" else "none"
    wdt = "bf16" if case == "bf16_params" else "f32"
    jstate = _ref_state(quant, wdt)
    kw = {}
    if case == "param_compress":
        kw["param_compress"] = QuantSpec(kind="pofx", N=8, ES=2)
        jkw = {"param_compress": JSpec(kind="pofx", N=8, ES=2)}
    elif case == "pofx_params_policy":
        jstate = {"params": jax.jit(lambda p: j_apply_policy(p, "pofx8"))(jstate["params"]),
                  "opt": {"count": jstate["opt"]["count"]}}
        kw["policy"] = jkw = "pofx8"
        jkw = {"policy": "pofx8"}
    else:
        jkw = {}
    tstate = params_from_numpy(to_numpy_tree(jstate), device="cpu")
    JManager(str(tmp_path / "j"), async_save=False).save(3, jstate, **jkw)
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(3, tstate, **kw)
    _same_dirs(tmp_path / "j" / "step_00000003", tmp_path / "t" / "step_00000003")
    # the port restores the reference's checkpoint into a template state
    template = params_from_numpy(to_numpy_tree(_ref_state(quant, wdt)), device="cpu")
    if case == "pofx_params_policy":
        template = tstate
    mgr = CheckpointManager(str(tmp_path / "j"))
    got = mgr.restore(template)
    want = (params_to_numpy(tstate) if case != "param_compress"
            else to_numpy_tree(JManager(str(tmp_path / "j")).restore()))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(params_to_numpy(got))):
        if isinstance(a, str):
            assert a == b
        else:
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    if case == "pofx_params_policy":
        assert mgr.read_manifest()["quant_policy"] == "pofx8"
        assert isinstance(got["params"]["blocks"][1]["attn"]["wq"], QuantizedTensor)


def test_checkpoint_template_mismatch_raises(tmp_path):
    state = params_from_numpy(to_numpy_tree(_ref_state("posit8", "f32")), device="cpu")
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(1, state)
    with pytest.raises(ValueError, match="leaves"):
        cm.restore({"params": state["params"]})
    wrong = params_from_numpy(to_numpy_tree(_ref_state("none", "f32")), device="cpu")
    with pytest.raises(ValueError, match="quantization"):
        cm.restore(wrong)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def _small(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((16, 8), generator=g) * 0.1,
                       "b": torch.zeros((8,), dtype=torch.bfloat16)},
            "opt": {"count": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_keep_k_and_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 3, 9):
        cm.save(s, _small())
    assert cm.all_steps() == [3, 9] and cm.latest_step() == 9


def test_checkpoint_crash_mid_save_keeps_previous(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    cm.save(1, _small())
    os.makedirs(tmp_path / ".tmp_00000002")
    (tmp_path / ".tmp_00000002" / "junk").write_text("partial")
    assert cm.latest_step() == 1
    got = cm.restore(_small(5))
    assert int(got["opt"]["count"]) == 7
    assert torch.equal(got["params"]["w"], _small()["params"]["w"])
    assert got["params"]["b"].dtype == torch.bfloat16


def test_checkpoint_async_is_consistent(tmp_path):
    """save() snapshots synchronously: an in-place update right after it
    (the optimizer's) does not reach the checkpoint."""
    cm = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    state = _small()
    want = state["params"]["w"].clone()
    cm.save(1, state)
    state["params"]["w"].mul_(0)
    cm.wait()
    assert torch.equal(cm.restore(_small(3))["params"]["w"], want)
