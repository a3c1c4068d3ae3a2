"""The port's kernel benchmark (``python -m repro_torch.bench.kernels``):
its CPU smoke run, its bound arithmetic and where it writes.

On the CPU the wrappers compute their plain versions, so the smoke run
checks the exhaustive decode paths and the row plumbing and times only
the plain versions; the kernels themselves run in chip_smoke.py phase 2.
"""
import csv
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.bench import common, kernels

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread for the module: the CPU rows are tiny, and under
    the suite's parallel workers a thread a core in every worker only
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_cpu_smoke_run_rows_all_exact(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "repro_torch.bench.kernels", "--smoke",
                          "--device", "cpu", "--out", str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "only the plain versions are timed" in res.stdout
    rows = _read(tmp_path / "kernels.csv")
    assert [(r["name"], r["shape"]) for r in rows] == [
        ("pofx_decode", "128x256 (8,2)"), ("pofx_decode", "257x130 (8,2)"),
        ("pofx_matmul", "64x128x96 (8,2)"), ("fxp_matmul", "96x160x64")]
    for r in rows:
        assert r["ok"] == "True" and float(r["max_abs_err"]) <= float(r["tol"])
        assert r["device"] == "cpu" and float(r["plain_cpu_ms"]) > 0
        # no device metric comes from a CPU run
        assert r["ms"] == r["plain_ms"] == r["library_ms"] == r["bound_ms"] == ""
        if r["name"] != "pofx_matmul":
            assert float(r["max_abs_err"]) == 0.0


def test_full_rows_on_cpu_at_reduced_shapes(monkeypatch, capsys):
    """Every kind of row of the full run, at shapes cut down for the CPU."""
    monkeypatch.setattr(kernels, "SHAPES_POFX", [(64, 96), (96, 40)])
    monkeypatch.setattr(kernels, "KV_SHAPES", ((20, [5, 9, 17, 20]), (40, [1, 13, 39, 40])))
    monkeypatch.setattr(kernels, "FXP_SHAPES", [(64, 96)])
    monkeypatch.setattr(kernels, "MOE_SHAPES_POFX", [(64, 40)])
    monkeypatch.setattr(kernels, "SSM_SHAPES_POFX", [(64, 40), (32, 72)])
    monkeypatch.setattr(kernels, "SSM_UNEMBEDS", [(64, 40)])
    monkeypatch.setattr(kernels, "WHISPER_SHAPES_POFX", [(32, 40)])
    monkeypatch.setattr(kernels, "TP2_SHAPES_POFX", [(48, 40)])
    monkeypatch.setattr(kernels, "GRID_KV_SHAPES", ((20, [0, 5, 17, 20]), (40, [0, 0, 0, 0])))
    rows = kernels.run("cpu")
    names = [r["name"] for r in rows]
    # pofx_decode: 6 sweep rows, one (8, 2) row per weight shape, one (9, 2) row
    assert names.count("pofx_decode") == 6 + 2 + 1
    # flash decode: 2 specs x 2 S at G = 4, R = 8, and fxp8 x 2 S at G = 16,
    # R = 1 (moonshot), at G = 32, R = 1, Dh = 64 (zamba2), at G = 8,
    # R = 12, Dh = 192 (nemotron) and at G = 2, R = 8 (yi-9b at tp = 2);
    # the dense kernel also with its lse at a grid rank's 2 blocks
    assert names.count("kv_flash_decode") == 4 + 2 + 2 + 2 + 2 + 2
    assert [r["shape"] for r in rows if r["shape"].startswith("lse ")] == [
        "lse fxp8 B=4 G=4 R=8 S=20 Dh=128 pos=[0, 5, 17, 20]",
        "lse fxp8 B=4 G=4 R=8 S=40 Dh=128 pos=[0, 0, 0, 0]"]
    assert names.count("kv_flash_paged_decode") == 4 + 2 + 2 + 2 + 2
    assert sum("G=2 R=8" in r["shape"] for r in rows) == 4
    nemotron_kv = [r for r in rows if "G=8 R=12" in r["shape"]]
    assert len(nemotron_kv) == 4 and all("Dh=192" in r["shape"] for r in nemotron_kv)
    # pofx_matmul: 2 sweep rows, m = 4, 64 per yi-9b shape, m = 1 unembed,
    # m = 1, 4, 64 per moonshot shape, m = 4, 64 per ssm/hybrid shape,
    # m = 1 per ssm/hybrid unembed, m = 4, 256 per whisper shape and m = 4,
    # 64 per tp = 2 shard shape
    assert names.count("pofx_matmul") == 2 + 4 + 1 + 3 + 4 + 1 + 2 + 2
    assert [r["shape"] for r in rows if r["shape"].endswith("tp2")] == [
        "m=4 k=48 n=40 x=bf16 tp2", "m=64 k=48 n=40 x=bf16 tp2"]
    assert sum(r["shape"] == "m=256 k=32 n=40 x=bf16" for r in rows) == 1
    assert sum("G=16 R=1" in r["shape"] for r in rows) == 4
    zamba_kv = [r for r in rows if "G=32 R=1" in r["shape"]]
    assert len(zamba_kv) == 4 and all("Dh=64" in r["shape"] for r in zamba_kv)
    assert sum(r["shape"] == "m=4 k=32 n=72 x=bf16" for r in rows) == 1
    assert names.count("fxp_matmul") == 1 + 2
    for r in rows:
        if r["name"] == "fxp_matmul":
            assert r["slices"] >= 1 and r["slice_len"] % 64 == 0
            assert "ms_clean_l2" in r and "library_ms_clean_l2" in r
    assert all(r["ok"] for r in rows)
    assert all(r["max_abs_diff_dense_kernel"] == 0.0 for r in rows
               if r["name"] == "kv_flash_paged_decode")
    assert "all codes of pofx(N=6..8, ES=1..3) exact" in capsys.readouterr().out


def test_pofx_decode_bound_is_bytes():
    ms, by = common.bound_ms(2 * 4096 * 11008, 0, "int8")
    assert by == "bytes" and ms == pytest.approx(0.0269, abs=5e-5)
    ms, by = common.bound_ms(4 * 4096 * 2, 2 * 4096 * 4096 * 4096, "bf16")
    assert by == "operations" and ms == pytest.approx(2 * 4096**3 / 989e12 * 1e3)


def test_output_dir_precedence(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_BENCH_OUT", raising=False)
    assert common.out_dir() == ROOT / "chiprun_out" / "bench"
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path / "env"))
    assert common.out_dir() == tmp_path / "env"
    assert common.out_dir(str(tmp_path / "arg")) == tmp_path / "arg"
    path = common.write_csv("t", [{"a": 1}, {"a": 2, "b": 3}], str(tmp_path / "arg"))
    assert _read(path) == [{"a": "1", "b": ""}, {"a": "2", "b": "3"}]


def test_card_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    with pytest.raises(SystemExit, match="no CUDA card"):
        kernels.main(["--device", "cuda"])
