"""Serving the hybrid, ssm and encdec families on a (pod, data, model)
grid, on the CPU over gloo, against the reference's ``prefill``/
``decode_step`` at ``mesh=None`` (``serve_grid_bridge``; the bounds and
checks of ``tests/test_torch_serve_grid.py``).

* zamba2-1.2b (hybrid): the shared block's fxp8 cache ("shared_kv") cut
  over model as the dense cache is, the mamba2 layers' conv and ssm states
  the rank's channels and heads;
* falcon-mamba-7b (ssm): no attention; the mamba1 states' d_inner over
  model;
* whisper-medium (encdec): bf16 self and cross caches, both with their
  sequence over model: the cross-attention's decode merges the blocks of
  the encoder's 8 positions (4 a rank) masked at ``xlen``.
"""
import pytest

from serve_grid_bridge import check_grid
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

GRIDS = {"data2-model2": (1, 2, 2), "pod2-model2": (2, 1, 2)}


@pytest.fixture(scope="module")
def pool():
    from repro_torch.launch.mesh import RankPool
    with RankPool(4, "cpu", threads=1, grids=list(GRIDS.values()), timeout_s=120) as p:
        yield p
    assert not any(proc.is_alive() for proc in p._procs)


# (arch, kv cache)
FAMILIES = [("zamba2-1.2b", "fxp8"), ("falcon-mamba-7b", None), ("whisper-medium", None)]


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch,kv", FAMILIES, ids=[a for a, _ in FAMILIES])
def test_grid_serving_matches_reference(pool, arch, kv, grid):
    check_grid(pool, GRIDS[grid], arch, kv=kv)
