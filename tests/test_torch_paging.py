"""The port's paged-KV block manager against the reference's.

``repro_torch.launch.paging`` is the port's own copy of the reference's
host-side paging module. Both managers are driven through the same seeded
operation sequences (admit with and without page alignment, ensure,
register, suspend, release, and the LRU reclaim that allocation falls back
on under pool pressure) over a tiny token alphabet, so prefixes collide
often. Every result must be equal: admission plans (prefix length, block
table, copy-on-write copies), grown table rows, holdings added, pages
freed, the errors raised, ``stats()`` and ``check()``.
"""
import numpy as np
import pytest

from repro.launch import paging as J
from repro_torch.launch import paging as T
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)


def _same(jcall, tcall):
    """Run one operation on both managers: equal results or equal errors."""
    try:
        want = jcall()
    except (RuntimeError, ValueError) as e:
        with pytest.raises(type(e)) as got:
            tcall()
        assert str(got.value) == str(e)
        return None
    got = tcall()
    if isinstance(want, J.AdmitPlan):
        assert isinstance(got, T.AdmitPlan)
        assert got.prefix_len == want.prefix_len
        assert got.copies == want.copies
        np.testing.assert_array_equal(got.table, want.table)
        assert got.table.dtype == want.table.dtype
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
    return want


def _state_equal(jm, tm):
    jm.check()
    tm.check()
    assert tm.stats() == jm.stats()
    assert sorted(tm._seqs) == sorted(jm._seqs)
    for rid in jm._seqs:
        assert tm.seq_pages(rid) == jm.seq_pages(rid)
    np.testing.assert_array_equal(tm.alloc._ref, jm.alloc._ref)
    assert tm.alloc._free == jm.alloc._free


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("ps,n_pages", [(1, 24), (4, 12), (5, 30)])
def test_manager_matches_reference_over_seeded_traffic(seed, ps, n_pages):
    rng = np.random.default_rng(seed * 100 + ps)
    max_pages = -(-16 // ps)
    jm = J.PagedKVManager(n_pages, ps, max_pages, "fxp8")
    tm = T.PagedKVManager(n_pages, ps, max_pages, "fxp8")
    # a few base prompts over a 3-token alphabet: frequent shared prefixes
    bases = [rng.integers(0, 3, 14).tolist() for _ in range(3)]
    tokens, live, next_rid = {}, [], 0
    for _ in range(40):
        op = rng.integers(0, 5)
        if op <= 1 or not live:                       # admit
            base = bases[rng.integers(len(bases))]
            n = int(rng.integers(1, 14))
            seq = base[:n] + rng.integers(0, 3, int(rng.integers(0, 3))).tolist()
            rid, next_rid = next_rid, next_rid + 1
            alloc_len = len(seq) + int(rng.integers(0, 3))
            align = bool(rng.integers(2))
            plan = _same(lambda: jm.admit(rid, seq, alloc_len, page_align=align),
                         lambda: tm.admit(rid, seq, alloc_len, page_align=align))
            if plan is not None:
                tokens[rid] = seq
                live.append(rid)
                _same(lambda: jm.register(rid, seq, len(seq)),
                      lambda: tm.register(rid, seq, len(seq)))
        else:
            rid = live[int(rng.integers(len(live)))]
            seq = tokens[rid]
            if op == 2:                               # grow, as decode does
                grow = len(seq) + int(rng.integers(0, 2 * ps + 1))
                _same(lambda: jm.ensure(rid, grow), lambda: tm.ensure(rid, grow))
            elif op == 3:                             # evict
                n_valid = int(rng.integers(1, len(seq) + 1))
                _same(lambda: jm.suspend(rid, seq, n_valid),
                      lambda: tm.suspend(rid, seq, n_valid))
                live.remove(rid)
            else:                                     # finish without indexing
                _same(lambda: jm.release(rid), lambda: tm.release(rid))
                live.remove(rid)
        _state_equal(jm, tm)
    for rid in list(live):
        _same(lambda: jm.release(rid), lambda: tm.release(rid))
    _state_equal(jm, tm)
    # a foreign kv format never matches in either
    assert tm.index.match(bases[0], "pofx8es2") == jm.index.match(bases[0], "pofx8es2") == ([], 0)


@pytest.mark.parametrize("n_free", [1, 3, 100])
def test_index_reclaim_matches_reference(n_free):
    """LRU reclaim order and counts, on an index built by the same inserts."""
    out = []
    for mod in (J, T):
        alloc = mod.PageAllocator(64)
        idx = mod.RadixPrefixIndex(alloc, 4, "s")
        rng = np.random.default_rng(5)
        for _ in range(8):
            seq = rng.integers(0, 2, int(rng.integers(3, 17))).tolist()
            pids = [alloc.alloc() for _ in range(-(-len(seq) // 4))]
            idx.insert(seq, pids, len(seq))
            idx.match(seq[: len(seq) // 2], "s")      # touches LRU clocks
            for pid in pids:
                alloc.decref(pid)
        freed = idx.reclaim(n_free)
        out.append((freed, idx.n_holdings, idx.resident_tokens(), alloc.n_free,
                    alloc._ref.tolist()))
    assert out[1] == out[0]


def test_allocator_and_errors_match_reference():
    for mod in (J, T):
        with pytest.raises(ValueError, match="reserved"):
            mod.PageAllocator(1)
        a = mod.PageAllocator(3)
        assert [a.alloc(), a.alloc(), a.alloc()] == [1, 2, None]
        with pytest.raises(ValueError, match="unallocated"):
            a.incref(mod.GARBAGE_PAGE)
        assert a.decref(1) is True
        with pytest.raises(ValueError, match="double free"):
            a.decref(1)
        m = mod.PagedKVManager(8, 4, 2, "fxp8")
        with pytest.raises(ValueError, match="max_pages"):
            m.admit(0, list(range(9)), 9)
        with pytest.raises(ValueError, match="page_size"):
            mod.PagedKVManager(8, 0, 2, "fxp8")
