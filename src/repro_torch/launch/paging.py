"""Paged KV-cache block management: pages, refcounts, prefix sharing.

The port's own copy of ``repro/launch/paging.py`` (numpy and the standard
library only; the port imports nothing of the reference package). The
dense engine allocates one ``(n_slots, max_len)`` quantized KV cache —
every short request pays for ``max_len`` positions of device memory and
every evict -> resume pays a full re-prefill. This module is the host half
of the paged alternative: the device holds one flat *pool* of fixed-size
token pages (quantized codes next to the static per-channel scale leaves,
so a byte-wide page packs ~2x the resident tokens of a bf16 page), and
each sequence owns a *block table* of physical page ids.

Three objects, all host-side (device traffic is the engine's job;
everything here is plain ints and numpy rows):

* ``PageAllocator`` — free-list allocator with per-page refcounts. Page 0
  is reserved as a garbage page: unallocated block-table entries point at
  it, and retired slots' zombie writes land in it, so device code never
  needs an "is allocated" branch.
* ``RadixPrefixIndex`` — a radix tree over *page-granular token runs*
  (one edge per full page of ``page_size`` token ids) plus an optional
  partial tail per node, keyed additionally on the kv_spec string: two
  requests share a page only if their token prefixes AND cache formats
  match. The index holds its own refcount on every page it names, so
  prefixes survive the sequences that wrote them (system prompts stay
  resident across requests); an LRU sweep releases holdings under pool
  pressure.
* ``PagedKVManager`` — per-sequence block tables stitched over both:
  admission matches the index, borrows shared pages (incref), allocates
  owned pages for the rest, and emits copy-on-write instructions when the
  first written position lands inside a borrowed page. Sharing is safe
  without any device-side synchronization because writes are append-only:
  a sequence only ever writes positions >= its admission prefix, shared
  full pages are never written, and a shared partial tail is CoW-copied
  before the sharer's first write while readers only read the tail's
  valid prefix.

Why a page's content is shareable at all: K/V at position t is a pure
function of the token ids at positions <= t, the model weights, and the
static per-channel scales (which are per-model calibration constants —
the paged cache hoists them to one leaf per layer precisely so every page
is quantized under the same grid). Prefill fake-quantizes through the
cache grid and decode quantizes-on-write against the same static scales,
so the same token prefix always regenerates the same codes — the
quantized cache's evict -> resume invariant, now doing cross-request duty.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PageAllocator", "RadixPrefixIndex", "PagedKVManager",
           "AdmitPlan", "GARBAGE_PAGE"]

# Physical page 0 is never allocated: it is the write sink for retired
# slots and the read target of unallocated block-table entries (reads of
# it are always masked by per-slot ``pos``).
GARBAGE_PAGE = 0


class PageAllocator:
    """Free-list page allocator with refcounts (page 0 reserved)."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (one is reserved), got {n_pages}")
        self.n_pages = int(n_pages)
        self._free: List[int] = list(range(n_pages - 1, 0, -1))  # pop() -> 1 first
        self._ref = np.zeros(n_pages, np.int64)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_resident(self) -> int:
        """Allocated (live) pages, excluding the reserved garbage page."""
        return self.n_pages - 1 - len(self._free)

    def refcount(self, pid: int) -> int:
        return int(self._ref[pid])

    def alloc(self) -> Optional[int]:
        """One fresh page at refcount 1, or None when the pool is empty."""
        if not self._free:
            return None
        pid = self._free.pop()
        self._ref[pid] = 1
        return pid

    def incref(self, pid: int) -> None:
        if pid == GARBAGE_PAGE or self._ref[pid] <= 0:
            raise ValueError(f"incref on unallocated page {pid}")
        self._ref[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        if pid == GARBAGE_PAGE or self._ref[pid] <= 0:
            raise ValueError(f"decref on unallocated page {pid} (double free?)")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)
            return True
        return False


@dataclasses.dataclass
class _Node:
    """One radix-tree node: the full page that ends this token run."""
    pid: int
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)
    # (token run shorter than a page, its page id): a sequence's last,
    # partially-filled page. Readers use only the run's length; a sharer
    # that extends it copies the page first (CoW in PagedKVManager).
    tail: Optional[Tuple[Tuple[int, ...], int]] = None
    last_used: int = 0


class RadixPrefixIndex:
    """Radix tree over page-granular token prefixes, refcount-holding.

    Keys are runs of ``page_size`` token ids (one edge per full page) with
    an optional sub-page tail per node; the whole index is additionally
    keyed on ``spec_key`` (the kv format string) — ``match`` with a
    different spec_key returns nothing, so a pool serving one format never
    hands codes to a consumer expecting another.
    """

    def __init__(self, alloc: PageAllocator, page_size: int, spec_key: str):
        self.alloc = alloc
        self.page_size = int(page_size)
        self.spec_key = str(spec_key)
        self._root = _Node(pid=-1)
        self._clock = 0
        self.n_holdings = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens: Sequence[int], spec_key: str
              ) -> Tuple[List[int], int]:
        """Longest indexed prefix of ``tokens``: (page ids, token count).

        The returned pages cover ``count`` tokens: ``count // page_size``
        full pages plus, when ``count % page_size`` > 0, one final page of
        which only the first ``count % page_size`` positions are valid.
        No references are taken — the caller borrows via its allocator.
        """
        if str(spec_key) != self.spec_key:
            return [], 0
        toks = [int(t) for t in tokens]
        ps = self.page_size
        node, pids, used = self._root, [], 0
        while used + ps <= len(toks):
            key = tuple(toks[used:used + ps])
            child = node.children.get(key)
            if child is None:
                break
            node.last_used = child.last_used = self._tick()
            pids.append(child.pid)
            node = child
            used += ps
        if node.tail is not None:
            run, pid = node.tail
            rem = toks[used:]
            cp = 0
            for a, b in zip(run, rem):
                if a != b:
                    break
                cp += 1
            if cp > 0:
                node.last_used = self._tick()
                pids.append(pid)
                used += cp
        return pids, used

    def insert(self, tokens: Sequence[int], pids: Sequence[int],
               n_valid: int) -> int:
        """Index ``pids`` as the pages holding ``tokens[:n_valid]``.

        Full pages become radix nodes; a sub-page remainder becomes the
        end node's tail (replacing a shorter one). The index increfs every
        page for a *new* holding; existing nodes keep their original page
        (identical content by the determinism invariant — the caller's
        duplicate page simply stays caller-owned). Returns new holdings.
        """
        toks = [int(t) for t in tokens[:n_valid]]
        ps = self.page_size
        node, added, i = self._root, 0, 0
        while (i + 1) * ps <= len(toks):
            key = tuple(toks[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(pid=int(pids[i]), last_used=self._tick())
                self.alloc.incref(child.pid)
                node.children[key] = child
                self.n_holdings += 1
                added += 1
            node = child
            node.last_used = self._tick()
            i += 1
        rem = tuple(toks[i * ps:])
        if rem and i < len(pids):
            old = node.tail
            if old is None or len(old[0]) < len(rem):
                self.alloc.incref(int(pids[i]))
                node.tail = (rem, int(pids[i]))
                self.n_holdings += 1 - (0 if old is None else 1)
                if old is not None:
                    self.alloc.decref(old[1])
                added += 1
        return added

    def resident_tokens(self) -> int:
        """Distinct tokens resident in indexed pages (full pages count
        ``page_size``, tails their run length) — page-level dedup is
        inherent: a shared page appears once in the tree."""
        total = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node.pid >= 0:
                total += self.page_size
            if node.tail is not None:
                total += len(node.tail[0])
            stack.extend(node.children.values())
        return total

    def _droppable(self) -> List[Tuple[int, _Node, Optional[Tuple[int, ...]]]]:
        """(last_used, parent, child_key) for droppable holdings: every
        tail, and every childless (leaf) full-page node."""
        out = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node.tail is not None:
                out.append((node.last_used, node, None))
            for key, child in node.children.items():
                if not child.children and child.tail is None:
                    out.append((child.last_used, node, key))
                else:
                    stack.append(child)
        out.sort(key=lambda t: t[0])
        return out

    def reclaim(self, n_pages: int) -> int:
        """LRU-drop holdings until >= ``n_pages`` pages were actually freed
        (a drop frees a page only when the index held its last reference).
        Returns the number freed; stops early when nothing is droppable."""
        freed = 0
        while freed < n_pages:
            cands = self._droppable()
            if not cands:
                break
            progressed = False
            for _, parent, key in cands:
                if key is None:
                    _, pid = parent.tail
                    parent.tail = None
                else:
                    pid = parent.children.pop(key).pid
                self.n_holdings -= 1
                progressed = True
                if self.alloc.decref(pid):
                    freed += 1
                if freed >= n_pages:
                    break
            if not progressed:
                break
        return freed


@dataclasses.dataclass(frozen=True)
class AdmitPlan:
    """Host-side admission result the engine executes on device.

    prefix_len  tokens of the context already resident in shared pages
                (prefill skips them; the suffix starts here)
    table       the slot's physical block-table row, garbage-page padded
    copies      (src_pid, dst_pid) pool copies to run BEFORE prefill —
                copy-on-write of a borrowed page the suffix will write into
    """
    prefix_len: int
    table: np.ndarray
    copies: Tuple[Tuple[int, int], ...]


@dataclasses.dataclass
class _Seq:
    pids: List[int]            # one held reference per entry
    length: int                # tokens covered by allocated pages


class PagedKVManager:
    """Block tables + prefix index over one page pool (one kv format).

    The engine drives it admit -> ensure* -> (register | suspend/release);
    every page reference the manager hands a sequence is returned through
    ``release``. ``check()`` recomputes refcounts from scratch — the
    invariant the property tests pin.
    """

    def __init__(self, n_pages: int, page_size: int, max_pages: int,
                 spec_key: str):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self.max_pages = int(max_pages)
        self.alloc = PageAllocator(n_pages)
        self.index = RadixPrefixIndex(self.alloc, page_size, spec_key)
        self.spec_key = str(spec_key)
        self._seqs: Dict[int, _Seq] = {}
        # metrics surfaced via ServeEngine.stats()
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.pages_freed = 0
        self.pages_reclaimed = 0
        self.cow_copies = 0

    # -- allocation ----------------------------------------------------------

    def _alloc_one(self) -> int:
        pid = self.alloc.alloc()
        if pid is None:
            self.pages_reclaimed += self.index.reclaim(1)
            pid = self.alloc.alloc()
        if pid is None:
            raise RuntimeError(
                "KV page pool exhausted: every page is referenced by a "
                "running sequence (raise n_pages or lower n_slots/max_len)")
        return pid

    def _pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size)

    def _row(self, pids: List[int]) -> np.ndarray:
        row = np.full(self.max_pages, GARBAGE_PAGE, np.int32)
        row[:len(pids)] = pids
        return row

    # -- sequence lifecycle --------------------------------------------------

    def admit(self, rid: int, tokens: Sequence[int], alloc_len: int,
              page_align: bool = False) -> AdmitPlan:
        """Plan admission of ``tokens`` with pages covering ``alloc_len``.

        Matches the prefix index (capped at ``len(tokens) - 1`` so at
        least one token prefills and yields logits to sample from),
        borrows the matched pages, copy-on-writes the one borrowed page
        the suffix will write into (iff the prefix ends mid-page), and
        allocates owned pages for the rest of ``alloc_len`` (the
        bucket-padded context; junk beyond the true length is masked by
        ``pos`` exactly as in the dense engine).

        ``page_align`` rounds the hit DOWN to a page boundary: fewer
        tokens skipped (up to page_size - 1 re-prefill, stream-identical
        by code determinism) but no mid-page suffix starts — the engine
        sets it alongside prompt bucketing, whose point is bounding
        prefill compile variants, which token-granular ``prefix_len``
        (a static jit argument) would otherwise undo.
        """
        if rid in self._seqs:
            raise ValueError(f"sequence {rid} already admitted")
        ps = self.page_size
        n_total = self._pages_for(max(alloc_len, len(tokens)))
        if n_total > self.max_pages:
            raise ValueError(
                f"context of {alloc_len} tokens needs {n_total} pages > "
                f"max_pages {self.max_pages}")
        matched, hit = self.index.match(tokens, self.spec_key)
        self.prefix_queries += 1
        prefix_len = min(hit, len(tokens) - 1)
        if page_align:
            prefix_len -= prefix_len % ps
        n_full = prefix_len // ps
        pids: List[int] = []
        copies: List[Tuple[int, int]] = []
        try:
            for pid in matched[:n_full]:
                self.alloc.incref(pid)       # borrowed, never written
                pids.append(pid)
            if prefix_len % ps:
                # the suffix's first write lands inside this borrowed
                # page: copy it into an owned page before anyone writes
                src = matched[n_full]
                dst = self._alloc_one()
                copies.append((src, dst))
                self.cow_copies += 1
                pids.append(dst)
            while len(pids) < n_total:
                pids.append(self._alloc_one())
        except RuntimeError:
            # roll back partial admission state: a failed admit must not
            # leak references (check() would flag the drift)
            for pid in pids:
                self.alloc.decref(pid)
            raise
        if prefix_len > 0:
            self.prefix_hits += 1
            self.prefix_hit_tokens += prefix_len
        self._seqs[rid] = _Seq(pids=pids, length=n_total * ps)
        return AdmitPlan(prefix_len=prefix_len, table=self._row(pids),
                         copies=tuple(copies))

    def ensure(self, rid: int, n_tokens: int) -> Optional[np.ndarray]:
        """Grow ``rid``'s table to cover ``n_tokens``; returns the new row
        when pages were added, None when coverage was already sufficient."""
        seq = self._seqs[rid]
        need = self._pages_for(n_tokens)
        if need > self.max_pages:
            raise ValueError(
                f"coverage of {n_tokens} tokens needs {need} pages > "
                f"max_pages {self.max_pages}")
        if need <= len(seq.pids):
            return None
        while len(seq.pids) < need:
            seq.pids.append(self._alloc_one())
        seq.length = len(seq.pids) * self.page_size
        return self._row(seq.pids)

    def register(self, rid: int, tokens: Sequence[int], n_valid: int) -> int:
        """Index ``rid``'s pages as holding ``tokens[:n_valid]`` so later
        requests (and this request's own resume) can share them."""
        seq = self._seqs[rid]
        n_use = self._pages_for(n_valid)
        return self.index.insert(tokens, seq.pids[:n_use], n_valid)

    def release(self, rid: int) -> int:
        """Return every page reference ``rid`` holds; returns pages freed
        (pages the index also names survive for future prefix hits)."""
        seq = self._seqs.pop(rid)
        freed = sum(1 for pid in seq.pids if self.alloc.decref(pid))
        self.pages_freed += freed
        return freed

    def suspend(self, rid: int, tokens: Sequence[int], n_valid: int) -> int:
        """Evict: index the sequence's pages (full pages AND the partial
        tail), then drop its own references. Resume is a normal ``admit``
        whose prefix match re-attaches everything that survived — the
        "no re-prefill on resume" path."""
        self.register(rid, tokens, n_valid)
        return self.release(rid)

    # -- introspection -------------------------------------------------------

    def seq_pages(self, rid: int) -> List[int]:
        return list(self._seqs[rid].pids)

    def stats(self) -> Dict[str, float]:
        return {
            "resident_pages": self.alloc.n_resident,
            "free_pages": self.alloc.n_free,
            "prefix_queries": self.prefix_queries,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": (self.prefix_hits / self.prefix_queries
                                if self.prefix_queries else 0.0),
            "pages_freed": self.pages_freed,
            "pages_reclaimed": self.pages_reclaimed,
            "cow_copies": self.cow_copies,
            "index_holdings": self.index.n_holdings,
            "index_resident_tokens": self.index.resident_tokens(),
        }

    def check(self) -> None:
        """Recompute refcounts from scratch; raises on any drift — the
        no-double-free / no-leak invariant the property suite pins."""
        expect = np.zeros(self.alloc.n_pages, np.int64)
        for seq in self._seqs.values():
            for pid in seq.pids:
                expect[pid] += 1
        stack = [self.index._root]
        while stack:
            node = stack.pop()
            if node.pid >= 0:
                expect[node.pid] += 1
            if node.tail is not None:
                expect[node.tail[1]] += 1
            stack.extend(node.children.values())
        if not np.array_equal(expect, self.alloc._ref):
            bad = np.nonzero(expect != self.alloc._ref)[0]
            raise AssertionError(
                f"refcount drift on pages {bad.tolist()}: held "
                f"{self.alloc._ref[bad].tolist()} vs reachable "
                f"{expect[bad].tolist()}")
        free = set(self.alloc._free)
        if len(free) != len(self.alloc._free):
            raise AssertionError("free list contains duplicates")
        live = set(np.nonzero(self.alloc._ref > 0)[0].tolist())
        if free & live:
            raise AssertionError(f"pages both free and referenced: {free & live}")
