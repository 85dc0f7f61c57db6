"""Port parity: the allocator's prefix-cache holds (``alloc_prefix``,
``cache_hold``, ``cache_release``, the audit of ``check_invariants``) and
``PrefixCache`` (``paddle_tpu_torch/inference/paged.py``), host code on
both sides.

The reference's own cases (``tests/test_prefix_cache.py``,
``TestAllocatorHolds`` and ``TestRadix``) run against the port, then a
seeded sequence of alloc / alloc_prefix / advance / insert / match /
evict / free runs through both packages in lockstep: every return value,
free list, refcount and cache hold must be equal.
"""
import numpy as np
import pytest

from paddle_tpu.inference import paged as JP
from paddle_tpu_torch.inference.paged import PageAllocator, PrefixCache


class TestAllocatorHolds:
    def test_hold_release_refcount_math(self):
        a = PageAllocator(num_pages=6, page_size=4, max_pages_per_seq=4)
        pages = a.alloc(0, 8)
        a.advance(0, 8)
        a.cache_hold(pages[0])
        a.check_invariants()                 # seq + hold == ref
        with pytest.raises(Exception):
            a.cache_hold(pages[0])           # double hold
        assert a.cache_release(pages[0]) == 0    # seq still holds it
        a.cache_hold(pages[0])
        a.free(0)
        a.check_invariants()                 # hold alone keeps ref == 1
        assert a.cache_release(pages[0]) == 1    # last ref -> freed
        assert a.free_pages == 6
        a.check_invariants()

    def test_alloc_prefix_forks_shared_pages(self):
        a = PageAllocator(num_pages=8, page_size=4, max_pages_per_seq=4)
        pages = a.alloc(0, 12)
        a.advance(0, 12)
        a.alloc_prefix(1, pages[:2], 12)     # fork 2, take 1 fresh
        assert a.seq_pages(1)[:2] == pages[:2]
        assert a._ref[pages[0]] == 2 and a._ref[pages[1]] == 2
        assert a.page_count(1) == 3 and a.seq_len(1) == 0
        a.check_invariants()
        a.free(1)
        assert a._ref[pages[0]] == 1
        a.check_invariants()
        with pytest.raises(Exception):       # tail page must be fresh
            a.alloc_prefix(2, pages[:3], 12)

    def test_invariants_catch_hold_drift(self):
        a = PageAllocator(num_pages=4, page_size=4, max_pages_per_seq=2)
        a.alloc(0, 4)
        a._cache_hold[a.seq_pages(0)[0]] = 1     # hold without a ref
        with pytest.raises(Exception):
            a.check_invariants()


class TestRadix:
    def _cache(self, num_pages=8, ps=4):
        alloc = PageAllocator(num_pages=num_pages, page_size=ps,
                              max_pages_per_seq=num_pages)
        return alloc, PrefixCache(alloc)

    def test_match_caps_below_full_prompt(self):
        alloc, pc = self._cache()
        toks = np.arange(8, dtype=np.int32)
        pages = alloc.alloc(0, 8)
        alloc.advance(0, 8)
        pc.insert(toks, pages)
        alloc.free(0)
        # exact-length prompt: at least one tail token stays uncached
        n, got = pc.match(toks)
        assert n == 4 and got == pages[:1]
        n, got = pc.match(np.arange(9, dtype=np.int32))
        assert n == 8 and got == pages
        alloc.check_invariants()

    def test_insert_commits_full_pages_only(self):
        alloc, pc = self._cache()
        alloc.alloc(0, 8)
        alloc.advance(0, 6)                  # page 1 half-written
        pc.insert(np.arange(6, dtype=np.int32), alloc.seq_pages(0))
        assert pc.nodes == 1                 # only the full page
        alloc.free(0)
        alloc.check_invariants()
        assert alloc.free_pages == 7         # held page stays out

    def test_eviction_skips_live_holders(self):
        alloc, pc = self._cache(num_pages=4)
        toks = np.arange(9, dtype=np.int32)
        pages = alloc.alloc(0, 8)
        alloc.advance(0, 8)
        pc.insert(toks, pages)
        alloc.free(0)
        # a live sequence forks both cached pages
        alloc.alloc_prefix(1, pages, 12)
        assert pc.evict(4) == 0              # nothing evictable
        assert pc.reclaimable() == 0
        alloc.check_invariants()
        alloc.free(1)
        assert pc.reclaimable() == 2
        assert pc.evict(4) == 2              # now they go, LRU first
        alloc.check_invariants()
        assert alloc.free_pages == 4
        assert pc.nodes == 0 and pc.evicted_nodes == 2

    def test_lru_prefers_cold_leaves(self):
        alloc, pc = self._cache(num_pages=8)
        a = alloc.alloc(0, 4)
        alloc.advance(0, 4)
        pc.insert(np.arange(4, dtype=np.int32), a)
        alloc.free(0)
        b = alloc.alloc(1, 4)
        alloc.advance(1, 4)
        pc.insert(np.arange(100, 104, dtype=np.int32), b)
        alloc.free(1)
        pc.match(np.arange(5, dtype=np.int32))   # refresh A's stamp
        assert pc.evict(1) == 1
        n, _ = pc.match(np.arange(5, dtype=np.int32))
        assert n == 4                        # A survived, B evicted
        alloc.check_invariants()


def _state(alloc, pc):
    return (list(alloc._free), alloc._ref.tolist(),
            alloc._cache_hold.tolist(),
            {s: (alloc.seq_pages(s), alloc.seq_len(s)) for s in alloc._seqs},
            pc.nodes, pc.evicted_nodes, pc.reclaimable())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_lockstep_with_reference(seed):
    """A random admission / retirement workload over prompts that share a
    few prefixes, in a pool small enough to force eviction: each step
    evicts what a prompt may need, matches it, admits it with
    ``alloc_prefix`` over the matched pages, writes it, and sometimes
    retires a live sequence (insert, then free). Eviction runs before the
    match, so it never drops a page the match hands out. Both packages return
    the same values and hold the same state after every operation."""
    rng = np.random.default_rng(seed)
    ps, num_pages = 4, 24
    sides = []
    for mod in (JP, None):
        make_alloc = mod.PageAllocator if mod else PageAllocator
        make_pc = mod.PrefixCache if mod else PrefixCache
        alloc = make_alloc(num_pages=num_pages, page_size=ps,
                           max_pages_per_seq=8)
        sides.append((alloc, make_pc(alloc)))
    prefixes = [rng.integers(0, 50, 3 * ps) for _ in range(3)]
    live, next_id = [], 0
    for _ in range(60):
        if live and rng.random() < 0.4:
            sid, toks = live.pop(int(rng.integers(len(live))))
            outs = []
            for alloc, pc in sides:
                outs.append(pc.insert(toks, alloc.seq_pages(sid)))
                alloc.free(sid)
            assert outs[0] == outs[1]
        else:
            pre = prefixes[int(rng.integers(3))][:int(rng.integers(1, 3 * ps))]
            toks = np.concatenate([pre, rng.integers(0, 50,
                                                     int(rng.integers(1, 10)))])
            outs = []
            for alloc, pc in sides:
                short = alloc.pages_for(len(toks)) - alloc.free_pages
                freed = pc.evict(short) if short > 0 else 0
                n, pages = pc.match(toks)
                got = (alloc.alloc_prefix(next_id, pages, len(toks))
                       if pages else alloc.alloc(next_id, len(toks)))
                if got is not None:
                    alloc.advance(next_id, len(toks))
                outs.append((n, list(pages), freed, got))
            assert outs[0] == outs[1]
            if outs[0][3] is not None:
                live.append((next_id, toks))
            next_id += 1
        for alloc, _ in sides:
            alloc.check_invariants()
        assert _state(*sides[0]) == _state(*sides[1])
