"""Paged KV cache: page-pool tensors, block-table allocator, the radix
prefix cache and the paged data plane (port of
``paddle_tpu/inference/paged.py``; full-precision and int8 pools).

- ``PageAllocator``: host-side free list and ref-counted pages per
  sequence, with the prefix cache's holds (one extra ref a cached page);
  plain Python and numpy, never touches the device.
- ``PrefixCache``: radix tree over committed page-aligned prompt
  prefixes, one node a page, LRU leaf eviction (host Python).
- ``PagedKVCache``: the pool tensors married to an allocator.
- ``paged_prefill`` / ``paged_decode_step``: the data plane, generic over
  the model family's decoder seam (``_qkv_proj``-compatible layers,
  ``decode_mlp``, ``_head``), which ``models.llama`` and ``models.moe``
  both expose; ``paged_prefill_shared`` (the uncached tail of prompts
  over cached prefix pages) and ``paged_verify_window`` (a drafted
  window of tokens in one pass), the pieces the engine's prefix cache
  and speculative decode call. Those two attend through the masked plain
  attention (``sdpa_raw`` with ``attn_mask``), as the reference.

Pool layout: ``[L, num_pages + 1, kv_heads, page_size, head_dim]``:
``num_pages`` usable pages and one sink page at index ``num_pages``.
Block table entries equal to ``num_pages`` are the "no page" sentinel: a
write aimed at it is dropped. Unlike the reference, which replaces its
donated pool arrays, the port updates the pool tensors in place
(``index_copy_`` / ``index_put_``). torch raises on an out-of-range
index where JAX's ``mode="drop"`` drops it, so every write that the
reference drops (a sentinel row, an inactive slot, a page past the
table) is aimed at the sink page instead: no row is selected on the
host, and the data plane never synchronises the host with the card. The
allocator never hands the sink out and the decode kernel is given the
usable pages only. A gather over a block table (``_kv_pool_gather``)
reads the sink for a sentinel entry, where the reference reads page
``P - 1`` (JAX clamps the index): both are garbage that the attention
mask keeps out of every result.

With ``kv_quant`` (the reference's ``FLAGS_serving_kv_quant``) each pool
leaf is the pair ``{"q": int8 [L, P + 1, kv, ps, hd], "s": float32 [L,
P + 1, kv]}``: int8 codes and one scale per (page, kv head), the absmax
/ 127 of that page's values at its last write. Code and scale rows share
the page axis, so every page-granular operation (copy-on-write, scatter
with drop) moves them together; a page never written has scale 0 and
dequantizes to 0.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import enforce as E
from ..kernels import dispatched_paged_attention
from ..models.llama import _head_logits, _mm, _qkv_proj, _rms, layer
from ..nn.functional.attention import rope_raw, rope_tables, sdpa_raw

__all__ = ["PageAllocator", "PrefixCache", "PagedKVCache", "init_pool",
           "paged_prefill", "paged_decode_step", "paged_prefill_shared",
           "paged_verify_window"]


class PageAllocator:
    """Free-list page allocator with per-sequence block tables and
    ref-counted pages (copy-on-fork and prefix sharing). Host-side and
    O(pages touched); OOM is a ``None`` return with state unchanged."""

    def __init__(self, num_pages: int, page_size: int,
                 max_pages_per_seq: int):
        E.enforce(num_pages >= 1, f"num_pages must be >= 1, got {num_pages}")
        E.enforce(page_size >= 1, f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref = np.zeros(num_pages, np.int32)
        # prefix-cache pins: a held page carries one extra ref owned by
        # the radix cache (0 or 1 a page), so that sequence holds plus
        # cache holds equal _ref
        self._cache_hold = np.zeros(num_pages, np.int32)
        # seq_id -> {"pages": [page ids], "len": tokens written}
        self._seqs: Dict[int, dict] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size)

    def seq_len(self, seq_id: int) -> int:
        return self._seqs[seq_id]["len"]

    def seq_pages(self, seq_id: int) -> List[int]:
        return list(self._seqs[seq_id]["pages"])

    def page_count(self, seq_id: int) -> int:
        """Pages this sequence holds (no list copy)."""
        return len(self._seqs[seq_id]["pages"])

    def block_row(self, seq_id: int, width: Optional[int] = None
                  ) -> np.ndarray:
        """This sequence's block-table row, padded with the ``num_pages``
        sentinel."""
        width = self.max_pages_per_seq if width is None else width
        row = np.full(width, self.num_pages, np.int32)
        pages = self._seqs[seq_id]["pages"]
        row[:len(pages)] = pages
        return row

    def check_invariants(self):
        """Refcount audit (tests): every page is free (ref 0) or
        referenced exactly as often as sequences and the prefix cache
        hold it, and the free list is duplicate-free. The cache-hold half
        is what shows that evicting from the prefix cache never frees a
        page a live sequence holds."""
        counts = np.zeros(self.num_pages, np.int32)
        for s in self._seqs.values():
            for p in s["pages"]:
                counts[p] += 1
        if not np.array_equal(counts + self._cache_hold, self._ref):
            raise AssertionError(f"refcount drift: held={counts.tolist()} "
                                 f"cached={self._cache_hold.tolist()} "
                                 f"ref={self._ref.tolist()}")
        if np.any(self._cache_hold < 0) or np.any(self._cache_hold > 1):
            raise AssertionError(
                f"cache-hold out of range: {self._cache_hold.tolist()}")
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate pages on the free list")
        if any(self._ref[p] != 0 for p in free):
            raise AssertionError("referenced page on the free list")
        if len(free) + int((self._ref > 0).sum()) != self.num_pages:
            raise AssertionError("leaked page: neither free nor referenced")

    def _take(self, n: int) -> Optional[List[int]]:
        if len(self._free) < n:
            return None
        taken = [self._free.pop() for _ in range(n)]
        for p in taken:
            self._ref[p] += 1
        return taken

    def alloc(self, seq_id: int, n_tokens: int) -> Optional[List[int]]:
        """Create a sequence with capacity for ``n_tokens`` (written
        length starts at 0; ``advance`` after the KV lands). None = OOM."""
        E.enforce(seq_id not in self._seqs,
                  f"sequence {seq_id} already allocated")
        need = self.pages_for(n_tokens)
        E.enforce(need <= self.max_pages_per_seq,
                  f"{n_tokens} tokens need {need} pages > "
                  f"max_pages_per_seq {self.max_pages_per_seq}")
        pages = self._take(need)
        if pages is None:
            return None
        self._seqs[seq_id] = {"pages": pages, "len": 0}
        return pages

    def alloc_prefix(self, seq_id: int, shared_pages: List[int],
                     n_tokens: int) -> Optional[List[int]]:
        """Create a sequence whose leading pages are shared (refcount
        bumps): ``shared_pages`` hold the committed KV of a cached prompt
        prefix, and the rest up to ``n_tokens`` of capacity is taken
        fresh. The shared region must leave a fresh tail page (the cache
        matches strictly less than the prompt), so the holder never
        writes a shared page. None = OOM, state unchanged."""
        E.enforce(seq_id not in self._seqs,
                  f"sequence {seq_id} already allocated")
        need = self.pages_for(n_tokens)
        E.enforce(need <= self.max_pages_per_seq,
                  f"{n_tokens} tokens need {need} pages > "
                  f"max_pages_per_seq {self.max_pages_per_seq}")
        E.enforce(len(shared_pages) < need,
                  f"shared prefix ({len(shared_pages)} pages) must "
                  f"leave a fresh tail page (need {need})")
        E.enforce(all(self._ref[p] > 0 for p in shared_pages),
                  "shared prefix references an unreferenced page")
        fresh = self._take(need - len(shared_pages))
        if fresh is None:
            return None
        for p in shared_pages:
            self._ref[p] += 1
        pages = list(shared_pages) + fresh
        self._seqs[seq_id] = {"pages": pages, "len": 0}
        return pages

    def cache_hold(self, page: int):
        """Pin ``page`` with the prefix cache's own ref. Only a committed
        (referenced) page may be cached: insertion runs at retirement,
        before the sequence's ``free``."""
        E.enforce(self._ref[page] > 0,
                  f"cache_hold on unreferenced page {page}")
        E.enforce(self._cache_hold[page] == 0,
                  f"page {page} already cache-held")
        self._ref[page] += 1
        self._cache_hold[page] = 1

    def cache_release(self, page: int) -> int:
        """Drop the cache's pin on ``page``. Returns 1 if the page went to
        the free list (no live sequence held it), else 0."""
        E.enforce(self._cache_hold[page] == 1,
                  f"cache_release on unheld page {page}")
        self._cache_hold[page] = 0
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            return 1
        return 0

    def ensure(self, seq_id: int, total_tokens: int
               ) -> Optional[Tuple[List[int], List[Tuple[int, int]]]]:
        """Grow capacity to ``total_tokens`` and copy-on-write any shared
        page the upcoming writes (positions >= current len) would touch.
        Returns (new_pages, cow_pairs[(src, dst)]), which the caller
        mirrors onto the device pool, or None on OOM (state unchanged)."""
        s = self._seqs[seq_id]
        need_total = self.pages_for(total_tokens)
        E.enforce(need_total <= self.max_pages_per_seq,
                  f"{total_tokens} tokens need {need_total} pages > "
                  f"max_pages_per_seq {self.max_pages_per_seq}")
        grow = max(0, need_total - len(s["pages"]))
        first_written = s["len"] // self.page_size
        cow_idx = [i for i in range(first_written,
                                    min(len(s["pages"]), need_total))
                   if self._ref[s["pages"][i]] > 1]
        fresh = self._take(grow + len(cow_idx))
        if fresh is None:
            return None
        new_pages, cow_dst = fresh[:grow], fresh[grow:]
        cow_pairs = []
        for i, dst in zip(cow_idx, cow_dst):
            src = s["pages"][i]
            cow_pairs.append((src, dst))
            self._ref[src] -= 1          # shared: never hits 0 here
            s["pages"][i] = dst
        s["pages"].extend(new_pages)
        return new_pages, cow_pairs

    def advance(self, seq_id: int, n_tokens: int = 1):
        """Record ``n_tokens`` written; capacity must already exist."""
        s = self._seqs[seq_id]
        new_len = s["len"] + int(n_tokens)
        E.enforce(new_len <= len(s["pages"]) * self.page_size,
                  f"advance past capacity: {new_len} tokens > "
                  f"{len(s['pages'])} pages")
        s["len"] = new_len

    def fork(self, src_id: int, dst_id: int) -> List[int]:
        """Share src's pages with a new sequence: refcount bumps, no
        copies now; a later ``ensure`` on either side copy-on-writes."""
        E.enforce(dst_id not in self._seqs,
                  f"sequence {dst_id} already allocated")
        s = self._seqs[src_id]
        for p in s["pages"]:
            self._ref[p] += 1
        self._seqs[dst_id] = {"pages": list(s["pages"]), "len": s["len"]}
        return list(s["pages"])

    def free(self, seq_id: int):
        s = self._seqs.pop(seq_id)
        for p in s["pages"]:
            self._ref[p] -= 1
            E.enforce(self._ref[p] >= 0, f"double free of page {p}")
            if self._ref[p] == 0:
                self._free.append(p)


class _RadixNode:
    """One page of cached prefix: ``key`` is the page's token tuple; the
    path from the root is the page-aligned prefix it completes."""
    __slots__ = ("key", "page", "children", "parent", "stamp")

    def __init__(self, key, page, parent, stamp):
        self.key = key
        self.page = page
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.parent = parent
        self.stamp = stamp


class PrefixCache:
    """Radix tree over committed, page-aligned KV prefixes: one node a
    page, the edge key that page's token ids.

    With ``PageAllocator``:

    - ``insert`` runs when a request retires, before the sequence's
      ``free``: only fully committed pages enter, each pinned with
      ``cache_hold``.
    - ``match`` returns the longest cached page-aligned prefix strictly
      shorter than the prompt (the prefill needs at least one tail token
      for the last position's logits) and refreshes the matched nodes'
      LRU stamps.
    - ``evict`` drops LRU leaves whose page no live sequence holds
      (``_ref == cache_hold``); pinned leaves are skipped.

    The same tokens at the same positions give the same KV, so inserting
    along an existing node keeps the cached copy."""

    def __init__(self, alloc: PageAllocator):
        self.alloc = alloc
        self.page_size = alloc.page_size
        self.root = _RadixNode(None, None, None, 0)
        self._clock = 0
        self._nodes = 0
        self.evicted_nodes = 0

    @property
    def nodes(self) -> int:
        return self._nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _key(self, tokens, i: int) -> tuple:
        ps = self.page_size
        return tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    def match(self, tokens) -> Tuple[int, List[int]]:
        """Longest cached page-aligned prefix of ``tokens`` capped at
        ``len(tokens) - 1``: ``(n_cached_tokens, pages)``. Touches every
        matched node's LRU stamp."""
        limit = (len(tokens) - 1) // self.page_size
        node, pages = self.root, []
        stamp = self._tick()
        i = 0
        while i < limit:
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            child.stamp = stamp
            pages.append(child.page)
            node = child
            i += 1
        return i * self.page_size, pages

    def insert(self, tokens, pages: List[int]) -> int:
        """Insert the committed page-aligned prefix of ``tokens`` (its KV
        in ``pages``, the retiring sequence's pages). New nodes take a
        cache hold on their page; existing nodes keep the cached copy.
        Returns the nodes added."""
        n_full = min(len(tokens) // self.page_size, len(pages))
        node, added = self.root, 0
        stamp = self._tick()
        for i in range(n_full):
            key = self._key(tokens, i)
            child = node.children.get(key)
            if child is None:
                self.alloc.cache_hold(pages[i])
                child = _RadixNode(key, pages[i], node, stamp)
                node.children[key] = child
                self._nodes += 1
                added += 1
            else:
                child.stamp = stamp
            node = child
        return added

    def reclaimable(self) -> int:
        """Pages eviction could free now: cache-held pages whose only ref
        is the cache's."""
        a = self.alloc
        return int(np.sum((a._cache_hold > 0) & (a._ref == a._cache_hold)))

    def evict(self, n_pages: int) -> int:
        """LRU leaf eviction until ``n_pages`` reached the free list or
        nothing evictable remains. Only leaves whose page would free are
        dropped (interior nodes become leaves as their subtrees drain).
        Returns the pages freed."""
        a = self.alloc
        freed = 0
        while freed < n_pages:
            best = None
            stack = [self.root]
            while stack:
                nd = stack.pop()
                for ch in nd.children.values():
                    if ch.children:
                        stack.append(ch)
                    elif a._ref[ch.page] == a._cache_hold[ch.page] \
                            and (best is None or ch.stamp < best.stamp):
                        best = ch
            if best is None:
                break
            del best.parent.children[best.key]
            self._nodes -= 1
            self.evicted_nodes += 1
            freed += a.cache_release(best.page)
        return freed


def init_pool(config, num_pages: int, page_size: int, dtype=None,
              device=None, kv_quant: bool = False) -> dict:
    """Zeroed page pools, one ``[P + 1, kv, ps, hd]`` grid per layer (the
    ``P = num_pages`` usable pages and the sink page), stacked on a
    leading layer axis; with ``kv_quant`` each leaf is the ``{"q": int8
    codes, "s": float32 [L, P + 1, kv] scales}`` pair."""
    dt = dtype if dtype is not None else config.dtype
    shape = (config.num_hidden_layers, num_pages + 1,
             config.num_key_value_heads, page_size, config.head_dim)
    if kv_quant:
        def leaf():
            return {"q": torch.zeros(shape, dtype=torch.int8,
                                     device=device),
                    "s": torch.zeros(shape[:3], dtype=torch.float32,
                                     device=device)}
        return {"k": leaf(), "v": leaf()}
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _layer_leaf(pool_leaf, i):
    """Layer ``i`` of a pool leaf: a ``[P, kv, ps, hd]`` tensor, or the
    ``{"q", "s"}`` pair of it."""
    if isinstance(pool_leaf, dict):
        return {k: v[i] for k, v in pool_leaf.items()}
    return pool_leaf[i]


def _usable(leaf, P):
    """The usable pages ``[:P]`` of one layer's leaf (the sink left out):
    what the decode kernel reads."""
    if isinstance(leaf, dict):
        return {k: v[:P] for k, v in leaf.items()}
    return leaf[:P]


def _pool_tensors(pool):
    """Every tensor of a pool: the plain leaves, or codes and scales."""
    for leaf in pool.values():
        yield from (leaf.values() if isinstance(leaf, dict) else (leaf,))


class PagedKVCache:
    """Pool tensors (``.pool``, updated in place) plus allocator
    (``.alloc``): the serving engine's cache object."""

    def __init__(self, config, num_pages: int, page_size: int,
                 max_pages_per_seq: int, dtype=None, device=None,
                 kv_quant: bool = False):
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.kv_quant = bool(kv_quant)
        self.pool = init_pool(config, num_pages, page_size, dtype, device,
                              kv_quant=self.kv_quant)
        self.alloc = PageAllocator(num_pages, page_size, max_pages_per_seq)

    def pool_bytes(self) -> int:
        """Device bytes of the usable pages (codes and scales included;
        the sink page, which holds no token, is not counted)."""
        return sum(t[:, :self.num_pages].numel() * t.element_size()
                   for t in _pool_tensors(self.pool))

    def apply_cow(self, pairs):
        """Mirror allocator copy-on-write decisions onto the pool (codes
        and scale rows of a quantized pool together: both have the page
        on axis 1)."""
        for src, dst in pairs:
            for t in _pool_tensors(self.pool):
                t[:, dst] = t[:, src]

    def block_tables(self, seq_ids, width: Optional[int] = None
                     ) -> np.ndarray:
        """``[len(seq_ids), width]`` block table; None entries (empty
        slots) become all-sentinel rows."""
        width = self.max_pages_per_seq if width is None else width
        rows = np.full((len(seq_ids), width), self.num_pages, np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is not None:
                rows[i] = self.alloc.block_row(sid, width)
        return rows


# int8 KV code range (the reference's _KV_QMAX): scales are per-page per-kv
# head write-time absmax / 127, symmetric, round half to even
_KV_QMAX = 127.0


def _kv_quantize(xf, s):
    """int8 codes of float32 values under broadcastable scales ``s``."""
    return torch.clamp(torch.round(xf / torch.clamp(s, min=1e-10)),
                       -_KV_QMAX, _KV_QMAX).to(torch.int8)


def _kv_pool_write(leaf, pages, page_rows):
    """Write whole-page grids ``pages`` ``[G, npad, kv, ps, hd]`` into one
    layer's pool ``leaf`` ``[P + 1, kv, ps, hd]`` at ``page_rows`` ``[G,
    npad]``; sentinel rows (``>= P``) are written into the sink page
    ``P``, in the same
    ``index_copy_`` (which of several sink writes lands does not matter:
    nothing reads the sink). A quantized leaf (the ``{"q", "s"}`` pair)
    takes each page's own absmax over ``(ps, hd)`` per kv head as its
    scale (a prompt's padding positions in its last page count, as in
    the reference) and the codes under it."""
    quant = isinstance(leaf, dict)
    P = (leaf["q"] if quant else leaf).shape[0] - 1
    rows = page_rows.reshape(-1)
    rows = torch.where(rows < P, rows, P)
    pages = pages.reshape(-1, *pages.shape[2:])
    if quant:
        xf = pages.float()
        s = xf.abs().amax(dim=(-2, -1)) / _KV_QMAX
        leaf["q"].index_copy_(0, rows, _kv_quantize(xf, s[..., None, None]))
        leaf["s"].index_copy_(0, rows, s)
        return
    leaf.index_copy_(0, rows, pages.to(leaf.dtype))


def _kv_pool_gather(leaf, rows, dtype):
    """Pages ``rows`` (any shape of page ids, sink included) of one
    layer's pool ``leaf`` as ``[*rows.shape, kv, ps, hd]`` in ``dtype``;
    a quantized leaf dequantizes as the reference: a float32 multiply of
    codes and scales, then one cast."""
    if isinstance(leaf, dict):
        return (leaf["q"][rows].float()
                * leaf["s"][rows][..., None, None]).to(dtype)
    return leaf[rows].to(dtype)


def _kv_page_append(leaf, rows, off, val):
    """Write one token's ``[n, kv, hd]`` values at slot ``off`` of pages
    ``rows`` (the decode-step write; rows the reference drops are aimed
    at the sink page, whose rescale touches nothing else). A
    quantized leaf rescales the whole touched page, as the reference
    does: gather and dequantize it, zero the slots after ``off`` (a
    reused page's stale codes must not inflate the scale), insert the
    token, requantize under the page's new absmax (committed slots are
    rounded again) and write codes and scale row."""
    if isinstance(leaf, dict):
        n, kv = val.shape[0], val.shape[1]
        ps = leaf["q"].shape[2]
        page = (leaf["q"][rows].float()
                * leaf["s"][rows][..., None, None])    # [n, kv, ps, hd]
        keep = (torch.arange(ps, device=page.device)[None, None, :, None]
                <= off[:, None, None, None])
        page = torch.where(keep, page, 0.0)
        page[torch.arange(n, device=page.device), :, off] = val.float()
        s = page.abs().amax(dim=(-2, -1)) / _KV_QMAX
        leaf["q"][rows] = _kv_quantize(page, s[..., None, None])
        leaf["s"][rows] = s
        return
    kvi = torch.arange(leaf.shape[1], device=leaf.device)
    leaf.index_put_((rows[:, None], kvi[None, :], off[:, None]),
                    val.to(leaf.dtype))


def _to_pages(x, npad, ps):
    """``[G, npad * ps, kv, hd]`` token rows as ``[G, npad, kv, ps, hd]``
    page grids."""
    G, _, kv, hd = x.shape
    return x.reshape(G, npad, ps, kv, hd).transpose(2, 3)


def _from_pages(pages):
    """``[G, n, kv, ps, hd]`` page grids as ``[G, n * ps, kv, hd]`` token
    rows."""
    G, n, kv, ps, hd = pages.shape
    return pages.transpose(2, 3).reshape(G, n * ps, kv, hd)


def paged_prefill(family, params, ids, config, pool_k, pool_v, page_rows,
                  slen):
    """Consume padded prompts ``ids`` ``[G, S_pad]`` (S_pad a page
    multiple; rows are independent requests): writes every covered page
    of K/V into ``page_rows`` ``[G, S_pad / ps]`` (sentinel rows drop;
    an all-sentinel row is a group-padding dummy) and returns the logits
    ``[G, V]`` at each row's position ``slen[g] - 1``. Pools (plain or
    quantized leaves) are updated in place; nothing is read back to the
    host."""
    c = config
    G, S = ids.shape
    L, P, kv, ps, hd = (pool_k["q"] if isinstance(pool_k, dict)
                        else pool_k).shape
    E.enforce(S % ps == 0, f"padded prompt {S} not a multiple of "
              f"page_size {ps}")
    npad = S // ps
    x = params["embed"][ids]
    cos, sin = rope_tables(S, c.head_dim, theta=c.rope_theta,
                           device=x.device)
    for i in range(c.num_hidden_layers):
        lp = layer(params, i)
        h = _rms(x, lp["ln1"], c.rms_norm_eps)
        q, k, v = _qkv_proj(h, lp, c)
        q = rope_raw(q, cos, sin)
        k = rope_raw(k, cos, sin)
        a = sdpa_raw(q, k, v, is_causal=True).reshape(G, S, -1)
        x = x + _mm(a.to(x.dtype), lp["wo"])
        x = family.decode_mlp(x, lp, c)
        _kv_pool_write(_layer_leaf(pool_k, i), _to_pages(k, npad, ps),
                       page_rows)
        _kv_pool_write(_layer_leaf(pool_v, i), _to_pages(v, npad, ps),
                       page_rows)
    x = _rms(x, params["ln_f"], c.rms_norm_eps)
    last = (slen.long() - 1).clamp(min=0)
    x = x[torch.arange(G, device=x.device), last]
    return _head_logits(x, family._head(params, c))


def paged_decode_step(family, params, pool_k, pool_v, block_tables,
                      lengths, tokens, config):
    """One incremental step over the slot grid. ``tokens`` ``[B]`` sit at
    position ``lengths - 1`` of their sequences (``lengths`` int32 is the
    valid KV count including each new token; 0 marks an inactive slot,
    whose write is dropped and whose logits row is garbage the caller
    masks). ``block_tables`` is int32 ``[B, maxp]``. Pools (plain or
    quantized leaves) are updated in place; returns the logits ``[B,
    V]``. Nothing is read back to the host."""
    c = config
    B = tokens.shape[0]
    quant = isinstance(pool_k, dict)
    L, P, kv, ps, hd = (pool_k["q"] if quant else pool_k).shape
    P -= 1                                             # the sink is page P
    n = lengths
    posw = (n.long() - 1).clamp(min=0)                 # [B] write position
    x = params["embed"][tokens][:, None, :]
    # rope angles computed at the ragged positions (the same floats as a
    # rope_tables row)
    inv = 1.0 / (c.rope_theta ** (
        torch.arange(0, c.head_dim, 2, dtype=torch.float32,
                     device=x.device) / c.head_dim))
    freqs = posw.float()[:, None, None] * inv          # [B, 1, hd/2]
    cos, sin = freqs.cos(), freqs.sin()
    page_idx = (posw // ps).clamp(max=block_tables.shape[1] - 1)
    off = posw % ps
    rows = block_tables.gather(1, page_idx[:, None])[:, 0].long()
    # the writes the reference drops (inactive slots, of length 0, and
    # sentinel entries) go to the sink page
    rows = torch.where((n > 0) & (rows < P), rows, P)
    for i in range(c.num_hidden_layers):
        lp = layer(params, i)
        h = _rms(x, lp["ln1"], c.rms_norm_eps)
        q, k, v = _qkv_proj(h, lp, c)
        q = rope_raw(q, cos, sin)
        k = rope_raw(k, cos, sin)
        kpl, vpl = _layer_leaf(pool_k, i), _layer_leaf(pool_v, i)
        _kv_page_append(kpl, rows, off, k[:, 0])
        _kv_page_append(vpl, rows, off, v[:, 0])
        kpl, vpl = _usable(kpl, P), _usable(vpl, P)
        if quant:
            a = dispatched_paged_attention(
                q[:, 0].contiguous(), kpl["q"], vpl["q"], block_tables, n,
                k_scales=kpl["s"], v_scales=vpl["s"])
        else:
            a = dispatched_paged_attention(q[:, 0].contiguous(), kpl, vpl,
                                           block_tables, n)
        x = x + _mm(a.reshape(B, 1, -1).to(x.dtype), lp["wo"])
        x = family.decode_mlp(x, lp, c)
    x = _rms(x, params["ln_f"], c.rms_norm_eps)
    return _head_logits(x[:, 0, :], family._head(params, c))


def paged_prefill_shared(family, params, ids, config, pool_k, pool_v,
                         page_rows, slen, ctx_rows):
    """Tail-only prefill over a shared cached prefix: every row owns
    ``ctx_rows`` ``[G, ncp]`` pages of committed prefix KV (all rows the
    same cached length ``ctx = ncp * ps``) and prefills only its uncached
    tail ``ids`` ``[G, S_tail]`` (a page multiple) into ``page_rows``
    ``[G, S_tail / ps]`` (sentinel rows go to the sink, as in
    ``paged_prefill``). Tail query ``i`` sits at position ``ctx + i``
    (rope there) and attends key ``t`` of prefix ++ tail where ``t <= ctx
    + i``, through the masked plain attention. Returns the logits ``[G,
    V]`` at tail position ``slen - 1``, those of a full prefill at ``ctx +
    slen - 1``. Pools are updated in place; nothing is read back to the
    host."""
    c = config
    G, S = ids.shape
    L, P, kv, ps, hd = (pool_k["q"] if isinstance(pool_k, dict)
                        else pool_k).shape
    ncp = ctx_rows.shape[1]
    E.enforce(S % ps == 0, f"padded tail {S} not a multiple of "
              f"page_size {ps}")
    E.enforce(ncp >= 1, "shared prefill needs a cached prefix")
    ctx, npad = ncp * ps, S // ps
    x = params["embed"][ids]
    cos, sin = rope_tables(ctx + S, c.head_dim, theta=c.rope_theta,
                           device=x.device)
    cos, sin = cos[ctx:], sin[ctx:]
    mask = (torch.arange(ctx + S, device=x.device)[None, :]
            <= torch.arange(S, device=x.device)[:, None] + ctx)[None, None]
    for i in range(c.num_hidden_layers):
        lp = layer(params, i)
        kpl, vpl = _layer_leaf(pool_k, i), _layer_leaf(pool_v, i)
        h = _rms(x, lp["ln1"], c.rms_norm_eps)
        q, k, v = _qkv_proj(h, lp, c)
        q = rope_raw(q, cos, sin)
        k = rope_raw(k, cos, sin)
        # the cached pages, token-major (rope applied when written)
        ka = torch.cat([_from_pages(_kv_pool_gather(kpl, ctx_rows, k.dtype)),
                        k], dim=1)
        va = torch.cat([_from_pages(_kv_pool_gather(vpl, ctx_rows, v.dtype)),
                        v], dim=1)
        a = sdpa_raw(q, ka, va, attn_mask=mask).reshape(G, S, -1)
        x = x + _mm(a.to(x.dtype), lp["wo"])
        x = family.decode_mlp(x, lp, c)
        _kv_pool_write(kpl, _to_pages(k, npad, ps), page_rows)
        _kv_pool_write(vpl, _to_pages(v, npad, ps), page_rows)
    x = _rms(x, params["ln_f"], c.rms_norm_eps)
    last = (slen.long() - 1).clamp(min=0)
    x = x[torch.arange(G, device=x.device), last]
    return _head_logits(x, family._head(params, c))


def paged_verify_window(family, params, tokens, config, pool_k, pool_v,
                        block_tables, kv_len, live):
    """Speculative-decode verify: a drafted window ``tokens`` ``[B, C]`` at
    positions ``kv_len .. kv_len + C - 1`` of each sequence in one pass.
    The window's KV is written into the block table's pages first (rows
    not ``live``, and positions whose page is past the table or a
    sentinel, go to the sink), then window query ``i`` attends every slot
    ``t`` of the row's block table (token-major) with ``t <= kv_len + i``,
    through the masked plain attention. The same math per position as
    ``paged_decode_step``, so the argmax of the returned logits ``[B, C,
    V]`` is the sequential chunk's. A quantized pool rewrites the
    window's pages whole (``_window_rewrite``). Pools are updated in
    place; nothing is read back to the host."""
    c = config
    B, C = tokens.shape
    quant = isinstance(pool_k, dict)
    L, P, kv, ps, hd = (pool_k["q"] if quant else pool_k).shape
    P -= 1                                             # the sink is page P
    maxp = block_tables.shape[1]
    dev = tokens.device
    bt = block_tables.long()
    pos = kv_len.long()[:, None] + torch.arange(C, device=dev)[None, :]
    x = params["embed"][tokens]
    inv = 1.0 / (c.rope_theta ** (
        torch.arange(0, c.head_dim, 2, dtype=torch.float32,
                     device=dev) / c.head_dim))
    freqs = pos.float()[:, :, None] * inv             # [B, C, hd/2]
    cos, sin = freqs.cos(), freqs.sin()
    page_idx = pos // ps
    off = pos % ps
    rows = bt.gather(1, page_idx.clamp(max=maxp - 1))
    rows = torch.where(live[:, None] & (page_idx < maxp), rows, P)
    kvi = torch.arange(kv, device=dev)
    # slot t of a row's table is visible to window query i iff t <=
    # kv_len + i; slots past the allocated pages read the sink, beyond
    # every query's limit
    mask = (torch.arange(maxp * ps, device=dev)[None, None, :]
            <= pos[:, :, None])[:, None]               # [B, 1, C, T]
    if quant:
        # the window spans at most nwp consecutive pages of a sequence
        nwp = (C + ps - 2) // ps + 1
        wstart = kv_len.long() // ps                       # [B]
        wi = wstart[:, None] + torch.arange(nwp, device=dev)[None, :]
        wrows = bt.gather(1, wi.clamp(max=maxp - 1))
        wrows = torch.where((wi < maxp) & live[:, None], wrows, P)
        lpi = page_idx - wstart[:, None]                   # [B, C]
        bi = torch.arange(B, device=dev)[:, None]
        gpos = wi[:, :, None] * ps + torch.arange(ps, device=dev)
        keep = gpos <= (kv_len.long() + C - 1)[:, None, None]

        def _window_rewrite(leaf, val):
            """Gather and dequantize the window's pages, zero their
            unwritten tail (stale codes must not inflate the scale),
            insert the window's tokens, requantize each page under its
            new absmax and write codes and scale rows back."""
            page = (leaf["q"][wrows].float()
                    * leaf["s"][wrows][..., None, None])  # [B, nwp, kv, ps, hd]
            page = torch.where(keep[:, :, None, :, None], page, 0.0)
            page[bi[:, :, None], lpi[:, :, None], kvi[None, None, :],
                 off[:, :, None]] = val.float()
            s = page.abs().amax(dim=(-2, -1)) / _KV_QMAX
            leaf["q"][wrows] = _kv_quantize(page, s[..., None, None])
            leaf["s"][wrows] = s

    for i in range(c.num_hidden_layers):
        lp = layer(params, i)
        kpl, vpl = _layer_leaf(pool_k, i), _layer_leaf(pool_v, i)
        h = _rms(x, lp["ln1"], c.rms_norm_eps)
        q, k, v = _qkv_proj(h, lp, c)
        q = rope_raw(q, cos, sin)
        k = rope_raw(k, cos, sin)
        if quant:
            _window_rewrite(kpl, k)
            _window_rewrite(vpl, v)
        else:
            idx = (rows[:, :, None], kvi[None, None, :], off[:, :, None])
            kpl.index_put_(idx, k.to(kpl.dtype))
            vpl.index_put_(idx, v.to(vpl.dtype))
        ck = _from_pages(_kv_pool_gather(kpl, bt, q.dtype))
        cv = _from_pages(_kv_pool_gather(vpl, bt, q.dtype))
        a = sdpa_raw(q, ck, cv, attn_mask=mask).reshape(B, C, -1)
        x = x + _mm(a.to(x.dtype), lp["wo"])
        x = family.decode_mlp(x, lp, c)
    x = _rms(x, params["ln_f"], c.rms_norm_eps)
    return _head_logits(x, family._head(params, c))
