"""Paged KV cache: page-pool tensors, block-table allocator and the paged
prefill/decode data plane (port of ``paddle_tpu/inference/paged.py``;
full-precision and int8 pools; the prefix cache is not ported).

- ``PageAllocator``: host-side free list and ref-counted pages per
  sequence; plain Python and numpy, never touches the device.
- ``PagedKVCache``: the pool tensors married to an allocator.
- ``paged_prefill`` / ``paged_decode_step``: the data plane, generic over
  the model family's decoder seam (``_qkv_proj``-compatible layers,
  ``decode_mlp``, ``_head``), which ``models.llama`` and ``models.moe``
  both expose.

Pool layout: ``[L, num_pages + 1, kv_heads, page_size, head_dim]``:
``num_pages`` usable pages and one sink page at index ``num_pages``.
Block table entries equal to ``num_pages`` are the "no page" sentinel: a
write aimed at it is dropped. Unlike the reference, which replaces its
donated pool arrays, the port updates the pool tensors in place
(``index_copy_`` / ``index_put_``). torch raises on an out-of-range
index where JAX's ``mode="drop"`` drops it, so every write that the
reference drops (a sentinel row, an inactive slot) is aimed at the sink
page instead: no row is selected on the host, and the data plane never
synchronises the host with the card. Nothing reads the sink: the
allocator never hands it out, block tables never name it, and the
decode kernel is given the usable pages only.

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

__all__ = ["PageAllocator", "PagedKVCache", "init_pool", "paged_prefill",
           "paged_decode_step"]


class PageAllocator:
    """Free-list page allocator with per-sequence block tables and
    ref-counted pages (copy-on-fork). Host-side and O(pages touched);
    OOM is a ``None`` return with state unchanged."""

    def __init__(self, num_pages: int, page_size: int,
                 max_pages_per_seq: int):
        E.enforce(num_pages >= 1, f"num_pages must be >= 1, got {num_pages}")
        E.enforce(page_size >= 1, f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref = np.zeros(num_pages, np.int32)
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

    def seq_pages(self, seq_id: int) -> List[int]:
        return list(self._seqs[seq_id]["pages"])

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
        referenced exactly as often as sequences hold it, and the free
        list is duplicate-free."""
        counts = np.zeros(self.num_pages, np.int32)
        for s in self._seqs.values():
            for p in s["pages"]:
                counts[p] += 1
        if not np.array_equal(counts, self._ref):
            raise AssertionError(f"refcount drift: held={counts.tolist()} "
                                 f"ref={self._ref.tolist()}")
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
        # [G, S, kv, hd] -> [G, npad, kv, ps, hd] page grids
        _kv_pool_write(_layer_leaf(pool_k, i),
                       k.reshape(G, npad, ps, kv, hd).transpose(2, 3),
                       page_rows)
        _kv_pool_write(_layer_leaf(pool_v, i),
                       v.reshape(G, npad, ps, kv, hd).transpose(2, 3),
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
