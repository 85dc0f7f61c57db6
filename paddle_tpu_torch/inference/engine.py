"""Continuous-batching serving engine over a paged KV cache (port of
``paddle_tpu/inference/engine.py``).

With every ``FLAGS_serving_*`` option at its default (off) the scheduler
is the reference's core: FIFO admission with a page watermark,
same-bucket grouped prefill padded to a power-of-two page count and
group size, chunked decode over a fixed slot grid, recompute preemption
of the youngest request when the page pool runs out, and slot
compaction. ``kv_quant`` (default: ``FLAGS_serving_kv_quant``) stores
int8 KV pages with one float32 scale per (page, kv head). The model is a
family module, ``models.llama`` or ``models.moe``; ``params`` may also be
a weight-only-quantized tree of it (``quantize_weights``).

The reference's options that are off by default, each taking its
``FLAGS_serving_*`` flag as its default:

- ``prefix_cache``: a radix ``PrefixCache`` over committed pages.
  Admission forks the longest cached page-aligned prefix and takes only
  the tail fresh (evicting cold cache pages under pressure), a group
  shares one cached length and prefills only its tails
  (``paged_prefill_shared``), retirement inserts the committed positions,
  and a decode chunk that runs out of pages evicts cache pages before it
  preempts.
- ``spec_decode``: on a greedy turbo chunk, each sequence drafts a window
  from a bigram table over its own context and one ``paged_verify_window``
  pass accepts the longest run the model's greedy predictions confirm.
- ``priority_admission`` and ``tenant_inflight_cap``: admission picks the
  highest ``Request.priority`` first and skips a tenant that holds its
  cap of slots. ``_admit`` is one scan for every option; the
  reference's second, copied scan (``_admit_policy``) is not kept.
- ``slo_preemption``: the victim is the lowest (priority, prior
  preemptions, KV length) instead of the youngest.

The bounded queue, shedding, deadlines and drain, failover and fleet burn
scaling are not ported (ROADMAP A7): the constructor refuses to build an
engine with one of their flags on. Nor are the monitor, forensics and
trace planes, so the reference's calls into them (``_defer``'s deferral
records, the cost records, latency histograms, spans and counters) are
left out; SLO preemption measures a victim's work by its KV length, the
reference's measure when its monitor is off.

Where the reference jits one program per chunk, ``_decode_chunk`` is a
Python loop over ``chunk`` decode steps; the pool is updated in place.
The host waits for the card twice per prefill group, decode chunk or
verify round, and nowhere else: once to upload its inputs (``_upload``,
one copy) and once to read its tokens back. Between the two, the data
plane (``_prefill_plane``, ``_decode_plane``, ``_spec_plane``) selects no
rows on the host (writes the reference drops land in the pool's sink
page) and draws sampled tokens on the device, so the host issues a
chunk's steps while the card works through the earlier ones.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import enforce as E
from ..core import flags as _flags
from ..core import resolve_device
from .paged import (PagedKVCache, PrefixCache, paged_decode_step,
                    paged_prefill, paged_prefill_shared, paged_verify_window)

__all__ = ["Request", "RequestOutput", "RequestRejected", "EngineStats",
           "ServingEngine"]

PAGED_DEFAULT_PAGE = 16
# the reference's page-size floor for int8 pools (kernels/autotune.py
# paged_candidates(kv_quant=True)[0]); the CUDA int8 arm takes any page
# size, so this is the default only
PAGED_QUANT_PAGE = 32

# the flags of the reference's serving options (the engine's, and the
# elastic controller's fleet burn scaling) that the port does not run yet
_UNPORTED_FLAGS = ("serving_max_queue", "serving_shed_on_burn",
                   "serving_failover", "serving_fleet_burn_scaling")


class RequestRejected(E.InvalidArgumentError):
    """A malformed submission, refused by ``submit`` before it touches
    the queue, the page pool or any device state."""

    def __init__(self, rid, reason: str):
        self.rid = rid
        self.reason = reason
        super().__init__(f"request {rid!r} rejected: {reason}")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # [S] int token ids
    max_new_tokens: int
    temperature: float = 0.0
    eos_token_id: Optional[int] = None
    seed: Optional[int] = None           # sampling seed when temperature > 0
    tenant: str = "default"              # admission cap dimension
    priority: int = 0                    # scheduling class: HIGHER is
    #                                      more important (admission
    #                                      order, preemption protection)


@dataclasses.dataclass
class RequestOutput:
    rid: int
    tokens: np.ndarray                   # generated ids (<= max_new_tokens)
    prompt_len: int
    preemptions: int = 0                 # times this request was evicted
    ttft_s: Optional[float] = None       # first submit to the first token
    #                                      the client keeps (host clock)
    tenant: str = "default"


class _Slot:
    __slots__ = ("req", "kv_len", "gen", "tokens", "pending", "done",
                 "preemptions", "t_first", "ng", "ng_n")

    def __init__(self, req: Request):
        self.req = req
        self.kv_len = 0          # KV positions written (prompt + decoded)
        self.gen = 0             # tokens sampled so far
        self.tokens: List[int] = []
        self.pending = 0         # last sampled token (KV not yet written)
        self.done = False
        self.preemptions = 0
        self.t_first = None      # host time the first token reached the host
        self.ng = None           # spec decode: bigram draft table over
        #                          this request's own context (lazy)
        self.ng_n = 0            # context tokens folded into ng so far


class EngineStats:
    def __init__(self):
        self.admitted = 0
        self.completed = 0
        self.preempted = 0
        self.decode_steps = 0
        self.tokens_generated = 0    # incl. the token sampled at prefill
        self.tokens_decoded = 0      # emitted by decode steps only
        self.tokens_prefilled = 0
        self.tokens_discarded = 0    # thrown away by preemption recompute
        self.peak_pages_in_use = 0
        self.prefill_s = 0.0         # host wall time of prefill groups,
        self.decode_s = 0.0          # and of decode chunks (each ends in a
        #                              download, which waits for the card)
        self._occ_steps = 0          # decode steps weighted by slot count
        # shared-prefix radix cache (prefix_cache)
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0     # prompt tokens not re-prefilled
        self.prefix_evictions = 0        # radix nodes dropped by pressure
        # n-gram speculative decode (spec_decode)
        self.spec_rounds = 0     # per-slot verify windows dispatched
        self.spec_drafted = 0    # draft tokens proposed (C-1 per round)
        self.spec_accepted = 0   # drafts accepted by greedy verify

    def occupancy(self) -> float:
        """Useful-token fraction of the decode grid: decode-emitted
        tokens / (decode steps x slots)."""
        return (self.tokens_decoded / self._occ_steps
                if self._occ_steps else 0.0)

    def as_dict(self) -> dict:
        """The counters under the reference's keys (those of the options
        the port does not run, ``expired`` and ``shed``, left out)."""
        return {"admitted": self.admitted, "completed": self.completed,
                "preempted": self.preempted,
                "decode_steps": self.decode_steps,
                "tokens_generated": self.tokens_generated,
                "tokens_prefilled": self.tokens_prefilled,
                "tokens_discarded": self.tokens_discarded,
                "peak_pages_in_use": self.peak_pages_in_use,
                "batch_occupancy": round(self.occupancy(), 4),
                "prefix_lookups": self.prefix_lookups,
                "prefix_hits": self.prefix_hits,
                "prefix_tokens_saved": self.prefix_tokens_saved,
                "prefix_evictions": self.prefix_evictions,
                "spec_rounds": self.spec_rounds,
                "spec_drafted": self.spec_drafted,
                "spec_accepted": self.spec_accepted}


def _token_seed(seed: int, t: int) -> int:
    """Seed of the draw for token ``t`` of a request: a function of the
    request's seed and the token index alone, so a preempted request
    that recomputes draws the same tokens again."""
    return (int(seed) * 1_000_003 + int(t)) & 0x7FFF_FFFF_FFFF_FFFF


def _sample_rows(logits, temps, seeds=None):
    """Per-slot sampling: greedy (first argmax) rows where the temperature
    is 0; a row with temperature > 0 draws from softmax(logits / t) with a
    ``torch.Generator`` of the logits' device seeded by ``seeds[row]``.
    ``seeds=None`` means every row is greedy.

    The draw is the exponential race that ``torch.multinomial`` runs for
    one sample: the argmax of ``p / e``, ``e ~ Exp(1)``, where a token of
    probability 0 never wins. Unlike ``multinomial`` it does not check
    its input on the host, so the token stays a device tensor. The
    stream of ``e`` is the device generator's, so a card draws other
    tokens than the CPU under the same seed; on each device one seed
    gives one token, and a preempted request that recomputes draws the
    same tokens again."""
    greedy = logits.argmax(dim=-1)
    if seeds is None:
        return greedy
    out = greedy.clone()
    for i, sd in enumerate(seeds):
        if sd is None or temps[i] <= 0.0:
            continue
        p = torch.softmax(logits[i].float() / max(float(temps[i]), 1e-6),
                          dim=-1)
        gen = torch.Generator(device=logits.device).manual_seed(sd)
        race = p / torch.empty_like(p).exponential_(generator=gen)
        out[i] = race.masked_fill_(p == 0, 0.0).argmax()
    return out


def _decode_chunk(family, config, chunk, params, pool_k, pool_v,
                  block_tables, tokens, kv_len, done, gen, max_new, eos,
                  temps, seeds):
    """``chunk`` decode steps: write the pending token's KV, attend,
    sample the next. Done slots coast (writes dropped via length 0,
    outputs masked to -1). ``seeds[t]`` holds step ``t``'s per-row
    sampling seeds, or is None when every row is greedy. Returns the
    emitted grid ``[chunk, B]`` (on the device)."""
    emitted = []
    for t in range(chunk):
        n = torch.where(done, 0, kv_len + 1).to(torch.int32)
        logits = paged_decode_step(family, params, pool_k, pool_v,
                                   block_tables, n, tokens, config)
        kv_len = torch.where(done, kv_len, kv_len + 1)
        nxt = _sample_rows(logits, temps,
                           None if seeds is None else seeds[t])
        em = torch.where(done, -1, nxt)
        gen = gen + (~done).long()
        hit_eos = (~done) & (nxt == eos)
        done = done | hit_eos | (gen >= max_new)
        tokens = torch.where(em >= 0, nxt, tokens)
        emitted.append(em)
    return torch.stack(emitted)


class ServingEngine:
    """Continuous-batching decode over a paged KV cache.

    ``family`` is a model module exposing the decoder seam
    (``models.llama`` or ``models.moe``); ``params`` its parameter dict
    (or its weight-only-quantized tree), already on
    ``device``. ``device=None`` means the CUDA card and raises without
    one; pass ``device="cpu"`` for the plain versions on the CPU.

    ``kv_quant`` (default: ``FLAGS_serving_kv_quant``) stores the KV
    pages as int8 codes with per-(page, kv head) float32 scales (about
    half the bytes of bfloat16 pages), and decodes through the int8 arm
    of the paged kernel. ``page_size=None`` is 32 with ``kv_quant``, else
    16.

    ``prefix_cache``, ``spec_decode``, ``priority_admission``,
    ``tenant_inflight_cap`` (a negative cap is 0, uncapped) and
    ``slo_preemption`` each default to their ``FLAGS_serving_*`` flag;
    the module docstring says what each does. All off, the default, is
    the engine above, tokens and scheduling alike.

    The reference's other serving options (queue bounds, shedding,
    failover, fleet burn scaling) are not ported yet (ROADMAP A7): with
    any of their ``FLAGS_serving_*`` flags on (true, or a positive
    depth) the constructor raises ``NotImplementedError``."""

    def __init__(self, family, params, config, *, num_slots: int = 8,
                 max_len: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 decode_chunk: int = 4, watermark: float = 0.0,
                 kv_quant: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 spec_decode: Optional[bool] = None,
                 priority_admission: Optional[bool] = None,
                 tenant_inflight_cap: Optional[int] = None,
                 slo_preemption: Optional[bool] = None, device=None):
        on = [f"FLAGS_{flag}" for flag in _UNPORTED_FLAGS
              if _flags.flag_value(flag) > 0]
        if on:
            raise NotImplementedError(
                f"ServingEngine: {', '.join(on)} selects a serving option "
                f"that is not ported yet (ROADMAP.md queue A item A7)")

        def _opt(v, flag):
            return _flags.flag_value(flag) if v is None else v
        self._priority_admission = bool(
            _opt(priority_admission, "serving_priority_admission"))
        # negatives clamp to 0 = uncapped (a raw -1 cap would read
        # `0 >= -1` for every tenant and block admission forever)
        self._tenant_cap = max(0, int(
            _opt(tenant_inflight_cap, "serving_tenant_inflight_cap")))
        self._slo_preemption = bool(
            _opt(slo_preemption, "serving_slo_preemption"))
        self._spec_decode = bool(_opt(spec_decode, "serving_spec_decode"))
        prefix_on = bool(_opt(prefix_cache, "serving_prefix_cache"))
        self.device = resolve_device(device)
        E.enforce(params["embed"].device == self.device,
                  f"params lie on {params['embed'].device}, the engine "
                  f"runs on {self.device}", error=E.InvalidArgumentError)
        self.family = family
        self.params = params
        self.config = config
        self.num_slots = int(num_slots)
        self.decode_chunk = int(decode_chunk)
        E.enforce(self.decode_chunk >= 1, "decode_chunk must be >= 1")
        max_len = int(max_len if max_len is not None
                      else config.max_position_embeddings)
        self.kv_quant = bool(_flags.flag_value("serving_kv_quant")
                             if kv_quant is None else kv_quant)
        if page_size is None:
            page_size = PAGED_QUANT_PAGE if self.kv_quant \
                else PAGED_DEFAULT_PAGE
        self.page_size = int(page_size)
        self.max_len = -(-max_len // self.page_size) * self.page_size
        self.max_pages_per_seq = self.max_len // self.page_size
        if num_pages is None:
            num_pages = self.num_slots * self.max_pages_per_seq
        E.enforce(num_pages >= self.max_pages_per_seq,
                  f"pool of {num_pages} pages cannot hold even one "
                  f"max-length sequence ({self.max_pages_per_seq} pages)")
        self.watermark_pages = int(watermark * num_pages)
        self.cache = PagedKVCache(config, num_pages, self.page_size,
                                  self.max_pages_per_seq, config.dtype,
                                  self.device, kv_quant=self.kv_quant)
        # radix shared-prefix cache over the pool's committed pages; None
        # (option off) short-circuits every hook to the plain code
        self._prefix = PrefixCache(self.cache.alloc) if prefix_on else None
        self.queue: deque = deque()
        self.slots: List[Optional[_Slot]] = [None] * self.num_slots
        self.outputs: Dict[int, RequestOutput] = {}
        self.stats = EngineStats()
        self._rng_fallback = 0
        # the 4x "turbo" chunk engages when every live slot is sure to
        # run it end to end (no retire/join could happen mid-chunk)
        self.turbo_chunk = self.decode_chunk * 4

    # -- submission ---------------------------------------------------------

    def _reject_reason(self, req: Request):
        """``(reason, None)`` for a submission that must be refused, else
        ``(None, (prompt, max_new, temperature))`` with the validated,
        coerced values."""
        def bad(reason):
            return reason, None
        try:
            prompt = np.asarray(req.prompt)
        except Exception:
            return bad("prompt is not array-like")
        if prompt.ndim != 1:
            return bad(f"prompt must be 1-D token ids, got shape "
                       f"{prompt.shape}")
        plen = int(prompt.shape[0])
        if plen < 1:
            return bad("empty prompt")
        if not np.issubdtype(prompt.dtype, np.integer):
            return bad(f"prompt dtype {prompt.dtype} is not an integer "
                       "token-id type")
        vocab = int(self.config.vocab_size)
        lo, hi = int(prompt.min()), int(prompt.max())
        if lo < 0 or hi >= vocab:
            return bad(f"prompt token ids outside [0, {vocab}): min {lo}, "
                       f"max {hi}")
        try:
            max_new = int(req.max_new_tokens)
            if max_new != req.max_new_tokens:
                return bad(f"max_new_tokens {req.max_new_tokens!r} is "
                           "not an integral count")
        except (TypeError, ValueError, OverflowError):
            return bad(f"max_new_tokens {req.max_new_tokens!r} is not "
                       "an int")
        if max_new < 1:
            return bad(f"max_new_tokens must be >= 1, got {max_new}")
        if plen + max_new > self.max_len:
            return bad(f"prompt {plen} + max_new {max_new} exceeds "
                       f"max_len {self.max_len}")
        try:
            temp = float(req.temperature)
        except (TypeError, ValueError):
            return bad(f"temperature {req.temperature!r} is not a float")
        if not math.isfinite(temp) or temp < 0.0:
            return bad(f"temperature must be finite and >= 0, got {temp}")
        tenant = req.tenant
        if tenant is None:
            tenant = "default"
        else:
            try:
                tenant = str(tenant)
            except Exception:
                return bad("tenant is not string-coercible")
            tenant = tenant or "default"
            if len(tenant) > 128:
                return bad(f"tenant name of {len(tenant)} chars exceeds "
                           "the 128-char limit")
        try:
            priority = int(req.priority)
            if priority != req.priority:
                return bad(f"priority {req.priority!r} is not an "
                           "integral class")
        except (TypeError, ValueError, OverflowError):
            return bad(f"priority {req.priority!r} is not an int")
        return None, (prompt.astype(np.int64), max_new, temp, tenant,
                      priority)

    def submit(self, req: Request):
        """Queue a request, or raise :class:`RequestRejected` when it is
        malformed (engine state untouched either way until admission)."""
        reason, norm = self._reject_reason(req)
        if reason is not None:
            raise RequestRejected(req.rid, reason)
        (req.prompt, req.max_new_tokens, req.temperature, req.tenant,
         req.priority) = norm
        if req.temperature > 0.0 and req.seed is None:
            self._rng_fallback += 1
            req.seed = self._rng_fallback
        req._t_submit = time.perf_counter()
        req._preempt_count = 0
        req._pfx_cached = 0          # cached prefix length of its admission
        self.queue.append(req)

    # -- scheduling ---------------------------------------------------------

    def _bucket(self, plen: int) -> int:
        """Padded prompt length: next power-of-two page count."""
        pages = self.cache.alloc.pages_for(plen)
        b = 1
        while b < pages:
            b *= 2
        return min(b, self.max_pages_per_seq) * self.page_size

    def _compact(self):
        """Pack live slots into the low indices (a host permutation; the
        block tables are rebuilt for every chunk)."""
        live = [s for s in self.slots if s is not None]
        self.slots = live + [None] * (self.num_slots - len(live))

    def _free_slack(self) -> int:
        """Free pages the admission watermark may count: the free list
        plus prefix-cache pages reclaimable on demand (one
        ``_evict_pages`` away from free), so that cold cache entries never
        jam admission. Cache off: exactly ``free_pages``."""
        free = self.cache.alloc.free_pages
        if self._prefix is not None:
            free += self._prefix.reclaimable()
        return free

    def _evict_pages(self, n: int) -> int:
        """LRU-evict prefix-cache entries until ``n`` pages reach the free
        list (or nothing evictable remains); returns the pages freed.
        Cache off: 0."""
        if self._prefix is None:
            return 0
        before = self._prefix.evicted_nodes
        freed = self._prefix.evict(n)
        self.stats.prefix_evictions += self._prefix.evicted_nodes - before
        return freed

    def _match_len(self, req: Request) -> int:
        """Cached page-aligned prefix length of a prompt (the group-fill
        probe; refreshes the matched nodes' LRU stamps)."""
        return self._prefix.match(req.prompt)[0]

    def _alloc_for(self, req: Request, s_pad: int):
        """Admission allocation through the prefix cache: fork the longest
        cached page-aligned prefix by refcount and take only the tail
        fresh, evicting LRU cache leaves under pool pressure. The match
        is re-run after every eviction round: eviction may drop the very
        nodes just matched, and a stale page list must never be forked.
        Stamps ``req._pfx_cached`` with the shared token count on
        success. Cache off: the plain ``alloc``."""
        alloc = self.cache.alloc
        if self._prefix is None:
            return alloc.alloc(req.rid, s_pad)
        self.stats.prefix_lookups += 1
        need = alloc.pages_for(s_pad)
        while True:
            cached, pages = self._prefix.match(req.prompt)
            missing = (need - len(pages)) - alloc.free_pages
            if missing > 0:
                if self._evict_pages(missing) == 0:
                    return None
                continue
            got = alloc.alloc_prefix(req.rid, pages, s_pad) if cached \
                else alloc.alloc(req.rid, s_pad)
            if got is None:
                return None
            req._pfx_cached = cached
            if cached:
                self.stats.prefix_hits += 1
                self.stats.prefix_tokens_saved += cached
            return got

    def _retire(self, idx: int):
        slot = self.slots[idx]
        self.slots[idx] = None
        if self._prefix is not None and slot.kv_len >= self.page_size:
            # only COMMITTED positions enter the radix: the prompt plus
            # the generated tokens whose KV is written (kv_len of them;
            # the last sampled token's KV never is). insert() takes its
            # cache holds BEFORE the free below, so the pages survive the
            # sequence's release.
            plen = int(slot.req.prompt.shape[0])
            gen_committed = slot.kv_len - plen
            stream = slot.req.prompt if gen_committed <= 0 else \
                np.concatenate([slot.req.prompt, np.asarray(
                    slot.tokens[:gen_committed], np.int64)])
            self._prefix.insert(stream,
                                self.cache.alloc.seq_pages(slot.req.rid))
        self.cache.alloc.free(slot.req.rid)
        self.outputs[slot.req.rid] = RequestOutput(
            rid=slot.req.rid, tokens=np.asarray(slot.tokens, np.int32),
            prompt_len=int(slot.req.prompt.shape[0]),
            preemptions=slot.preemptions,
            ttft_s=slot.t_first - slot.req._t_submit,
            tenant=slot.req.tenant)
        self.stats.completed += 1

    def _preempt_victim_idx(self) -> Optional[int]:
        """The eviction victim. Default: the youngest live request (the
        highest slot index). With ``slo_preemption``: the lowest
        (priority, prior preemptions, KV length), the youngest among
        equals: the least important class first, within a class repeat
        victims protected, then the request cheapest to recompute."""
        if not self._slo_preemption:
            for idx in range(self.num_slots - 1, -1, -1):
                slot = self.slots[idx]
                if slot is not None and not slot.done:
                    return idx
            return None
        best_idx, best_key = None, None
        for idx in range(self.num_slots):
            slot = self.slots[idx]
            if slot is None or slot.done:
                continue
            key = (slot.req.priority, slot.preemptions, slot.kv_len, -idx)
            if best_key is None or key < best_key:
                best_idx, best_key = idx, key
        return best_idx

    def _preempt_one(self) -> bool:
        """Evict :meth:`_preempt_victim_idx`'s request (recompute policy:
        pages freed, request requeued at the front). False when nothing
        can be evicted."""
        idx = self._preempt_victim_idx()
        if idx is None:
            return False
        slot = self.slots[idx]
        self.slots[idx] = None
        self.cache.alloc.free(slot.req.rid)
        slot.req._preempt_count += 1
        self.queue.appendleft(slot.req)
        self.stats.preempted += 1
        self.stats.tokens_discarded += slot.gen
        return True

    def _pad_bucket(self, req: Request) -> int:
        return max(self._bucket(int(req.prompt.shape[0])), self.page_size)

    def _admit(self):
        """Admission with a head-of-line page watermark. Each pass picks
        a head: the FIFO head, or with ``priority_admission`` the
        highest-priority waiter (ties by queue position: arrival order,
        preemption re-queues at the front). With ``tenant_inflight_cap``
        a tenant that already holds its cap of slots is skipped: its
        requests wait without blocking other tenants, and the cap alone
        keeps FIFO among the eligible. Same-bucket waiters join the
        head's prefill group (with the prefix cache, only those whose
        cached length is the head's), in queue order, or in priority
        order under ``priority_admission``, so grouping may co-admit
        lower-priority same-bucket waiters into slots the dispatch would
        leave idle (a bounded, one-dispatch-deep inversion traded for
        batched prefill). The reference runs the options in a second,
        copied scan (``_admit_policy``); with both options off this scan
        takes the same steps as its FIFO one."""
        alloc = self.cache.alloc
        cap = self._tenant_cap
        inflight: Dict[str, int] = {}
        if cap:
            for s in self.slots:
                if s is not None:
                    inflight[s.req.tenant] = inflight.get(s.req.tenant, 0) + 1
        while self.queue:
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                break
            pos = None
            for j, r in enumerate(self.queue):
                if cap and inflight.get(r.tenant, 0) >= cap:
                    continue
                if not self._priority_admission:
                    pos = j               # first eligible (FIFO)
                    break
                if pos is None or r.priority > self.queue[pos].priority:
                    pos = j
            if pos is None:               # every waiter's tenant is at cap
                break
            req = self.queue[pos]
            s_pad = self._pad_bucket(req)
            need = s_pad // self.page_size
            idle = not any(s is not None and not s.done
                           for s in self.slots)
            if self._free_slack() - need < self.watermark_pages \
                    and not idle:
                break
            del self.queue[pos]
            if self._alloc_for(req, s_pad) is None:
                self.queue.insert(pos, req)
                # an idle engine that cannot place its head request will
                # never make progress: a sizing error, not a transient
                E.enforce(not idle,
                          f"request {req.rid} needs {need} pages but only "
                          f"{alloc.free_pages} exist free on an idle "
                          f"engine", error=E.ResourceExhaustedError)
                break
            # the tail prefill's context page count is one per group, so
            # co-grouped requests must match the head's cached length
            head_cached = req._pfx_cached
            group = [req]
            if cap:
                inflight[req.tenant] = inflight.get(req.tenant, 0) + 1
            # priority order (ties: queue position), so an equal-or-higher
            # priority same-bucket waiter never loses its seat to an
            # earlier-queued lower-priority one
            order = list(range(len(self.queue)))
            if self._priority_admission:
                order.sort(key=lambda j: (-self.queue[j].priority, j))
            picked: List[int] = []
            for j in order:
                if len(group) >= len(free):
                    break
                if self._free_slack() - need < self.watermark_pages:
                    break
                cand = self.queue[j]
                if self._pad_bucket(cand) != s_pad or (
                        cap and inflight.get(cand.tenant, 0) >= cap) or (
                        self._prefix is not None
                        and self._match_len(cand) != head_cached):
                    continue
                if self._alloc_for(cand, s_pad) is None:
                    break
                if cand._pfx_cached != head_cached:
                    # an eviction inside _alloc_for shifted the match:
                    # not groupable this pass, so it stays queued
                    alloc.free(cand.rid)
                    continue
                picked.append(j)
                group.append(cand)
                if cap:
                    inflight[cand.tenant] = inflight.get(cand.tenant, 0) + 1
            for j in sorted(picked, reverse=True):
                del self.queue[j]
            self._prefill_group(free, group, s_pad)

    def _prefill_group(self, free: List[int], group: List[Request],
                       s_pad: int):
        """One batched prefill for same-bucket requests, padded to a
        power-of-two group size; dummy rows carry all-sentinel page rows
        and never touch the pool. With the prefix cache every member
        shares one cached page-aligned prefix length (admission grouped
        by it), and only the uncached tails are prefilled, over the
        shared context pages, which are read and never written."""
        need = s_pad // self.page_size
        g = 1
        while g < len(group):
            g *= 2
        cached = group[0]._pfx_cached if self._prefix is not None else 0
        ncp = cached // self.page_size
        sentinel = self.cache.num_pages
        ids = np.zeros((g, s_pad - cached), np.int64)
        rows = np.full((g, need - ncp), sentinel, np.int64)
        ctx_rows = np.full((g, ncp), sentinel, np.int64)
        slen = np.ones(g, np.int64)
        temps = [0.0] * g
        seeds = [None] * g
        slots = []
        for j, r in enumerate(group):
            plen = int(r.prompt.shape[0])
            ids[j, :plen - cached] = r.prompt[cached:]
            brow = self.cache.alloc.block_row(r.rid, need)
            ctx_rows[j] = brow[:ncp]
            rows[j] = brow[ncp:]
            slen[j] = plen - cached
            temps[j] = r.temperature
            if r.temperature > 0.0:
                seeds[j] = _token_seed(r.seed, 0)
            slot = _Slot(r)
            slot.kv_len = plen
            slot.preemptions = r._preempt_count
            slots.append(slot)
        t0 = time.perf_counter()
        ids, rows, slen, *ctx = self._upload(
            ids, rows, slen, *((ctx_rows,) if cached else ()))
        toks = self._prefill_plane(
            ids, rows, slen, temps,
            seeds if any(s is not None for s in seeds) else None,
            *ctx).tolist()
        t_first = time.perf_counter()
        self.stats.prefill_s += t_first - t0
        for j, (r, slot) in enumerate(zip(group, slots)):
            tail = int(r.prompt.shape[0]) - cached
            self.cache.alloc.advance(r.rid, tail + cached)
            tok = int(toks[j])
            slot.tokens.append(tok)
            slot.pending = tok
            slot.gen = 1
            slot.t_first = t_first
            slot.done = (r.eos_token_id is not None
                         and tok == r.eos_token_id) \
                or slot.gen >= r.max_new_tokens
            self.slots[free[j]] = slot
            self.stats.admitted += 1
            self.stats.tokens_generated += 1
            self.stats.tokens_prefilled += tail

    def _upload(self, *arrays):
        """A prefill group's or decode chunk's host arrays as device
        tensors, shapes and types kept, through one copy: a copy from
        pageable host memory waits for the card, so there is one, not
        one an array."""
        flat = np.concatenate([a.ravel().astype(np.int64) for a in arrays])
        buf = torch.as_tensor(flat, device=self.device)
        out, at = [], 0
        for a in arrays:
            out.append(buf[at:at + a.size].view(a.shape)
                       .to(torch.as_tensor(a[:0]).dtype))
            at += a.size
        return out

    def _prefill_plane(self, ids, rows, slen, temps, seeds, ctx_rows=None):
        """The device work of one prefill group on uploaded inputs: the
        prefill over the pool (with ``ctx_rows``, the cached prefix's
        pages, the tails' prefill over them) and the draw of the first
        tokens, which stay on the device. Reads nothing back."""
        pool = self.cache.pool
        if ctx_rows is None:
            logits = paged_prefill(self.family, self.params, ids,
                                   self.config, pool["k"], pool["v"], rows,
                                   slen)
        else:
            logits = paged_prefill_shared(self.family, self.params, ids,
                                          self.config, pool["k"], pool["v"],
                                          rows, slen, ctx_rows)
        return _sample_rows(logits, temps, seeds)

    def _decode_plane(self, chunk, bt, tokens, kv_len, done, gen, max_new,
                      eos, temps, seeds):
        """The device work of one decode chunk on uploaded inputs:
        ``_decode_chunk`` over the pool. Reads nothing back."""
        return _decode_chunk(
            self.family, self.config, chunk, self.params,
            self.cache.pool["k"], self.cache.pool["v"], bt, tokens, kv_len,
            done, gen, max_new, eos, temps, seeds)

    def _pick_chunk(self, live_idx: List[int]) -> int:
        """Turbo chunk when no retire/join/EOS could land mid-chunk."""
        if len(live_idx) < self.num_slots:
            return self.decode_chunk
        for i in live_idx:
            s = self.slots[i]
            if (s.req.eos_token_id is not None
                    or s.req.max_new_tokens - s.gen < self.turbo_chunk):
                return self.decode_chunk
        return self.turbo_chunk

    def _ensure_chunk_capacity(self, live_idx: List[int],
                               chunk: int) -> List[int]:
        """Reserve pages for up to ``chunk`` appends per live slot; on OOM
        evict cold prefix-cache pages first, then preempt
        (``_preempt_victim_idx``). Returns the (possibly shrunk) live
        index list."""
        i = 0
        while i < len(live_idx):
            slot = self.slots[live_idx[i]]
            if slot is None:              # preempted by an earlier pass
                live_idx.pop(i)
                continue
            appends = min(chunk, slot.req.max_new_tokens - slot.gen + 1)
            got = self.cache.alloc.ensure(slot.req.rid,
                                          slot.kv_len + appends)
            if got is None:
                if self._evict_pages(1) == 0:
                    E.enforce(self._preempt_one(),
                              "page pool exhausted with nothing left to "
                              "preempt", error=E.ResourceExhaustedError)
                continue                  # retry this slot
            self.cache.apply_cow(got[1])
            i += 1
        return [idx for idx in live_idx if self.slots[idx] is not None]

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduling iteration: retire -> compact -> admit -> one
        decode chunk. Returns False when the engine is fully idle.

        Runs in inference mode: a served parameter tree that requires
        grad builds no autograd graph and saves nothing for a backward."""
        for idx in range(self.num_slots):
            if self.slots[idx] is not None and self.slots[idx].done:
                self._retire(idx)
        self._compact()
        self._admit()
        self.stats.peak_pages_in_use = max(self.stats.peak_pages_in_use,
                                           self.cache.alloc.used_pages)
        live_idx = [i for i, s in enumerate(self.slots)
                    if s is not None and not s.done]
        if not live_idx:
            return bool(self.queue) or any(
                s is not None for s in self.slots)
        C = self._pick_chunk(live_idx)
        live_idx = self._ensure_chunk_capacity(live_idx, C)
        if not live_idx:
            return True
        if (self._spec_decode and C == self.turbo_chunk
                and not any(self.slots[i].req.temperature > 0
                            for i in live_idx)):
            # greedy turbo chunk: verify a self-drafted window in one
            # model pass instead of C sequential decode steps. The turbo
            # preconditions (full grid, no EOS, every remaining run
            # covers the chunk) hold, so the round ends at the boundary
            # the sequential chunk would
            return self._spec_step(live_idx, C)

        B = self.num_slots
        tokens = np.zeros(B, np.int64)
        kv_len = np.zeros(B, np.int64)
        done = np.ones(B, bool)
        gen = np.zeros(B, np.int64)
        max_new = np.zeros(B, np.int64)
        eos = np.full(B, -1, np.int64)
        temps = [0.0] * B
        for i in live_idx:
            s = self.slots[i]
            tokens[i], kv_len[i], done[i] = s.pending, s.kv_len, False
            gen[i], max_new[i] = s.gen, s.req.max_new_tokens
            temps[i] = s.req.temperature
            if s.req.eos_token_id is not None:
                eos[i] = s.req.eos_token_id
        seeds = None
        if any(t > 0.0 for t in temps):
            seeds = [[_token_seed(self.slots[i].req.seed,
                                  min(self.slots[i].gen + t,
                                      self.slots[i].req.max_new_tokens - 1))
                      if i in live_idx and temps[i] > 0.0 else None
                      for i in range(B)] for t in range(C)]
        live = set(live_idx)
        bt = self.cache.block_tables(
            [self.slots[i].req.rid if i in live else None
             for i in range(B)])
        t0 = time.perf_counter()
        emitted = self._decode_plane(
            C, *self._upload(bt, tokens, kv_len, done, gen, max_new, eos),
            temps, seeds)
        emitted = emitted.cpu().numpy()                      # [C, B]
        self.stats.decode_s += time.perf_counter() - t0
        new_tokens = 0
        for i in live_idx:
            s = self.slots[i]
            toks = emitted[:, i]
            toks = toks[toks >= 0].tolist()
            if toks:
                s.tokens.extend(toks)
                new_tokens += len(toks)
                self.cache.alloc.advance(s.req.rid, len(toks))
                s.kv_len += len(toks)
                s.gen += len(toks)
                s.pending = toks[-1]
            s.done = s.gen >= s.req.max_new_tokens or (
                s.req.eos_token_id is not None and bool(toks)
                and toks[-1] == s.req.eos_token_id)
        self.stats.decode_steps += C
        self.stats.tokens_generated += new_tokens
        self.stats.tokens_decoded += new_tokens
        self.stats._occ_steps += C * self.num_slots
        return True

    def _draft_for(self, s: _Slot, C: int) -> np.ndarray:
        """A C-token verify window for one sequence: position 0 is the
        pending token (its KV is the one unwritten commit), positions
        1..C-1 come from a bigram table over the request's own context
        (prompt + emitted tokens), repeat-last on a miss. Host work only:
        the table lives on the slot and folds in only the tokens appended
        since the last draft."""
        if s.ng is None:
            s.ng = {}
        prompt = s.req.prompt
        plen = int(prompt.shape[0])
        total = plen + len(s.tokens)

        def at(p):
            return int(prompt[p]) if p < plen else int(s.tokens[p - plen])

        for p in range(max(s.ng_n, 2), total):
            s.ng[(at(p - 2), at(p - 1))] = at(p)
        s.ng_n = total
        out = np.empty(C, np.int64)
        out[0] = s.pending
        p2, p1 = at(total - 2), at(total - 1)
        for t in range(1, C):
            nxt = s.ng.get((p2, p1), p1)
            out[t] = nxt
            p2, p1 = p1, nxt
        return out

    def _spec_plane(self, bt, drafts, kv_len, live):
        """The device work of one verify round on uploaded inputs: the
        drafted windows through ``paged_verify_window`` (their KV written
        into the pool) and each position's greedy prediction ``[B, C]``,
        on the device. Reads nothing back."""
        logits = paged_verify_window(
            self.family, self.params, drafts, self.config,
            self.cache.pool["k"], self.cache.pool["v"], bt, kv_len, live)
        return logits.argmax(dim=-1)

    def _spec_step(self, live_idx: List[int], C: int) -> bool:
        """One speculative verify round over the greedy turbo chunk: write
        all C drafted positions' KV, attend over the window in one pass,
        and accept the longest run where the model's greedy prediction
        confirms the next draft. The tokens are the sequential path's by
        construction: draft 0 is the real pending token, so prediction 0
        is the sequential next token; each further draft is kept only
        when it equals the prediction before it, and the first token
        after a rejection is again the model's own prediction. (The
        window is another program than the decode steps, so in reduced
        precision an argmax near-tie can flip; float32 is exact.)
        Rejected positions' KV stays in the pool past each sequence's
        length, masked out and overwritten by later commits."""
        B = self.num_slots
        live = set(live_idx)
        bt = self.cache.block_tables(
            [self.slots[i].req.rid if i in live else None
             for i in range(B)])
        drafts = np.zeros((B, C), np.int64)
        kv_len = np.zeros(B, np.int64)
        live_m = np.zeros(B, bool)
        for i in live_idx:
            s = self.slots[i]
            drafts[i] = self._draft_for(s, C)
            kv_len[i] = s.kv_len
            live_m[i] = True
        t0 = time.perf_counter()
        preds = self._spec_plane(
            *self._upload(bt, drafts, kv_len, live_m)).cpu().numpy()
        self.stats.decode_s += time.perf_counter() - t0
        new_tokens = accepted = 0
        for i in live_idx:
            s = self.slots[i]
            dr, col = drafts[i], preds[i]
            a = 0
            while a < C - 1 and dr[a + 1] == col[a]:
                a += 1
            emitted = [int(t) for t in col[:a + 1]]
            s.tokens.extend(emitted)
            new_tokens += len(emitted)
            accepted += a
            self.cache.alloc.advance(s.req.rid, len(emitted))
            s.kv_len += len(emitted)
            s.gen += len(emitted)
            s.pending = emitted[-1]
            # the turbo preconditions rule out EOS: only the length bound
            # can finish a sequence here
            s.done = s.gen >= s.req.max_new_tokens
        self.stats.decode_steps += C
        self.stats.tokens_generated += new_tokens
        self.stats.tokens_decoded += new_tokens
        self.stats._occ_steps += C * self.num_slots
        self.stats.spec_rounds += len(live_idx)
        self.stats.spec_drafted += (C - 1) * len(live_idx)
        self.stats.spec_accepted += accepted
        return True

    def run(self, requests=None, max_steps: int = 1_000_000
            ) -> Dict[int, RequestOutput]:
        """Drive the scheduler until every submitted request completes;
        returns {rid: RequestOutput}."""
        if requests:
            for r in requests:
                self.submit(r)
        steps = 0
        while self.step():
            steps += 1
            E.enforce(steps < max_steps,
                      f"engine did not drain within {max_steps} steps")
        return self.outputs
