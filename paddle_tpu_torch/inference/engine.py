"""Continuous-batching serving engine over a paged KV cache (port of
``paddle_tpu/inference/engine.py``).

With every ``FLAGS_serving_*`` option at its default (off) the scheduler
is the reference's core: FIFO admission with a page watermark,
same-bucket grouped prefill padded to a power-of-two page count and
group size, chunked decode over a fixed slot grid, recompute preemption
of the youngest request when the page pool runs out, and slot
compaction. ``kv_dtype`` (default: the model's dtype) is the type of
the KV pages: float32, bfloat16 or float16 under a float32 or bfloat16
model, decoded by the paged kernel's pair for that (q, page) type.
``kv_quant`` (default: ``FLAGS_serving_kv_quant``) stores int8 KV pages
with one float32 scale per (page, kv head) instead. The model is a family
module, ``models.llama`` or ``models.moe``; ``params`` may also be a
weight-only-quantized tree of it (``quantize_weights``).

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
- ``max_queue``: a bounded queue. A submission to a full queue displaces
  the lowest strictly-lower-priority queued request (never a preemption
  re-queue), which leaves through ``outputs`` as ``shed``; when nothing
  can be displaced the newcomer is shed with :class:`EngineOverloaded`.
  Every shed carries ``retry_after_s`` from the autoscale demand model
  (``monitor.slo``) over this engine's state (``autoscale_payload``).
- ``failover``: ``attach_journal`` opts the engine into the exactly-once
  admission journal (``inference/failover.py``): each admitted request is
  journaled after every gate, its sampling seed pinned first, and each
  terminal event (completed, shed, expired) writes a completion marker.
- ``shed_on_burn``: with the monitor on, a submission of priority <= 0
  is shed while a latency objective of the SLO plane burns its error
  budget at or over the warn rate (``monitor.slo.burn_alerting(
  load_only=True)``). With the monitor off it never sheds.

Without an option: ``Request.deadline_s`` is a TTL from submission; once
it is spent the request expires from the queue with no tokens or is
evicted from its slot with the tokens it had (``finish_reason=
"expired"``; a slot already done retires as completed). The expiry scan
runs first in ``step`` and only once some request carried a deadline.
``begin_drain`` stops admission (``submit`` sheds), sheds the queue
except preemption re-queues, and lets live slots run to retirement;
``drain_complete`` then holds. Every submitted request ends in exactly one
of completed / expired / shed, or is refused at ``submit``.

Monitor planes (``FLAGS_enable_monitor``, default off; ``monitor/``): the
reference's counters (``serving.requests.*``, ``serving.tokens.*``,
``serving.prefix_cache.*``, ``serving.spec.*``), gauges
(``serving.pages.in_use|total``, ``serving.queue.depth``,
``serving.batch.occupancy``) and latency histograms
(``serving.latency.{queue_wait,ttft,tpot,e2e}_ms``, each observed once a
request: ``ttft_ms`` and ``e2e_ms`` from the first submission, at
retirement, so a preempted run's discarded first token never counts);
the trace ring's lifecycle instants and spans; the forensics timelines
and decision records (``_defer`` at each deferral of the admission
scan); the SLO records and the autoscale tick; the program registry with
1-in-N exec timing; and the KV-page absmax sampler. Each request carries
a :class:`RequestCost` (``RequestOutput.cost``): tokens, the cumulative
queue wait, page-seconds and slot steps integrated at chunk edges, and
its share of each program's FLOPs (``serving_program_flops``, counted
from the program's shapes). All of it is host bookkeeping after the
download each group, chunk or round already makes, so the monitor adds
no synchronization, and with it off each seam is one cached-flag branch:
tokens and scheduling are the same either way.

Token accounting contract (the reference's): ``serving.tokens.generated``
counts every sampled token (prefill's first token and decode emissions,
work later thrown away included); ``serving.tokens.discarded`` counts the
tokens a preemption discarded. On a drained engine ``generated -
discarded == sum(len(output.tokens))`` exactly.

The operator and fleet planes: ``FLAGS_enable_monitor_server`` makes the
constructor start the operator HTTP server (``monitor/server.py``
``maybe_start``), whose ``/profile`` window annotates the prefill group,
decode chunk and verify round (``monitor/profile_capture.py``);
``publish_frames`` attaches a telemetry frame publisher
(``monitor/federation.py``) that publishes on every scheduler step and
on the drain transition, reading host state only;
``FLAGS_serving_fleet_burn_scaling`` is the elastic controller's option
(``distributed/fleet/elastic.py``), which reads those frames. SLO
preemption measures a victim's work by its cost
record's prefill and decode tokens with the monitor on, else by its KV
length, as the reference does.

Where the reference jits one program per chunk, ``_decode_chunk`` is a
Python loop over ``chunk`` decode steps; the pool is updated in place.
The host waits for the card twice per prefill group, decode chunk or
verify round, and nowhere else: once to upload its inputs (``_upload``,
one copy) and once to read its tokens back. Between the two, the data
plane (``_prefill_plane``, ``_decode_plane``, ``_spec_plane``) selects no
rows on the host (writes the reference drops land in the pool's sink
page) and draws sampled tokens on the device, so the host issues a
chunk's steps while the card works through the earlier ones. With the
monitor on, a KV-page sample (1 chunk in ``PADDLE_TPU_KV_SAMPLE``) reads
its reductions back once more, after the chunk's tokens: the card has
no chunk work left then.
"""
from __future__ import annotations

import dataclasses
import math
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import monitor as _monitor
from ..core import enforce as E
from ..core import flags as _flags
from ..core import resolve_device
from ..kernels import autotune as _autotune
from ..monitor import forensics as _forensics
from ..monitor import profile_capture as _pcap
from ..monitor import programs as _programs
from ..monitor import server as _mserver
from ..monitor import slo as _slo
from ..monitor import trace as _trace
from ..monitor.registry import LATENCY_BUCKETS_MS as _LATENCY_BUCKETS_MS
from .paged import (PagedKVCache, PrefixCache, paged_decode_step,
                    paged_prefill, paged_prefill_shared, paged_verify_window)

__all__ = ["EngineOverloaded", "Request", "RequestCost", "RequestOutput",
           "RequestRejected", "EngineStats", "ServingEngine",
           "serving_program_flops", "serving_program_bytes"]


def _engine_health_provider(ref):
    """Health contributor over a weakly-held engine: queue depth, slot
    occupancy, page-pool pressure. Returns None once the engine is
    garbage-collected (the map prunes the entry). Always ``ok`` — a deep
    queue is backpressure, not a liveness failure."""
    def provide():
        eng = ref()
        if eng is None:
            return None
        return {
            "ok": True,
            "queue_depth": len(eng.queue),
            "slots_live": sum(1 for s in eng.slots if s is not None),
            "num_slots": eng.num_slots,
            "pages_free": eng.cache.alloc.free_pages,
            "pages_total": eng.cache.num_pages,
            "requests_completed": eng.stats.completed,
        }
    return provide


def _observe_latency(name: str, ms: float, doc: str):
    _monitor.observe(name, ms, doc=doc, buckets=_LATENCY_BUCKETS_MS)


def serving_program_flops(config, *, tokens: int, key_len: int,
                          head_rows: int, steps: int = 1) -> float:
    """FLOPs of one call of a serving program, from its shapes: ``steps``
    passes (the steps of a decode chunk; 1 otherwise), each taking
    ``tokens`` query rows through every layer and ``head_rows`` rows
    through the head. A layer counts its matmuls (the q / k / v / o
    projections and the MLP: SwiGLU, or the router, the experts as the
    family's dispatch runs them and the shared expert) and its attention,
    a score and a value product over ``key_len`` keys a query row: every
    key position of the program's shapes, masked ones included, as the
    plain versions compute it. The kernels skip work the mask rules out
    (the flash forward's tiles above the diagonal, the decode kernel's
    positions past each length), so on the card this term bounds their
    work. Normalisation, rope and sampling are not counted."""
    c = config
    D, L = c.hidden_size, c.num_hidden_layers
    nh, nkv, hd = (c.num_attention_heads, c.num_key_value_heads,
                   c.head_dim)
    T = int(tokens)
    proj = 2 * T * D * (2 * nh * hd + 2 * nkv * hd)
    attn = 4 * T * nh * hd * int(key_len)
    if hasattr(c, "num_experts"):
        E_, Fe = c.num_experts, c.intermediate_size
        mlp = 2 * T * D * E_ + 6 * T * D * c.shared_intermediate_size
        if (c.dispatch_mode or "capacity") == "dense":
            mlp += 6 * E_ * T * D * Fe + 2 * E_ * T * D
        else:
            from ..models.moe import moe_capacity
            mlp += 6 * E_ * moe_capacity(c, T) * D * Fe
    else:
        mlp = 6 * T * D * c.intermediate_size
    head = 2 * int(head_rows) * D * c.vocab_size
    return float(int(steps) * (L * (proj + attn + mlp) + head))


def serving_program_bytes(config, *, tokens: int, key_len: int,
                          head_rows: int, seqs: int, steps: int = 1,
                          weight_bytes: float, kv_bytes_per_pos: float,
                          act_bytes: int) -> float:
    """HBM bytes of one call of a serving program, from its shapes, for
    the roofline plane (``monitor/roofline.py``): ``steps`` passes, each
    reading ``weight_bytes`` (every layer's weights and the head; of the
    embedding table only the rows gathered), reading the KV of
    ``key_len`` positions for each of the ``seqs`` sequences and writing
    that of the ``tokens`` new positions in every layer
    (``kv_bytes_per_pos``: keys and values of one position across the kv
    heads, int8 scales included), reading and writing the ``tokens``
    residual rows of every layer in ``act_bytes`` a value, and writing
    ``head_rows`` float32 logits. The key positions are those
    ``serving_program_flops`` counts, so the two describe one amount of
    work."""
    c = config
    D, L = c.hidden_size, c.num_hidden_layers
    T = int(tokens)
    kv = L * (int(seqs) * int(key_len) + T) * kv_bytes_per_pos
    act = (2 * L + 1) * T * D * act_bytes
    logits = 4 * int(head_rows) * c.vocab_size
    return float(int(steps) * (weight_bytes + kv + act + logits))


def _tree_bytes(tree) -> int:
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


class RequestRejected(E.InvalidArgumentError):
    """A malformed submission, refused by ``submit`` before it touches
    the queue, the page pool or any device state."""

    def __init__(self, rid, reason: str):
        self.rid = rid
        self.reason = reason
        super().__init__(f"request {rid!r} rejected: {reason}")


class EngineOverloaded(RequestRejected):
    """A well-formed submission refused by overload policy: the bounded
    queue is full (``max_queue``) with nothing to displace, or the engine
    is draining. ``retry_after_s`` is the demand model's backoff hint
    over this engine's state."""

    def __init__(self, rid, reason: str, retry_after_s: float):
        self.retry_after_s = retry_after_s
        super().__init__(rid, reason)


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
    #                                      order, displacement, preemption
    #                                      protection)
    deadline_s: Optional[float] = None   # TTL from submit: the request
    #                                      expires in the queue or is
    #                                      evicted from its slot once it
    #                                      is spent (default off)
    prompt_spec: Optional[dict] = None   # failover journal only: a
    #                                      derivation spec (trace seed,
    #                                      rid, lengths) journaled
    #                                      instead of inline tokens


@dataclasses.dataclass
class RequestCost:
    """Per-request resource attribution (the reference's record),
    accumulated at the engine's existing host-sync seams with the monitor
    on. Cumulative across preemption re-queues: the record follows the
    request, not one run of it."""

    tenant: str = "default"
    priority: int = 0
    prefill_tokens: int = 0      # prompt tokens prefilled (re-prefills
    #                              after preemption included; tokens a
    #                              cached prefix skipped are not here)
    prefix_cached_tokens: int = 0    # prompt tokens served from the
    #                              radix prefix cache instead of prefill
    prefill_flops_saved: float = 0.0  # modeled FLOPs the cached prefix
    #                              skipped (the tail program's per-padded-
    #                              token rate x cached tokens)
    decode_tokens: int = 0       # decode emissions (work done, incl.
    #                              tokens a preemption later discarded)
    discarded_tokens: int = 0    # thrown away by preemption recompute
    queue_wait_ms: float = 0.0   # sum of every enqueue->admission wait
    page_seconds: float = 0.0    # KV pages held x wall (chunk edges)
    slot_steps: int = 0          # decode-grid steps a slot was held
    grid_steps: int = 0          # grid capacity (steps x slots) that
    #                              elapsed during the residencies
    slot_share: Optional[float] = None   # slot_steps / grid_steps
    model_flops: float = 0.0     # program FLOPs, split across the
    #                              dispatch's live slots / group rows
    preemptions: int = 0
    ttft_ms: Optional[float] = None
    tpot_ms: Optional[float] = None
    e2e_ms: Optional[float] = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RequestOutput:
    rid: int
    tokens: np.ndarray                   # generated ids (<= max_new_tokens)
    prompt_len: int
    preemptions: int = 0                 # times this request was evicted
    ttft_s: Optional[float] = None       # first submit to the first token
    #                                      the client keeps (host clock;
    #                                      None without tokens)
    tenant: str = "default"
    cost: Optional[RequestCost] = None   # monitor on: the attribution
    #                                      record; monitor off: None
    finish_reason: str = "completed"     # completed | expired | shed
    retry_after_s: Optional[float] = None  # shed only: the backoff hint
    shed_reason: Optional[str] = None    # shed only: displacement or drain


class _Slot:
    __slots__ = ("req", "kv_len", "gen", "tokens", "pending", "done",
                 "preemptions", "t_first", "t_last", "cost", "t_tick",
                 "steps0", "ng", "ng_n")

    def __init__(self, req: Request):
        self.req = req
        self.kv_len = 0          # KV positions written (prompt + decoded)
        self.gen = 0             # tokens sampled so far
        self.tokens: List[int] = []
        self.pending = 0         # last sampled token (KV not yet written)
        self.done = False
        self.preemptions = 0
        self.t_first = None      # host time the first token reached the host
        self.t_last = None       # latest-token stamp (monitor on)
        self.cost = None         # the request's RequestCost (monitor on)
        self.t_tick = None       # last page-seconds integration stamp
        self.steps0 = 0          # engine decode_steps at admission
        self.ng = None           # spec decode: bigram draft table over
        #                          this request's own context (lazy)
        self.ng_n = 0            # context tokens folded into ng so far


class EngineStats:
    def __init__(self):
        self.admitted = 0
        self.completed = 0
        self.preempted = 0
        self.expired = 0             # ended by their deadline
        self.shed = 0                # refused or ended by overload policy
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
        """The counters under the reference's keys, in its order."""
        return {"admitted": self.admitted, "completed": self.completed,
                "preempted": self.preempted,
                "expired": self.expired, "shed": self.shed,
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

    ``kv_dtype`` (a torch dtype; default: ``config.dtype``) is the KV
    pages' type: float32, bfloat16 or float16. ``kv_quant`` (default:
    ``FLAGS_serving_kv_quant``) stores the KV pages as int8 codes with
    per-(page, kv head) float32 scales instead (about half the bytes of
    bfloat16 pages), and decodes through the int8 arm of the paged
    kernel. ``page_size=None`` resolves through the autotune cache
    (``kernels.autotune.paged_page_size`` at this engine's slots, heads,
    ``max_len`` and page type: measured on the card, else the nearest
    tuned neighbour or the default, 32 with ``kv_quant``, else 16).

    ``prefix_cache``, ``spec_decode``, ``priority_admission``,
    ``tenant_inflight_cap`` (a negative cap is 0, uncapped),
    ``slo_preemption``, ``max_queue`` (a negative depth is 0, unbounded),
    ``shed_on_burn`` and ``failover`` each default to their
    ``FLAGS_serving_*`` flag; the module docstring says what each does.
    All off, the default, is the engine above, tokens and scheduling
    alike. Deadlines (``Request.deadline_s``) and the drain lifecycle
    (``begin_drain``) need no option. With ``FLAGS_enable_monitor_server``
    on, the constructor starts the operator HTTP server on
    ``FLAGS_monitor_server_port``."""

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
                 slo_preemption: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 shed_on_burn: Optional[bool] = None,
                 failover: Optional[bool] = None, kv_dtype=None,
                 device=None):
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
        self._max_queue = max(0, int(_opt(max_queue, "serving_max_queue")))
        self._shed_on_burn = bool(_opt(shed_on_burn, "serving_shed_on_burn"))
        # the flag only offers durability: journaling starts when the
        # caller names the replica through attach_journal
        self._failover = bool(_opt(failover, "serving_failover"))
        self._journal = None
        # the fleet telemetry frame publisher (publish_frames opts in)
        self._frame_pub = None
        self._draining = False
        self._deadlines_seen = False     # sticky: the first request with a
        #                                  deadline arms step's expiry scan
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
        self.kv_dtype = config.dtype if kv_dtype is None else kv_dtype
        E.enforce(self.kv_dtype in (torch.float32, torch.bfloat16,
                                    torch.float16),
                  f"kv_dtype {self.kv_dtype} is not a page type the decode "
                  f"kernel takes (float32, bfloat16, float16)",
                  error=E.InvalidArgumentError)
        if page_size is None:
            page_size = _autotune.paged_page_size(
                self.num_slots, config.num_attention_heads,
                config.num_key_value_heads, config.head_dim,
                -(-max_len // 16) * 16, self.kv_dtype,
                kv_quant=self.kv_quant, device=self.device)
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
                                  self.max_pages_per_seq, self.kv_dtype,
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
        # KV-page absmax sampling (monitor/numerics.py): 1-in-N decode
        # chunks reduce the pool after the chunk's download
        self._kv_chunks = 0
        # program FLOPs, cached per registry key: the cost plane reads
        # it once per chunk, not once per slot
        self._flops_by_key: dict = {}
        self._weight_bytes = None     # serving_program_bytes: weights
        _monitor.set_gauge("serving.pages.total", self.cache.num_pages,
                           doc="KV page pool capacity")
        # the operator HTTP server, when FLAGS_enable_monitor_server is
        # on (one cached-flag branch otherwise)
        _mserver.maybe_start()
        # process-unique uid: keys the health provider ("serving:<n>")
        # and the program records, which outlive the engine. The
        # provider holds the engine weakly and registers only while
        # some plane could read it: a fully-off process grows nothing.
        self._engine_uid = _programs.next_uid()
        if _monitor.enabled() or _mserver.plane_active():
            _mserver.register_health_provider(
                f"serving:{self._engine_uid}",
                _engine_health_provider(weakref.ref(self)))
        # the sharding inspector's view of the parameter tree for
        # /sharding (monitor-gated: off, nothing is computed)
        from ..distributed import introspect as _introspect
        _introspect.register_sharded_tree(
            f"serving:{self._engine_uid}.params", self.params)

    def _record_serving_program(self, spec_key, name, shape, args):
        """Register a serving program with the program registry
        (``monitor/programs.py``) at the first dispatch of its key, with
        its signature and the FLOPs and bytes its ``shape`` gives
        (``serving_program_flops`` / ``serving_program_bytes``); later
        dispatches count hits. The registry itself is the
        dedup: after a ``monitor.reset()`` mid-run the next dispatch
        registers again. Monitor on only. The parameter tree's sharding
        summary rides the same seam (``ensure_sharded_tree``), so
        ``/sharding`` fills again after a reset too."""
        from ..distributed import introspect as _introspect
        _introspect.ensure_sharded_tree(
            f"serving:{self._engine_uid}.params", lambda: self.params)
        key = ("engine", self._engine_uid) + spec_key
        if _programs.has_record(key):
            _programs.note_hit(key)
            return key
        shape = dict(shape)
        seqs = shape.pop("seqs")
        _programs.record_call(
            key, name, serving_program_flops(self.config, **shape), args,
            source="serving",
            bytes_accessed=self._program_bytes(shape, seqs))
        return key

    def _program_bytes(self, shape, seqs: int) -> float:
        """``serving_program_bytes`` of a program's ``shape`` (the
        keyword arguments of ``serving_program_flops``) over ``seqs``
        sequences, this engine's weights and its pages."""
        c = self.config
        params = self.params
        if self._weight_bytes is None:
            w = _tree_bytes({k: v for k, v in params.items()
                             if k != "embed"})
            if "lm_head" not in params:
                w += _tree_bytes(params["embed"])    # the tied head
            self._weight_bytes = w
        row = _tree_bytes(params["embed"]) / c.vocab_size
        nkv, hd = c.num_key_value_heads, c.head_dim
        if self.kv_quant:
            per_pos = 2 * nkv * (hd + 4.0 / self.page_size)
        else:
            per_pos = 2 * nkv * hd * self.kv_dtype.itemsize
        return serving_program_bytes(
            c, weight_bytes=self._weight_bytes + shape["tokens"] * row,
            kv_bytes_per_pos=per_pos, act_bytes=c.dtype.itemsize, seqs=seqs,
            **shape)

    def _program_flops(self, key):
        """Cached ``monitor/programs.flops_of`` read (None when unknown).
        An unknown key is not cached as None: after a ``monitor.reset()``
        the next dispatch registers again and the lookup recovers."""
        v = self._flops_by_key.get(key)
        if v is None:
            v = _programs.flops_of(key)
            if v is not None:
                self._flops_by_key[key] = v
        return v

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
        deadline = req.deadline_s
        if deadline is not None:
            try:
                deadline = float(deadline)
            except (TypeError, ValueError, OverflowError):
                return bad(f"deadline_s {req.deadline_s!r} is not a "
                           "float")
            if not math.isfinite(deadline) or deadline <= 0.0:
                return bad("deadline_s must be finite and > 0, got "
                           f"{deadline}")
        return None, (prompt.astype(np.int64), max_new, temp, tenant,
                      priority, deadline)

    def submit(self, req: Request):
        """Queue a request, or raise :class:`RequestRejected` when it is
        malformed (engine state untouched either way until admission).
        A well-formed submission may be shed instead, with
        :class:`EngineOverloaded`: the engine is draining, or the bounded
        queue (``max_queue``) is full and holds no strictly
        lower-priority request to displace, or (``shed_on_burn``, monitor
        on) a priority <= 0 submission arrives while a latency objective
        burns; a displaced request ends in ``outputs`` as ``shed``."""
        reason, norm = self._reject_reason(req)
        if reason is not None:
            _monitor.inc("serving.requests.rejected",
                         doc="malformed submissions refused at the "
                             "door (engine state untouched)")
            _trace.instant("serving.reject", rid=req.rid, reason=reason)
            if _monitor.enabled():
                # availability counts the refusal, attributed to the
                # tenant the submission claimed (the rejection may be
                # about that very field)
                try:
                    tenant = str(req.tenant or "default")[:128]
                except Exception:
                    tenant = "default"
                _slo.record_rejected(tenant or "default")
                _forensics.note_terminal(req.rid, "rejected",
                                         reason=reason,
                                         tenant=tenant or "default")
            raise RequestRejected(req.rid, reason)
        (req.prompt, req.max_new_tokens, req.temperature, req.tenant,
         req.priority, req.deadline_s) = norm
        # overload gates, in severity order, all before the request
        # touches any engine state: a draining engine refuses everything,
        # a latency burn sheds best-effort work, a full queue sheds (or
        # displaces a lower priority)
        if self._draining:
            self._shed_submit(req, "engine is draining")
        if (self._shed_on_burn and req.priority <= 0
                and _monitor.enabled()
                and _slo.burn_alerting(load_only=True)):
            # load_only: the sheds this gate makes are availability-bad
            # records, and an availability-fed trigger would keep itself
            # alight after the overload cleared
            self._shed_submit(req, "SLO fast-burn alerting; "
                                   "priority<=0 work shed")
        if self._max_queue and len(self.queue) >= self._max_queue:
            victim = self._displaceable_pos(req.priority)
            if victim is None:
                self._shed_submit(
                    req, f"queue full ({self._max_queue}) and no "
                         f"lower-priority request to displace")
            shed = self.queue[victim]
            del self.queue[victim]
            _forensics.decision(
                "displace", rid=shed.rid, reason="queue_full",
                queue_depth=len(self.queue) + 1, max_queue=self._max_queue,
                by_rid=req.rid, by_priority=req.priority,
                victim_priority=shed.priority)
            self._finish_shed(shed, "displaced by higher-priority request "
                                    f"{req.rid!r}")
        if req.temperature > 0.0 and req.seed is None:
            self._rng_fallback += 1
            req.seed = self._rng_fallback
        # per-run state, set anew on every submission: an object submitted
        # again starts a new run (the seed pinned on its first submission
        # is kept, so it draws the same tokens again)
        req._t_submit = time.perf_counter()
        req._preempt_count = 0
        req._pfx_cached = 0          # cached prefix length of its admission
        req._t_deadline = None
        req._t0 = req._t_enqueue = req._cost = None
        if req.deadline_s is not None:
            req._t_deadline = req._t_submit + req.deadline_s
            self._deadlines_seen = True
        if _monitor.enabled():
            # _t0 anchors TTFT and e2e; _t_enqueue is refreshed by
            # preemption re-queues and anchors each queue wait; the cost
            # record follows the request across those re-queues
            plen = int(req.prompt.shape[0])
            req._t0 = req._t_enqueue = now = time.perf_counter()
            req._cost = RequestCost(tenant=req.tenant,
                                    priority=req.priority)
            _trace.instant("serving.enqueue", rid=req.rid, prompt=plen,
                           max_new=req.max_new_tokens, tenant=req.tenant)
            _forensics.note(req.rid, "enqueue", t=now, tenant=req.tenant,
                            priority=req.priority, prompt=plen,
                            max_new=req.max_new_tokens)
        if self._journal is not None:
            # after every gate that could still refuse the request, and
            # after the seed is pinned: a re-dispatch replays its tokens
            self._journal.admit(req)
        self.queue.append(req)

    # -- overload policy: shedding, deadlines, drain ------------------------

    def autoscale_payload(self) -> dict:
        """The autoscale demand model (``monitor.slo.demand_model``) over
        this engine's state. Resident slots count as live, done but
        unretired ones too (their output appears at the next ``step``),
        so ``drain_safe`` here is :attr:`drain_complete`."""
        resident = sum(1 for s in self.slots if s is not None)
        return _slo.demand_model(
            len(self.queue), resident, self.num_slots,
            self.cache.alloc.free_pages / self.cache.num_pages
            if self.cache.num_pages else 0.0)

    def _retry_after(self) -> float:
        return _slo.retry_after_hint(self.autoscale_payload())

    def attach_journal(self, name: str, dir_path: Optional[str] = None,
                       *, client=None):
        """Opt this engine into the exactly-once admission journal
        (``inference/failover.py``) under the replica name ``name``, on
        the heartbeat transport's directory ``dir_path`` and key-value
        ``client``. Needs ``failover=True`` (or ``FLAGS_serving_failover``):
        without it returns None and journals nothing. Returns the journal
        (one per engine; attaching again replaces it)."""
        if not self._failover:
            return None
        from .failover import AdmissionJournal
        self._journal = AdmissionJournal(name, dir_path=dir_path,
                                         client=client)
        return self._journal

    def _shed_submit(self, req: Request, why: str):
        """Refuse a well-formed submission by overload policy, before it
        touches any engine state: :class:`EngineOverloaded` with the
        demand model's backoff hint."""
        hint = self._retry_after()
        self.stats.shed += 1
        _monitor.inc("serving.requests.shed",
                     doc="admissible work refused by overload policy "
                         "(bounded queue, SLO burn, displacement, "
                         "drain) with a retry_after_s hint")
        _trace.instant("serving.shed", rid=req.rid, reason=why,
                       retry_after_s=hint, tenant=req.tenant)
        if _monitor.enabled():
            _slo.record_shed(req.tenant)
            _forensics.decision("shed", rid=req.rid, reason=why,
                                queue_depth=len(self.queue),
                                priority=req.priority,
                                draining=self._draining)
            _forensics.note_terminal(req.rid, "shed", reason=why,
                                     tenant=req.tenant,
                                     retry_after_s=round(hint, 3))
        raise EngineOverloaded(req.rid, why, hint)

    def _displaceable_pos(self, priority: int) -> Optional[int]:
        """Queue position of the displacement victim for an arriving
        ``priority`` request at a full queue: the lowest-priority queued
        request, oldest first, and only when strictly below the newcomer
        (equal priority is never displaced). Preemption re-queues are
        exempt: they are admitted work mid-recompute."""
        pos, lowest = None, None
        for j, r in enumerate(self.queue):
            if r._preempt_count > 0:
                continue
            if r.priority < priority and (lowest is None
                                          or r.priority < lowest):
                pos, lowest = j, r.priority
        return pos

    def _finish_shed(self, req: Request, why: str):
        """End a queued request as shed (displacement or drain): it leaves
        through ``outputs`` with ``finish_reason="shed"``, the backoff hint
        and the reason."""
        hint = self._retry_after()
        self.stats.shed += 1
        _monitor.inc("serving.requests.shed")
        mon = _monitor.enabled()
        cost = req._cost if mon else None
        if cost is not None:
            cost.queue_wait_ms += (time.perf_counter()
                                   - req._t_enqueue) * 1e3
            # the shed counts against availability like a rejection, and
            # what it consumed (prefill before a preemption, page-seconds,
            # the queue wait above) folds into its tenant's aggregates
            _slo.record_request(dict(cost.as_dict(), rejected=True,
                                     shed=True))
        elif mon:
            _slo.record_shed(req.tenant)
        self.outputs[req.rid] = RequestOutput(
            rid=req.rid, tokens=np.zeros(0, np.int32),
            prompt_len=int(req.prompt.shape[0]),
            preemptions=req._preempt_count, tenant=req.tenant, cost=cost,
            finish_reason="shed", retry_after_s=hint, shed_reason=why)
        if self._journal is not None:
            self._journal.finish(req.rid, "shed")
        _trace.instant("serving.shed", rid=req.rid, reason=why,
                       retry_after_s=hint, tenant=req.tenant)
        if mon:
            _forensics.decision("shed", rid=req.rid, reason=why,
                                queued=True, priority=req.priority,
                                draining=self._draining)
            _forensics.note_terminal(req.rid, "shed", reason=why,
                                     tenant=req.tenant,
                                     retry_after_s=round(hint, 3))

    def begin_drain(self, shed_queued: bool = True):
        """Enter the drain lifecycle: stop admitting (``submit`` sheds
        with :class:`EngineOverloaded`), shed the queued requests
        (``shed_queued=False`` lets them finish instead) but never a
        preemption re-queue, which is admitted work, and let live slots
        run to retirement; :attr:`drain_complete` holds once nothing is
        queued or resident. Idempotent."""
        from ..testing import faults as _faults
        _faults.hit("serving.drain")
        already = self._draining
        self._draining = True
        _trace.instant("serving.drain.begin", queued=len(self.queue),
                       again=already)
        if shed_queued:
            keep: deque = deque()
            while self.queue:
                r = self.queue.popleft()
                if r._preempt_count > 0:
                    keep.append(r)
                else:
                    self._finish_shed(r, "engine is draining")
            self.queue = keep
        if self._frame_pub is not None:
            # drain state must reach the federation controller now, not
            # a rate-limit later; only the TRANSITION forces: the
            # controller re-invokes begin_drain every retry tick of a
            # slow drain
            self._frame_pub.maybe_publish(self, force=not already)

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drain_complete(self) -> bool:
        """No queued and no resident requests (a done but unretired slot
        is resident: its output appears at the next ``step``)."""
        return not self.queue and all(s is None for s in self.slots)

    def _expire_due(self):
        """Deadline enforcement, once a ``step``: a queued request whose
        deadline is spent leaves with no tokens, a running one is evicted
        with the tokens it had (pages freed, nothing inserted into the
        prefix cache). A done slot past its deadline retires as
        completed: its output is whole."""
        now = time.perf_counter()
        if any(r._t_deadline is not None and now >= r._t_deadline
               for r in self.queue):
            keep: deque = deque()
            for r in self.queue:
                if r._t_deadline is not None and now >= r._t_deadline:
                    self._finish_expired(r, None, now)
                else:
                    keep.append(r)
            self.queue = keep
        for idx in range(self.num_slots):
            slot = self.slots[idx]
            if slot is None or slot.done:
                continue
            t = slot.req._t_deadline
            if t is not None and now >= t:
                self._finish_expired(slot.req, idx, now)

    def _finish_expired(self, req: Request, slot_idx: Optional[int],
                        now: float):
        """End ``req`` as expired at ``now``: from the queue (no tokens)
        or evicted from slot ``slot_idx`` with its tokens, which are the
        client's, so ``tokens_generated - tokens_discarded`` stays the
        tokens emitted."""
        mon = _monitor.enabled()
        cost = req._cost if mon else None
        tokens = np.zeros(0, np.int32)
        preemptions = req._preempt_count
        ttft = None
        if slot_idx is not None:
            slot = self.slots[slot_idx]
            self.slots[slot_idx] = None
            if cost is not None and slot.t_tick is not None:
                # final page-seconds tick, read before the free
                cost.page_seconds += (self.cache.alloc.page_count(req.rid)
                                      * (now - slot.t_tick))
            self.cache.alloc.free(req.rid)
            tokens = np.asarray(slot.tokens, np.int32)
            preemptions = slot.preemptions
            ttft = slot.t_first - req._t_submit
            if cost is not None:
                cost.grid_steps += (self.stats.decode_steps
                                    - slot.steps0) * self.num_slots
        elif cost is not None:
            cost.queue_wait_ms += (now - req._t_enqueue) * 1e3
        self.stats.expired += 1
        _monitor.inc("serving.requests.expired",
                     doc="requests retired by their submit-time "
                         "deadline (expired in queue or evicted from "
                         "the running batch)")
        if cost is not None:
            cost.preemptions = preemptions
            cost.e2e_ms = (now - req._t0) * 1e3
            if cost.grid_steps > 0:
                cost.slot_share = round(
                    cost.slot_steps / cost.grid_steps, 6)
            # the SLO window counts an expiry bad for availability and
            # leaves it out of the latency objectives
            _slo.record_request(dict(cost.as_dict(), expired=True))
        self.outputs[req.rid] = RequestOutput(
            rid=req.rid, tokens=tokens, prompt_len=int(req.prompt.shape[0]),
            preemptions=preemptions, ttft_s=ttft, tenant=req.tenant,
            cost=cost, finish_reason="expired")
        if self._journal is not None:
            self._journal.finish(req.rid, "expired",
                                 tokens=int(tokens.shape[0]))
        _trace.instant("serving.expire", rid=req.rid,
                       tokens=int(tokens.shape[0]),
                       in_slot=slot_idx is not None, tenant=req.tenant)
        if mon:
            if slot_idx is not None:
                _forensics.decision("evict", rid=req.rid,
                                    reason="deadline", slot=slot_idx,
                                    tokens=int(tokens.shape[0]))
            _forensics.note_terminal(
                req.rid, "expired", t=now,
                e2e_ms=(cost.e2e_ms if cost is not None
                        and cost.e2e_ms else None),
                tenant=req.tenant, tokens=int(tokens.shape[0]),
                in_slot=slot_idx is not None)

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
        dropped = self._prefix.evicted_nodes - before
        if dropped:
            self.stats.prefix_evictions += dropped
            _monitor.inc("serving.prefix_cache.evictions", dropped,
                         doc="radix nodes dropped under pool pressure")
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
        _monitor.inc("serving.prefix_cache.lookups",
                     doc="admission prompt-prefix radix probes")
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
                _monitor.inc("serving.prefix_cache.hits",
                             doc="admissions that forked cached "
                                 "prefix pages")
                _monitor.inc("serving.prefix_cache.tokens_saved", cached,
                             doc="prompt tokens served from cached KV "
                                 "instead of prefill")
            return got

    def _retire(self, idx: int):
        slot = self.slots[idx]
        self.slots[idx] = None
        mon = _monitor.enabled()
        cost = slot.cost if mon else None
        if cost is not None and slot.t_tick is not None:
            # final page-seconds tick: pages held from the last chunk
            # edge until this retirement, read before the free below
            now_t = time.perf_counter()
            cost.page_seconds += (self.cache.alloc.page_count(slot.req.rid)
                                  * (now_t - slot.t_tick))
            slot.t_tick = now_t
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
            tenant=slot.req.tenant, cost=cost)
        if self._journal is not None:
            # the completion marker lands before the output can be
            # harvested: a crash after it re-dispatches nothing for
            # this rid
            self._journal.finish(slot.req.rid, "completed",
                                 tokens=len(slot.tokens))
        self.stats.completed += 1
        _monitor.inc("serving.requests.completed")
        if mon:
            self._retire_monitor(slot, cost)

    def _retire_monitor(self, slot: _Slot, cost: Optional[RequestCost]):
        """The monitor's half of a retirement: the latency histograms,
        each observed once a completed request (``ttft_ms`` from the
        first submission to the first token of the run the client keeps,
        so a preempted run's discarded token never counts), the cost
        record's final fields and its SLO record, the retire instant and
        the forensics terminal."""
        req = slot.req
        now = time.perf_counter()
        if req._t0 is not None:
            e2e = (now - req._t0) * 1e3
            _observe_latency("serving.latency.e2e_ms", e2e,
                             "request lifetime: original enqueue to "
                             "retirement")
            if cost is not None:
                cost.e2e_ms = e2e
            if slot.t_first is not None:
                ttft = (slot.t_first - req._t0) * 1e3
                _observe_latency("serving.latency.ttft_ms", ttft,
                                 "original enqueue to the prefill-sampled "
                                 "first token the client keeps")
                if cost is not None:
                    cost.ttft_ms = ttft
        if slot.gen > 1 and slot.t_first is not None \
                and slot.t_last is not None:
            # mean inter-token time over the decode phase (chunk-edge
            # resolution)
            tpot = (slot.t_last - slot.t_first) / (slot.gen - 1) * 1e3
            _observe_latency("serving.latency.tpot_ms", tpot,
                             "mean time per output token after the first")
            if cost is not None:
                cost.tpot_ms = tpot
        if cost is not None:
            cost.preemptions = slot.preemptions
            # the share of the decode grid this request held over its
            # residencies (None when it retired without a decode chunk)
            cost.grid_steps += (self.stats.decode_steps
                                - slot.steps0) * self.num_slots
            cost.slot_share = round(cost.slot_steps / cost.grid_steps, 6) \
                if cost.grid_steps > 0 else None
            _slo.record_request(cost.as_dict())
        _trace.instant("serving.retire", rid=req.rid, tokens=slot.gen,
                       preemptions=slot.preemptions, tenant=req.tenant)
        _forensics.note_terminal(
            req.rid, "completed", t=now,
            e2e_ms=(cost.e2e_ms if cost is not None and cost.e2e_ms
                    else None),
            ttft_ms=(cost.ttft_ms if cost is not None and cost.ttft_ms
                     else None),
            tenant=req.tenant, tokens=slot.gen,
            preemptions=slot.preemptions)

    def _preempt_victim_idx(self) -> Optional[int]:
        """The eviction victim. Default: the youngest live request (the
        highest slot index). With ``slo_preemption``: the lowest
        (priority, prior preemptions, work), the youngest among
        equals: the least important class first, within a class repeat
        victims protected, then the request cheapest to recompute
        (:meth:`_work`)."""
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
            key = (slot.req.priority, slot.preemptions, self._work(slot),
                   -idx)
            if best_key is None or key < best_key:
                best_idx, best_key = idx, key
        return best_idx

    @staticmethod
    def _work(slot: _Slot) -> int:
        """A live request's work so far: its cost record's prefill and
        decode tokens (cumulative across re-runs) when the monitor keeps
        one, else the current run's KV length."""
        if slot.cost is not None:
            return slot.cost.prefill_tokens + slot.cost.decode_tokens
        return slot.kv_len

    def _preempt_one(self) -> bool:
        """Evict :meth:`_preempt_victim_idx`'s request (recompute policy:
        pages freed, request requeued at the front). False when nothing
        can be evicted."""
        idx = self._preempt_victim_idx()
        if idx is None:
            return False
        slot = self.slots[idx]
        self.slots[idx] = None
        now = time.perf_counter() if _monitor.enabled() else None
        cost = slot.cost if now is not None else None
        if cost is not None and slot.t_tick is not None:
            # final page-seconds tick for this run, read before the free:
            # an evicted request paid for the pages it held
            cost.page_seconds += (self.cache.alloc.page_count(slot.req.rid)
                                  * (now - slot.t_tick))
        self.cache.alloc.free(slot.req.rid)
        slot.req._preempt_count += 1
        self.queue.appendleft(slot.req)
        self.stats.preempted += 1
        self.stats.tokens_discarded += slot.gen
        _monitor.inc("serving.requests.preempted")
        _monitor.inc("serving.tokens.discarded", slot.gen,
                     doc="sampled tokens thrown away by "
                         "preemption recompute")
        if now is not None:
            # the re-queue refreshes _t_enqueue: the next wait adds onto
            # the record's cumulative queue_wait_ms at re-admission
            slot.req._t_enqueue = now
            if cost is not None:
                cost.discarded_tokens += slot.gen
                cost.grid_steps += (self.stats.decode_steps
                                    - slot.steps0) * self.num_slots
            tenant = slot.req.tenant
            _trace.instant("serving.preempt", rid=slot.req.rid,
                           discarded=slot.gen, tenant=tenant)
            # the victim-selection inputs that chose this slot
            victim = dict(policy="slo" if self._slo_preemption
                          else "youngest", slot=idx,
                          priority=slot.req.priority,
                          prior_preemptions=slot.preemptions,
                          work=int(self._work(slot)))
            _forensics.decision("preempt", rid=slot.req.rid,
                                discarded=slot.gen, **victim)
            _forensics.note(slot.req.rid, "preempt", t=now, tenant=tenant,
                            discarded=slot.gen, **victim)
        return True

    def _defer(self, req: Request, reason: str, **inputs):
        """Record one admission-scan deferral (forensics timeline and
        decision ring, both self-gated and coalescing: a head request
        blocked on one reason for many steps is one record with a
        count)."""
        _forensics.note_defer(req.rid, reason, **inputs)
        _forensics.decision("defer", rid=req.rid, reason=reason, **inputs)

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
        takes the same steps as its FIFO one. Each deferral is recorded
        (``_defer``) with the reason and inputs of the reference's scan
        that the options select: ``no_free_slot``, ``tenant_cap``,
        ``watermark`` and ``alloc_failed``."""
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
                self._defer(self.queue[0], "no_free_slot",
                            queue_depth=len(self.queue))
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
                self._defer(self.queue[0], "tenant_cap", cap=cap,
                            queue_depth=len(self.queue))
                break
            req = self.queue[pos]
            s_pad = self._pad_bucket(req)
            need = s_pad // self.page_size
            idle = not any(s is not None and not s.done
                           for s in self.slots)
            if self._free_slack() - need < self.watermark_pages \
                    and not idle:
                self._defer(req, "watermark",
                            free_slack=self._free_slack(), need=need,
                            watermark_pages=self.watermark_pages,
                            queue_depth=len(self.queue))
                break
            del self.queue[pos]
            if self._alloc_for(req, s_pad) is None:
                self.queue.insert(pos, req)
                self._defer(req, "alloc_failed", need=need,
                            free_pages=alloc.free_pages,
                            queue_depth=len(self.queue))
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
        mon = _monitor.enabled()
        t_admit = None
        if mon:
            t_admit = time.perf_counter()
            self._admit_monitor(free, group, s_pad, t_admit)
        g = 1
        while g < len(group):
            g *= 2
        cached = group[0]._pfx_cached if self._prefix is not None else 0
        ncp = cached // self.page_size
        s_eff = s_pad - cached
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
        sampled = any(s is not None for s in seeds)
        t0 = time.perf_counter()
        ids, rows, slen, *ctx = self._upload(
            ids, rows, slen, *((ctx_rows,) if cached else ()))
        exec_rec = None
        flops_share = None
        if mon:
            # the program's record (first dispatch of its key) and its
            # FLOPs, split across the real requests of the group (pad
            # rows attribute nowhere)
            key = self._record_serving_program(
                ("serving.prefill_shared", g, s_eff, ncp, sampled)
                if cached else ("serving.prefill", g, s_pad, sampled),
                f"serving.prefill_shared[g{g},s{s_eff},ctx{ncp}]"
                if cached else f"serving.prefill[g{g},s{s_pad}]",
                dict(tokens=g * s_eff, key_len=cached + s_eff,
                     head_rows=g, seqs=g),
                (ids, rows, slen, *ctx))
            from ..monitor import exectime as _exectime
            exec_rec = _exectime.maybe_sample(key, feed_last=False)
            pf_flops = self._program_flops(key)
            if pf_flops:
                flops_share = pf_flops / len(group)
        with _trace.span("serving.prefill", group=len(group),
                         s_pad=s_pad), _pcap.annotate("serving.prefill"):
            # the download waits for the card: the span ends, and the
            # first token is stamped, when the tokens reached the host
            toks = self._prefill_plane(
                ids, rows, slen, temps, seeds if sampled else None,
                *ctx).tolist()
        if exec_rec is not None:
            # the download above already waited: rec(None) adds no
            # synchronization at this seam
            exec_rec(None)
        t_first = time.perf_counter()
        self.stats.prefill_s += t_first - t0
        if mon:
            for r in group:
                _trace.instant("serving.first_token", rid=r.rid)
                _forensics.note(r.rid, "first_token", t=t_first)
        for j, (r, slot) in enumerate(zip(group, slots)):
            tail = int(r.prompt.shape[0]) - cached
            self.cache.alloc.advance(r.rid, tail + cached)
            tok = int(toks[j])
            slot.tokens.append(tok)
            slot.pending = tok
            slot.gen = 1
            slot.t_first = t_first
            if mon:
                slot.t_last = t_first
                slot.cost = r._cost
                # page-seconds integrate from admission (the pages were
                # allocated in _admit) at chunk-edge resolution
                slot.t_tick = t_admit
                slot.steps0 = self.stats.decode_steps
                if slot.cost is not None:
                    slot.cost.prefill_tokens += tail
                    if cached:
                        slot.cost.prefix_cached_tokens += cached
                        if flops_share:
                            # the tail program's per-padded-token cost
                            # times the tokens the cache served
                            slot.cost.prefill_flops_saved += (
                                flops_share / s_eff * cached)
                    if flops_share:
                        slot.cost.model_flops += flops_share
            slot.done = (r.eos_token_id is not None
                         and tok == r.eos_token_id) \
                or slot.gen >= r.max_new_tokens
            self.slots[free[j]] = slot
            self.stats.admitted += 1
            self.stats.tokens_generated += 1
            self.stats.tokens_prefilled += tail
            _monitor.inc("serving.requests.admitted")
            # the prefill-sampled first token counts here, so the counter
            # agrees with stats.tokens_generated
            _monitor.inc("serving.tokens.generated")
            _monitor.inc("serving.tokens.prefilled", tail)

    def _admit_monitor(self, free, group, s_pad: int, t_admit: float):
        """The monitor's half of an admission: the admit decision, each
        member's queue wait (observed once a wait; the cost record keeps
        the sum across preemption re-queues), its admit instant and its
        forensics note with the cached prefix length it was grouped on."""
        _forensics.decision(
            "admit", rid=group[0].rid, group=len(group), bucket=s_pad,
            free_slots=len(free), queue_depth=len(self.queue),
            pfx_cached=int(group[0]._pfx_cached))
        for r in group:
            wait_ms = None
            if r._t_enqueue is not None:
                wait_ms = (t_admit - r._t_enqueue) * 1e3
                _observe_latency(
                    "serving.latency.queue_wait_ms", wait_ms,
                    "enqueue (or preemption re-queue) to admission")
                if r._cost is not None:
                    r._cost.queue_wait_ms += wait_ms
            _trace.instant("serving.admit", rid=r.rid)
            _forensics.note(
                r.rid, "admit", t=t_admit, bucket=s_pad, group=len(group),
                wait_ms=round(wait_ms, 3) if wait_ms is not None else None,
                pfx_cached=int(r._pfx_cached))

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
        """One scheduling iteration: expire (once any request carried a
        deadline) -> retire -> compact -> admit -> one decode chunk.
        Returns False when the engine is fully idle.

        Runs in inference mode: a served parameter tree that requires
        grad builds no autograd graph and saves nothing for a backward."""
        if self._deadlines_seen:
            self._expire_due()
        for idx in range(self.num_slots):
            if self.slots[idx] is not None and self.slots[idx].done:
                self._retire(idx)
        self._compact()
        self._admit()
        _monitor.set_gauge("serving.queue.depth", len(self.queue),
                           doc="requests waiting for admission")
        in_use = self.cache.alloc.used_pages
        self.stats.peak_pages_in_use = max(self.stats.peak_pages_in_use,
                                           in_use)
        _monitor.set_gauge("serving.pages.in_use", in_use,
                           doc="KV pages currently allocated")
        live_idx = [i for i, s in enumerate(self.slots)
                    if s is not None and not s.done]
        if _monitor.enabled():
            # the autoscale feed: one host tick a scheduling step
            _slo.note_sched_tick(
                len(self.queue), len(live_idx), self.num_slots,
                self.cache.alloc.free_pages / self.cache.num_pages
                if self.cache.num_pages else 0.0)
        if self._frame_pub is not None:
            # the federation frame on the same host tick (rate-limited
            # inside; host state only, no read of the device)
            self._frame_pub.maybe_publish(self)
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
        mon = _monitor.enabled()
        t0 = time.perf_counter()
        args = self._upload(bt, tokens, kv_len, done, gen, max_new, eos)
        exec_rec, flops_share = self._chunk_monitor(
            ("serving.decode_chunk", C, seeds is not None),
            f"serving.decode_chunk[c{C}"
            f"{',sampled' if seeds is not None else ''}]",
            dict(tokens=B, key_len=bt.shape[1] * self.page_size,
                 head_rows=B, steps=C, seqs=B), args, len(live_idx)) \
            if mon else (None, None)
        with _trace.span("serving.decode_chunk", chunk=C,
                         live=len(live_idx)), \
                _pcap.annotate_step("serving.decode_chunk",
                                    self.stats.decode_steps):
            # one download a chunk: every host-side fact derives from the
            # emitted grid (-1 = the slot was done at that step), and the
            # download waits for the card, so the span ends when the
            # tokens reached the host
            emitted = self._decode_plane(C, *args, temps, seeds)
            emitted = emitted.cpu().numpy()                  # [C, B]
        self.stats.decode_s += time.perf_counter() - t0
        t_chunk = self._chunk_edge(exec_rec) if mon else None
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
                if t_chunk is not None:
                    s.t_last = t_chunk
            if t_chunk is not None and s.cost is not None:
                self._charge(s, t_chunk, C, len(toks), flops_share)
            s.done = s.gen >= s.req.max_new_tokens or (
                s.req.eos_token_id is not None and bool(toks)
                and toks[-1] == s.req.eos_token_id)
        self.stats.decode_steps += C
        self.stats.tokens_generated += new_tokens
        self.stats.tokens_decoded += new_tokens
        self.stats._occ_steps += C * self.num_slots
        _monitor.set_gauge("serving.batch.occupancy",
                           round(self.stats.occupancy(), 4),
                           doc="generated tokens / (decode steps x slots)")
        _monitor.inc("serving.tokens.generated", new_tokens)
        return True

    def _chunk_monitor(self, spec_key, name, shape, args, live: int):
        """Before a decode chunk's or verify round's dispatch (monitor
        on): the program's record, an armed exec sample (or None) and its
        FLOPs share for each of the ``live`` slots sharing the dispatch
        (done and empty slots ride the fixed grid for free; the work
        exists because of the live ones)."""
        key = self._record_serving_program(spec_key, name, shape, args)
        from ..monitor import exectime as _exectime
        exec_rec = _exectime.maybe_sample(key, feed_last=False)
        flops = self._program_flops(key)
        return exec_rec, (flops / live if flops else None)

    def _chunk_edge(self, exec_rec) -> float:
        """After a chunk's or round's download (monitor on): close the
        exec sample (the download already waited, so ``rec(None)`` adds
        no synchronization), take a KV-page sample, stamp the edge."""
        if exec_rec is not None:
            exec_rec(None)
        self._maybe_sample_kv_absmax()
        return time.perf_counter()

    def _charge(self, s: _Slot, t_chunk: float, C: int, emitted: int,
                flops_share):
        """Cost attribution of one slot at a chunk edge: page-seconds
        since its last tick, the chunk's grid steps, its emissions and
        its FLOPs share. Host reads only (allocator page counts, the
        cached program FLOPs)."""
        cost = s.cost
        if s.t_tick is not None:
            cost.page_seconds += (self.cache.alloc.page_count(s.req.rid)
                                  * (t_chunk - s.t_tick))
        s.t_tick = t_chunk
        cost.slot_steps += C
        cost.decode_tokens += emitted
        if flops_share:
            cost.model_flops += flops_share

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
        mon = _monitor.enabled()
        t0 = time.perf_counter()
        args = self._upload(bt, drafts, kv_len, live_m)
        exec_rec, flops_share = self._chunk_monitor(
            ("serving.spec_chunk", C), f"serving.spec_chunk[c{C}]",
            dict(tokens=B * C, key_len=bt.shape[1] * self.page_size,
                 head_rows=B * C, seqs=B), args, len(live_idx)) \
            if mon else (None, None)
        with _trace.span("serving.spec_chunk", chunk=C,
                         live=len(live_idx)), \
                _pcap.annotate_step("serving.spec_chunk",
                                    self.stats.decode_steps):
            preds = self._spec_plane(*args).cpu().numpy()    # [B, C]
        self.stats.decode_s += time.perf_counter() - t0
        t_chunk = self._chunk_edge(exec_rec) if mon else None
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
            if t_chunk is not None:
                s.t_last = t_chunk
                if s.cost is not None:
                    self._charge(s, t_chunk, C, len(emitted), flops_share)
                # an aggregate fold, no event: spec rounds come at chunk
                # rate and would flood the bounded timeline
                _forensics.note_spec(s.req.rid, C - 1, a)
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
        _monitor.set_gauge("serving.batch.occupancy",
                           round(self.stats.occupancy(), 4),
                           doc="generated tokens / (decode steps x slots)")
        _monitor.inc("serving.tokens.generated", new_tokens)
        _monitor.inc("serving.spec.rounds", len(live_idx),
                     doc="per-sequence speculative verify rounds")
        _monitor.inc("serving.spec.drafted", (C - 1) * len(live_idx),
                     doc="n-gram draft tokens proposed for verification")
        _monitor.inc("serving.spec.accepted", accepted,
                     doc="draft tokens confirmed by the greedy verify")
        return True

    def _maybe_sample_kv_absmax(self):
        """KV-page absmax feed of the numerics plane: every 1-in-N chunks
        (``PADDLE_TPU_KV_SAMPLE``; 0 disables) the per-layer per-page
        max |K| / max |V| over the pool (with int8 pools: max |code| x
        scale, the scales and the fraction of codes at the +-127 rail),
        kept for the pages the allocator holds live (free pages are zeros
        that would drown the distribution). Plain PyTorch reductions,
        run after the chunk's download: the card has finished the chunk,
        and the one download of the results waits for nothing else. A
        full-precision pool is read once (``aminmax``)."""
        from ..monitor import numerics as _numerics
        rate = _numerics.kv_sample_rate()
        if rate <= 0:
            return
        self._kv_chunks += 1
        if self._kv_chunks < rate:
            return
        self._kv_chunks = 0
        in_use = np.flatnonzero(self.cache.alloc._ref > 0)
        if in_use.size == 0:
            return
        k, v = self.cache.pool["k"], self.cache.pool["v"]
        if self.kv_quant:
            # codes [L, P, kv, ps, hd] and scales [L, P, kv]
            def one(leaf):
                am = leaf["q"].abs().amax(dim=(3, 4))
                return (am.float() * leaf["s"]).amax(dim=2)
            clip = ((k["q"].abs() == 127).float().mean(dim=(0, 2, 3, 4))
                    + (v["q"].abs() == 127).float().mean(
                        dim=(0, 2, 3, 4))) * 0.5               # [P]
            scales = torch.maximum(k["s"].amax(dim=2), v["s"].amax(dim=2))
            grids = torch.stack([one(k), one(v), scales])
            flat = torch.cat([grids.reshape(-1), clip]).cpu().numpy()
            out = flat[:grids.numel()].reshape(grids.shape)
            clip = flat[grids.numel():]
        else:
            # max |x| a (layer, page) from one pass: the larger of the max
            # and the negated min (abs() would write the pool's size first)
            def one(leaf):
                lo, hi = torch.aminmax(leaf.reshape(*leaf.shape[:2], -1),
                                       dim=-1)
                return torch.maximum(hi, -lo).float()
            out = torch.stack([one(k), one(v)]).cpu().numpy()
        _numerics.record_kv_absmax(out[0][:, in_use], out[1][:, in_use])
        if self.kv_quant:
            _numerics.record_kv_quant(out[2][:, in_use],
                                      float(np.mean(clip[in_use])))

    def publish_frames(self, name: str, dir_path: Optional[str] = None,
                       *, min_interval_s: float = 0.25, client=None,
                       local_only: bool = False, slo_fn=None):
        """Opt this replica into fleet SLO federation
        (``monitor/federation.py``): attach a frame publisher that emits a
        compact versioned telemetry frame (autoscale payload,
        per-objective burn and compliance, bounded tenant aggregates,
        terminal-state counters, drain state) on every scheduler step,
        rate-limited to ``min_interval_s``, through the name-keyed
        heartbeat transport (``dir_path`` beat files, and a key-value
        store with ``client``; the frame IS the liveness beat).
        ``local_only`` keeps frames in this process's registry. Host
        reads only: publishing adds no read of the device. Returns the
        publisher (one per engine; attaching again replaces it)."""
        from ..monitor import federation as _fed
        self._frame_pub = _fed.FramePublisher(
            name, dir_path=dir_path, client=client,
            local_only=local_only,
            min_interval_s=min_interval_s, slo_fn=slo_fn)
        self._frame_pub.maybe_publish(self, force=True)
        return self._frame_pub

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
