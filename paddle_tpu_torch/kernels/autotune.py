"""Runtime kernel autotuning with a persisted cache (port of
``paddle_tpu/kernels/autotune.py``).

Reference capability: paddle/phi/kernels/autotune/{cache.h,cache_base.h,
switch_autotune.h} -- measure the candidates for an op at its actual
runtime shape once, remember the winner keyed by shape and dtype, persist
it across processes. The reference's policy is kept unchanged: the cache,
its modes, the failure budget, the warm start and the counters. What the
port tunes, and how it measures:

- ``paged_page_size``: the KV page size of a ``ServingEngine`` built with
  ``page_size=None``, over the reference's candidates (8, 16, 32, 64),
  default first (16; 32 for int8 pages). Which are legal comes from the
  CUDA decode entries' own check (``paged_attention.supported`` and the
  split plan, ``decode_split_plan``), not from the TPU's sublane floors;
  a page larger than both ``max_len`` and the default is never offered.
  The default stays unless a candidate is more than
  ``PAGED_KEEP_DEFAULT_WITHIN`` faster (the reference takes the strict
  minimum).
- ``ce_chunk``: the vocabulary chunk of the blockwise cross entropy
  (``dispatched_fused_ce`` with ``vocab_chunk=None``), over 1024 ... 16384,
  timing forward and backward (under grad mode of its own, so a first
  call under ``no_grad`` or ``inference_mode`` sweeps too).
- ``flash_blocks`` / ``varlen_blocks``: the dense and segment flash
  kernels run fixed tiles a route (``flash_attention.seg_tiles``), so each
  knob has one candidate, the route's tiles, recorded in the cache the
  reference's way (``"candidates": 1``). The flash wrappers do not look
  them up per launch.

A sweep runs only where a card is present and the dispatch is on it, and
never under CUDA-graph capture or ``torch.compile`` tracing (``_in_trace``);
elsewhere the defaults (or a warm start) come back at once unless a
caller injects ``measure=``. A sweep whose working set cannot be made
fails as one whose every candidate failed. Each candidate is first held
to the kernel's plain version on the same inputs (a candidate that
disagrees raises and drops out of the sweep, the reference's rule for a
failing candidate), then timed with CUDA events over several launches
after a warm-up (the decode kernel's behind a stream hold, so the events
see the card's time and not the wrapper's host cost).

The winner is cached in-process and in a JSON file,
``~/.cache/paddle_tpu_torch/autotune.json`` (``PADDLE_TPU_AUTOTUNE_CACHE``
overrides it; the JAX package's file is never read). Keys are the
reference's with the dispatch's device type (``cuda`` or ``cpu``) in the
backend field. ``PADDLE_TPU_AUTOTUNE``: ``1`` measure and cache (default),
``cached`` use hits but never measure, ``0`` off; ``FLAGS_use_autotune``
off freezes every knob at its default.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
from typing import Callable, Optional

import torch

from ..core import flags as _flags


def _cache_path() -> str:
    return os.environ.get(
        "PADDLE_TPU_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu_torch",
                     "autotune.json"))


def _inc(name: str, n=1, doc: str = ""):
    from .. import monitor
    monitor.inc(name, n, doc=doc)


class AutotuneCache:
    """shape-key -> chosen config, in-memory with JSON persistence."""

    def __init__(self, path: Optional[str] = None):
        self._explicit_path = path
        self._mem: dict = {}
        self._loaded = False
        self._resolved_path: Optional[str] = None

    @property
    def _path(self) -> str:
        # resolved at use, not at construction: the module-level _CACHE is
        # built at import, which may precede the caller setting
        # PADDLE_TPU_AUTOTUNE_CACHE
        if self._explicit_path is not None:
            return self._explicit_path
        return _cache_path()

    def _load(self):
        # a path that moves after the first load evicts what the old file
        # gave, so put() never writes the old file's entries into the new
        path = self._path
        if self._resolved_path is not None and path != self._resolved_path:
            _inc("autotune.cache.evictions", len(self._mem),
                 doc="entries dropped on cache-path change")
            self._mem.clear()
            self._loaded = False
        self._resolved_path = path
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self._path) as f:
                disk = json.load(f)
            if isinstance(disk, dict):
                # disk entries never override fresher in-memory ones
                for k, v in disk.items():
                    self._mem.setdefault(k, v)
        except (OSError, ValueError):
            pass

    def get(self, key: str):
        self._load()
        return self._mem.get(key)

    def get_nearest(self, key: str):
        """Warm-start lookup for a cold shape key: the closest tuned
        entry whose key shares this key's non-numeric skeleton (same
        knob family, backend, dtype -- digit runs wildcarded), by
        log-space distance over the numeric fields. Returns
        ``(neighbor_key, value)`` or ``None``; error entries never
        warm-start."""
        self._load()
        skel = re.sub(r"\d+", "#", key)
        nums = [int(x) for x in re.findall(r"\d+", key)]
        best = None
        best_d = None
        for k in sorted(self._mem):       # deterministic tie-break
            v = self._mem[k]
            if k == key or not isinstance(v, dict) or v.get("error"):
                continue
            if re.sub(r"\d+", "#", k) != skel:
                continue
            kn = [int(x) for x in re.findall(r"\d+", k)]
            if len(kn) != len(nums):
                continue
            d = sum(abs(math.log(a + 1) - math.log(b + 1))
                    for a, b in zip(nums, kn))
            if best_d is None or d < best_d:
                best_d, best = d, (k, v)
        return best

    def put(self, key: str, value: dict):
        self._load()
        self._mem[key] = value
        try:
            # re-merge the file first: another process may have written
            # other shapes since our load (our own entries win)
            try:
                with open(self._path) as f:
                    disk = json.load(f)
                if isinstance(disk, dict):
                    for k, v in disk.items():
                        self._mem.setdefault(k, v)
            except (OSError, ValueError):
                pass
            os.makedirs(os.path.dirname(self._path), exist_ok=True)
            tmp = f"{self._path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self._mem, f, indent=1, sort_keys=True)
            os.replace(tmp, self._path)
        except OSError:
            pass   # the cache is an optimisation; never fail the op

    def clear(self):
        self._mem.clear()
        self._loaded = True


_CACHE = AutotuneCache()

# Keys whose sweep failed in this process: never re-swept here. A
# persisted error entry is a miss (a later process re-sweeps and may heal
# it) until MAX_SWEEP_FAILURES processes have each failed it.
_FAILED_KEYS: set = set()
MAX_SWEEP_FAILURES = 2

# what each knob returned in this process, per shape key
_USED: dict = {}


def used_blocks() -> dict:
    """``{shape_key: {<knob>: value, "source": cache|measured|default|...}}``
    for every decision made by this process."""
    return dict(_USED)


def _mode() -> str:
    """PADDLE_TPU_AUTOTUNE: "1" measure+cache (default), "cached" use
    cache hits but never measure, "0" off."""
    return os.environ.get("PADDLE_TPU_AUTOTUNE", "1")


def _backend(device) -> str:
    """The key's backend field: the dispatch's device type."""
    return torch.device("cuda" if device is None else device).type


def _tuning_backend(device=None) -> bool:
    """A sweep needs a card, and the dispatch on it."""
    return _backend(device) == "cuda" and torch.cuda.is_available()


def _in_trace() -> bool:
    """True under ``torch.compile`` tracing or CUDA-graph capture, where a
    candidate's launches and syncs would be captured instead of timed."""
    if torch.compiler.is_compiling():
        return True
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _dtype_name(dtype) -> str:
    """``bfloat16`` for ``torch.bfloat16`` (the reference's ``jnp.dtype
    (...).name``)."""
    return str(dtype).removeprefix("torch.")


def _resolve(key, field, cands, default, measure, make_measure, cache,
             device, encode=int, decode=int, warm_start=False,
             keep_default_within=0.0):
    """The reference's policy for one knob at one shape ``key``: off, no
    card, a cache hit, a failure budget spent, ``cached`` mode, a trace,
    one candidate, else a sweep of ``cands`` (``measure`` or
    ``make_measure()``; a raising candidate drops out) cached as its
    winner, or as the reference's error entry when every candidate fails
    (or ``make_measure()`` itself raises). ``_USED[key]`` records the
    value and its source; ``encode`` / ``decode`` turn a value into its
    cache form and back. With ``warm_start`` a fallback takes the nearest
    tuned neighbour's value (``AutotuneCache.get_nearest``) where it is a
    candidate. ``keep_default_within`` (a fraction) keeps the default
    unless the fastest candidate beats it by more than that: the
    reference takes the strict minimum (0)."""
    mode = _mode()

    def fallback(tag):
        nb = (cache or _CACHE).get_nearest(key) if warm_start else None
        if nb and nb[1].get(field) in [encode(c) for c in cands]:
            _USED[key] = {field: nb[1][field], "source": f"warm-start:{nb[0]}"}
            return decode(nb[1][field])
        _USED[key] = {field: encode(default), "source": tag}
        return default

    if not _flags.flag_value("use_autotune") or mode == "0":
        _USED[key] = {field: encode(default), "source": "off"}
        return default
    if measure is None and mode != "cached" and not _tuning_backend(device):
        return fallback("default-no-card")
    cache = cache or _CACHE
    hit = cache.get(key)
    _inc("autotune.cache.hit" if hit and not hit.get("error")
         else "autotune.cache.miss")
    if hit and not hit.get("error"):
        _USED[key] = {field: hit[field], "source": "cache"}
        return decode(hit[field])
    if key in _FAILED_KEYS or (
            hit and hit.get("failures", 1) >= MAX_SWEEP_FAILURES):
        _USED[key] = {field: encode(default), "source": "default"}
        return default
    if mode == "cached":
        return fallback("default")
    if measure is None and _in_trace():
        return fallback("default-in-trace")
    if len(cands) == 1:
        cache.put(key, {field: encode(cands[0]), "us": None,
                        "candidates": 1})
        _USED[key] = {field: encode(cands[0]), "source": "measured"}
        return cands[0]
    _inc("autotune.sweeps", doc="candidate measurement sweeps run")
    timings = {}
    last_err = None
    try:
        measure = measure or make_measure()
    except Exception as e:      # no working set: the sweep has failed
        last_err = f"{type(e).__name__}: {e}"[:200]
    else:
        for c in cands:
            try:
                timings[c] = measure(c)
            except Exception as e:   # a failing candidate just drops out
                last_err = f"{type(e).__name__}: {e}"[:200]
    if not timings:
        _FAILED_KEYS.add(key)
        prior = hit.get("failures", 1) if hit and hit.get("error") else 0
        cache.put(key, {field: encode(default), "us": None, "candidates": 0,
                        "failures": prior + 1,
                        "error": f"all candidates failed ({last_err})"})
        _USED[key] = {field: encode(default), "source": "default"}
        return default
    best = min(timings, key=timings.get)
    if default in timings and \
            timings[best] >= (1.0 - keep_default_within) * timings[default]:
        best = default
    cache.put(key, {field: encode(best),
                    "us": round(timings[best] * 1e6, 1),
                    "candidates": len(timings),
                    "timings_us": {str(c): round(t * 1e6, 1)
                                   for c, t in timings.items()}})
    _USED[key] = {field: encode(best), "source": "measured"}
    return best


def _event_seconds(fn, warmup: int, iters: int,
                   hold_ms: float = 0.0) -> float:
    """Seconds a call of ``fn`` on the card: ``warmup`` calls, then CUDA
    events around ``iters`` calls. With ``hold_ms`` a spin kernel holds
    the stream that long (at the H100's 1.98 GHz) while the host enqueues
    the calls, so that short launches run back to back and the events
    time the card, not the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold_ms:
        torch.cuda._sleep(int(hold_ms * 1.98e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / 1e3


def _randn(gen, shape, dtype, device, scale=1.0):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(
        dtype)


# candidates' agreement with the plain versions, relative to the plain
# result's largest magnitude: one rounding of the output type (bf16 2^-8
# of a value, float16 2^-11) plus float32 summation order; float32 the
# summation order and exp only
_AGREE_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2,
              torch.float32: 1e-4}


def _check_agrees(what, got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    scale = max(float(want.float().abs().max()), 1e-30)
    tol = _AGREE_TOL.get(dtype, 2e-2)
    if not err <= tol * scale:
        raise ArithmeticError(f"{what}: max |kernel - plain| {err:.3g} "
                              f"over {tol} x {scale:.3g}")
    return err


# --------------------------------------------------------------------------
# flash / varlen tiles: one candidate a route
# --------------------------------------------------------------------------

def _route_tiles(dtype, d):
    """The forward tiles the dense and segment kernels run at (``dtype``,
    head dim ``d``): 128 x 128 on the tensor cores, 32 x 32 on the CUDA
    cores (``flash_attention.seg_tiles``)."""
    from . import flash_attention as fa
    probe = torch.empty((1, 1, 1, d), dtype=dtype, device="meta")
    return fa.seg_tiles(probe)


def flash_candidates(bh, sq, sk, d, dtype):
    """The dense flash kernels' one candidate: the route's tiles."""
    return [_route_tiles(dtype, d)]


def varlen_candidates(b, bh, sq, sk, d, dtype):
    """The segment kernels' one candidate: the route's tiles."""
    return [_route_tiles(dtype, d)]


def _blocks(prefix, q_shape, k_shape, dtype, causal, measure, cache,
            device):
    b, sq, h, d = q_shape
    sk, kvh = k_shape[1], k_shape[2]
    tiles = _route_tiles(dtype, d)
    key = (f"{prefix}:{_backend(device)}:{_dtype_name(dtype)}:"
           f"b{b}h{h}kv{kvh}:q{sq}k{sk}d{d}:c{int(bool(causal))}")
    return _resolve(key, "blocks", [tiles], tiles, measure, None, cache,
                    device, encode=list, decode=tuple)


def flash_blocks(q_shape, k_shape, dtype, causal,
                 measure: Optional[Callable] = None,
                 cache: Optional[AutotuneCache] = None, device=None):
    """``(block_q, block_k)`` of a dense flash call at ``q_shape`` /
    ``k_shape`` on ``device`` (default the card): the route's tiles, one
    candidate, recorded in the cache under the reference's ``flash:``
    key."""
    return _blocks("flash", q_shape, k_shape, dtype, causal, measure, cache,
                   device)


def varlen_blocks(q_shape, k_shape, dtype, causal,
                  measure: Optional[Callable] = None,
                  cache: Optional[AutotuneCache] = None, device=None):
    """``(block_q, block_k)`` of a segment-masked flash call: the route's
    tiles under the reference's ``varlen:`` key."""
    return _blocks("varlen", q_shape, k_shape, dtype, causal, measure,
                   cache, device)


# --------------------------------------------------------------------------
# blockwise cross-entropy vocab chunk
# --------------------------------------------------------------------------

CE_DEFAULT_CHUNK = 4096
CE_CANDIDATES = (1024, 2048, 4096, 8192, 16384)


def ce_candidates(vocab: int):
    """Vocab-chunk candidates, default first, clamped to V (the
    reference's list; a chunk of 128-multiple or the whole V)."""
    out = []
    for c in (CE_DEFAULT_CHUNK,) + CE_CANDIDATES:
        c = min(c, vocab)
        if c % 128 and c != vocab:
            continue
        if c not in out:
            out.append(c)
    return out


@contextlib.contextmanager
def _grad_on():
    """Grad mode on and inference mode off: the first call of a shape may
    come under ``torch.no_grad()`` or ``torch.inference_mode()`` (a
    validation loss), and the sweep times a backward of its own."""
    with torch.inference_mode(False), torch.enable_grad():
        yield


def _ce_measurer(n, d, v, dtype, device="cuda"):
    """Per-sweep closure timing forward and backward of the blockwise
    cross entropy at ``[n, d]`` tokens over a ``[v, d]`` head, whatever
    the caller's grad mode. The operands are made once (seed 0, on
    ``device``); each candidate's loss, ``dx`` and ``dhead`` are held to
    the materialising cross entropy's before it is timed.
    ``measure.errors[chunk]`` keeps the largest ``|kernel - plain|`` of
    the three."""
    from .fused_ce import _mm_f32, fused_cross_entropy, \
        masked_xent_from_logits

    with _grad_on():
        gen = torch.Generator(device=device).manual_seed(0)
        x = _randn(gen, (n, d), dtype, device)
        head = _randn(gen, (v, d), dtype, device, scale=0.05)
        labels = torch.randint(0, v, (n,), generator=gen, device=device)

    def fwd_bwd(loss_of):
        with _grad_on():
            xg = x.detach().requires_grad_()
            hg = head.detach().requires_grad_()
            loss = loss_of(xg, hg)
            loss.backward()
        return loss.detach(), xg.grad, hg.grad

    plain = fwd_bwd(lambda xg, hg: masked_xent_from_logits(
        _mm_f32(xg, hg.t()), labels))

    def measure(chunk):
        def run():
            return fwd_bwd(lambda xg, hg: fused_cross_entropy(
                xg, hg, labels, vocab_chunk=chunk))
        got = run()
        measure.errors[chunk] = max(
            _check_agrees(f"ce chunk {chunk} {what}", g, p, dtype)
            for what, g, p in zip(("loss", "dx", "dhead"), got, plain))
        del got
        t = _event_seconds(run, warmup=1, iters=3)
        torch.cuda.empty_cache()
        return t

    measure.errors = {}
    return measure


def ce_chunk(n_tokens, hidden, vocab, dtype,
             default: int = CE_DEFAULT_CHUNK,
             measure: Optional[Callable] = None,
             cache: Optional[AutotuneCache] = None, device=None) -> int:
    """Tuned ``vocab_chunk`` of a blockwise cross-entropy call on
    ``device`` (default the card); measures once a shape key and caches
    it (memory and disk), under the reference's policy."""
    default = min(default, vocab)
    key = (f"ce:{_backend(device)}:{_dtype_name(dtype)}:"
           f"n{n_tokens}v{vocab}d{hidden}")
    return _resolve(key, "chunk", ce_candidates(vocab), default, measure,
                    lambda: _ce_measurer(n_tokens, hidden, vocab, dtype,
                                         device or "cuda"),
                    cache, device)


# --------------------------------------------------------------------------
# paged decode page size
# --------------------------------------------------------------------------

PAGED_DEFAULT_PAGE = 16
# the reference's int8 floor (its TPU sublane tile) kept as the int8
# default: the CUDA int8 arm takes any page size
PAGED_QUANT_PAGE = 32
PAGED_CANDIDATES = (8, 16, 32, 64)
# the stream hold under a candidate's 20 timed launches: the wrapper's
# host cost (tens of µs a call) is above the kernel's at serving shapes
PAGED_HOLD_MS = 10.0
# the default page stays unless a candidate's decode is more than this
# fraction faster: one page size's time moved by up to 3.2% between runs
# on an H100 (8 slots, 2048 positions, both arms), more than the pages
# differed within a run (1.1%), so a strict minimum would cache noise
PAGED_KEEP_DEFAULT_WITHIN = 0.05


def paged_candidates(dtype, max_len: int, kv_quant: bool = False, *,
                     batch: int = 1, num_heads: int = 1, kv_heads: int = 1,
                     head_dim: int = 128):
    """Page sizes the decode kernel takes for a pool of ``dtype`` (int8
    codes with ``kv_quant``) at ``(batch, num_heads, kv_heads,
    head_dim)``, default first (16; 32 with ``kv_quant``): the reference's
    candidates that ``paged_attention.supported`` and the split plan
    accept, none above both ``max_len`` and the default."""
    from . import paged_attention as pa
    default = PAGED_QUANT_PAGE if kv_quant else PAGED_DEFAULT_PAGE
    q_dtype = dtype if dtype in (torch.float32, torch.bfloat16) \
        else torch.bfloat16
    q = torch.empty((batch, num_heads, head_dim), dtype=q_dtype,
                    device="meta")
    out = []
    for ps in (default,) + PAGED_CANDIDATES:
        if ps > max(max_len, default) or ps in out:
            continue
        maxp = -(-max_len // ps)
        pages = torch.empty((1, kv_heads, ps, head_dim),
                            dtype=torch.int8 if kv_quant else dtype,
                            device="meta")
        table = torch.empty((batch, maxp), dtype=torch.int32, device="meta")
        if (pa.supported(q, pages, table, quant=kv_quant)
                and pa.decode_split_plan(batch, kv_heads, ps, maxp)[0]
                <= pa.MAX_SPLIT_PAGES):
            out.append(ps)
    return out or [default]


def _paged_measurer(batch, nh, kvh, d, max_len, dtype, kv_quant=False,
                    device="cuda"):
    """Per-sweep closure: one random KV working set (seed 0, on
    ``device``), re-paged for each candidate (``max_len`` rounds up to the
    largest candidate so every page size divides it; lengths drawn from
    ``[max_len / 4, max_len]``). ``kv_quant`` measures the int8 arm: codes
    and per-(page, kv head) scales quantized from the same working set.
    Each candidate's output is held to ``paged_attention_ref`` before it
    is timed; ``measure.errors[page_size]`` keeps the largest
    ``|kernel - plain|``."""
    from .paged_attention import paged_attention_ref, ragged_paged_attention

    cap = max(PAGED_CANDIDATES)
    max_len = -(-max_len // cap) * cap
    q_dtype = dtype if dtype in (torch.float32, torch.bfloat16) \
        else torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn(gen, (batch, nh, d), q_dtype, device)
    flat_k = _randn(gen, (batch * max_len, kvh, d), dtype, device)
    flat_v = _randn(gen, (batch * max_len, kvh, d), dtype, device)
    lengths = torch.randint(max_len // 4, max_len + 1, (batch,),
                            generator=gen, device=device,
                            dtype=torch.int32)

    def _quantize(pages):
        s = pages.float().abs().amax(dim=(2, 3)) / 127.0
        codes = torch.round(pages.float() / s.clamp_min(1e-10)[:, :, None,
                                                               None])
        return codes.to(torch.int8).contiguous(), s.contiguous()

    def measure(ps):
        maxp = max_len // ps
        pages = batch * maxp
        kp = flat_k.reshape(pages, ps, kvh, d).transpose(1, 2).contiguous()
        vp = flat_v.reshape(pages, ps, kvh, d).transpose(1, 2).contiguous()
        bt = torch.arange(pages, dtype=torch.int32,
                          device=device).reshape(batch, maxp)
        scales = {}
        if kv_quant:
            kp, scales["k_scales"] = _quantize(kp)
            vp, scales["v_scales"] = _quantize(vp)

        def run():
            return ragged_paged_attention(q, kp, vp, bt, lengths, **scales)
        measure.errors[ps] = _check_agrees(
            f"paged page {ps}", run(),
            paged_attention_ref(q, kp, vp, bt, lengths, **scales), q_dtype)
        return _event_seconds(run, warmup=3, iters=20,
                              hold_ms=PAGED_HOLD_MS)

    measure.errors = {}
    return measure


def paged_page_size(batch, num_heads, kv_heads, head_dim, max_len, dtype,
                    default: Optional[int] = None,
                    measure: Optional[Callable] = None,
                    cache: Optional[AutotuneCache] = None,
                    kv_quant: bool = False, device=None) -> int:
    """Tuned KV page size of a paged serving shape on ``device`` (default
    the card); measures the decode kernel once a shape key and caches it
    (memory and disk), under the reference's policy. Used by
    ``ServingEngine(page_size=None)``.

    ``kv_quant`` selects the int8 arm: its own ``:kvq`` key suffix and
    quantized measurement operands. A cold shape that cannot measure
    (off the card, cached-only mode, under a trace) warm-starts from the
    nearest tuned neighbour in its key family instead of the default."""
    cands = paged_candidates(dtype, max_len, kv_quant=kv_quant, batch=batch,
                             num_heads=num_heads, kv_heads=kv_heads,
                             head_dim=head_dim)
    default = default if default in cands else cands[0]
    key = (f"paged:{_backend(device)}:{_dtype_name(dtype)}:"
           f"b{batch}h{num_heads}kv{kv_heads}d{head_dim}:m{max_len}"
           + (":kvq" if kv_quant else ""))
    return _resolve(key, "page_size", cands, default, measure,
                    lambda: _paged_measurer(batch, num_heads, kv_heads,
                                            head_dim, max_len, dtype,
                                            kv_quant=kv_quant,
                                            device=device or "cuda"),
                    cache, device, warm_start=True,
                    keep_default_within=PAGED_KEEP_DEFAULT_WITHIN)
