"""Deterministic arrival-trace generation for serving load tests (a copy
of ``paddle_tpu/loadgen/traces.py``; numpy only).

The serving options (the prefix cache, spec decode, priority admission,
tenant caps) are exercised by replaying a seeded workload through the
engine. This module is the single source for those workloads:

- :func:`heavy_tailed_lengths` -- the packed-training document trace
  (``io/packing.py``'s, re-exported);
- :func:`mixed_length_trace` -- the reference's ``serving_paged`` bench
  rung's (prompt_len, gen_len) choice trace;
- :func:`generate_trace` -- the full multi-tenant arrival trace:
  Pareto-ish prompt/output lengths, a Poisson arrival process with an
  optional burst window, a weighted tenant mix carrying priorities,
  deadlines and shared system prefixes. Serializes to canonical JSON
  (:meth:`ArrivalTrace.to_json`), so a trace can be checked in and
  replayed byte-identically.

Determinism discipline: everything here is a pure function of its
seed -- no wall clock, no global RNG. Same seed => byte-identical JSON,
the same bytes as the JAX package's for the same arguments.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..io.packing import heavy_tailed_lengths

__all__ = ["ArrivalTrace", "TenantSpec", "TraceRequest",
           "generate_trace", "heavy_tailed_lengths",
           "mixed_length_trace", "prompt_tokens",
           "tenant_prefix_tokens"]

# v2: per-tenant shared system prefixes (TenantSpec.prefix_len,
# TraceRequest.prefix_len, tenant_prefix_tokens). v1 traces load
# unchanged — the new fields default to 0 / absent.
TRACE_VERSION = 2


def mixed_length_trace(prompt_lens: Sequence[int],
                       gen_lens: Sequence[int], n_requests: int,
                       rng) -> List[Tuple[int, int]]:
    """The ``serving_paged`` rung's mixed-length request trace:
    ``n_requests`` independent (prompt_len, gen_len) choices, sorted
    longest-generation-first (the standard makespan heuristic — the
    drain tail is short requests, so slot occupancy stays high).
    ``rng`` is a ``numpy`` Generator or an int seed; passing the
    caller's live Generator preserves its draw sequence exactly (the
    bench's prompt-token draws continue from where the trace left
    off)."""
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    trace = [(int(rng.choice(prompt_lens)), int(rng.choice(gen_lens)))
             for _ in range(n_requests)]
    trace.sort(key=lambda t: -t[1])
    return trace


def prompt_tokens(seed: int, rid: int, prompt_len: int,
                  vocab_size: int) -> np.ndarray:
    """Deterministic prompt ids for one trace request: a pure function
    of (trace seed, rid), so replaying a trace materializes identical
    prompts without the JSON having to carry token arrays."""
    rng = np.random.default_rng([int(seed) & 0x7FFFFFFF, int(rid)])
    return rng.integers(0, vocab_size, (int(prompt_len),)).astype(
        np.int32)


def tenant_prefix_tokens(seed: int, tenant: str, prefix_len: int,
                         vocab_size: int) -> np.ndarray:
    """Deterministic shared system-prefix ids for one tenant: a pure
    function of (trace seed, tenant name), mirroring how
    :func:`prompt_tokens` is a pure function of (seed, rid). The
    three-entry seed sequence (vs prompt_tokens' two) keeps the stream
    family disjoint from every per-request stream; the tenant name is
    hashed (sha256, stable across processes) so renames — not dict
    order — decide the stream."""
    tid = int.from_bytes(
        hashlib.sha256(str(tenant).encode()).digest()[:4], "big")
    rng = np.random.default_rng(
        [int(seed) & 0x7FFFFFFF, 0x70F1, tid])
    return rng.integers(0, vocab_size, (int(prefix_len),)).astype(
        np.int32)


def _trace_prompt(seed: int, rid: int, prompt_len: int, vocab: int,
                  tenant: str, prefix_len: int) -> np.ndarray:
    """Materialize one trace prompt (a copy of ``_trace_prompt`` from
    ``paddle_tpu/loadgen/replay.py``): the tenant's shared system prefix
    (a pure function of (seed, tenant)) followed by per-request tokens
    (a pure function of (seed, rid)). prefix_len=0 reproduces the v1
    prompt bytes exactly."""
    pfx = int(prefix_len or 0)
    tail = prompt_tokens(seed, rid, int(prompt_len) - pfx, vocab)
    if pfx <= 0:
        return tail
    return np.concatenate(
        [tenant_prefix_tokens(seed, tenant, pfx, vocab), tail])


@dataclasses.dataclass
class TenantSpec:
    """One tenant in the arrival mix: ``share`` weights how often the
    arrival process assigns it a request; ``priority``/``deadline_s``
    ride every request it is assigned."""

    name: str
    share: float = 1.0
    priority: int = 0
    deadline_s: Optional[float] = None
    # shared system-prefix length (tokens) every request of this tenant
    # starts with — ids derived by :func:`tenant_prefix_tokens`. 0 = no
    # shared prefix (the v1 behavior).
    prefix_len: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TraceRequest:
    """One arrival: virtual time + the request shape the replay driver
    materializes into an engine ``Request`` (prompts are derived from
    the trace seed, see :func:`prompt_tokens`)."""

    rid: int
    arrival_s: float
    prompt_len: int
    max_new_tokens: int
    tenant: str = "default"
    priority: int = 0
    deadline_s: Optional[float] = None
    # leading prefix_len of the prompt_len TOTAL tokens come from the
    # tenant's shared prefix stream; the rest from the per-rid stream
    prefix_len: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TraceRequest":
        return cls(rid=int(d["rid"]), arrival_s=float(d["arrival_s"]),
                   prompt_len=int(d["prompt_len"]),
                   max_new_tokens=int(d["max_new_tokens"]),
                   tenant=str(d.get("tenant", "default")),
                   priority=int(d.get("priority", 0)),
                   deadline_s=(None if d.get("deadline_s") is None
                               else float(d["deadline_s"])),
                   prefix_len=int(d.get("prefix_len", 0)))


@dataclasses.dataclass
class ArrivalTrace:
    """A seeded, serializable arrival trace. ``to_json`` is canonical
    (sorted keys, no whitespace): two traces generated from the same
    seed + config serialize to the same bytes, which is the
    determinism pin the tests and the bench guard lean on."""

    seed: int
    horizon_s: float
    requests: List[TraceRequest]
    config: dict = dataclasses.field(default_factory=dict)
    version: int = TRACE_VERSION

    def as_dict(self) -> dict:
        return {"version": self.version, "seed": self.seed,
                "horizon_s": self.horizon_s, "config": self.config,
                "requests": [r.as_dict() for r in self.requests]}

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, blob: str) -> "ArrivalTrace":
        d = json.loads(blob)
        if int(d.get("version", 0)) > TRACE_VERSION:
            raise ValueError(
                f"trace version {d.get('version')} is newer than this "
                f"reader ({TRACE_VERSION}); refusing to half-parse")
        return cls(seed=int(d["seed"]), horizon_s=float(d["horizon_s"]),
                   requests=[TraceRequest.from_dict(r)
                             for r in d["requests"]],
                   config=dict(d.get("config", {})),
                   version=int(d.get("version", TRACE_VERSION)))

    def sha256(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()

    def offered_tokens(self) -> int:
        """Upper bound of useful decode tokens this trace asks for."""
        return sum(r.max_new_tokens for r in self.requests)

    def tenants(self) -> List[str]:
        return sorted({r.tenant for r in self.requests})


def _pareto_lengths(rng: np.random.Generator, n: int, lo: int, hi: int,
                    alpha: float) -> np.ndarray:
    """Discrete Pareto-ish lengths on [lo, hi]: heavy upper tail, mass
    concentrated near ``lo`` — the serving length distribution paged
    batching exists for."""
    u = rng.random(n)
    raw = lo * np.power(1.0 - u, -1.0 / alpha)
    return np.clip(np.rint(raw), lo, hi).astype(np.int64)


def generate_trace(seed: int, *, duration_s: float = 1.0,
                   rate: float = 64.0,
                   tenants: Sequence[TenantSpec] = (),
                   prompt_len: Tuple[int, int] = (4, 64),
                   max_new_tokens: Tuple[int, int] = (4, 32),
                   alpha: float = 1.2,
                   burst: Optional[Tuple[float, float, float]] = None,
                   ) -> ArrivalTrace:
    """Generate a multi-tenant Poisson arrival trace.

    ``rate`` is mean arrivals/sec of virtual time over ``duration_s``;
    ``burst=(start_s, duration_s, factor)`` multiplies the rate inside
    the window (the overload episode a replay scripts against).
    Prompt/output lengths are Pareto-ish (``alpha`` ≈ 1–2: smaller is
    heavier-tailed) on the given [lo, hi] ranges. ``tenants`` defaults
    to a single ``"default"`` tenant; shares are normalized. Everything
    is drawn from ``default_rng(seed)`` in a fixed order — same seed
    and kwargs ⇒ byte-identical :meth:`ArrivalTrace.to_json`."""
    if duration_s <= 0 or rate <= 0:
        raise ValueError(f"need duration_s > 0 and rate > 0, got "
                         f"{duration_s}, {rate}")
    specs = list(tenants) or [TenantSpec("default")]
    shares = np.array([max(float(t.share), 0.0) for t in specs])
    if shares.sum() <= 0:
        raise ValueError("tenant shares sum to 0")
    shares = shares / shares.sum()
    rng = np.random.default_rng(seed)
    arrivals: List[float] = []
    t = 0.0
    while True:
        r = rate
        if burst is not None:
            b0, bd, bf = burst
            if b0 <= t < b0 + bd:
                r = rate * float(bf)
        t += float(rng.exponential(1.0 / r))
        if t >= duration_s:
            break
        arrivals.append(t)
    n = len(arrivals)
    tenant_idx = rng.choice(len(specs), size=n, p=shares) if n else []
    plens = _pareto_lengths(rng, n, prompt_len[0], prompt_len[1], alpha)
    glens = _pareto_lengths(rng, n, max_new_tokens[0],
                            max_new_tokens[1], alpha)
    reqs = []
    for i in range(n):
        spec = specs[int(tenant_idx[i])]
        # the shared prefix is DERIVED (no extra rng draw — the v1 draw
        # sequence is a pinned contract) and clamped so at least one
        # prompt token stays per-request: prompt_len is the TOTAL
        pfx = min(max(int(getattr(spec, "prefix_len", 0)), 0),
                  int(plens[i]) - 1)
        reqs.append(TraceRequest(
            rid=i, arrival_s=round(arrivals[i], 9),
            prompt_len=int(plens[i]), max_new_tokens=int(glens[i]),
            tenant=spec.name, priority=spec.priority,
            deadline_s=spec.deadline_s, prefix_len=max(pfx, 0)))
    config = {
        "rate": rate, "alpha": alpha,
        "prompt_len": list(prompt_len),
        "max_new_tokens": list(max_new_tokens),
        "burst": list(burst) if burst is not None else None,
        "tenants": [t.as_dict() for t in specs],
    }
    return ArrivalTrace(seed=int(seed), horizon_s=float(duration_s),
                        requests=reqs, config=config)
