"""Global flag registry (copy of ``paddle_tpu/core/flags.py``).

Typed flags with defaults, overridable from the environment (``FLAGS_<name>``
is read when the flag is defined) and from Python through ``set_flags`` /
``get_flags``, the ``paddle.set_flags`` surface. Hot paths keep the record
of ``flag_info`` and read ``.value``.

The port defines the reference's flags that mean something here, with the
reference's names, defaults and docs: ``enable_sentinel`` and
``enable_numerics`` (read by ``make_train_step``'s ``guard`` / ``numerics``
defaults through ``training.guards``) and every ``serving_*`` flag (read by
``ServingEngine``: ``serving_kv_quant``, ``serving_prefix_cache``,
``serving_spec_decode``, ``serving_priority_admission``,
``serving_tenant_inflight_cap``, ``serving_slo_preemption``,
``serving_max_queue``, ``serving_shed_on_burn`` and ``serving_failover``
are its options' defaults; ``serving_fleet_burn_scaling`` names the elastic
controller's option, which waits for fleet federation, and the engine
refuses to run with it on), ``enable_monitor`` (the monitor planes),
``enable_monitor_server`` and ``monitor_server_port`` (the operator HTTP
server, ROADMAP A7(d): the engine refuses ``enable_monitor_server``) and
``fault_injection`` (armed at import by ``testing.faults``). Left out,
because nothing in the port reads them: the JAX-only flags
(``use_pallas_kernels``, ``eager_jit_ops``, ``default_matmul_precision``)
and ``check_nan_inf``, whose module is not ported yet.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

from . import enforce as E

__all__ = ["define_flag", "get_flags", "set_flags", "flag_value",
           "flag_info"]


@dataclass
class _FlagInfo:
    name: str
    default: Any
    doc: str
    parser: Callable[[str], Any]
    value: Any = None


_REGISTRY: Dict[str, _FlagInfo] = {}


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


def define_flag(name: str, default, doc: str = ""):
    """Register a flag. Type inferred from the default. Env var ``FLAGS_<name>``
    overrides the default at registration time."""
    if isinstance(default, bool):
        parser = _parse_bool
    elif isinstance(default, int):
        parser = int
    elif isinstance(default, float):
        parser = float
    else:
        parser = str
    value = default
    env = os.environ.get(f"FLAGS_{name}")
    if env is not None:
        value = parser(env)
    _REGISTRY[name] = _FlagInfo(name, default, doc, parser, value)


def get_flags(flags):
    """paddle.get_flags parity: accepts a str or list of str, returns a dict."""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for f in flags:
        key = f[len("FLAGS_"):] if f.startswith("FLAGS_") else f
        if key not in _REGISTRY:
            raise E.InvalidArgumentError(f"Flag {f} is not registered")
        out[f] = _REGISTRY[key].value
    return out


def set_flags(flags: dict):
    """paddle.set_flags parity."""
    for k, v in flags.items():
        key = k[len("FLAGS_"):] if k.startswith("FLAGS_") else k
        if key not in _REGISTRY:
            raise E.InvalidArgumentError(f"Flag {k} is not registered")
        info = _REGISTRY[key]
        info.value = info.parser(v) if isinstance(v, str) else v


def flag_value(name: str):
    return _REGISTRY[name].value


def flag_info(name: str) -> _FlagInfo:
    """The live flag record. set_flags mutates it in place, so hot paths
    cache the record once and read ``.value`` — one attribute load per
    check instead of a registry lookup."""
    return _REGISTRY[name]


# The reference's flags that the port reads (see the module docstring).
define_flag("enable_monitor", False,
            "Collect runtime metrics (paddle_tpu.monitor counters/gauges/"
            "histograms) on the instrumented hot paths; off = one branch.")
define_flag("enable_sentinel", False,
            "Train-loop anomaly sentinel: models.llama/models.moe "
            "make_train_step builds the GUARDED step (in-graph "
            "NaN/grad-spike gate + health aux scalars) when its "
            "guard=None default resolves against this flag, and the "
            "hapi fit loop skips optimizer updates on non-finite "
            "losses (any model). Other families (dit, ocr) are not yet "
            "guarded. Off = one cached branch, zero extra device "
            "outputs.")
define_flag("enable_numerics", False,
            "Numerics plane: the GUARDED train steps (see "
            "enable_sentinel) additionally compute per-layer tensor "
            "statistics (absmax/rms/mean/zero fraction, overflow/"
            "underflow fraction vs dtype range, per-layer grad-norm "
            "breakdown) as fused on-device reductions, returned as a "
            "'numerics' block in the health aux pytree and fed to "
            "paddle_tpu.monitor.numerics. Only meaningful with the "
            "sentinel guard on; off = the guarded step is byte-"
            "identical to the pre-numerics program.")
define_flag("enable_monitor_server", False,
            "Serve the operator plane (paddle_tpu.monitor.server): an "
            "HTTP daemon with /metrics (Prometheus text), /healthz "
            "(liveness), /flight, /programs and /memory, started by the "
            "ServingEngine / SentinelLoop / hapi fit entrypoints. Off "
            "(the default) = one cached branch, no thread, no socket.")
define_flag("monitor_server_port", 0,
            "Port for the operator-plane HTTP server (binds 127.0.0.1; "
            "override host with PADDLE_TPU_MONITOR_HOST). 0 = an "
            "ephemeral port, exposed on the server object for tests.")
define_flag("serving_priority_admission", False,
            "Serving engine admission orders the queue by (priority "
            "desc, arrival) instead of FIFO and honours "
            "FLAGS_serving_tenant_inflight_cap. Off (the default) = "
            "the original FIFO scan, byte-identical scheduling.")
define_flag("serving_tenant_inflight_cap", 0,
            "Max live decode slots one tenant may hold at once "
            "(0 = uncapped). Works alone (admission stays strict FIFO "
            "among cap-eligible requests) or with "
            "FLAGS_serving_priority_admission (priority order among "
            "cap-eligible).")
define_flag("serving_max_queue", 0,
            "Bounded serving queue: submissions beyond this depth are "
            "shed with a typed EngineOverloaded carrying a "
            "retry_after_s hint from the autoscale demand model "
            "(higher-priority submissions displace the lowest-priority "
            "queued request instead). 0 (the default) = unbounded, "
            "today's behavior.")
define_flag("serving_shed_on_burn", False,
            "Shed priority<=0 submissions while a LATENCY SLO "
            "objective's (TTFT/TPOT/e2e — availability excluded: "
            "sheds are themselves availability-bad records and must "
            "not re-arm their own trigger) fast-window burn rate is "
            "at/over the warn threshold (monitor on only; the burn "
            "check is cached ~0.5s). Off by default.")
define_flag("serving_slo_preemption", False,
            "Page-pressure preemption evicts the request with the "
            "LOWEST eviction cost (priority, then prior preemptions, "
            "then accumulated work from the per-request cost record) "
            "instead of youngest-first. Off (the default) = "
            "youngest-first, today's behavior.")
define_flag("serving_fleet_burn_scaling", False,
            "Elastic serving controller (run_serving) federates "
            "per-replica SLO telemetry frames (monitor/federation.py): "
            "a fleet latency-objective fast-burn adds scale-out "
            "pressure even at flat demand, and scale-in is refused "
            "while the fleet burn alerts (latency objectives only — "
            "availability-fed triggers self-lock). Off (the default) "
            "= demand-only scaling, byte-identical controller "
            "decisions.")
define_flag("serving_failover", False,
            "Exactly-once request failover (inference/failover.py): "
            "engines journal every admitted request (idempotency key, "
            "prompt spec, pinned PRNG key, attempt count) with "
            "completion markers on the name-keyed heartbeat "
            "transport; the elastic serving controller re-dispatches "
            "work stranded on a replaced replica through normal "
            "admission on survivors (bounded attempts, capped "
            "retry_after_s backoff, poison-request quarantine, "
            "per-replica circuit breakers). Off (the default) = no "
            "journal, no coordinator, byte-identical scheduling and "
            "tokens.")
define_flag("serving_prefix_cache", False,
            "Radix shared-prefix KV cache (inference/paged.py "
            "PrefixCache): admission looks up the longest cached "
            "page-aligned prompt prefix and forks those committed "
            "pages with pure refcount bumps, prefilling only the "
            "uncached tail; retirement inserts the request's "
            "committed pages back into the radix. Cached pages are "
            "pinned by a cache hold with LRU leaf eviction under "
            "pool pressure. Off (the default) = no cache, "
            "byte-identical scheduling and tokens.")
define_flag("serving_kv_quant", False,
            "Quantized KV-cache memory plane (inference/paged.py): "
            "page pools store int8 codes with per-page per-kv-head "
            "f32 scale planes (absmax chosen at write time; the "
            "scatter-with-drop write discipline quantizes "
            "in-program), and the paged-attention kernel + jnp "
            "fallback dequantize inline so HBM page reads stay int8 "
            "— half (bf16) to a quarter (f32) the page-pool bytes at "
            "fixed concurrency. Fork/CoW/free mirror scale rows with "
            "their pages, so the allocator audit and the radix "
            "prefix-cache holds balance unchanged. Off (the default) "
            "= full-precision pools, byte-identical pool contents, "
            "tokens and scheduling.")
define_flag("serving_spec_decode", False,
            "N-gram self-drafting speculative decode on the greedy "
            "turbo path: draft k tokens per sequence from a bigram "
            "table over the request's own context, verify all k in "
            "ONE jitted window program (k-fold fewer sequential "
            "model passes), accept the longest matching run at the "
            "chunk boundary. Greedy verify makes spec-on output "
            "token-identical to spec-off by construction. Off (the "
            "default) = sequential chunked decode, byte-identical "
            "tokens.")
define_flag("fault_injection", "",
            "Chaos-run fault spec: comma list of point:action[:nth[:delay_s]]"
            " armed at import by paddle_tpu.testing.faults (actions: "
            "raise|delay|kill|corrupt|corrupt_inf; e.g. "
            "'checkpoint.rename:kill:2', 'train.batch:corrupt:3').")
