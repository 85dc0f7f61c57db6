"""Shared helpers of the monitor-plane parity suites
(``tests/test_torch_{monitor,trace,slo,forensics,programs,
exec_numerics,replay}.py``).

- :class:`FakeClock` replaces the ``time`` name of every module that
  reads a clock, in both packages (the engines, ``slo``, ``forensics``,
  ``trace``, ``exectime``, ``programs`` and the replay drivers): its
  ``perf_counter`` / ``perf_counter_ns`` / ``monotonic`` / ``time``
  read one value that only the script moves, so latencies, page-seconds,
  burn verdicts and timelines are equal on both sides.
- :func:`monitor_on` turns ``FLAGS_enable_monitor`` on in both registries
  and resets both planes around a test.
- :func:`equal_flops` sets the FLOPs of each serving program equal on
  both sides (a function of the program's key without the engine uid):
  the reference's FLOPs come from XLA's cost analysis, which counts a
  ``lax.scan`` body once, the port's from the program's shapes.
- :func:`serve_pair` drives the same scripted submissions through the JAX
  engine and the port's engine on carried-over float32 weights.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu import monitor as JM
from paddle_tpu.core import flags as JF
from paddle_tpu.inference import EngineOverloaded as JOverloaded
from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import RequestRejected as JRejected
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import monitor as TM
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import (EngineOverloaded, Request,
                                        RequestRejected, ServingEngine)
from paddle_tpu_torch.models import llama as TL

CLOCKED = ("inference.engine", "monitor.slo", "monitor.forensics",
           "monitor.trace", "monitor.exectime", "monitor.programs",
           "loadgen.replay")

# the FLOPs counter and gauge carry each side's own FLOPs
FLOPS_METRICS = ("jit.program.flops", "jit.program.last_flops")


class FakeClock:
    """The ``time`` module as the planes see it."""

    def __init__(self, now=1000.0):
        self.now = float(now)

    def perf_counter(self):
        return self.now

    def perf_counter_ns(self):
        return int(round(self.now * 1e9))

    def monotonic(self):
        return self.now

    def time(self):
        return 1.7e9 + self.now

    def sleep(self, dt):
        self.now += dt

    def advance(self, dt):
        self.now += dt


def patch_clock(monkeypatch, clock):
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        for mod in CLOCKED:
            monkeypatch.setattr(importlib.import_module(f"{pkg}.{mod}"),
                                "time", clock)
    return clock


def set_monitor(on: bool):
    JF.set_flags({"enable_monitor": on})
    TF.set_flags({"enable_monitor": on})


def reset_both():
    """Both packages' planes and every override the planes keep across
    ``monitor.reset()`` (sample rates, objectives, window, tenant cap, the
    SLO plane's health provider), so a case leaves nothing behind."""
    JM.reset()
    TM.reset()
    for M in (JM, TM):
        M.server.unregister_health_provider("slo_burn")
        M.slo._PROVIDER_REGISTERED[0] = False
        M.exectime.set_sample_rate(None)
        M.numerics.set_kv_sample_rate(None)
        M.slo.set_objectives(ttft_p99_ms=None, tpot_p99_ms=None,
                             e2e_p99_ms=None, availability=None)
        M.slo.set_window(None)
        M.slo.set_max_tenants(None)


@pytest.fixture
def monitor_on():
    reset_both()
    set_monitor(True)
    yield
    set_monitor(False)
    reset_both()


def _spec_flops(key):
    return 1e6 * (1 + len(str(tuple(key[2:]))))


def equal_flops(monkeypatch):
    monkeypatch.setattr(importlib.import_module(
        "paddle_tpu.monitor.programs"), "flops_of", _spec_flops)
    monkeypatch.setattr(importlib.import_module(
        "paddle_tpu_torch.monitor.programs"), "flops_of", _spec_flops)


def tiny_pair(layers=2, seed=0):
    jcfg = JL.llama_tiny(num_hidden_layers=layers, dtype=jnp.float32)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TL.llama_tiny(num_hidden_layers=layers), tp


def prompt(seed, n, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, (n,)).astype(np.int32)


def play(eng, req_cls, overloaded, rejected, script, clock):
    """Run ``script``: ``("sub", rid, n, new, kw)`` submits (``kw["pseed"]``
    picks the prompt's seed, default the rid); ``("step",)``;
    ``("tick", dt)``; ``("drain",)``; then steps until idle, advancing
    the clock 0.01 s after each step. Returns the outputs and the refused
    rids with ``("shed" | "rejected", reason, retry_after_s)``."""
    refused = {}
    for ev in script:
        kind = ev[0]
        if kind == "sub":
            _, rid, n, new, kw = ev
            kw = dict(kw)
            p = kw.pop("prompt", None)
            if p is None:
                p = prompt(kw.pop("pseed", rid), n)
            try:
                eng.submit(req_cls(rid=rid, prompt=p, max_new_tokens=new,
                                   **kw))
            except overloaded as e:
                refused[rid] = ("shed", e.reason, e.retry_after_s)
            except rejected as e:
                refused[rid] = ("rejected", e.reason, None)
        elif kind == "step":
            eng.step()
        elif kind == "tick":
            clock.advance(ev[1])
        elif kind == "drain":
            eng.begin_drain()
    while eng.step():
        clock.advance(0.01)
    return dict(eng.outputs), refused


def plane_state(M):
    """Everything a parity test compares from one package's planes."""
    snap = M.snapshot()
    for kind in ("counters", "gauges"):
        for name in FLOPS_METRICS:
            snap.get(kind, {}).pop(name, None)
    fo = M.forensics.forensics_payload()
    return {
        "snapshot": snap,
        "slo": M.slo.compliance_report(),
        "tenants": M.slo.tenants_snapshot(),
        "tenant_compliance": M.slo.tenant_compliance(),
        "records": M.slo.records(),
        "forensics": fo,
        "timelines": {rid: M.forensics.request_payload(rid)
                      for rid in fo["requests"]},
        "events": [{k: v for k, v in e.items() if k != "tid"}
                   for e in M.trace.events()],
        "programs": sorted((r["name"], r["hits"], r["exec_samples"])
                           for r in M.programs.programs_snapshot()
                           if r["source"] == "serving"),
        "kv": M.numerics.kv_snapshot(),
        "kv_quant": M.numerics.kv_quant_snapshot(),
    }


def serve_pair(tiny, clock, script, *, family=None, tfamily=None, **kw):
    """``script`` through both engines, the monitor planes reset before
    each. Returns ``{"jax": (outputs, refused, planes, engine), "torch":
    ...}``."""
    jcfg, jp, tcfg, tp = tiny
    family = family or JL
    tfamily = tfamily or TL
    out = {}
    JM.reset()
    TM.reset()
    clock.now = 1000.0
    teng = ServingEngine(tfamily, tp, tcfg, device="cpu", **kw)
    tres = play(teng, Request, EngineOverloaded, RequestRejected, script,
                clock)
    out["torch"] = tres + (plane_state(TM), teng)
    JM.reset()
    TM.reset()
    clock.now = 1000.0
    jeng = JEngine(family, jp, jcfg, **kw)
    jres = play(jeng, JRequest, JOverloaded, JRejected, script, clock)
    out["jax"] = jres + (plane_state(JM), jeng)
    return out


def cost_dict(out):
    return None if out.cost is None else out.cost.as_dict()
