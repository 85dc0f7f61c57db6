"""Port parity: the serving engine's bounded queue, shedding, deadlines,
drain lifecycle and ``kv_dtype`` pools.

The port's ``ServingEngine(device="cpu")`` and the JAX ``ServingEngine``
serve the same scripted submissions (the reference's own cases from
``tests/test_engine.py``'s shedding, deadline and drain classes) on the
same carried-over float32 ``llama_tiny`` (1 layer) weights. Deadlines run
on one fake clock: the ``time`` name of both engine modules is replaced
by a clock the script advances, so expiry order and partial token counts
are deterministic. Per rid, ``finish_reason``, tokens, ``shed_reason``,
``retry_after_s`` and preemptions must be equal, as must the rids each
engine refused with ``EngineOverloaded`` (and their hints) and
``stats.as_dict()``; every serve leaves the allocator's refcounts
consistent.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu.inference import EngineOverloaded as JOverloaded
from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import RequestRejected as JRejected
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import (EngineOverloaded, Request,
                                        RequestRejected, ServingEngine)
from paddle_tpu_torch.kernels import paged_attention as TPA
from paddle_tpu_torch.models import llama as TL

JENG = importlib.import_module("paddle_tpu.inference.engine")
TENG = importlib.import_module("paddle_tpu_torch.inference.engine")
JPA = importlib.import_module("paddle_tpu.kernels.paged_attention")


@pytest.fixture(scope="module")
def tiny():
    jcfg = JL.llama_tiny(num_hidden_layers=1, dtype=jnp.float32)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(3))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TL.llama_tiny(num_hidden_layers=1), tp


class FakeClock:
    """The ``time`` module as the engines see it: ``perf_counter`` reads a
    value only ``advance`` moves."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        return self.now

    def advance(self, dt):
        self.now += dt


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(JENG, "time", c)
    monkeypatch.setattr(TENG, "time", c)
    return c


def _prompt(rid, n):
    return np.random.default_rng(rid).integers(0, 256, (n,)).astype(np.int32)


def _play(eng, req_cls, overloaded, script, clock):
    """Run ``script`` on ``eng``. Items: ``("sub", rid, n, new, kw)``
    submits an ``n``-token prompt from seed ``rid`` (or ``kw["pseed"]``)
    with ``new`` new tokens and the Request fields ``kw``;
    ``("step",)``; ``("tick", dt)`` advances the clock;
    ``("drain", shed_queued)``; ``("run",)``;
    ``("until_requeue",)`` steps until a preemption re-queue heads the
    queue. Returns the outputs, the rids refused with ``overloaded`` and
    their hints and reasons, and ``drain_complete`` / ``drain_safe``
    probes recorded after each ``("probe",)``."""
    refused, probes = {}, []
    for ev in script:
        kind = ev[0]
        if kind == "sub":
            _, rid, n, new, kw = ev
            kw = dict(kw)
            prompt = _prompt(kw.pop("pseed", rid), n)
            try:
                eng.submit(req_cls(rid=rid, prompt=prompt,
                                   max_new_tokens=new, **kw))
            except overloaded as e:
                refused[rid] = (e.retry_after_s, e.reason)
        elif kind == "step":
            eng.step()
        elif kind == "tick":
            clock.advance(ev[1])
        elif kind == "drain":
            eng.begin_drain(shed_queued=ev[1])
        elif kind == "run":
            eng.run()
        elif kind == "until_requeue":
            for _ in range(20):
                eng.step()
                if eng.queue and eng.queue[0]._preempt_count > 0:
                    break
            assert eng.queue and eng.queue[0]._preempt_count > 0
        elif kind == "probe":
            probes.append((eng.drain_complete,
                           eng.autoscale_payload()["drain_safe"],
                           len(eng.queue)))
    out = eng.run()
    eng.cache.alloc.check_invariants()
    return out, refused, probes


def _both(tiny, clock, script, **kw):
    """The script on both engines; every observable compared."""
    jcfg, jp, tcfg, tp = tiny
    tkw = dict(kw)
    if "kv_dtype" in kw:
        kw = dict(kw, kv_dtype={torch.bfloat16: jnp.bfloat16,
                                torch.float32: jnp.float32}[kw["kv_dtype"]])
    teng = ServingEngine(TL, tp, tcfg, device="cpu", **tkw)
    tres = _play(teng, Request, EngineOverloaded, script, clock)
    jeng = JEngine(JL, jp, jcfg, **kw)
    jres = _play(jeng, JRequest, JOverloaded, script, clock)
    (tout, trefused, tprobes), (jout, jrefused, jprobes) = tres, jres
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        t, j = tout[rid], jout[rid]
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.finish_reason, t.shed_reason, t.retry_after_s,
                t.preemptions, t.prompt_len) == (
            j.finish_reason, j.shed_reason, j.retry_after_s,
            j.preemptions, j.prompt_len), rid
    assert trefused == jrefused
    assert tprobes == jprobes
    assert teng.stats.as_dict() == jeng.stats.as_dict()
    # token contract: generated - discarded == emitted
    st = teng.stats
    assert st.tokens_generated - st.tokens_discarded == sum(
        len(o.tokens) for o in tout.values())
    return tout, trefused, teng


def _sub(rid, n=5, new=4, **kw):
    return ("sub", rid, n, new, kw)


_ONE = dict(num_slots=1, max_len=32, page_size=4, decode_chunk=2)
_STARVED = dict(num_slots=2, max_len=16, page_size=4, num_pages=5,
                decode_chunk=2)


def test_bounded_queue_sheds_typed_with_retry_hint(tiny, clock):
    out, refused, eng = _both(
        tiny, clock, [_sub(0, new=8), ("step",), _sub(1), _sub(2), _sub(3)],
        max_queue=2, **_ONE)
    (hint, reason), = refused.values()
    assert list(refused) == [3] and hint >= 1.0 and "queue full" in reason
    assert eng.stats.shed == 1 and sorted(out) == [0, 1, 2]
    assert issubclass(EngineOverloaded, RequestRejected)


def test_high_priority_displaces_lowest(tiny, clock):
    out, refused, eng = _both(
        tiny, clock, [_sub(0, new=8), ("step",), _sub(1, priority=1),
                      _sub(2, priority=0), _sub(3, priority=5)],
        max_queue=2, priority_admission=True, **_ONE)
    assert {r: o.finish_reason for r, o in out.items()} == {
        0: "completed", 1: "completed", 2: "shed", 3: "completed"}
    assert out[2].tokens.size == 0 and out[2].retry_after_s > 0
    assert "displaced" in out[2].shed_reason and not refused
    assert eng.stats.completed == 3 and eng.stats.shed == 1


def test_equal_priority_never_displaced(tiny, clock):
    out, refused, _ = _both(
        tiny, clock, [_sub(0, new=8), ("step",), _sub(1, priority=2),
                      _sub(2, priority=2)],
        max_queue=1, priority_admission=True, **_ONE)
    assert list(refused) == [2] and sorted(out) == [0, 1]


def test_displacement_never_picks_a_preempted_requeue(tiny, clock):
    """Only a preemption re-queue is queued: the high-priority newcomer is
    shed instead, and the admitted victim completes."""
    out, refused, _ = _both(
        tiny, clock, [_sub(0, new=8), ("step",), _sub(1, new=8),
                      ("until_requeue",), _sub(9, new=2, priority=9)],
        max_queue=1, **_STARVED)
    assert list(refused) == [9]
    assert all(o.finish_reason == "completed" and o.tokens.size == 8
               for o in out.values())
    assert sum(o.preemptions for o in out.values()) >= 1


@pytest.mark.parametrize("shed_queued", [True, False])
def test_drain_sheds_the_queue_and_finishes_live_work(tiny, clock,
                                                      shed_queued):
    script = [_sub(i, new=6) for i in range(5)] + [
        ("step",), ("probe",), ("drain", shed_queued), ("probe",),
        _sub(99)]
    out, refused, eng = _both(tiny, clock, script, num_slots=2, max_len=32,
                              page_size=4, decode_chunk=2)
    assert list(refused) == [99] and "drain" in refused[99][1]
    states = sorted(o.finish_reason for o in out.values())
    assert states == (["completed"] * 2 + ["shed"] * 3 if shed_queued
                      else ["completed"] * 5)
    assert eng.draining and eng.drain_complete
    assert eng.autoscale_payload()["drain_safe"]


def test_begin_drain_is_idempotent(tiny, clock):
    _, _, eng = _both(tiny, clock, [("drain", True), ("drain", True),
                                    ("probe",)], **_ONE)
    assert eng.drain_complete


def test_repeat_drain_never_sheds_a_preempted_requeue(tiny, clock):
    out, _, _ = _both(
        tiny, clock, [_sub(0, new=8), _sub(1, new=8), ("until_requeue",),
                      ("drain", True), ("probe",), ("drain", True),
                      ("probe",)], **_STARVED)
    assert all(o.finish_reason == "completed" and o.tokens.size == 8
               for o in out.values())


def test_drain_safe_counts_a_done_unretired_slot(tiny, clock):
    """A request done at its prefill token sits in its slot until the next
    step's retirement: not drain-safe until then."""
    _, _, eng = _both(tiny, clock, [_sub(0, new=1), ("step",), ("probe",)],
                      **_ONE)
    assert eng.outputs[0].finish_reason == "completed"


@pytest.mark.parametrize("bad", [-1.0, 0.0, float("nan"), "soon", 10 ** 400])
def test_deadline_validation_typed(tiny, bad):
    jcfg, jp, tcfg, tp = tiny
    teng = ServingEngine(TL, tp, tcfg, device="cpu", **_ONE)
    jeng = JEngine(JL, jp, jcfg, **_ONE)
    for eng, cls, rej in ((teng, Request, RequestRejected),
                          (jeng, JRequest, JRejected)):
        with pytest.raises(rej, match="deadline"):
            eng.submit(cls(rid=0, prompt=_prompt(0, 4), max_new_tokens=2,
                           deadline_s=bad))
        assert not eng.queue and eng.stats.shed == 0


def test_expires_in_the_queue(tiny, clock):
    out, _, eng = _both(
        tiny, clock, [_sub(0, new=10), ("step",), _sub(1, deadline_s=1e-4),
                      ("tick", 0.01)], **_ONE)
    assert out[1].finish_reason == "expired" and out[1].tokens.size == 0
    assert out[1].ttft_s is None and eng.stats.expired == 1


def test_running_eviction_delivers_partial_tokens(tiny, clock):
    out, _, eng = _both(
        tiny, clock, [_sub(0, new=40, deadline_s=0.05), ("step",),
                      ("tick", 0.03), ("step",), ("tick", 0.03)],
        num_slots=1, max_len=64, page_size=4, decode_chunk=2)
    assert out[0].finish_reason == "expired"
    assert 0 < out[0].tokens.size < 40 and out[0].ttft_s is not None
    assert eng.cache.alloc.free_pages == eng.cache.num_pages


def test_eviction_frees_pages_beside_the_prefix_cache(tiny, clock):
    """With the prefix cache on, an evicted request's pages are freed and
    nothing enters the radix, while a completed one seeds it."""
    shared = [_sub(0, n=9, new=3, pseed=7), ("run",),
              _sub(1, n=9, new=30, pseed=7, deadline_s=0.05), ("step",),
              ("tick", 0.1), _sub(2, n=9, new=3, pseed=7)]
    out, _, eng = _both(tiny, clock, shared, prefix_cache=True,
                        num_slots=2, max_len=48, page_size=4,
                        decode_chunk=2)
    assert out[1].finish_reason == "expired"
    assert eng.stats.prefix_hits >= 1


def test_done_slot_past_deadline_retires_completed(tiny, clock):
    out, _, _ = _both(
        tiny, clock, [_sub(0, new=2, deadline_s=0.02), ("step",),
                      ("tick", 0.04)],
        num_slots=1, max_len=32, page_size=4, decode_chunk=4)
    assert out[0].finish_reason == "completed" and out[0].tokens.size == 2


def test_mixed_overload_under_deadlines(tiny, clock):
    """Priority admission, a bounded queue, preemption and deadlines at
    once on a starved pool: eight mixed-priority submissions, two batches
    of ticks; every rid ends in exactly one state."""
    script = []
    for i in range(8):
        kw = {"priority": (i * 5) % 3}
        if i % 3 == 0:
            kw["deadline_s"] = 0.02 + 0.01 * i
        script.append(_sub(i, n=4 + i % 4, new=3 + (i % 4) * 2, **kw))
        if i in (2, 5):
            script += [("step",), ("tick", 0.015)]
    out, refused, eng = _both(tiny, clock, script, max_queue=3,
                              priority_admission=True, num_slots=2,
                              max_len=24, page_size=4, num_pages=7,
                              decode_chunk=2)
    assert sorted(set(out) | set(refused)) == list(range(8))
    assert not set(out) & set(refused)
    st = eng.stats
    assert st.expired == sum(o.finish_reason == "expired"
                             for o in out.values())
    assert st.shed == len(refused) + sum(o.finish_reason == "shed"
                                         for o in out.values())


def test_negative_queue_means_unbounded(tiny, clock):
    jcfg, jp, tcfg, tp = tiny
    assert ServingEngine(TL, tp, tcfg, device="cpu", max_queue=-5,
                         **_ONE)._max_queue == 0
    saved = TF.flag_value("serving_max_queue")
    try:
        paddle_tpu_torch.set_flags({"FLAGS_serving_max_queue": -3})
        assert ServingEngine(TL, tp, tcfg, device="cpu",
                             **_ONE)._max_queue == 0
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_serving_max_queue": saved})
    out, refused, _ = _both(tiny, clock, [_sub(i, new=2) for i in range(6)],
                            max_queue=-5, tenant_inflight_cap=-1,
                            num_slots=2, max_len=32, page_size=4,
                            decode_chunk=2)
    assert len(out) == 6 and not refused
    assert all(o.finish_reason == "completed" for o in out.values())


def test_options_off_never_shed(tiny, clock):
    out, refused, eng = _both(tiny, clock,
                              [_sub(i, new=2) for i in range(12)], **_ONE)
    assert len(out) == 12 and not refused and eng.stats.shed == 0


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
def test_kv_dtype_pools_match_the_reference(tiny, clock, kv_dtype):
    """A bfloat16 and a float32 pool under the float32 model, through
    queueing and preemption: the tokens equal the JAX engine's with the
    same ``kv_dtype``, and the pool holds the dtype asked for."""
    script = [_sub(i, n=3 + i, new=4 + i % 3) for i in range(5)]
    _, _, eng = _both(tiny, clock, script, kv_dtype=kv_dtype, **_STARVED)
    assert eng.cache.pool["k"].dtype == kv_dtype == eng.kv_dtype
    assert eng.stats.preempted >= 1


def test_kv_dtype_refuses_a_type_the_kernel_does_not_take(tiny):
    _, _, tcfg, tp = tiny
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(TL, tp, tcfg, device="cpu", kv_dtype=torch.float64,
                      **_ONE)


@pytest.mark.parametrize("qdt,pdt", [("float32", "bfloat16"),
                                     ("float32", "float16"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", "float16")])
def test_plain_decode_matches_the_pallas_kernel_on_mixed_pages(qdt, pdt):
    """The plain version (the CPU path the engine parity above runs)
    against the reference's Pallas kernel in interpret mode on q and pages
    of different types. The kernel rounds p to a 2-byte page type before
    P.V (the plain version keeps float32), so the tolerance is that
    rounding's bound, the page type's unit roundoff of max |v| (bf16
    2^-8, float16 2^-11, float32 pages 0), plus the output's own (bf16 q:
    2e-2)."""
    rng = np.random.default_rng(5)
    B, nh, kv, hd, ps, P, maxp = 3, 4, 2, 32, 8, 14, 4
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    k = rng.standard_normal((P, kv, ps, hd)).astype(np.float32)
    v = rng.standard_normal((P, kv, ps, hd)).astype(np.float32)
    bt = rng.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    ln = np.array([0, 13, 32], np.int32)
    jq = jnp.asarray(q, getattr(jnp, qdt))
    jk, jv = (jnp.asarray(a, getattr(jnp, pdt)) for a in (k, v))
    kern = JPA.ragged_paged_attention(jq, jk, jv, jnp.asarray(bt),
                                      jnp.asarray(ln), interpret=True)
    tq = torch.as_tensor(np.array(jq.astype(jnp.float32))).to(
        getattr(torch, qdt))
    tk, tv = (torch.as_tensor(np.array(a.astype(jnp.float32))).to(
        getattr(torch, pdt)) for a in (jk, jv))
    got = TPA.ragged_paged_attention(tq, tk, tv, torch.as_tensor(bt),
                                     torch.as_tensor(ln))
    assert got.dtype == getattr(torch, qdt)
    vmax = float(tv.float().abs().max())
    unit = {"float32": 0.0, "bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
    tol = (2e-2 if qdt == "bfloat16" else 1e-5) + unit[pdt] * vmax
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(kern.astype(jnp.float32)),
                               atol=tol, rtol=0)
    assert torch.all(got[0] == 0)


def _chip_smoke():
    """``chip_smoke.py`` at the repo root, imported by path."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_overload",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_overload_trace_replay_matches_the_reference(tiny, clock):
    """``chip_smoke``'s ``[overload_serve]`` schedule on both engines: the
    JAX ``serving_trace_replay`` rung's trace and burst episode at the
    serving lengths, 8 slots and a queue of 16 with priority admission,
    one step per ``OVERLOAD_DT`` of the fake clock, then the drain. Every
    observable is equal, and sheds at submit, a displacement, expiries in
    the queue and in a slot and sheds by the drain all happen, as the card
    run asserts."""
    C = _chip_smoke()
    timed, burst = C.overload_trace_requests(256)
    steps = [("step",), ("tick", C.OVERLOAD_DT)]
    script, vnow, i, pending = [], 0.0, 0, list(burst)

    def sub(r):
        return _sub(r.rid, n=len(r.prompt), new=r.max_new_tokens,
                    tenant=r.tenant, priority=r.priority,
                    deadline_s=r.deadline_s)

    while i < len(timed) or pending:
        if pending and C.OVERLOAD_BURST_AT <= vnow:
            script += [sub(r) for r in pending]
            pending = []
        while i < len(timed) and timed[i][0] <= vnow:
            script.append(sub(timed[i][1]))
            i += 1
        script += steps
        vnow += C.OVERLOAD_DT
    script += [("drain", True)] + steps * 40
    out, refused, eng = _both(tiny, clock, script, num_slots=8, max_len=2048,
                              page_size=16, priority_admission=True,
                              max_queue=16)
    assert sorted(set(out) | set(refused)) == sorted(
        [r.rid for _, r in timed] + [r.rid for r in burst])
    expired = [o for o in out.values() if o.finish_reason == "expired"]
    why = [o.shed_reason or "" for o in out.values()]
    assert refused and eng.stats.expired == len(expired)
    assert any(w.startswith("displaced") for w in why)
    assert any("draining" in w for w in why)
    assert any(len(o.tokens) == 0 for o in expired)
    assert any(len(o.tokens) > 0 for o in expired)
