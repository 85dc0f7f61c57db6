"""Port parity: the serving engine's admission and preemption policies
(``priority_admission``, ``tenant_inflight_cap``, ``slo_preemption``).

The port's ``ServingEngine(device="cpu")`` and the JAX ``ServingEngine``
serve the same scripted submissions (the reference's own scenarios from
``tests/test_engine.py``, and a mixed overload) on the same carried-over
float32 ``llama_tiny`` (2 layers) weights. Each engine's prefill groups
are recorded by wrapping ``_prefill_group`` on the instance, so the order
of admission is compared group for group; tokens, each request's
preemptions and the engine's counters must be equal too, and every
serve leaves the page allocator's refcounts consistent.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu_torch
from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.inference.engine import RequestRejected
from paddle_tpu_torch.models import llama as TL


@pytest.fixture(scope="module")
def tiny():
    jcfg = JL.llama_tiny(num_hidden_layers=2, dtype=jnp.float32)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(3))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TL.llama_tiny(num_hidden_layers=2), tp


def _prompt(rid, n):
    return np.random.default_rng(rid).integers(0, 256, (n,)).astype(np.int32)


def _serve(eng, req_cls, script):
    """Run ``script`` on ``eng``: ``("step",)`` takes one scheduling step,
    ``(rid, n, new, tenant, priority)`` submits a request of an ``n``-token
    prompt from seed ``rid`` (or of the prompt ``n``, an array). Returns
    the outputs and the prefill groups as lists of rids in the order they
    were admitted."""
    groups = []
    plain = eng._prefill_group

    def recorded(free, group, s_pad):
        groups.append([r.rid for r in group])
        return plain(free, group, s_pad)

    eng._prefill_group = recorded
    for ev in script:
        if ev == ("step",):
            eng.step()
            continue
        rid, n, new, tenant, priority = ev
        prompt = _prompt(rid, n) if np.isscalar(n) else n
        eng.submit(req_cls(rid=rid, prompt=prompt,
                           max_new_tokens=new, tenant=tenant,
                           priority=priority))
    out = eng.run()
    eng.cache.alloc.check_invariants()
    return out, groups


def _both(tiny, script, **kw):
    jcfg, jp, tcfg, tp = tiny
    teng = ServingEngine(TL, tp, tcfg, device="cpu", **kw)
    tout, tgroups = _serve(teng, Request, script)
    jeng = JEngine(JL, jp, jcfg, **kw)
    jout, jgroups = _serve(jeng, JRequest, script)
    assert tgroups == jgroups
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        np.testing.assert_array_equal(tout[rid].tokens, jout[rid].tokens)
        assert tout[rid].preemptions == jout[rid].preemptions
        assert tout[rid].tenant == jout[rid].tenant
    t, j = teng.stats.as_dict(), jeng.stats.as_dict()
    assert {k: t[k] for k in t} == {k: j[k] for k in t}
    return tout, tgroups


_ONE_SLOT = dict(num_slots=1, max_len=32, page_size=4, decode_chunk=2)
_JUMP = [(0, 5, 12, "default", 0), ("step",), (1, 5, 2, "default", 0),
         (2, 5, 2, "default", 3)]


def test_high_priority_jumps_the_queue(tiny):
    """A later high-priority request is admitted before an earlier
    low-priority one while a blocker holds the only slot."""
    _, groups = _both(tiny, _JUMP, priority_admission=True, **_ONE_SLOT)
    assert groups == [[0], [2], [1]]


def test_options_off_stay_fifo(tiny):
    """The same submissions with every option off: priority is carried
    but admission is FIFO, as the reference's."""
    _, groups = _both(tiny, _JUMP, **_ONE_SLOT)
    assert groups == [[0], [1], [2]]


def test_tenant_inflight_cap(tiny):
    """Tenant "a" floods a 2-slot engine; with a cap of 1, tenant "b"'s
    later request joins the first group beside exactly one "a" request,
    and "a"'s others wait for it, one at a time."""
    script = [(i, 5, 10, "a", 0) for i in range(3)] + [(9, 5, 10, "b", 0)]
    _, groups = _both(tiny, script, priority_admission=True,
                      tenant_inflight_cap=1, num_slots=2, max_len=32,
                      page_size=4, decode_chunk=2)
    assert groups == [[0, 9], [1], [2]]


def test_tenant_cap_alone_keeps_fifo(tiny):
    """The cap without priority admission skips a tenant at its cap but
    keeps strict FIFO among the eligible: the higher-priority rid 2 does
    not pass rid 1."""
    script = [(0, 5, 10, "a", 0), ("step",), (1, 5, 2, "b", 0),
              (2, 5, 2, "b", 9), (3, 5, 2, "a", 9)]
    _, groups = _both(tiny, script, tenant_inflight_cap=1, **_ONE_SLOT)
    assert groups.index([1]) < groups.index([2])


def _overcommit(priorities):
    # 2 slots on a 5-page pool: two 5-token prompts (2 pages each) fit,
    # but both growing past 8 KV positions need a third page each and
    # only one exists, which forces a preemption
    return [(i, 5, 8, "default", p) for i, p in enumerate(priorities)]


_OVERCOMMIT = dict(num_slots=2, max_len=16, page_size=4, num_pages=5,
                   decode_chunk=2)


@pytest.mark.parametrize("slo", [False, True])
def test_preemption_victims(tiny, slo):
    """Youngest first by default: the younger high-priority request is the
    victim. With ``slo_preemption`` the older low-priority one is, and
    the high-priority request runs through."""
    out, _ = _both(tiny, _overcommit([0, 2]), slo_preemption=slo,
                   **_OVERCOMMIT)
    victim, spared = (0, 1) if slo else (1, 0)
    assert out[victim].preemptions >= 1 and out[spared].preemptions == 0
    assert all(len(o.tokens) == 8 for o in out.values())


@pytest.mark.parametrize("prefix", [False, True])
def test_mixed_overload_matches_the_reference(tiny, prefix):
    """Priority admission, a tenant cap of 2 and SLO preemption together
    on a starved pool (with and without the prefix cache): three tenants
    of mixed priorities, prompts of 4-13 tokens, two of them sharing a
    prefix. Groups, tokens, preemptions and counters equal JAX's."""
    shared = _prompt(99, 8)
    script = []
    for i in range(8):
        tenant, prio = ("a", "b", "c")[i % 3], (i * 5) % 3
        n = 4 + (i * 3) % 10
        if i in (4, 7):
            n = np.concatenate([shared, _prompt(i, 5)])
        script.append((i, n, 3 + (i % 4) * 2, tenant, prio))
        if i == 2:
            script.append(("step",))
    out, _ = _both(tiny, script, num_slots=3, max_len=24, page_size=4,
                   num_pages=9, decode_chunk=2, priority_admission=True,
                   tenant_inflight_cap=2, slo_preemption=True,
                   prefix_cache=prefix)
    assert sum(o.preemptions for o in out.values()) > 0
    assert len(out) == 8


def test_negative_cap_means_uncapped(tiny):
    """A cap of -1 clamps to 0 (uncapped), from the argument and from the
    flag, and admission proceeds as the reference's."""
    jcfg, jp, tcfg, tp = tiny
    kw = dict(num_slots=2, max_len=32, page_size=4, decode_chunk=2)
    eng = ServingEngine(TL, tp, tcfg, device="cpu", tenant_inflight_cap=-1,
                        **kw)
    assert eng._tenant_cap == 0
    saved = TF.flag_value("serving_tenant_inflight_cap")
    try:
        paddle_tpu_torch.set_flags({"FLAGS_serving_tenant_inflight_cap": -3})
        assert ServingEngine(TL, tp, tcfg, device="cpu",
                             **kw)._tenant_cap == 0
    finally:
        paddle_tpu_torch.set_flags(
            {"FLAGS_serving_tenant_inflight_cap": saved})
    out, groups = _both(tiny, [(i, 5, 2, "a", 0) for i in range(6)],
                        tenant_inflight_cap=-1, **kw)
    assert len(out) == 6 and sum(groups, []) == list(range(6))


@pytest.mark.parametrize("field,value", [("tenant", "x" * 129),
                                         ("priority", 1.5),
                                         ("priority", "high")])
def test_malformed_tenant_or_priority_is_rejected(tiny, field, value):
    _, _, tcfg, tp = tiny
    eng = ServingEngine(TL, tp, tcfg, device="cpu", num_slots=1, max_len=16,
                        page_size=4)
    req = Request(rid=0, prompt=_prompt(0, 4), max_new_tokens=2)
    setattr(req, field, value)
    with pytest.raises(RequestRejected, match=field):
        eng.submit(req)
    assert not eng.queue
