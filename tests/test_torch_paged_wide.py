"""Port parity: the paged decode kernel's whole domain (ROADMAP B1b),
head dims above 128 and large GQA groups, for both arms.

The Pallas kernel takes any ``head_dim % 8 == 0`` up to 256 and any group
``num_heads / kv_heads``; the port's CUDA entries take the same domain.
On the CPU the wrapper runs the plain version ``paged_attention_ref``,
held here to JAX's ``ragged_paged_attention`` in interpret mode and to
its ``paged_attention_ref`` on one set of numpy inputs, at head dims 136
and 256 and groups 16 and 32, both arms, with the split-then-combine
model of the kernel (``test_torch_paged._split_combine``) at the chunk
``decode_split_plan`` gives. Tolerances: float32 ``atol=2e-5``
(summation order over up to 256 dims), bfloat16 ``atol=2e-2`` (one bf16
rounding of outputs of size ~1).

The serving engine at a ``llama_tiny`` of head dim 256 (hidden 512, 2
query heads over 1 kv head) and at a group of 16 gives JAX's greedy
tokens in float32, through a preemption, with full-precision and with
int8 pages.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.kernels import paged_attention as TPA
from paddle_tpu_torch.models import llama as TL

from test_torch_paged import _split_combine

JPA = importlib.import_module("paddle_tpu.kernels.paged_attention")

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (num_heads, kv_heads, head_dim): D 136 (rows of 17 lanes, int8 rows
# not a multiple of 16 bytes), D 256 (a row group of a whole warp), and
# groups 16 and 32 (two and four blocks of a kv head's heads)
SHAPES = [(4, 2, 136), (4, 2, 256), (32, 2, 64), (32, 1, 128),
          (32, 1, 256)]


def _wide_case(nh, kv, hd, quant, *, ps=32, maxp=4, B=4, seed=0):
    """Lengths: a partial page, an empty slot, a page boundary and the
    full table; entries past each sequence's pages hold garbage and the
    sentinel. int8: codes and positive scales, two pages never written
    (scale 0)."""
    rng = np.random.default_rng(seed)
    P = 3 * maxp
    q = rng.normal(size=(B, nh, hd)).astype(np.float32)
    if quant:
        kp = rng.integers(-127, 128, (P, kv, ps, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, kv, ps, hd)).astype(np.int8)
        ks = rng.uniform(0.001, 0.03, (P, kv)).astype(np.float32)
        vs = rng.uniform(0.001, 0.03, (P, kv)).astype(np.float32)
        ks[[2, 7]] = vs[[2, 7]] = 0.0
        scales = (ks, vs)
    else:
        kp = rng.normal(size=(P, kv, ps, hd)).astype(np.float32)
        vp = rng.normal(size=(P, kv, ps, hd)).astype(np.float32)
        scales = None
    lengths = np.array([ps + 5, 0, 2 * ps, maxp * ps][:B], np.int32)
    bt = rng.integers(-5, 3 * P, (B, maxp)).astype(np.int32)
    bt[:, -1] = P
    for b, n in enumerate(lengths):
        used = -(-int(n) // ps)
        bt[b, :used] = rng.permutation(P)[:used]
    return q, kp, vp, bt, lengths, scales


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,kv,hd", SHAPES)
def test_wide_decode_matches_jax_kernel_interpret_and_ref(nh, kv, hd, dt,
                                                          quant):
    q, kp, vp, bt, ln, scales = _wide_case(nh, kv, hd, quant)
    pdt = None if quant else dt
    jq = jnp.asarray(q, _JDT[dt])
    tq = torch.as_tensor(q).to(_TDT[dt])
    jk, jv = ((jnp.asarray(kp), jnp.asarray(vp)) if quant else
              (jnp.asarray(kp, _JDT[pdt]), jnp.asarray(vp, _JDT[pdt])))
    tk, tv = ((torch.as_tensor(kp), torch.as_tensor(vp)) if quant else
              (torch.as_tensor(kp).to(_TDT[pdt]),
               torch.as_tensor(vp).to(_TDT[pdt])))
    jkw = tkw = {}
    if quant:
        jkw = dict(k_scales=jnp.asarray(scales[0]),
                   v_scales=jnp.asarray(scales[1]))
        tkw = dict(k_scales=torch.as_tensor(scales[0]),
                   v_scales=torch.as_tensor(scales[1]))
    tbt, tln = torch.as_tensor(bt), torch.as_tensor(ln)
    TK.reset_dispatch_stats()
    got = TPA.ragged_paged_attention(tq, tk, tv, tbt, tln, **tkw)
    arm = "paged_quant" if quant else "paged"
    assert TK.dispatch_stats()[arm + "_ref"] == 1
    assert TPA.supported(tq, tk, tbt, quant=quant)
    kern = JPA.ragged_paged_attention(jq, jk, jv, jnp.asarray(bt),
                                      jnp.asarray(ln), interpret=True,
                                      **jkw)
    ref = JPA.paged_attention_ref(jq, jk, jv, jnp.asarray(bt),
                                  jnp.asarray(ln), **jkw)
    assert got.dtype == _TDT[dt] and got.shape == (4, nh, hd)
    assert torch.isfinite(got.float()).all() and torch.all(got[1] == 0)
    for other in (kern, ref):
        np.testing.assert_allclose(_np(got), _np(other), atol=_TOL[dt],
                                   rtol=0)
    # the kernel's split-then-combine at the plan's chunk
    pps, splits = TPA.decode_split_plan(4, kv, 32, bt.shape[1])
    model = _split_combine(tq, tk, tv, tbt, tln, pps, **tkw)
    np.testing.assert_allclose(_np(model), _np(kern), atol=_TOL[dt],
                               rtol=0)


@pytest.mark.parametrize("pdt", ["bfloat16", "float16"])
@pytest.mark.parametrize("nh,kv,hd", [(4, 2, 256), (32, 1, 128)])
def test_wide_mixed_pairs_round_p_as_the_pallas_kernel(nh, kv, hd, pdt):
    """float32 q over 2-byte pages at D 256 and group 32: the Pallas
    kernel rounds p to the page type before P.V; ``chip_smoke``'s
    ``paged_ref_round_p`` (the card's yardstick for the mixed pairs)
    matches it on sequences of at most one page within the page type's
    unit roundoff of max |v| (bf16 2^-8, float16 2^-11): XLA's and
    torch's float32 exp may differ by an ulp, which can move a rounded p
    by one unit of the page type (seen at D 128, float16)."""
    from test_torch_paged import _chip_smoke
    rng = np.random.default_rng(3)
    B, ps, P, maxp = 4, 32, 6, 2
    q = rng.normal(size=(B, nh, hd)).astype(np.float32)
    kp = rng.normal(size=(P, kv, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(P, kv, ps, hd)).astype(np.float32)
    ln = np.array([13, 0, ps, 27], np.int32)
    bt = rng.integers(-5, 3 * P, (B, maxp)).astype(np.int32)
    bt[:, 0] = rng.permutation(P)[:B]
    kern = np.asarray(JPA.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp, getattr(jnp, pdt)),
        jnp.asarray(vp, getattr(jnp, pdt)), jnp.asarray(bt),
        jnp.asarray(ln), interpret=True))
    args = (torch.as_tensor(q), torch.as_tensor(kp).to(getattr(torch, pdt)),
            torch.as_tensor(vp).to(getattr(torch, pdt)), torch.as_tensor(bt),
            torch.as_tensor(ln))
    got = _chip_smoke().paged_ref_round_p(torch, *args)
    unit = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}[pdt]
    np.testing.assert_allclose(got.numpy(), kern,
                               atol=unit * float(np.abs(vp).max()), rtol=0)


_ENGINE = dict(num_slots=2, max_len=16, page_size=4, num_pages=5,
               decode_chunk=2)

# head dim 256 (hidden 512 over 2 heads, 1 kv head) and a group of 16
ENGINE_CFGS = {"hd256": dict(hidden_size=512, num_attention_heads=2,
                             num_key_value_heads=1),
               "group16": dict(hidden_size=256, num_attention_heads=16,
                               num_key_value_heads=1)}


@pytest.fixture(scope="module", params=sorted(ENGINE_CFGS))
def wide_tiny(request):
    kw = ENGINE_CFGS[request.param]
    jcfg = JL.llama_tiny(**kw)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return request.param, jcfg, jp, TL.llama_tiny(**kw), tp


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_greedy_tokens_match_jax_at_wide_heads(wide_tiny, kv_quant):
    """Greedy tokens of the port's engine (plain versions on the CPU)
    equal the JAX engine's, token for token in float32, through a
    preemption; page size 4 on both (int8 pages too: the port's int8
    arm takes any page size and the reference's plain path does)."""
    name, jcfg, jp, tcfg, tp = wide_tiny
    assert tcfg.head_dim == jcfg.head_dim
    rng = np.random.default_rng(5)
    trace = [(rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32), m)
             for n, m in zip((4, 7, 3, 5, 6), (8, 5, 9, 6, 4))]

    def serve(engine_cls, req_cls, family, params, cfg, **kw):
        eng = engine_cls(family, params, cfg, kv_quant=kv_quant, **kw,
                         **_ENGINE)
        out = eng.run([req_cls(rid=i, prompt=p, max_new_tokens=m)
                       for i, (p, m) in enumerate(trace)])
        assert eng.cache.alloc.used_pages == 0
        return eng, [out[i].tokens for i in range(len(trace))]

    jeng, want = serve(JEngine, JRequest, JL, jp, jcfg)
    TK.reset_dispatch_stats()
    eng, got = serve(ServingEngine, Request, TL, tp, tcfg, device="cpu")
    stats = TK.dispatch_stats()
    arm = "paged_quant_ref" if kv_quant else "paged_ref"
    assert stats[arm] > 0
    assert eng.stats.preempted >= 1
    assert eng.stats.preempted == jeng.stats.preempted
    for (_, m), a, b in zip(trace, got, want):
        np.testing.assert_array_equal(a, b)
        assert len(a) == m
