"""Port parity: the load generator (``paddle_tpu_torch/loadgen``, a copy of
``paddle_tpu/loadgen/traces.py`` plus ``replay._trace_prompt``, kept in
``traces.py``; numpy only).

Over several seeds and tenant mixes (shared prefixes, priorities,
deadlines, a burst window) the port's ``generate_trace`` must give the
JAX package's trace byte for byte (the canonical JSON, so the same
``sha256``), and ``_trace_prompt`` / ``prompt_tokens`` /
``tenant_prefix_tokens`` the same token bytes.
"""
import numpy as np
import pytest

from paddle_tpu.loadgen import replay as JR
from paddle_tpu.loadgen import traces as JT
from paddle_tpu_torch import loadgen as TG
from paddle_tpu_torch.loadgen import traces as TT

_MIXES = {
    "single": dict(),
    "prefixed": dict(tenants=[("sys", 2.0, 0, None, 8), ("raw", 1.0, 0,
                                                         None, 0)],
                     prompt_len=(10, 24), max_new_tokens=(3, 6)),
    "priorities": dict(tenants=[("gold", 1.0, 2, 0.5, 0),
                                ("free", 3.0, 0, None, 4)],
                       burst=(0.2, 0.1, 4.0), alpha=1.5),
    "serving_rung": dict(tenants=[("assistant", 3.0, 0, None, 512),
                                  ("adhoc", 1.0, 0, None, 0)],
                         prompt_len=(600, 1024), max_new_tokens=(32, 64),
                         alpha=1.3, rate=28.0, duration_s=1.0),
}


def _trace(mod, seed, mix):
    kw = dict(_MIXES[mix])
    tenants = [mod.TenantSpec(n, share=s, priority=p, deadline_s=d,
                              prefix_len=x)
               for n, s, p, d, x in kw.pop("tenants", [])]
    kw.setdefault("duration_s", 0.5)
    kw.setdefault("rate", 24.0)
    return mod.generate_trace(seed, tenants=tenants, **kw)


@pytest.mark.parametrize("mix", sorted(_MIXES))
@pytest.mark.parametrize("seed", [0, 1717, 4242])
def test_generate_trace_is_the_reference_byte_for_byte(seed, mix):
    got, want = _trace(TT, seed, mix), _trace(JT, seed, mix)
    assert got.to_json() == want.to_json()
    assert got.sha256() == want.sha256()
    assert TT.ArrivalTrace.from_json(want.to_json()).to_json() \
        == want.to_json()
    assert got.offered_tokens() == want.offered_tokens()
    assert got.tenants() == want.tenants()


def test_golden_pin():
    """The reference's own v2 pin (``tests/test_prefix_cache.py``)."""
    tr = _trace(TT, 4242, "prefixed")
    assert tr.version == 2
    assert tr.sha256() == ("b3772890d45a8ced90637c82c8da9d4a"
                           "19e318ffec2646aec578f890ba5bfc2d")


@pytest.mark.parametrize("mix", ["prefixed", "serving_rung"])
@pytest.mark.parametrize("seed", [0, 1717])
def test_trace_prompts_are_the_reference_bytes(seed, mix):
    vocab = 128256 if mix == "serving_rung" else 64
    for r in _trace(TT, seed, mix).requests:
        got = TT._trace_prompt(seed, r.rid, r.prompt_len, vocab, r.tenant,
                               r.prefix_len)
        want = JR._trace_prompt(seed, r.rid, r.prompt_len, vocab, r.tenant,
                                r.prefix_len)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert len(got) == r.prompt_len


def test_token_streams_and_length_traces():
    for seed in (0, 7, 1717):
        np.testing.assert_array_equal(TT.prompt_tokens(seed, 3, 17, 1000),
                                      JT.prompt_tokens(seed, 3, 17, 1000))
        np.testing.assert_array_equal(
            TT.tenant_prefix_tokens(seed, "sys", 9, 1000),
            JT.tenant_prefix_tokens(seed, "sys", 9, 1000))
        assert TT.heavy_tailed_lengths(2048, 24, seed) \
            == JT.heavy_tailed_lengths(2048, 24, seed)
        assert TT.mixed_length_trace((64, 128), (8, 32), 10, seed) \
            == JT.mixed_length_trace((64, 128), (8, 32), 10, seed)
    assert TG.generate_trace is TT.generate_trace
    assert not hasattr(TG, "_trace_prompt")
    with pytest.raises(ValueError):
        TT.generate_trace(0, rate=0.0)
