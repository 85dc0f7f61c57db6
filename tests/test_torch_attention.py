"""Port parity: attention functionals and the flash forward's plain version.

The same inputs, drawn with numpy from a seed, go through the JAX
reference (``flash_attention`` in Pallas interpret mode, and
``sdpa_reference``) and through the port's plain version, which is what
the port's flash wrapper runs for CPU tensors. Tolerances: float32
``atol=1e-5`` (summation order only), bfloat16 ``atol=2e-2`` (the two
frameworks round the bf16 probabilities at different points).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import attention as JATT
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.kernels import flash_attention as TFA
from paddle_tpu_torch.nn.functional import attention as TATT

# the JAX package's kernels/__init__ rebinds the name flash_attention to
# the function, so reach the module itself through the import system
JFA = importlib.import_module("paddle_tpu.kernels.flash_attention")

_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, sq, sk, H, KVH, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, sq, H, D)).astype(np.float32),
            rng.normal(size=(B, sk, KVH, D)).astype(np.float32),
            rng.normal(size=(B, sk, KVH, D)).astype(np.float32))


def _jax(a, dt):
    return jnp.asarray(a, _JDT[dt])


def _torch(a, dt):
    return torch.as_tensor(a).to(_TDT[dt])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# (sq, sk, causal): square causal and non-causal, and a bottom-right
# aligned causal case with more keys than queries; GQA 4 q / 2 kv heads
_SHAPES = [(32, 32, True), (32, 32, False), (16, 32, True)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal", _SHAPES)
def test_flash_ref_matches_jax_flash_interpret(dt, sq, sk, causal):
    q, k, v = _qkv(0, 2, sq, sk, 4, 2, 32)
    want = JFA.flash_attention(_jax(q, dt), _jax(k, dt), _jax(v, dt),
                               causal=causal, interpret=True)
    got = TFA.flash_attention_ref(_torch(q, dt), _torch(k, dt),
                                  _torch(v, dt), causal=causal)[0]
    assert got.dtype == _TDT[dt] and tuple(got.shape) == (2, sq, 4, 32)
    np.testing.assert_allclose(_np(got), _np(want), atol=_TOL[dt], rtol=0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal", _SHAPES)
def test_flash_ref_matches_jax_sdpa_reference(dt, sq, sk, causal):
    q, k, v = _qkv(1, 2, sq, sk, 4, 2, 16)
    want = JATT.sdpa_reference(_jax(q, dt), _jax(k, dt), _jax(v, dt),
                               causal=causal)
    tq, tk, tv = _torch(q, dt), _torch(k, dt), _torch(v, dt)
    got = TFA.flash_attention_ref(tq, tk, tv, causal=causal)[0]
    np.testing.assert_allclose(_np(got), _np(want), atol=_TOL[dt], rtol=0)
    # the port's own sdpa_reference is the same math
    got2 = TATT.sdpa_reference(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got2), _np(want), atol=_TOL[dt], rtol=0)


def test_flash_ref_lse_is_logsumexp_of_scaled_scores():
    """lse (what the backward will read) = log sum exp(q.k * scale) over
    the keys a row sees; float32 atol=1e-5."""
    q, k, v = _qkv(2, 1, 8, 8, 2, 1, 16)
    _, lse = TFA.flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                                     torch.as_tensor(v), causal=True)
    s = np.einsum("qhd,khd->hqk", q[0], np.repeat(k[0], 2, axis=1)) / 4.0
    s = np.where(np.tril(np.ones((8, 8), bool))[None], s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse[0].numpy(), want, atol=1e-5, rtol=0)


def test_flash_ref_fully_masked_row_is_zero():
    """More queries than keys, causal: the first rows see no key. The
    kernel (and so its plain version) gives a zero row and lse -inf."""
    q, k, v = _qkv(3, 1, 8, 4, 2, 2, 16)
    out, lse = TFA.flash_attention_ref(torch.as_tensor(q),
                                       torch.as_tensor(k),
                                       torch.as_tensor(v), causal=True)
    assert torch.all(out[0, :4] == 0) and torch.isinf(lse[0, :, :4]).all()
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_row", [False, True])
def test_rope_raw_matches_jax(dt, per_row):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    jc, js = JATT.rope_tables(6, 16, theta=500000.0)
    tc, ts = TATT.rope_tables(6, 16, theta=500000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    if per_row:        # gathered at explicit positions: [B, S, D/2]
        pos = rng.integers(0, 6, (2, 6))
        jc, js = jc[pos], js[pos]
        tc, ts = tc[torch.as_tensor(pos)], ts[torch.as_tensor(pos)]
    want = JATT.rope_raw(_jax(x, dt), jc, js)
    got = TATT.rope_raw(_torch(x, dt), tc, ts)
    assert got.dtype == _TDT[dt]
    np.testing.assert_allclose(_np(got), _np(want),
                               atol=1e-6 if dt == "float32" else 1e-2)


def test_sdpa_raw_on_cpu_takes_plain_version():
    q, k, v = _qkv(5, 1, 8, 8, 4, 2, 16)
    TK.reset_dispatch_stats()
    out = TATT.sdpa_raw(torch.as_tensor(q), torch.as_tensor(k),
                        torch.as_tensor(v), is_causal=True)
    stats = TK.dispatch_stats()
    assert stats["flash_ref"] == 1 and stats["flash"] == 0
    want = JATT.sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


def test_flash_supported_guard():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    assert TFA.supported(q, k, k)
    assert not TFA.supported(q, torch.zeros(1, 8, 3, 32),
                             torch.zeros(1, 8, 3, 32))     # H % KVH
    for d in (24, 72, 256):                                # D % 8, <= 256
        assert TFA.supported(torch.zeros(1, 8, 4, d), torch.zeros(1, 8, 2, d),
                             torch.zeros(1, 8, 2, d)), d
    for d in (4, 12, 264):                                 # D % 8, > 256
        assert not TFA.supported(torch.zeros(1, 8, 4, d),
                                 torch.zeros(1, 8, 2, d),
                                 torch.zeros(1, 8, 2, d)), d
    assert not TFA.supported(q.half(), k.half(), k.half())
