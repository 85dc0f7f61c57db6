"""Port parity: the flash attention backward's plain version and the
autograd wrapper around the flash kernels.

The same inputs, drawn with numpy from a seed, go through ``jax.vjp`` of
the JAX package's Pallas ``flash_attention`` in interpret mode and
through the port's ``flash_attention_bwd_ref``, which is what the port's
backward wrapper runs for CPU tensors. Tolerances: float32 ``atol=1e-5``
(summation order only); bfloat16 ``2e-2 * max |ref|`` (the reference
rounds p and ds to bfloat16 before its products, the port keeps them in
float32).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.kernels import flash_attention as TFA
from paddle_tpu_torch.nn.functional import attention as TATT

JFA = importlib.import_module("paddle_tpu.kernels.flash_attention")

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (sq, sk, causal), GQA 4 query / 2 kv heads, head_dim 32
_SHAPES = [(32, 32, True), (32, 32, False), (16, 32, True)]


def _inputs(seed, sq, sk, H=4, KVH=2, D=32, B=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, sq, H, D)).astype(np.float32),
            rng.normal(size=(B, sk, KVH, D)).astype(np.float32),
            rng.normal(size=(B, sk, KVH, D)).astype(np.float32),
            rng.normal(size=(B, sq, H, D)).astype(np.float32))


def _jax_grads(q, k, v, dout, dt, causal):
    def f(q, k, v):
        return JFA.flash_attention(q, k, v, causal=causal, interpret=True,
                                   block_q=16, block_k=16)
    out, vjp = jax.vjp(f, *(jnp.asarray(a, _JDT[dt]) for a in (q, k, v)))
    return [np.asarray(g, np.float32)
            for g in vjp(jnp.asarray(dout, _JDT[dt]))]


def _autograd_ref_grads(q, k, v, dout, causal):
    """torch autograd through the forward's plain version (float32)."""
    ts = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    out = TFA.flash_attention_ref(*ts, causal=causal)[0]
    return torch.autograd.grad(out, ts, torch.as_tensor(dout))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal", _SHAPES)
def test_bwd_ref_matches_jax_flash_vjp(dt, sq, sk, causal):
    q, k, v, dout = _inputs(0, sq, sk)
    want = _jax_grads(q, k, v, dout, dt, causal)
    tq, tk, tv, tg = (torch.as_tensor(a).to(_TDT[dt])
                      for a in (q, k, v, dout))
    out, lse = TFA.flash_attention_ref(tq, tk, tv, causal=causal)
    got = TFA.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg,
                                      causal=causal)
    for g, w, like in zip(got, want, (tq, tk, tv)):
        assert g.dtype == like.dtype and g.shape == like.shape
        atol = 1e-5 if dt == "float32" else 2e-2 * np.abs(w).max()
        np.testing.assert_allclose(g.float().numpy(), w, atol=atol, rtol=0)


@pytest.mark.parametrize("sq,sk,causal", _SHAPES)
def test_bwd_ref_matches_autograd_of_forward_ref(sq, sk, causal):
    q, k, v, dout = _inputs(1, sq, sk)
    want = _autograd_ref_grads(q, k, v, dout, causal)
    tq, tk, tv, tg = (torch.as_tensor(a) for a in (q, k, v, dout))
    out, lse = TFA.flash_attention_ref(tq, tk, tv, causal=causal)
    got = TFA.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg,
                                      causal=causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sq,sk,causal", _SHAPES)
def test_wrapper_gradients_match_autograd_and_jax(sq, sk, causal):
    """Attention has a gradient whatever the device: ``flash_attention``
    with inputs that require grad goes through
    ``_FlashAttention``, whose backward is the backward wrapper, and its
    gradients equal autograd through the plain forward and the JAX
    VJP."""
    q, k, v, dout = _inputs(2, sq, sk)
    ts = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    TK.reset_dispatch_stats()
    out = TFA.flash_attention(*ts, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ts, torch.as_tensor(dout))
    stats = TK.dispatch_stats()
    assert stats["flash_ref"] == 1 and stats["flash_bwd_ref"] == 1
    assert stats["flash"] == 0 and stats["flash_bwd"] == 0
    for g, w in zip(got, _autograd_ref_grads(q, k, v, dout, causal)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    for g, w in zip(got, _jax_grads(q, k, v, dout, "float32", causal)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)


def test_sdpa_raw_gradient_reaches_q_k_v():
    q, k, v, dout = _inputs(3, 16, 16)
    ts = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    (TATT.sdpa_raw(*ts, is_causal=True) * torch.as_tensor(dout)).sum() \
        .backward()
    for t in ts:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().max()) > 0


def test_no_grad_keeps_the_direct_forward():
    """Without a gradient to take, no autograd node and no saved tensors:
    the serving path's launches and memory stay those of the forward
    alone."""
    q, k, v, _ = _inputs(4, 16, 16)
    ts = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    with torch.no_grad():
        assert TFA.flash_attention(*ts, causal=True).grad_fn is None
    plain = [t.detach() for t in ts]
    assert TFA.flash_attention(*plain, causal=True).grad_fn is None


def test_rows_that_see_no_key_get_zero_gradients():
    """Causal with more queries than keys: the first rows see no key, the
    forward gives them a zero row and lse -inf, and the backward exact
    zero dq there and no NaN anywhere (the reference's dense backward
    gives p = 1 on such rows; ROADMAP queue C)."""
    q, k, v, dout = _inputs(5, 24, 16)
    tq, tk, tv, tg = (torch.as_tensor(a) for a in (q, k, v, dout))
    out, lse = TFA.flash_attention_ref(tq, tk, tv, causal=True)
    dq, dk, dv = TFA.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg,
                                             causal=True)
    assert torch.all(dq[:, :8] == 0)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))


def test_bwd_supported_guard():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    assert TFA.supported_bwd(q, k, k)
    for d in (24, 72, 256):                                    # D % 8
        assert TFA.supported_bwd(torch.zeros(1, 8, 4, d),
                                 torch.zeros(1, 8, 2, d),
                                 torch.zeros(1, 8, 2, d)), d
    for d in (4, 12, 264):                                     # D % 8, D
        assert not TFA.supported_bwd(torch.zeros(1, 8, 4, d),
                                     torch.zeros(1, 8, 2, d),
                                     torch.zeros(1, 8, 2, d)), d
    assert not TFA.supported_bwd(torch.zeros(16384, 1, 8, 16),
                                 torch.zeros(16384, 1, 8, 16),
                                 torch.zeros(16384, 1, 8, 16))  # B * H
