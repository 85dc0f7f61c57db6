"""Port parity: the blockwise cross entropy (``kernels/fused_ce.py``) and
its dispatcher.

The same numpy inputs go through the JAX package's
``fused_cross_entropy`` / ``masked_xent_from_logits`` and the port's.
Loss and both gradients (``dx``, ``dhead``) are held in float32 to
``rtol=1e-5, atol=1e-6`` (summation order only). In bfloat16 both take
the chunk products in float32 and round ``dx`` / ``dhead`` once, to
bfloat16: loss ``rtol=1e-5``, gradients ``8e-3 * max |ref|`` (one bf16
rounding, if the summation order tips it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import kernels as JK
from paddle_tpu.kernels import fused_ce as JCE
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.kernels import fused_ce as TCE


def _case(n=3, s=7, d=16, v=33, seed=0, ignore=False, out_of_range=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, s, d)).astype(np.float32)
    head = (rng.normal(size=(v, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, (n, s)).astype(np.int32)
    if ignore:
        labels[:, ::3] = -100
    if out_of_range:
        labels[0, 1], labels[1, 2] = v, v + 7
    g = rng.normal(size=(n, s)).astype(np.float32)
    return x, head, labels, g


def _jax(fn, x, head, labels, reduction, g):
    def f(x, h):
        out = fn(x, h)
        return out if reduction != "none" else jnp.sum(out * g)
    out = fn(jnp.asarray(x), jnp.asarray(head))
    grads = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    return np.asarray(out), [np.asarray(a) for a in grads]


def _torch(fn, x, head, labels, reduction, g):
    tx = torch.as_tensor(x).requires_grad_()
    th = torch.as_tensor(head).requires_grad_()
    out = fn(tx, th)
    total = out if reduction != "none" else (out * torch.as_tensor(g)).sum()
    grads = torch.autograd.grad(total, (tx, th))
    return out.detach().numpy(), [a.numpy() for a in grads]


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("v,chunk", [(32, 8), (33, 8), (7, 16)])
@pytest.mark.parametrize("labels_kind", ["plain", "ignored", "out_of_range"])
def test_fused_ce_matches_jax(reduction, v, chunk, labels_kind):
    x, head, labels, g = _case(v=v, ignore=labels_kind == "ignored",
                               out_of_range=labels_kind == "out_of_range")
    want = _jax(lambda a, b: JCE.fused_cross_entropy(
        a, b, jnp.asarray(labels), vocab_chunk=chunk, reduction=reduction),
        x, head, labels, reduction, g)
    got = _torch(lambda a, b: TCE.fused_cross_entropy(
        a, b, torch.as_tensor(labels), vocab_chunk=chunk,
        reduction=reduction), x, head, labels, reduction, g)
    _close(got, want)
    if labels_kind != "plain" and reduction == "none":
        invalid = (labels == -100) | (labels < 0) | (labels >= v)
        assert np.all(got[0][invalid] == 0)


def test_fused_ce_bf16_matches_jax():
    x, head, labels, _ = _case(d=64, v=33, seed=1, ignore=True)
    jx, jh = jnp.asarray(x, jnp.bfloat16), jnp.asarray(head, jnp.bfloat16)
    want, jgrads = jax.value_and_grad(
        lambda a, b: JCE.fused_cross_entropy(a, b, jnp.asarray(labels),
                                             vocab_chunk=8),
        argnums=(0, 1))(jx, jh)
    tx = torch.as_tensor(x).bfloat16().requires_grad_()
    th = torch.as_tensor(head).bfloat16().requires_grad_()
    got = TCE.fused_cross_entropy(tx, th, torch.as_tensor(labels),
                                  vocab_chunk=8)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for t, w in ((tx, jgrads[0]), (th, jgrads[1])):
        assert t.grad.dtype == torch.bfloat16
        w = np.asarray(jnp.asarray(w, jnp.float32))
        np.testing.assert_allclose(t.grad.float().numpy(), w, rtol=0,
                                   atol=8e-3 * np.abs(w).max())


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_masked_xent_matches_jax(reduction):
    x, head, labels, g = _case(v=33, ignore=True, out_of_range=True)

    def jfn(a, b):
        logits = jnp.einsum("...d,vd->...v", a, b)
        return JCE.masked_xent_from_logits(logits, jnp.asarray(labels),
                                           reduction=reduction)

    def tfn(a, b):
        return TCE.masked_xent_from_logits(
            a @ b.t(), torch.as_tensor(labels), reduction=reduction)

    _close(_torch(tfn, x, head, labels, reduction, g),
           _jax(jfn, x, head, labels, reduction, g))


def test_invalid_labels_get_zero_gradient():
    """An ignored token's hidden state gets no gradient at all."""
    x, head, labels, _ = _case(v=33, ignore=True)
    tx = torch.as_tensor(x).requires_grad_()
    TCE.fused_cross_entropy(tx, torch.as_tensor(head),
                            torch.as_tensor(labels), vocab_chunk=8).backward()
    assert torch.all(tx.grad[torch.as_tensor(labels) == -100] == 0)


def test_float_labels_raise():
    x, head, labels, _ = _case()
    with pytest.raises(TypeError):
        TCE.fused_cross_entropy(torch.as_tensor(x), torch.as_tensor(head),
                                torch.as_tensor(labels).float())


def test_dispatcher_counts_and_falls_back():
    """The blockwise path counts ``fused_ce``; a 1-D x is outside the
    guard and takes the materialising path (``fused_ce_fallback``), with
    the same value as JAX's dispatcher on both paths."""
    x, head, labels, _ = _case(v=16)
    TK.reset_dispatch_stats()
    got = TK.dispatched_fused_ce(torch.as_tensor(x), torch.as_tensor(head),
                                 torch.as_tensor(labels), vocab_chunk=8)
    want = JK.dispatched_fused_ce(jnp.asarray(x), jnp.asarray(head),
                                  jnp.asarray(labels), vocab_chunk=8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert TK.dispatch_stats()["fused_ce"] == 1
    assert TK.dispatch_stats()["fused_ce_fallback"] == 0
    got1 = TK.dispatched_fused_ce(torch.as_tensor(x[0, 0]),
                                  torch.as_tensor(head),
                                  torch.as_tensor(labels[0, 0]))
    want1 = JK.dispatched_fused_ce(jnp.asarray(x[0, 0]), jnp.asarray(head),
                                   jnp.asarray(labels[0, 0]))
    assert TK.dispatch_stats()["fused_ce_fallback"] == 1
    np.testing.assert_allclose(float(got1), float(want1), rtol=1e-6)


def test_dispatcher_chunk_default_and_explicit(monkeypatch):
    """``vocab_chunk=None`` resolves through the autotune cache, which
    off the card gives the reference's default chunk (4096) clamped to
    the vocabulary, as the reference's ``ce_chunk`` does; an explicit int
    is passed on as given."""
    seen = []
    real = TCE.fused_cross_entropy

    def spy(*a, vocab_chunk, **kw):
        seen.append(vocab_chunk)
        return real(*a, vocab_chunk=vocab_chunk, **kw)

    monkeypatch.setattr(TCE, "fused_cross_entropy", spy)
    x, head, labels, _ = _case(v=16)
    args = (torch.as_tensor(x), torch.as_tensor(head),
            torch.as_tensor(labels))
    TK.dispatched_fused_ce(*args)
    TK.dispatched_fused_ce(*args, vocab_chunk=5)
    assert seen == [min(TK.CE_DEFAULT_CHUNK, 16), 5]
    assert TK.CE_DEFAULT_CHUNK == 4096
