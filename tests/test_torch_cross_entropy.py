"""Port parity: ``F.cross_entropy`` with soft labels and with
``use_softmax=False`` (``nn/functional/loss.py``) against the JAX
package's, on the same numpy inputs: every reduction, with and without
a class ``weight`` and ``label_smoothing``, soft labels given by
``soft_label=True`` and found by their float type and shape, and hard
labels over probabilities; the input gradient against JAX's for one
case. Tolerance: float32, ``1e-6`` relative (the same float32
operations in another summation order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn.functional as TF

N, C = 6, 5


def _inputs(seed, probs):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, C)).astype(np.float32)
    if probs:
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
        x[0, 1] = 0.0                 # a zero probability: the 1e-30 clamp
    soft = rng.random((N, C)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    hard = rng.integers(0, C, N)
    hard[2] = -100
    w = rng.random(C).astype(np.float32) + 0.5
    return x, soft, hard, w


def _both(x, label, kw):
    want = JF.cross_entropy(jpaddle.to_tensor(x), jpaddle.to_tensor(label),
                            **{k: jpaddle.to_tensor(v) if k == "weight"
                               else v for k, v in kw.items()}).numpy()
    got = TF.cross_entropy(torch.as_tensor(x), torch.as_tensor(label),
                           **{k: torch.as_tensor(v) if k == "weight"
                              else v for k, v in kw.items()})
    return got.numpy(), want


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("use_softmax", [True, False])
def test_soft_labels_match_jax(reduction, weighted, smoothing, use_softmax):
    x, soft, _, w = _inputs(0, probs=not use_softmax)
    kw = {"reduction": reduction, "label_smoothing": smoothing,
          "use_softmax": use_softmax, "soft_label": True}
    if weighted:
        kw["weight"] = w
    got, want = _both(x, soft, kw)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    kw.pop("soft_label")              # found by the label's type and shape
    got, want = _both(x, soft, kw)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_hard_labels_over_probabilities_match_jax(reduction, weighted):
    x, _, hard, w = _inputs(1, probs=True)
    kw = {"reduction": reduction, "use_softmax": False,
          "label_smoothing": 0.05}
    if weighted:
        kw["weight"] = w
    got, want = _both(x, hard, kw)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_soft_label_input_gradient_matches_jax():
    x, soft, _, w = _inputs(2, probs=False)
    jx = jpaddle.to_tensor(x, stop_gradient=False)
    JF.cross_entropy(jx, jpaddle.to_tensor(soft), jpaddle.to_tensor(w),
                     soft_label=True, label_smoothing=0.1).backward()
    tx = torch.as_tensor(x).requires_grad_()
    TF.cross_entropy(tx, torch.as_tensor(soft), torch.as_tensor(w),
                     soft_label=True, label_smoothing=0.1).backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-5,
                               atol=1e-7)
