"""Port parity: ``paddle_tpu_torch/metric.py`` against
``paddle_tpu/metric.py``: ``Accuracy`` (top-1 and top-(1, 3), labels
``[N]`` and ``[N, 1]``, and over ``[B, S, V]`` scores), ``Precision``,
``Recall``, ``Auc`` and the functional ``accuracy``, on the same seeded
float32 inputs over several streamed updates. ``compute`` runs on the
tensors' device (a top-k; scores without ties, so the order of equal
scores never matters); ``update`` / ``accumulate`` return what the
reference's do, ``accumulate`` Python floats. Tolerance: the reductions
count hits, so the results are equal up to float32 summation (rtol
1e-6).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import metric as jm
from paddle_tpu_torch import metric as tm


def _scores(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.permutation(int(np.prod(shape))).reshape(shape).astype(
        np.float32) / 10.0


@pytest.mark.parametrize("topk", [1, (1, 3)])
@pytest.mark.parametrize("shape,label_shape", [((8, 7), (8,)),
                                               ((8, 7), (8, 1)),
                                               ((2, 5, 7), (2, 5))])
def test_accuracy_streams_like_the_reference(topk, shape, label_shape):
    t, j = tm.Accuracy(topk=topk), jm.Accuracy(topk=topk)
    assert t.name() == j.name()
    for step in range(3):
        pred = _scores(shape, step)
        label = np.random.default_rng(10 + step).integers(
            0, shape[-1], label_shape)
        tc = t.compute(torch.from_numpy(pred), torch.from_numpy(label))
        jc = j.compute(jpaddle.to_tensor(pred), jpaddle.to_tensor(label))
        assert tc.device.type == "cpu"
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(t.update(tc), j.update(jc), rtol=1e-6)
    got, want = t.accumulate(), j.accumulate()
    assert type(got) is type(want)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert all(isinstance(v, float) for v in np.atleast_1d(got).tolist())
    t.reset()
    assert t.accumulate() == (0.0 if topk == 1 else [0.0, 0.0])


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_stream_like_the_reference(name):
    t, j = getattr(tm, name)(), getattr(jm, name)()
    rng = np.random.default_rng(3)
    for step in range(3):
        if name == "Auc":
            p = rng.random((16, 2)).astype(np.float32)
            p /= p.sum(1, keepdims=True)
        else:
            p = rng.random(16).astype(np.float32)
        lbl = rng.integers(0, 2, (16, 1))
        t.update(torch.from_numpy(p), torch.from_numpy(lbl))
        j.update(jpaddle.to_tensor(p), jpaddle.to_tensor(lbl))
    got, want = t.accumulate(), j.accumulate()
    assert isinstance(got, float) and t.name() == j.name()
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("k", [1, 2])
def test_functional_accuracy_matches_the_reference(k):
    pred = _scores((10, 6), 5)
    label = np.random.default_rng(6).integers(0, 6, (10, 1))
    got = tm.accuracy(torch.from_numpy(pred), torch.from_numpy(label), k=k)
    want = jm.accuracy(jpaddle.to_tensor(pred), jpaddle.to_tensor(label), k=k)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == pytest.approx(float(np.asarray(want.numpy())),
                                       rel=1e-6)
