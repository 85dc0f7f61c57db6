"""Port parity: ``nn/initializer.py`` against the JAX package's.

Deterministic initializers must equal JAX's exactly: ``Constant``,
``Assign``, ``Dirac`` (grouped), ``Bilinear`` and ``calculate_gain`` for
every nonlinearity. The random ones draw from the port's seeded
generator, so they are held to their distributions over 200000 draws:
the mean within 0.01 standard deviations of its target, the standard
deviation within 1% of its own (``TruncatedNormal``: every draw inside
``[mean + a std, mean + b std]``, and the truncated distribution's
standard deviation), and the same seed gives the same draws. ``Orthogonal`` must give orthonormal rows or
columns (within 1e-5) times the gain. ``set_global_initializer`` comes
before a layer's default, after an explicit ``ParamAttr``'s.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu.nn.initializer as JI
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import device as TD
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import initializer as TI

N = 200_000


@pytest.fixture
def cpu_device():
    prev = TD._current_device
    tpaddle.set_device("cpu")
    yield
    TD._current_device = prev


def test_calculate_gain_matches_jax():
    names = ["sigmoid", "linear", "conv1d", "conv2d", "conv3d",
             "conv_transpose1d", "conv_transpose2d", "conv_transpose3d",
             "tanh", "relu", "selu", "leaky_relu", "unknown"]
    for n in names:
        assert TI.calculate_gain(n) == JI.calculate_gain(n), n
    assert TI.calculate_gain("leaky_relu", 0.2) == JI.calculate_gain(
        "leaky_relu", 0.2)


@pytest.mark.parametrize("make,shape", [
    (lambda M: M.Constant(0.5), (3, 4)),
    (lambda M: M.Assign(np.arange(12.0).reshape(3, 4)), (3, 4)),
    (lambda M: M.Assign(np.arange(12.0)), (4, 3)),
    (lambda M: M.Dirac(), (4, 3, 3, 3)),
    (lambda M: M.Dirac(groups=2), (6, 3, 5)),
    (lambda M: M.Bilinear(), (2, 3, 4, 4)),
    (lambda M: M.Bilinear(), (1, 1, 3, 5)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deterministic_initializers_equal_jax(cpu_device, make, shape,
                                             dtype):
    import jax.numpy as jnp
    want = np.asarray(make(JI)(shape, getattr(jnp, dtype)), np.float32)
    got = make(TI)(shape, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _trunc_std(a, b):
    """Standard deviation of a standard normal truncated to [a, b]."""
    pdf = lambda x: math.exp(-x * x / 2) / math.sqrt(2 * math.pi)  # noqa
    cdf = lambda x: 0.5 * (1 + math.erf(x / math.sqrt(2)))  # noqa: E731
    z = cdf(b) - cdf(a)
    mean = (pdf(a) - pdf(b)) / z
    return math.sqrt(1 + (a * pdf(a) - b * pdf(b)) / z - mean * mean)


# (initializer, shape, expected mean, expected std); fans of [in, out] =
# [400, 500] are (400, 500)
_RANDOM = {
    "Normal": (lambda: TI.Normal(0.5, 2.0), (400, 500), 0.5, 2.0),
    "TruncatedNormal": (lambda: TI.TruncatedNormal(1.0, 0.5, -1.5, 2.0),
                        (400, 500), None, 0.5 * _trunc_std(-1.5, 2.0)),
    "Uniform": (lambda: TI.Uniform(-0.5, 1.5), (400, 500), 0.5,
                2.0 / math.sqrt(12)),
    "XavierNormal": (lambda: TI.XavierNormal(), (400, 500), 0.0,
                     math.sqrt(2.0 / 900)),
    "XavierUniform": (lambda: TI.XavierUniform(gain=2.0), (400, 500), 0.0,
                      2.0 * math.sqrt(6.0 / 900) / math.sqrt(3)),
    "KaimingNormal": (lambda: TI.KaimingNormal(), (400, 500), 0.0,
                      math.sqrt(2.0) / math.sqrt(400)),
    "KaimingUniform": (lambda: TI.KaimingUniform(
        negative_slope=0.1, nonlinearity="leaky_relu"), (400, 500), 0.0,
        math.sqrt(2.0 / 1.01) * math.sqrt(3.0 / 400) / math.sqrt(3)),
}


@pytest.mark.parametrize("name", sorted(_RANDOM))
def test_random_initializers_by_statistics(cpu_device, name):
    make, shape, mean, std = _RANDOM[name]
    tpaddle.seed(7)
    x = make()(shape).double()
    assert x.numel() == N
    if name == "TruncatedNormal":
        assert float(x.min()) >= 1.0 - 1.5 * 0.5
        assert float(x.max()) <= 1.0 + 2.0 * 0.5
    else:
        assert abs(float(x.mean()) - mean) <= 0.01 * std
    assert abs(float(x.std()) / std - 1) <= 0.01
    tpaddle.seed(7)
    torch.testing.assert_close(make()(shape).double(), x, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(8, 20), (20, 8), (6, 2, 3, 3)])
def test_orthogonal_is_orthonormal(cpu_device, shape):
    tpaddle.seed(1)
    w = TI.Orthogonal(gain=2.0)(shape).reshape(shape[0], -1) / 2.0
    rows, cols = w.shape
    gram = w @ w.T if rows <= cols else w.T @ w
    torch.testing.assert_close(gram, torch.eye(min(rows, cols)),
                               rtol=0, atol=1e-5)


def test_global_initializer_precedence(cpu_device):
    class Attr:
        initializer = TI.Constant(3.0)

    TI.set_global_initializer(TI.Constant(1.0), TI.Constant(2.0))
    try:
        lin = tnn.Linear(3, 4)
        assert torch.all(lin.weight == 1.0) and torch.all(lin.bias == 2.0)
        emb = tnn.Embedding(5, 2)            # a default of Normal(0, 1)
        assert torch.all(emb.weight == 1.0)
        lin = tnn.Linear(3, 4, weight_attr=Attr())
        assert torch.all(lin.weight == 3.0)
        assert TI.global_initializer() is not None
    finally:
        TI.set_global_initializer(None)
    assert TI.global_initializer() is None and \
        TI.global_initializer(is_bias=True) is None
