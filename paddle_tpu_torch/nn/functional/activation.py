"""Activation functionals (port of
``paddle_tpu/nn/functional/activation.py``).

Each is registered through the op seam (``ops/_op.py``) under the
reference's name (``sigmoid`` as ``f_sigmoid``, ``tanh`` as ``f_tanh``,
``softplus`` as ``f_softplus``, ``softsign`` as ``f_softsign``, the
gumbel softmax as ``gumbel_softmax_p``) and computes what the
reference's ``jnp`` function does, each product in ``x``'s type. The
random ones (``rrelu`` in training, ``gumbel_softmax``) take a
``torch.Generator`` where the reference takes a key; the public
``gumbel_softmax`` draws from the seeded generator of ``x``'s device.
"""
from __future__ import annotations

import torch

from ...ops._op import op_fn

__all__ = [
    "celu", "elu", "gelu", "glu", "gumbel_softmax", "hardshrink",
    "hardsigmoid", "hardswish", "hardtanh", "leaky_relu", "log_sigmoid",
    "log_softmax", "maxout", "mish", "prelu", "relu", "relu6", "rrelu",
    "selu", "sigmoid", "silu", "softmax", "softplus", "softshrink",
    "softsign", "swish", "tanh", "tanhshrink", "thresholded_relu",
]


def _zero(x):
    return x.new_zeros(())


@op_fn
def relu(x):
    return torch.clamp_min(x, 0)


@op_fn
def relu6(x):
    return torch.clamp(x, 0, 6)


@op_fn
def elu(x, *, alpha: float = 1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


@op_fn
def celu(x, *, alpha: float = 1.0):
    return (torch.clamp_min(x, 0)
            + torch.clamp_max(alpha * torch.expm1(x / alpha), 0))


@op_fn
def selu(x, *, scale: float = 1.0507009873554805,
         alpha: float = 1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@op_fn
def gelu(x, *, approximate: bool = False):
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate
                                    else "none")


@op_fn
def leaky_relu(x, *, negative_slope: float = 0.01):
    return torch.where(x >= 0, x, negative_slope * x)


@op_fn
def prelu(x, weight, *, data_format: str = "NCHW"):
    # weight: one slope, or one a channel on the channel axis
    w = weight
    if w.ndim == 1 and w.shape[0] != 1 and x.ndim > 1:
        ch_axis = 1 if data_format.startswith("NC") else x.ndim - 1
        shape = [1] * x.ndim
        shape[ch_axis] = w.shape[0]
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


@op_fn
def rrelu(x, *, lower: float = 1.0 / 8.0, upper: float = 1.0 / 3.0,
          training: bool = False, generator=None):
    if training and generator is not None:
        a = torch.empty_like(x).uniform_(lower, upper, generator=generator)
    else:
        a = (lower + upper) / 2.0
    return torch.where(x >= 0, x, a * x)


@op_fn(name="f_sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@op_fn
def log_sigmoid(x):
    return torch.nn.functional.logsigmoid(x)


@op_fn(name="f_tanh")
def tanh(x):
    return torch.tanh(x)


@op_fn
def tanhshrink(x):
    return x - torch.tanh(x)


@op_fn
def hardshrink(x, *, threshold: float = 0.5):
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


@op_fn
def softshrink(x, *, threshold: float = 0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


@op_fn
def hardsigmoid(x, *, slope: float = 1.0 / 6.0, offset: float = 0.5):
    return torch.clamp(slope * x + offset, 0, 1)


@op_fn
def hardswish(x):
    return x * torch.clamp(x + 3, 0, 6) / 6


@op_fn
def hardtanh(x, *, min: float = -1.0, max: float = 1.0):
    return torch.clamp(x, min, max)


@op_fn
def mish(x):
    return x * torch.tanh(torch.nn.functional.softplus(x))


@op_fn(name="f_softplus")
def softplus(x, *, beta: float = 1.0, threshold: float = 20.0):
    bx = beta * x
    # jax.nn.softplus: logaddexp(bx, 0)
    return torch.where(bx > threshold, x,
                       torch.logaddexp(bx, _zero(bx)) / beta)


@op_fn(name="f_softsign")
def softsign(x):
    return x / (1 + torch.abs(x))


@op_fn
def silu(x):
    """``x * sigmoid(x)``, each product in ``x.dtype`` (the reference's
    two roundings in bfloat16, not one fused op)."""
    return x * torch.sigmoid(x)


@op_fn
def swish(x):
    return x * torch.sigmoid(x)


@op_fn
def thresholded_relu(x, *, threshold: float = 1.0, value: float = 0.0):
    return torch.where(x > threshold, x, torch.full_like(x, value))


@op_fn
def softmax(x, *, axis: int = -1):
    return torch.softmax(x, dim=axis)


@op_fn
def log_softmax(x, *, axis: int = -1):
    return torch.log_softmax(x, dim=axis)


@op_fn
def glu(x, *, axis: int = -1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@op_fn
def maxout(x, *, groups: int, axis: int = 1):
    ax = axis if axis >= 0 else x.ndim + axis
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return torch.amax(x.reshape(shape), dim=ax + 1)


@op_fn(name="gumbel_softmax_p")
def _gumbel_softmax_op(x, *, temperature: float = 1.0, hard: bool = False,
                       axis: int = -1, generator=None):
    if generator is not None:
        u = torch.empty_like(x).uniform_(1e-20, 1.0, generator=generator)
        x = x - torch.log(-torch.log(u + 1e-20))
    y = torch.softmax(x / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = (y_hard - y).detach() + y       # straight-through estimator
    return y


def gumbel_softmax(x, temperature: float = 1.0, hard: bool = False,
                   axis: int = -1, name=None):
    """``paddle.nn.functional.gumbel_softmax``: always samples the noise,
    from the seeded generator of ``x``'s device."""
    del name
    from ...framework.random import default_generator
    return _gumbel_softmax_op(x, temperature=temperature, hard=hard,
                              axis=axis,
                              generator=default_generator(x.device))


# -- in-place variants (the reference's relu_ / elu_ / ... aliases) -------

def _inplace(fn):
    import functools

    @functools.wraps(fn)
    def wrapper(x, *args, **kwargs):
        from ...ops import _adopt, _snapshot
        return _adopt(x, fn(_snapshot(x, args, kwargs), *args, **kwargs))
    wrapper.__name__ = fn.__name__ + "_"
    return wrapper


relu_ = _inplace(relu)
elu_ = _inplace(elu)
tanh_ = _inplace(tanh)
hardtanh_ = _inplace(hardtanh)
leaky_relu_ = _inplace(leaky_relu)
softmax_ = _inplace(softmax)
thresholded_relu_ = _inplace(thresholded_relu)

__all__ += ["relu_", "elu_", "tanh_", "hardtanh_", "leaky_relu_",
            "softmax_", "thresholded_relu_"]
