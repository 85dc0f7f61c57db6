"""Normalisation functionals (port of
``paddle_tpu/nn/functional/norm.py``): ``normalize``, ``layer_norm``,
``rms_norm``, ``batch_norm``, ``instance_norm``, ``group_norm`` and
``local_response_norm``, each registered through the op seam under the
reference's name (the batch norm's two halves as ``_batch_norm_train``
/ ``_batch_norm_eval``). Statistics are float32 whatever the input
type, as in the reference.

``rms_norm`` calls the fused RMSNorm's dispatcher
(``kernels.dispatched_rms_norm``, the reference's ``_FUSED_RMS_IMPL``
seam filled by ``kernels.register``; the port has one implementation,
so it calls it directly): the CUDA kernels for CUDA tensors, their plain
versions for CPU tensors. A missing weight is a weight of ones, which
leaves the kernel's float32 product unchanged; another axis than the
last is moved last for the kernel when there is no weight. Only a CPU
tensor takes the reference's plain math, for a weight with another axis
than the last; a CUDA tensor raises there.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core import enforce as E
from ...kernels import dispatched_rms_norm
from ...ops._op import op_fn

__all__ = ["normalize", "layer_norm", "rms_norm", "batch_norm",
           "instance_norm", "group_norm", "local_response_norm"]


@op_fn
def normalize(x, *, p: float = 2, axis: int = 1, epsilon: float = 1e-12):
    if p == 2:
        n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    else:
        n = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(n, epsilon)


@op_fn
def layer_norm(x, weight=None, bias=None, *, normalized_ndim: int = 1,
               epsilon: float = 1e-5):
    """LayerNorm over the trailing ``normalized_ndim`` dimensions."""
    axes = tuple(range(x.ndim - normalized_ndim, x.ndim))
    xf = x.float()
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=axes, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


@op_fn
def rms_norm(x, weight=None, epsilon: float = 1e-6, axis: int = -1):
    """RMSNorm over ``axis`` (reference: incubate ``fused_rms_norm``),
    float32 statistics, in the result type of ``x`` and ``weight``."""
    axis = axis % x.ndim
    if weight is None:
        ones = torch.ones(x.shape[axis], dtype=x.dtype, device=x.device)
        y = dispatched_rms_norm(x.movedim(axis, -1).contiguous(), ones,
                                epsilon)
        return y.movedim(-1, axis)
    if axis == x.ndim - 1:
        return dispatched_rms_norm(x, weight, epsilon)
    # the weight broadcasts against x in x's own layout, so the axis
    # cannot be moved for the kernel
    E.enforce(x.device.type == "cpu",
              f"rms_norm: the CUDA kernel normalises the last axis; with a "
              f"weight, axis must be the last, got axis {axis} of x "
              f"{tuple(x.shape)}", error=E.InvalidArgumentError)
    xf = x.float()
    ms = (xf * xf).mean(dim=axis, keepdim=True)
    return (xf * torch.rsqrt(ms + epsilon)).to(x.dtype) * weight


def _ch_shape(x, ch_axis):
    shape = [1] * x.ndim
    shape[ch_axis] = x.shape[ch_axis]
    return shape


def _affine(y, weight, bias, shape):
    if weight is not None:
        y = y * weight.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


@op_fn
def _batch_norm_train(x, weight, bias, *, epsilon, data_format, ch_axis):
    axes = tuple(i for i in range(x.ndim) if i != ch_axis)
    xf = x.float()
    mean = torch.mean(xf, dim=axes)
    var = torch.mean(torch.square(xf), dim=axes) - torch.square(mean)
    shape = _ch_shape(x, ch_axis)
    y = ((xf - mean.reshape(shape))
         * torch.rsqrt(var.reshape(shape) + epsilon)).to(x.dtype)
    return _affine(y, weight, bias, shape), mean, var


@op_fn
def _batch_norm_eval(x, running_mean, running_var, weight, bias, *,
                     epsilon, ch_axis):
    shape = _ch_shape(x, ch_axis)
    y = ((x.float() - running_mean.reshape(shape))
         * torch.rsqrt(running_var.reshape(shape) + epsilon)).to(x.dtype)
    return _affine(y, weight, bias, shape)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, data_format: str = "NCHW",
               use_global_stats: Optional[bool] = None, name=None):
    """``paddle.nn.functional.batch_norm``. In training the running
    statistics are updated in place with Paddle's momentum
    (``r = m * r + (1 - m) * batch``, the variance unbiased)."""
    del name
    ch_axis = 1 if data_format.startswith("NC") and x.ndim > 1 else \
        x.ndim - 1
    if data_format in ("NLC", "NHWC", "NDHWC"):
        ch_axis = x.ndim - 1
    if training and not use_global_stats:
        y, mean, var = _batch_norm_train(
            x, weight, bias, epsilon=epsilon, data_format=data_format,
            ch_axis=ch_axis)
        if isinstance(running_mean, torch.Tensor):
            n = 1
            for i, s in enumerate(x.shape):
                if i != ch_axis:
                    n *= s
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                running_mean.copy_(momentum * running_mean
                                   + (1 - momentum) * mean)
                running_var.copy_(momentum * running_var
                                  + (1 - momentum) * unbiased)
        return y
    return _batch_norm_eval(x, running_mean, running_var, weight, bias,
                            epsilon=epsilon, ch_axis=ch_axis)


@op_fn
def instance_norm(x, weight=None, bias=None, *, epsilon: float = 1e-5,
                  data_format: str = "NCHW"):
    if data_format.startswith("NC"):
        ch_axis, axes = 1, tuple(range(2, x.ndim))
    else:
        ch_axis, axes = x.ndim - 1, tuple(range(1, x.ndim - 1))
    xf = x.float()
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.var(xf, dim=axes, correction=0, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    return _affine(y, weight, bias, _ch_shape(x, ch_axis))


@op_fn
def group_norm(x, weight=None, bias=None, *, num_groups: int,
               epsilon: float = 1e-5, data_format: str = "NCHW"):
    if data_format.startswith("NC"):
        n, c = x.shape[0], x.shape[1]
        spatial = tuple(x.shape[2:])
        xg = x.reshape((n, num_groups, c // num_groups) + spatial)
        axes = tuple(range(2, xg.ndim))
        shape = [1, c] + [1] * len(spatial)
    else:
        n, c = x.shape[0], x.shape[-1]
        spatial = tuple(x.shape[1:-1])
        xg = x.reshape((n,) + spatial + (num_groups, c // num_groups))
        axes = tuple(range(1, xg.ndim - 2)) + (xg.ndim - 1,)
        shape = [1] * (x.ndim - 1) + [c]
    xf = xg.float()
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.var(xf, dim=axes, correction=0, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    return _affine(y.reshape(x.shape), weight, bias, shape)


@op_fn
def local_response_norm(x, *, size: int = 5, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0,
                        data_format: str = "NCHW"):
    ch_axis = 1 if data_format.startswith("NC") else x.ndim - 1
    sq = torch.movedim(torch.square(x), ch_axis, -1)
    pad_l = (size - 1) // 2
    pad_r = size - 1 - pad_l
    padded = torch.nn.functional.pad(sq, (pad_l, pad_r))
    win = padded.unfold(-1, size, 1).sum(-1)
    win = torch.movedim(win, -1, ch_axis)
    return x / torch.pow(k + alpha * win, beta)
