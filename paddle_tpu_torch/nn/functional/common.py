"""Common functionals (port of ``paddle_tpu/nn/functional/common.py``):
``linear``, ``embedding`` (dense and row-sparse), ``one_hot``, the
dropouts, ``pad``, ``interpolate``, the pixel and channel shuffles,
``unfold`` / ``fold``, ``cosine_similarity``, ``bilinear`` and
``label_smooth``.

Each registered function goes through the op seam under the reference's
name (``embedding`` for the dense lookup, ``dropout_p``,
``alpha_dropout_p``, ``f_pad``, ...). The dropouts take a
``torch.Generator`` where the reference takes a key; the public
functions draw from the seeded generator of ``x``'s device.
``interpolate`` computes ``jax.image.resize``'s resampling (half-pixel
centres, the Keys cubic kernel, a triangle filter widened when
downsampling) as one weight matrix an axis; ``align_corners`` and
``area`` are the reference's own.
"""
from __future__ import annotations

import torch

from ...ops._op import op_fn
from ...ops.manipulation import pad_nd

__all__ = [
    "linear", "embedding", "one_hot", "dropout", "dropout2d", "dropout3d",
    "alpha_dropout", "pad", "zeropad2d", "interpolate", "upsample",
    "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "unfold", "fold",
    "cosine_similarity", "bilinear", "label_smooth",
]


@op_fn
def linear(x, weight, bias=None):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight; a plain
    product (cuBLAS on the card), as the reference leaves it to XLA.
    Inputs of two float types meet at the promoted one, as ``jnp``'s do
    (a keyword weight that AMP leaves float32 beside a bf16 ``x``)."""
    if x.dtype != weight.dtype and x.is_floating_point():
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


def _zero_padding(out, ids, padding_idx):
    if padding_idx is None:
        return out
    return torch.where((ids == padding_idx)[..., None], out.new_zeros(()),
                       out)


@op_fn(name="embedding", nondiff_args=(0,))
def _embedding_dense(ids, weight, *, padding_idx=None):
    return _zero_padding(weight[ids], ids, padding_idx)


def embedding(ids, weight, padding_idx=None, sparse: bool = False):
    """Rows of ``weight`` at ``ids``; rows at ``padding_idx`` are zero.
    With ``sparse`` the gradient of ``weight`` is row-sparse (the
    reference's SelectedRows): a ``torch.sparse_coo`` tensor of the rows
    ``ids`` names, duplicates included until the optimizer coalesces
    them, and zero values at ``padding_idx`` positions. As in the
    reference, that holds for a leaf weight under autograd; otherwise
    (and without ``sparse``) the gradient is dense and the lookup is the
    registered ``embedding`` op."""
    if (sparse and weight.is_leaf and weight.requires_grad
            and torch.is_grad_enabled()):
        return _zero_padding(
            torch.nn.functional.embedding(ids, weight, sparse=True), ids,
            padding_idx)
    return _embedding_dense(ids, weight, padding_idx=padding_idx)


@op_fn(differentiable=False)
def one_hot(x, *, num_classes: int):
    cls = torch.arange(num_classes, device=x.device)
    return (x[..., None] == cls).to(torch.float32)


def _dropout_impl(x, p, training, mode, generator, bcast_dims=None):
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    shape = list(x.shape)
    for d in bcast_dims or ():
        shape[d] = 1
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    zero = x.new_zeros(())
    if mode == "upscale_in_train":
        return torch.where(mask, x / keep, zero).to(x.dtype)
    return torch.where(mask, x, zero).to(x.dtype)     # downscale_in_infer


@op_fn(name="dropout_p")
def _dropout_op(x, *, p, training, mode, generator, bcast_dims=None):
    return _dropout_impl(x, p, training, mode, generator, bcast_dims)


def _gen(x):
    from ...framework.random import default_generator
    return default_generator(x.device)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """``paddle.nn.functional.dropout`` (``upscale_in_train`` by default;
    ``downscale_in_infer`` scales by ``1 - p`` at inference instead)."""
    del name
    if not training or p == 0.0:
        if p > 0.0 and mode == "downscale_in_infer":
            from ...ops import scale as _scale
            return _scale(x, scale=1.0 - p)
        return x
    bcast = None
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        bcast = [d for d in range(x.ndim) if d not in axes]
    return _dropout_op(x, p=float(p), training=True, mode=mode,
                       generator=_gen(x), bcast_dims=bcast)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Drops whole channels of NCHW / NHWC feature maps."""
    del name
    if not training or p == 0.0:
        return x
    bcast = [2, 3] if data_format == "NCHW" else [1, 2]
    return _dropout_op(x, p=float(p), training=True, mode="upscale_in_train",
                       generator=_gen(x), bcast_dims=bcast)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    del name
    if not training or p == 0.0:
        return x
    bcast = [2, 3, 4] if data_format == "NCDHW" else [1, 2, 3]
    return _dropout_op(x, p=float(p), training=True, mode="upscale_in_train",
                       generator=_gen(x), bcast_dims=bcast)


@op_fn(name="alpha_dropout_p")
def _alpha_dropout_op(x, *, p, generator):
    # SELU-preserving dropout
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = 1.0 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return (a * torch.where(mask, x, x.new_full((), alpha_p)) + b).to(
        x.dtype)


def alpha_dropout(x, p=0.5, training=True, name=None):
    del name
    if not training or p == 0.0:
        return x
    return _alpha_dropout_op(x, p=float(p), generator=_gen(x))


def _norm_pad(pad_spec, ndim, data_format):
    """A Paddle pad spec as ``(lo, hi)`` per dimension: an int pads every
    dimension; ``2 * ndim`` ints pad every dimension from the last one
    back; fewer pad the spatial dimensions of the NC* / N*C layout, the
    last spatial dimension first."""
    if isinstance(pad_spec, int):
        return [(pad_spec, pad_spec)] * ndim
    pad_spec = [int(p) for p in pad_spec]
    out = [(0, 0)] * ndim
    n_pairs = len(pad_spec) // 2
    if n_pairs == ndim:
        dims = list(range(ndim - 1, -1, -1))
    elif data_format.startswith("NC"):
        dims = list(range(ndim - 1, ndim - 1 - n_pairs, -1))
    else:
        dims = list(range(ndim - 2, ndim - 2 - n_pairs, -1))
    for i, d in enumerate(dims):
        out[d] = (pad_spec[2 * i], pad_spec[2 * i + 1])
    return out


@op_fn(name="f_pad")
def _pad_op(x, *, pad_cfg, mode, value):
    return pad_nd(x, pad_cfg, mode, value)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``paddle.nn.functional.pad``."""
    del name
    spec = pad.tolist() if isinstance(pad, torch.Tensor) else pad
    cfg = tuple((int(a), int(b)) for a, b in _norm_pad(spec, x.ndim,
                                                       data_format))
    return _pad_op(x, pad_cfg=cfg, mode=mode, value=value)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format, name=name)


@op_fn
def cosine_similarity(x1, x2, *, axis: int = 1, eps: float = 1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp_min(n1 * n2, eps)


@op_fn
def bilinear(x1, x2, weight, bias=None):
    # weight: [out, in1, in2]
    y = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    if bias is not None:
        y = y + bias
    return y


@op_fn
def label_smooth(label, *, epsilon: float = 0.1):
    k = label.shape[-1]
    return (1 - epsilon) * label + epsilon / k


@op_fn
def pixel_shuffle(x, *, upscale_factor: int, data_format: str = "NCHW"):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w)
        x = x.permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r))
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


@op_fn
def pixel_unshuffle(x, *, downscale_factor: int, data_format: str = "NCHW"):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r)
        x = x.permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


@op_fn
def channel_shuffle(x, *, groups: int, data_format: str = "NCHW"):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, groups, c // groups, h, w)
        x = x.permute(0, 2, 1, 3, 4)
        return x.reshape(n, c, h, w)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups)
    x = x.permute(0, 1, 2, 4, 3)
    return x.reshape(n, h, w, c)


# -- interpolate ------------------------------------------------------------

def _triangle(t):
    return torch.clamp_min(1 - t.abs(), 0)


def _keys_cubic(t):
    t = t.abs()
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


def _resize_weights(n_in, n_out, kernel, device):
    """``jax.image.resize``'s ``[n_in, n_out]`` weights of one axis:
    half-pixel sample positions, the kernel widened by the scale when
    downsampling (its antialiasing), columns normalised to sum 1."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                           device=device)[:, None]).abs()
    w = kernel(dist / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_axis_aligned(x, axis, n_out):
    """Linear resize of one axis on corner-aligned positions
    (``src = i * (in - 1) / (out - 1)``)."""
    n_in = x.shape[axis]
    if n_out == 1 or n_in == 1:
        return torch.index_select(x, axis, torch.zeros(
            n_out, dtype=torch.long, device=x.device))
    src = torch.arange(n_out, dtype=torch.float32, device=x.device) * (
        (n_in - 1) / (n_out - 1))
    lo = torch.clamp(torch.floor(src).long(), 0, n_in - 1)
    hi = torch.clamp(lo + 1, 0, n_in - 1)
    shape = [1] * x.ndim
    shape[axis] = n_out
    frac = (src - lo.float()).reshape(shape).to(x.dtype)
    return (torch.index_select(x, axis, lo) * (1 - frac)
            + torch.index_select(x, axis, hi) * frac)


def _adaptive_avg(x, axes, size):
    """Bin averages of each axis (adaptive average pooling: bin ``i`` of
    ``n`` over ``[floor(i*L/n), ceil((i+1)*L/n))``)."""
    for ax, n in zip(axes, size):
        length = x.shape[ax]
        parts = []
        for i in range(n):
            s = (i * length) // n
            e = -((-(i + 1) * length) // n)
            parts.append(x.narrow(ax, s, e - s).mean(dim=ax, keepdim=True))
        x = torch.cat(parts, dim=ax)
    return x


@op_fn
def interpolate(x, *, size=None, scale_factor=None, mode: str = "nearest",
                align_corners: bool = False, data_format: str = "NCHW"):
    channel_last = not data_format.startswith("NC")
    spatial = x.shape[1:-1] if channel_last else x.shape[2:]
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    size = [int(s) for s in (size if isinstance(size, (list, tuple))
                             else [size])]
    axes = (tuple(range(1, x.ndim - 1)) if channel_last
            else tuple(range(2, x.ndim)))
    if mode == "area":
        return _adaptive_avg(x, axes, size)
    if align_corners and mode in ("linear", "bilinear", "trilinear"):
        for ax, s in zip(axes, size):
            x = _resize_axis_aligned(x, ax, s)
        return x
    if not x.is_floating_point() and mode != "nearest":
        x = x.to(torch.float32)
    for ax, n_out in zip(axes, size):
        n_in = x.shape[ax]
        if n_in == n_out:
            continue
        if mode == "nearest":
            idx = torch.floor((torch.arange(n_out, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * (n_in / n_out)).long()
            x = torch.index_select(x, ax, idx)
            continue
        kernel = {"linear": _triangle, "bilinear": _triangle,
                  "trilinear": _triangle, "bicubic": _keys_cubic}[mode]
        w = _resize_weights(n_in, n_out, kernel, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([ax], [0])), -1, ax)
    return x


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, data_format="NCHW", name=None):
    del name
    return interpolate(x, size=size, scale_factor=scale_factor, mode=mode,
                       align_corners=align_corners, data_format=data_format)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v[:2])


@op_fn
def unfold(x, *, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: ``[N, C, H, W]`` -> ``[N, C * kh * kw, L]``."""
    return torch.nn.functional.unfold(
        x, _pair(kernel_sizes), dilation=_pair(dilations),
        padding=_pair(paddings), stride=_pair(strides))


@op_fn
def fold(x, *, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1):
    """col2im, the inverse of ``unfold`` (overlapping patches sum)."""
    return torch.nn.functional.fold(
        x, tuple(output_sizes), _pair(kernel_sizes),
        dilation=_pair(dilations), padding=_pair(paddings),
        stride=_pair(strides))
