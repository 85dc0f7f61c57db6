"""The math op long tail (port of ``paddle_tpu/ops/math_ext.py``).

Special functions come from ``torch.special``: ``i0`` / ``i0e`` / ``i1``
/ ``i1e``, ``gammaln``, ``gammainc`` / ``gammaincc`` and
``multigammaln``. torch differentiates the regularized incomplete gamma
in its second argument only; the gradient in the first (``a``) is the
central difference of the function in float64 (``_igamma_grad_a``),
where the reference's XLA series is exact to float32. ``cummin`` /
``cummax`` give the reference's index, the last position whose value
equals the running extreme, and their values through the reference's
parallel prefix scan (``_assoc_scan``), so that a tie splits the
gradient between equal entries as JAX's ``lax.max`` / ``lax.min`` do.
"""
from __future__ import annotations

import torch

from ._op import op_fn, wrap
from .math import _float, _t
from ..core import enforce as E

__all__ = [
    "copysign", "nextafter", "i0", "i0e", "i1", "i1e", "sinc", "gammaln",
    "gammainc", "gammaincc", "multigammaln", "logcumsumexp", "cummin",
    "cummax", "nanmedian", "nanquantile", "neg", "sgn", "signbit",
    "bitwise_left_shift", "bitwise_right_shift", "bucketize", "diff",
    "cumulative_trapezoid", "frexp", "floor_mod", "remainder", "renorm",
    "multiplex", "polar", "reduce_as", "take", "isneginf", "isposinf",
    "isreal", "is_complex", "is_floating_point", "is_integer", "rank",
    "increment", "add_n", "broadcast_shape",
]


def _in_f32(fn, *xs):
    """``fn`` on 16-bit float inputs computed in float32 and rounded back
    (torch's special functions and scans take no 16-bit type on the card,
    or sum in it)."""
    xs = [_float(x) for x in xs]
    dt = xs[0].dtype
    if dt not in (torch.bfloat16, torch.float16):
        return fn(*xs)
    return fn(*(x.float() for x in xs)).to(dt)


@op_fn
def copysign(x, y):
    return torch.copysign(_float(x), _t(y, x))


@op_fn(differentiable=False)
def nextafter(x, y):
    return torch.nextafter(x, _t(y, x).to(x.dtype))


@op_fn
def i0(x):
    return _in_f32(torch.special.i0, x)


@op_fn
def i0e(x):
    return _in_f32(torch.special.i0e, x)


@op_fn
def i1(x):
    return _in_f32(torch.special.i1, x)


@op_fn
def i1e(x):
    return _in_f32(torch.special.i1e, x)


@op_fn
def sinc(x):
    return torch.sinc(_float(x))


@op_fn
def gammaln(x):
    return torch.special.gammaln(_float(x))


def _igamma_grad_a(fn, a, x):
    """d fn(a, x) / da by a central difference in float64 (step 1e-4 of
    ``max(a, 1)``: truncation ~1e-9, roundoff ~1e-12 of the value)."""
    a64, x64 = a.double(), x.double()
    h = 1e-4 * a64.abs().clamp(min=1.0)
    return ((fn(a64 + h, x64) - fn(a64 - h, x64)) / (2 * h)).to(a.dtype)


class _IGamma(torch.autograd.Function):
    """The regularized incomplete gamma ``fn(a, x)`` with both gradients:
    torch's own in ``x``, ``_igamma_grad_a`` in ``a``."""

    @staticmethod
    def forward(ctx, a, x, fn):
        ctx.save_for_backward(a, x)
        ctx.fn = fn
        return fn(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        ga = gx = None
        if ctx.needs_input_grad[0]:
            ga = g * _igamma_grad_a(ctx.fn, a, x)
        if ctx.needs_input_grad[1]:
            with torch.enable_grad():
                xx = x.detach().requires_grad_()
                gx, = torch.autograd.grad(ctx.fn(a.detach(), xx), xx, g)
        return ga, gx, None


def _igamma(fn, x, y):
    a, b = torch.broadcast_tensors(_float(x), _float(_t(y, x)))
    if a.dtype in (torch.bfloat16, torch.float16):
        return _igamma(fn, a.float(), b.float()).to(a.dtype)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _IGamma.apply(a, b, fn)
    return fn(a, b)


@op_fn
def gammainc(x, y):
    return _igamma(torch.special.gammainc, x, y)


@op_fn
def gammaincc(x, y):
    return _igamma(torch.special.gammaincc, x, y)


@op_fn(name="multigammaln_op")
def _multigammaln(x, *, p=1):
    return _in_f32(lambda a: torch.special.multigammaln(a, p), x)


def multigammaln(x, p=1, name=None):
    return _multigammaln(x, p=int(p))


@op_fn(name="logcumsumexp")
def _logcumsumexp(x, *, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return _in_f32(lambda a: torch.logcumsumexp(a, axis), x)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    out = _logcumsumexp(x, axis=axis)
    if dtype is not None:
        from ..core.dtype import convert_dtype
        out = out.to(convert_dtype(dtype))
    return out


def _assoc_scan(fn, x, dim):
    """The inclusive scan of ``fn`` along ``dim`` by the reference's
    parallel prefix algorithm (``jax.lax.associative_scan``): pairs
    combined, the odd positions scanned recursively, the even ones
    combined from them, then interleaved."""
    n = x.shape[dim]
    if n < 2:
        return x
    reduced = fn(x.narrow(dim, 0, n - 1)[_every(x, dim, 2)],
                 x.narrow(dim, 1, n - 1)[_every(x, dim, 2)])
    odd = _assoc_scan(fn, reduced, dim)
    rest = x.narrow(dim, 2, n - 2)[_every(x, dim, 2)]
    if n % 2 == 0:
        even = fn(odd.narrow(dim, 0, odd.shape[dim] - 1), rest)
    else:
        even = fn(odd, rest)
    even = torch.cat([x.narrow(dim, 0, 1), even], dim)
    out = torch.stack([even.narrow(dim, 0, odd.shape[dim]), odd], dim + 1)
    out = out.flatten(dim, dim + 1)
    if even.shape[dim] > odd.shape[dim]:
        out = torch.cat([out, even.narrow(dim, odd.shape[dim], 1)], dim)
    return out


def _every(x, dim, step):
    return (slice(None),) * dim + (slice(None, None, step),)


def _cum_extreme(x, axis, fn):
    """``(values, index)`` of a running max or min: the values by
    ``_assoc_scan``, the index of the last position equal to the running
    extreme (int64)."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = axis % max(x.ndim, 1)
    vals = _assoc_scan(fn, x, axis)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    iota = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    idx = torch.where(x == vals, iota, -1)
    idx = torch.cummax(idx, axis).values
    return vals, idx


@op_fn(name="cummin_op")
def _cummin(x, *, axis=None):
    return _cum_extreme(x, axis, torch.minimum)


def cummin(x, axis=None, dtype="int64", name=None):
    vals, idx = _cummin(x, axis=axis)
    if dtype:
        from ..core.dtype import convert_dtype
        idx = idx.to(convert_dtype(dtype))
    return vals, idx


@op_fn(name="cummax_op")
def _cummax_full(x, *, axis=None):
    return _cum_extreme(x, axis, torch.maximum)


def cummax(x, axis=None, dtype="int64", name=None):
    vals, idx = _cummax_full(x, axis=axis)
    if dtype:
        from ..core.dtype import convert_dtype
        idx = idx.to(convert_dtype(dtype))
    return vals, idx


def _flat_axes(x, axis):
    """``x`` with ``axis`` (None, an int or a tuple) moved last and
    flattened into one, and that dim: torch's quantiles take one dim."""
    if axis is None:
        return x.reshape(-1), 0
    if isinstance(axis, int):
        return x, axis
    axes = sorted(a % x.ndim for a in axis)
    rest = [d for d in range(x.ndim) if d not in axes]
    moved = x.permute(*rest, *axes)
    return moved.reshape(*[x.shape[d] for d in rest], -1), len(rest)


def _restore(out, x, axis, keepdim, lead=0):
    """Shape a quantile reduced over ``_flat_axes``' dim as the
    reference's (``keepdim``: every reduced axis kept as 1)."""
    if not keepdim:
        return out
    if axis is None:
        return out.reshape(out.shape[:lead] + (1,) * x.ndim)
    axes = [axis] if isinstance(axis, int) else list(axis)
    axes = sorted(a % x.ndim for a in axes)
    shape = list(out.shape[:lead])
    kept = iter(out.shape[lead:])
    for d in range(x.ndim):
        shape.append(1 if d in axes else next(kept))
    return out.reshape(shape)


def _quantile_dtype(x):
    """torch's quantiles take float32 / float64: a 16-bit float input is
    computed in float32 and rounded back."""
    x = _float(x)
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


@op_fn(name="nanmedian_op")
def _nanmedian(x, *, axis=None, keepdim=False):
    flat, dim = _flat_axes(x, axis)
    out = torch.nanquantile(_quantile_dtype(flat), 0.5, dim=dim)
    return _restore(out, x, axis, keepdim).to(_float(x).dtype)


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    return _nanmedian(x, axis=axis, keepdim=keepdim)


@op_fn(name="nanquantile_op")
def _nanquantile(x, *, q, axis=None, keepdim=False, interpolation="linear"):
    flat, dim = _flat_axes(x, axis)
    xf = _quantile_dtype(flat)
    qt = torch.as_tensor(q, dtype=xf.dtype, device=x.device)
    out = torch.nanquantile(xf, qt, dim=dim, interpolation=interpolation)
    return _restore(out, x, axis, keepdim, lead=qt.ndim).to(_float(x).dtype)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    return _nanquantile(x, q=q, axis=axis, keepdim=keepdim,
                        interpolation=interpolation)


@op_fn
def neg(x):
    return torch.neg(x)


@op_fn
def sgn(x):
    return torch.sgn(x)


@op_fn(differentiable=False)
def signbit(x):
    return torch.signbit(x)


@op_fn(differentiable=False)
def bitwise_left_shift(x, y, *, is_arithmetic=True):
    return torch.bitwise_left_shift(x, _t(y, x))


@op_fn(differentiable=False)
def bitwise_right_shift(x, y, *, is_arithmetic=True):
    y = _t(y, x)
    out = torch.bitwise_right_shift(x, y)
    if is_arithmetic:
        return out
    # logical: the bits shifted in from the top are zeros
    bits = x.element_size() * 8
    keep = torch.bitwise_left_shift(torch.ones_like(out), bits - y) - 1
    return torch.where(y > 0, out & keep, out)


@op_fn(differentiable=False, name="bucketize_op")
def _bucketize(x, sorted_sequence, *, out_int32=False, right=False):
    return torch.bucketize(x, sorted_sequence, out_int32=out_int32,
                           right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return _bucketize(x, sorted_sequence, out_int32=out_int32, right=right)


@op_fn(name="diff_op")
def _diff(x, *, n=1, axis=-1, prepend=None, append=None):
    return torch.diff(x, n=n, dim=axis, prepend=prepend, append=append)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return _diff(x, n=n, axis=axis, prepend=prepend, append=append)


@op_fn(name="cumulative_trapezoid_op")
def _cumulative_trapezoid(y, *, x=None, dx=None, axis=-1):
    n = y.shape[axis]
    y0, y1 = y.narrow(axis, 0, n - 1), y.narrow(axis, 1, n - 1)
    if x is not None:
        m = x.shape[axis]
        d = x.narrow(axis, 1, m - 1) - x.narrow(axis, 0, m - 1)
    else:
        d = 1.0 if dx is None else dx
    return _in_f32(lambda a: torch.cumsum(a, dim=axis), (y0 + y1) * d / 2.0)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    return _cumulative_trapezoid(y, x=x, dx=dx, axis=axis)


def frexp(x, name=None):
    m, e = torch.frexp(_float(x))
    return wrap(m), wrap(e.to(torch.int32))


@op_fn
def floor_mod(x, y):
    return torch.remainder(x, _t(y, x))


def remainder(x, y, name=None):
    from .math import mod
    return mod(x, y)


@op_fn(name="renorm_op")
def _renorm(x, *, p, axis, max_norm):
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.sum(flat.abs() ** p, dim=1) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    flat = flat * factor[:, None]
    return torch.movedim(flat.reshape(moved.shape), 0, axis)


def renorm(x, p, axis, max_norm, name=None):
    return _renorm(x, p=float(p), axis=int(axis), max_norm=float(max_norm))


@op_fn(name="multiplex_op")
def _multiplex(*inputs, index):
    stacked = torch.stack(inputs, dim=0)        # [n, batch, ...]
    sel = index.reshape(-1).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[sel, rows]


def multiplex(inputs, index, name=None):
    return _multiplex(*inputs, index=index)


@op_fn
def polar(abs, angle):
    return torch.polar(abs, _t(angle, abs))


@op_fn(name="reduce_as_op")
def _reduce_as(x, *, target_shape):
    ndiff = x.ndim - len(target_shape)
    axes = list(range(ndiff))
    for i, (xs, ts) in enumerate(zip(x.shape[ndiff:], target_shape)):
        if ts == 1 and xs != 1:
            axes.append(ndiff + i)
    out = torch.sum(x, dim=tuple(axes)) if axes else x
    return out.reshape(target_shape)


def reduce_as(x, target, name=None):
    return _reduce_as(x, target_shape=tuple(target.shape))


@op_fn(name="take_op")
def _take(x, index, *, mode="raise"):
    flat = x.reshape(-1)
    idx = index.long()
    n = flat.shape[0]
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = idx.clamp(0, n - 1)
    else:   # 'raise': a negative index wraps once, then clipped
        idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return flat[idx]


def take(x, index, mode="raise", name=None):
    if mode not in ("raise", "wrap", "clip"):
        raise E.InvalidArgumentError(
            f"'mode' must be raise/wrap/clip, got {mode}")
    return _take(x, index, mode=mode)


@op_fn(differentiable=False)
def isneginf(x):
    return torch.isneginf(x)


@op_fn(differentiable=False)
def isposinf(x):
    return torch.isposinf(x)


@op_fn(differentiable=False)
def isreal(x):
    return torch.isreal(x)


def is_complex(x):
    return x.is_complex()


def is_floating_point(x):
    return x.is_floating_point()


def is_integer(x):
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def rank(input):
    return wrap(torch.tensor(input.ndim, dtype=torch.int32,
                             device=input.device))


def increment(x, value=1.0, name=None):
    """``paddle.increment``: adds ``value`` to ``x`` in place, outside
    autograd (step counters and other bookkeeping tensors)."""
    with torch.no_grad():
        x.add_(value)
    return x


@op_fn(name="add_n_op")
def _add_n(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def add_n(inputs, name=None):
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    return _add_n(*inputs)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))
