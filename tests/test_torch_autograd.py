"""Port parity: ``paddle_tpu_torch.autograd`` and the grad-mode switches
(``core/state.py``) against ``paddle_tpu.autograd`` and ``jax.grad``.

The same numpy float32 inputs go through the reference's eager tape, the
port (torch's autograd) and JAX's transforms; values agree within 1e-5
relative (float32; an exact zero against an exact zero). Covered: ``grad``
(several inputs, ``allow_unused``, ``create_graph`` to second and third
order, mixed partials), ``backward``, ``jacobian`` / ``hessian`` (single
and several inputs; ``batch_axis=0`` gives the per-sample blocks of the
reference's dense result), ``PyLayer`` (saved tensors, several inputs
and outputs, non-Tensor arguments, a None grad, the arity error, one
Tensor passed twice, double backward through it, ``saved_tensors_hooks``,
training inside a module), ``no_grad`` / ``enable_grad`` /
``set_grad_enabled`` / ``is_grad_enabled`` and ``functional_mode``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.autograd as jag
import paddle_tpu_torch
import paddle_tpu_torch.autograd as tag
from paddle_tpu_torch.core import enforce as TE
from paddle_tpu_torch.core import state as TS

RTOL = 1e-5


def _close(got, *wants):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    for want in wants:
        want = np.asarray(want.numpy() if hasattr(want, "numpy")
                          and not isinstance(want, np.ndarray) else want,
                          np.float32)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=True)


def _j(x):
    return pt.to_tensor(np.asarray(x, np.float32), stop_gradient=False)


def test_grad_several_inputs_and_unused():
    xv, wv = np.float32(2.0), np.float32(3.0)
    tx, tw = _t(xv), _t(wv)
    jx, jw = _j(xv), _j(wv)
    tg = tag.grad(tx * tw + tx, [tx, tw])
    jg = pt.grad(jx * jw + jx, [jx, jw])
    assert isinstance(tg, list) and len(tg) == 2
    for a, b in zip(tg, jg):
        _close(a, b)
    assert tx.grad is None                # .grad untouched
    tu = _t(1.0)
    with pytest.raises(TE.PreconditionNotMetError):
        tag.grad(tx * tx, [tx, tu])
    with pytest.raises(RuntimeError):
        jag.grad(jx * jx, [jx, _j(1.0)])
    gx, gu = tag.grad(tx * tx, [tx, tu], allow_unused=True)
    assert gu is None
    _close(gx, jag.grad(jx * jx, [jx, _j(1.0)], allow_unused=True)[0])


def test_grad_of_grad_matches_jax():
    def f(x):
        return jnp.sin(x) * x * x

    x0 = np.float32(0.7)
    ta, ja = _t(x0), _j(x0)
    (tg,) = tag.grad((ta * ta) * torch.sin(ta), ta, create_graph=True)
    (tgg,) = tag.grad(tg, ta)
    (jg,) = pt.grad((ja * ja) * pt.sin(ja), ja, create_graph=True)
    (jgg,) = pt.grad(jg, ja)
    _close(tg, jg, jax.grad(f)(jnp.float32(x0)))
    _close(tgg, jgg, jax.grad(jax.grad(f))(jnp.float32(x0)))


def test_third_order_and_mixed_partials():
    ta, ja = _t(0.5), _j(0.5)
    tg = [ta * ta * ta * ta]
    jg = [ja * ja * ja * ja]
    for order in range(3):
        last = order == 2
        tg.append(tag.grad(tg[-1], ta, create_graph=not last)[0])
        jg.append(pt.grad(jg[-1], ja, create_graph=not last)[0])
    f = lambda x: x ** 4                                    # noqa: E731
    jx = [jax.grad(f), jax.grad(jax.grad(f)),
          jax.grad(jax.grad(jax.grad(f)))]
    for t, j, fj in zip(tg[1:], jg[1:], jx):
        _close(t, j, fj(jnp.float32(0.5)))
    # d2 (x^2 y) / dx dy = 2x
    tx, ty, jxx, jy = _t(3.0), _t(5.0), _j(3.0), _j(5.0)
    (tgx,) = tag.grad(tx * tx * ty, tx, create_graph=True)
    (jgx,) = pt.grad(jxx * jxx * jy, jxx, create_graph=True)
    _close(tag.grad(tgx, ty)[0], pt.grad(jgx, jy)[0], 6.0)


def test_backward_accumulates_into_grad():
    xv = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    gv = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    tx, jx = _t(xv), _j(xv)
    tag.backward(torch.tanh(tx), torch.as_tensor(gv), retain_graph=False)
    jag.backward(pt.tanh(jx), pt.to_tensor(gv))
    _close(tx.grad, jx.grad)
    tag.backward([(tx * tx).sum()])
    jag.backward([(jx * jx).sum()])
    _close(tx.grad, jx.grad)


def _jf(x):
    return jnp.tanh(x) * x * x


def test_jacobian_and_hessian_match():
    xv = np.random.default_rng(2).standard_normal(5).astype(np.float32)
    tx, jx = _t(xv), _j(xv)
    tj = tag.jacobian(torch.tanh(tx) * tx * tx, tx)
    jj = jag.jacobian(pt.tanh(jx) * jx * jx, jx)
    assert tuple(tj.shape) == (5, 5)
    _close(tj, jj, jax.jacobian(_jf)(jnp.asarray(xv)))
    th = tag.hessian((torch.tanh(tx) * tx * tx).sum(), tx)
    jh = jag.hessian((pt.tanh(jx) * jx * jx).sum(), jx)
    _close(th, jh, jax.hessian(lambda x: _jf(x).sum())(jnp.asarray(xv)))


def test_jacobian_hessian_of_several_inputs():
    rng = np.random.default_rng(3)
    xv = rng.standard_normal(3).astype(np.float32)
    yv = rng.standard_normal(2).astype(np.float32)

    def fj(x, y):
        return (x * x).sum() * (y * y * y).sum()

    tx, ty, jx, jy = _t(xv), _t(yv), _j(xv), _j(yv)
    th = tag.hessian((tx * tx).sum() * (ty * ty * ty).sum(), [tx, ty])
    jh = jag.hessian((jx * jx).sum() * (jy * jy * jy).sum(), [jx, jy])
    want = jax.hessian(fj, argnums=(0, 1))(jnp.asarray(xv), jnp.asarray(yv))
    for i in range(2):
        for k in range(2):
            _close(th[i][k], jh[i][k], want[i][k])
    tout = [tx * ty.sum(), (tx * tx).sum() + ty[0]]
    jout = [jx * jy.sum(), (jx * jx).sum() + jy[0]]
    tj = tag.jacobian(tout, [tx, ty])
    jj = jag.jacobian(jout, [jx, jy])
    for i in range(2):
        for k in range(2):
            _close(tj[i][k], jj[i][k])


def test_batch_axis_gives_the_per_sample_blocks():
    """``batch_axis=0``: the reference ignores it and returns the dense
    ``[B, N, B, N]`` result; the port returns its per-sample blocks."""
    xv = np.random.default_rng(4).standard_normal((3, 4)).astype(np.float32)
    tx, jx = _t(xv), _j(xv)
    tj = tag.jacobian(torch.tanh(tx) * tx, tx, batch_axis=0)
    dense = jag.jacobian(pt.tanh(jx) * jx, jx, batch_axis=0).numpy()
    assert dense.shape == (3, 4, 3, 4) and tuple(tj.shape) == (3, 4, 4)
    _close(tj, np.stack([dense[b, :, b, :] for b in range(3)]))
    th = tag.hessian((torch.tanh(tx) * tx * tx).sum(1), tx, batch_axis=0)
    jh = jax.vmap(jax.hessian(lambda r: _jf(r).sum()))(jnp.asarray(xv))
    _close(th, jh)
    with pytest.raises(TE.InvalidArgumentError):
        tag.jacobian(tx * 2, tx, batch_axis=1)


def _layers(ag):
    class Cube(ag.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 3.0 * x * x

    class MulAdd(ag.PyLayer):
        @staticmethod
        def forward(ctx, x, y):
            ctx.save_for_backward(x, y)
            return x * y, x + y

        @staticmethod
        def backward(ctx, dprod, dsum):
            x, y = ctx.saved_tensor()
            return dprod * y + dsum, dprod * x + dsum

    class ScaleFirst(ag.PyLayer):
        @staticmethod
        def forward(ctx, x, y, k):
            ctx.k = k
            return x * k + y * 0.0

        @staticmethod
        def backward(ctx, dy):
            return dy * ctx.k, None

    class Bad(ag.PyLayer):
        @staticmethod
        def forward(ctx, x, y):
            return x + y

        @staticmethod
        def backward(ctx, dy):
            return dy

    class TwoSlot(ag.PyLayer):
        @staticmethod
        def forward(ctx, x, y):
            return x * 1.0 + y * 2.0

        @staticmethod
        def backward(ctx, dy):
            return dy * 1.0, dy * 2.0

    return Cube, MulAdd, ScaleFirst, Bad, TwoSlot


def test_pylayer_matches_the_reference():
    xv = np.random.default_rng(5).standard_normal(4).astype(np.float32)
    yv = np.random.default_rng(6).standard_normal(4).astype(np.float32)
    T, J = _layers(tag), _layers(jag)
    out = {}
    for side, (Cube, MulAdd, ScaleFirst, _, TwoSlot), mk in (
            ("torch", T, _t), ("jax", J, _j)):
        a, b, c = mk(xv), mk(yv), mk(xv)
        y = Cube.apply(a)
        y.sum().backward()
        p, s = MulAdd.apply(a, b)
        (p + 2.0 * s).sum().backward()
        d = ScaleFirst.apply(c, b, 5.0)
        d.sum().backward()
        e = mk(xv)
        TwoSlot.apply(e, e).sum().backward()
        out[side] = [y, a.grad, b.grad, c.grad, e.grad]
    for t, j in zip(out["torch"], out["jax"]):
        _close(t, j)
    _close(out["torch"][1], 3 * xv ** 2 + yv + 2)
    _close(out["torch"][4], np.full(4, 3.0))


def test_pylayer_arity_error_and_none_grad():
    (_, _, ScaleFirst, Bad, _), (_, _, JScale, JBad, _) = \
        _layers(tag), _layers(jag)
    a, b = _t(1.0), _t(1.0)
    with pytest.raises(TE.InvalidArgumentError):
        Bad.apply(a, b).backward()
    ja, jb = _j(1.0), _j(1.0)
    with pytest.raises(ValueError):
        JBad.apply(ja, jb).backward()
    ScaleFirst.apply(a, b, 5.0).backward()
    JScale.apply(ja, jb, 5.0).backward()
    assert b.grad is None and jb.grad is None
    _close(a.grad, ja.grad, 5.0)


def test_pylayer_double_backward_matches():
    (Cube, *_), (JCube, *_) = _layers(tag), _layers(jag)
    ta, ja = _t(2.0), _j(2.0)
    (tg,) = tag.grad(Cube.apply(ta), ta, create_graph=True)
    (jg,) = pt.grad(JCube.apply(ja), ja, create_graph=True)
    _close(tg, jg, 12.0)
    _close(tag.grad(tg, ta)[0], pt.grad(jg, ja)[0], 12.0)


def test_saved_tensors_hooks_pack_and_unpack():
    (Cube, *_) = _layers(tag)
    packed, unpacked = [], []

    def pack(x):
        packed.append(tuple(x.shape))
        return x.detach().numpy().copy()

    def unpack(h):
        unpacked.append(h.shape)
        return torch.as_tensor(h)

    x = _t([3.0])
    with tag.saved_tensors_hooks(pack, unpack):
        y = Cube.apply(x)
    y.sum().backward()
    assert packed == [(1,)] and unpacked == [(1,)]
    _close(x.grad, [27.0])


def test_pylayer_trains_inside_a_module():
    class Square(tag.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 2.0 * x

    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 4)
    x = torch.randn(2, 4)
    Square.apply(lin(x)).sum().backward()
    want = torch.autograd.grad((lin(x) ** 2).sum(), lin.weight)[0]
    _close(lin.weight.grad, want)


def test_grad_mode_switches():
    x = _t(1.0)
    assert tag.is_grad_enabled() and TS.grad_enabled()
    with paddle_tpu_torch.no_grad():
        assert not (x * 2).requires_grad and not tag.is_grad_enabled()
        with paddle_tpu_torch.enable_grad():
            assert (x * 2).requires_grad
    prev = paddle_tpu_torch.set_grad_enabled(False)
    try:
        assert prev is True and not (x * 2).requires_grad
        assert tag.set_grad_enabled(False) is False
    finally:
        paddle_tpu_torch.set_grad_enabled(True)
    assert (x * 2).requires_grad

    @tag.no_grad()
    def f(t):
        return t * 2

    assert not f(x).requires_grad
    assert not TS.in_functional_mode()
    with TS.functional_mode():
        assert TS.in_functional_mode() and not TS.grad_enabled()
    assert TS.grad_enabled()
    # the reference's switches over its tape, for the same sequence
    jx = _j(1.0)
    with pt.no_grad():
        assert (jx * 2.0).stop_gradient
    assert not (jx * 2.0).stop_gradient
