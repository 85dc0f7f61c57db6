"""Port parity: the fused RMSNorm (``kernels/rms_norm.py``) and its
dispatch into ``F.rms_norm``.

The same numpy inputs go through the JAX package's
``paddle_tpu.kernels.rms_norm.rms_norm`` (its Pallas kernels in
interpret mode when ``n % 8 == 0``, its own plain fallback otherwise)
and the port's, whose CPU tensors take the plain versions. Gradients are
``jax.vjp`` of the JAX function against ``_RmsNorm``'s backward, with one
cotangent drawn from the seed.

Tolerances: float32 ``y`` within ``1e-6 * max |y|`` and ``dx`` within
``1e-5 * max |dx|`` (summation order, and ``rsqrt`` in the last bit);
bfloat16 and float16 ``y`` / ``dx`` within one ulp of their type of each
value (the float32 numbers before the one rounding may differ in the
last bit and round the other way; float16 ulps stop shrinking at its
subnormals); ``dw`` within ``1e-5`` of ``max |dw|`` in float32, one
bfloat16 ulp in bfloat16, and one float16 ulp or ``1e-6`` of ``max
|dw|`` (float32 summation order) in float16.
"""
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import _make_rms_dispatch as jax_rms_dispatch
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.core.tensor import from_numpy
from paddle_tpu_torch.kernels import rms_norm as TRN
from paddle_tpu_torch.nn import functional as TF

JRN = importlib.import_module("paddle_tpu.kernels.rms_norm")
EPS = 1e-5
_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
       "float16": np.float16}
# significand bits after the leading one: a 2-byte type's ulp; and the
# spacing of its subnormals, below which the ulp does not shrink
_BITS = {"bfloat16": 7, "float16": 10}
_SUBNORMAL_ULP = {"bfloat16": 2.0 ** -133, "float16": 2.0 ** -24}


def _inputs(n, d, xdt, wdt, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32).astype(_NP[xdt])
    w = (1 + 0.3 * rng.normal(size=(d,))).astype(np.float32).astype(
        _NP[wdt])
    dy = rng.normal(size=(n, d)).astype(np.float32).astype(_NP[xdt])
    return x, w, dy


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _ulp_close(got, want, what, dtype="bfloat16", floor=0.0):
    """|got - want| within one ulp of ``dtype`` (bfloat16 or float16) of
    the larger magnitude, or within ``floor``."""
    got, want = _f32(got), _f32(want)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.maximum(np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30)))
                             - _BITS[dtype]), _SUBNORMAL_ULP[dtype])
    ulp = np.maximum(ulp, floor)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), (what, int(bad.sum()), got[bad][:4], want[bad][:4])


def _rel_close(got, want, tol, what):
    got, want = _f32(got), _f32(want)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("d", [64, 4096])
@pytest.mark.parametrize("n", [64, 22, 1])
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("float32", "bfloat16"),
                                     ("float16", "float16"),
                                     ("float16", "float32"),
                                     ("float32", "float16")])
def test_rms_norm_matches_jax(n, d, xdt, wdt):
    x, w, dy = _inputs(n, d, xdt, wdt)
    y_j, vjp = jax.vjp(lambda a, b: JRN.rms_norm(a, b, EPS),
                       jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy))

    tx = from_numpy(x).requires_grad_()
    tw = from_numpy(w).requires_grad_()
    TK.reset_dispatch_stats()
    y_t = TRN.rms_norm(tx, tw, EPS)
    dx_t, dw_t = torch.autograd.grad(y_t, (tx, tw), from_numpy(dy))
    stats = TK.dispatch_stats()
    assert stats["rms_ref"] == 1 and stats["rms_bwd_ref"] == 1
    assert stats["rms"] == 0 and stats["rms_bwd"] == 0
    assert y_t.dtype == tx.dtype and dx_t.dtype == tx.dtype
    assert dw_t.dtype == tw.dtype and tuple(dw_t.shape) == (d,)

    y_t, dx_t, dw_t = (t.detach().float().numpy() for t in (y_t, dx_t, dw_t))
    if xdt == "float32":
        _rel_close(y_t, y_j, 1e-6, "y")
        _rel_close(dx_t, dx_j, 1e-5, "dx")
    else:
        _ulp_close(y_t, y_j, "y", xdt)
        _ulp_close(dx_t, dx_j, "dx", xdt)
    if wdt == "float32":
        _rel_close(dw_t, dw_j, 1e-5, "dw")
    else:
        # dw sums n rows in float32 in another order: where the sum
        # cancels to a small value, that float32 roundoff (1e-6 of max
        # |dw|) exceeds the small value's float16 ulp
        _ulp_close(dw_t, dw_j, "dw", wdt,
                   1e-6 * float(np.abs(_f32(dw_j)).max())
                   if wdt == "float16" else 0.0)


def test_forward_alone_saves_rstd():
    """Without autograd the wrapper runs the forward alone, and its rstd
    is the JAX kernel's saved residual."""
    x, w, _ = _inputs(64, 64, "float32", "float32")
    y, rstd = TRN.rms_norm_fwd(from_numpy(x), from_numpy(w), EPS)
    res = JRN._rms_fwd(jnp.asarray(x), jnp.asarray(w), EPS,
                       JRN.DEFAULT_BLOCK_ROWS, True)[1]
    np.testing.assert_allclose(rstd.numpy(), np.asarray(res[2])[:, 0],
                               rtol=1e-6)
    with torch.no_grad():
        TK.reset_dispatch_stats()
        TRN.rms_norm(from_numpy(x).requires_grad_(), from_numpy(w), EPS)
    assert TK.dispatch_stats()["rms_ref"] == 1


@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16")])
def test_dispatch_matches_jax_dispatch(xdt, wdt):
    """``F.rms_norm`` through the port's dispatcher, against the
    reference's dispatcher with its kernel (``tpu_only=False``): the
    output takes the result type of x and w. Leading dims are
    flattened."""
    x, w, _ = _inputs(16, 64, xdt, wdt, seed=3)
    x = x.reshape(2, 8, 64)
    want = jax_rms_dispatch(False)(jnp.asarray(x), jnp.asarray(w), EPS)
    TK.reset_dispatch_stats()
    got = TF.rms_norm(from_numpy(x), from_numpy(w), epsilon=EPS)
    assert TK.dispatch_stats()["rms_ref"] == 1
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if want.dtype == jnp.float32 and xdt == "float32":
        _rel_close(got.numpy(), want, 1e-6, "y")
    else:
        _ulp_close(got.float().numpy(), want, "y")


def test_wrong_weight_shape_takes_the_fallback():
    """A weight that is not ``[x.shape[-1]]`` takes the reference's plain
    math (normalise, round to x's type, scale), counted
    ``rms_fallback``, on the port as in the reference."""
    x, w, _ = _inputs(8, 64, "bfloat16", "float32", seed=5)
    w2 = w.reshape(1, 64)
    want = jax_rms_dispatch(False)(jnp.asarray(x), jnp.asarray(w2), EPS)
    TK.reset_dispatch_stats()
    got = TF.rms_norm(from_numpy(x), from_numpy(w2), epsilon=EPS)
    stats = TK.dispatch_stats()
    assert stats["rms_fallback"] == 1 and stats["rms_ref"] == 0
    assert got.dtype == torch.float32
    _rel_close(got.numpy(), want, 1e-6, "y")


@pytest.mark.parametrize("case", ["no_weight", "no_weight_axis1",
                                  "weight_axis1"])
def test_missing_weight_and_other_axis_match_jax(case):
    """``F.rms_norm`` against the reference's with no weight (the kernels'
    plain version with a weight of ones, moved to the last axis for
    ``axis=1``; counted ``rms_ref``) and with a weight and ``axis=1``
    (the reference's plain math, CPU tensors only): bfloat16 ``x``,
    within one bfloat16 ulp of each value."""
    import paddle_tpu as jpaddle
    import paddle_tpu.nn.functional as JF
    x, w, _ = _inputs(16, 8, "bfloat16", "float32", seed=6)
    x = x.reshape(2, 8, 8)
    weight, axis = {"no_weight": (None, -1), "no_weight_axis1": (None, 1),
                    "weight_axis1": (w, 1)}[case]
    want = JF.rms_norm(jpaddle.to_tensor(x), None if weight is None else
                       jpaddle.to_tensor(weight), epsilon=EPS,
                       axis=axis).numpy()
    TK.reset_dispatch_stats()
    got = TF.rms_norm(from_numpy(x), None if weight is None else
                      from_numpy(weight), epsilon=EPS, axis=axis)
    stats = TK.dispatch_stats()
    assert stats["rms_ref"] == (weight is None) and stats["rms_fallback"] == 0
    assert tuple(got.shape) == x.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _ulp_close(got.float().numpy(), want, "y")


_ESIZE = {torch.float32: 4, torch.bfloat16: 2}


@pytest.mark.parametrize("n,d,xdt,aligned,route", [
    (8192, 4096, torch.bfloat16, True, "bulk"),
    (4096, 4096, torch.float32, True, "bulk"),
    (1, 4096, torch.bfloat16, True, "bulk"),
    (7, 4096, torch.bfloat16, True, "bulk"),
    (8193, 5120, torch.bfloat16, True, "bulk"),
    (22, 64, torch.float32, True, "bulk"),
    (64, 512, torch.bfloat16, True, "bulk"),
    (2048, 16384, torch.bfloat16, True, "bulk"),
    (300, 16384, torch.float32, True, "bulk"),
    (64, 100, torch.bfloat16, True, "scalar"),
    (8193, 5120, torch.float32, False, "scalar"),
    (10 ** 6, 4092, torch.float32, True, "scalar")])
def test_bwd_plan(n, d, xdt, aligned, route):
    """The backward's plan is a function of ``n``, ``d``, the types and
    alignment alone (so dw's sums run in one order at every launch),
    takes the bulk route exactly for ``d % 8 == 0`` and aligned pointers,
    stays within the kernel's limits (512 threads, 8 groups, 4 stages, 4
    chunks of 8 columns a thread, 192 KB of rings, rings that
    hold the groups' dw accumulators) and hands every row to exactly one
    row group (group q of Q takes rows q, q + Q, ...)."""
    for wdt in (torch.float32, torch.bfloat16):
        plan = TRN.bwd_plan(n, d, xdt, wdt, aligned)
        assert plan == TRN.bwd_plan(n, d, xdt, wdt, aligned)
        assert plan.route == route
        groups = plan.grid * plan.groups
        taken = [min(plan.rows, max(0, -(-(n - q) // groups)))
                 for q in range(groups)]
        assert sum(taken) == n and max(taken) == plan.rows
        assert 1 <= plan.grid <= (132 if route == "bulk" else 264)
        if route == "scalar":
            assert plan.stages == 0 and plan.groups == 1
            assert plan.rows >= min(n, 32)
            continue
        ring = plan.groups * plan.stages * 2 * d * _ESIZE[xdt]
        assert plan.threads % 32 == 0 and plan.groups * plan.threads <= 512
        assert 1 <= plan.groups <= 8 and 1 <= plan.stages <= 4
        assert -(-d // 8 // plan.threads) <= 4
        assert plan.groups * d * 4 <= ring <= 192 * 1024
        if (n, d) == (8192, 4096):      # the eager path's shape
            assert plan == TRN.BwdPlan("bulk", 132, 2, 256, 3, 32)
