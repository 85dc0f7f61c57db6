"""The op library's semantics where JAX and torch differ, held to the
reference (``paddle_tpu``), not to torch: gather / scatter, descending
sort and ties, ``unique``, ``split`` with ``-1``, integer arithmetic and
promotion, rounding, ``argmax`` dtype, unbiased ``std`` / ``var``,
crossed ``clip`` bounds, empty and 0-d tensors, NaN / Inf, the domains of
``pow`` / ``sqrt`` / ``log``, decompositions up to sign; then the
in-place surface, ``check_nan_inf``, the monitor's op and tensor-byte
counters (the reference's ``tests/test_monitor.py`` cases over flat-op
calls) and a profiler window's op spans. Float32 at rtol 1e-5 / atol
1e-6 unless a case says otherwise; integers and booleans exactly."""
from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import monitor as JM
from paddle_tpu.core import flags as JF
from paddle_tpu_torch import device as TD
from paddle_tpu_torch import monitor as TM
from paddle_tpu_torch import profiler as TP
from paddle_tpu_torch.core import flags as TF

from _torch_ops_common import assert_same


@pytest.fixture(autouse=True)
def _cpu():
    prev = TD._current_device
    T.set_device("cpu")
    yield
    TD._current_device = prev


def both(fn_name, *args, **kw):
    """``fn_name`` of both packages on the same numpy inputs."""
    def conv(mod, a):
        if isinstance(a, np.ndarray):
            return (J.to_tensor(a) if mod is J
                    else torch.from_numpy(a.copy()))
        if isinstance(a, (list, tuple)):
            return type(a)(conv(mod, x) for x in a)
        return a
    want = getattr(J, fn_name)(*[conv(J, a) for a in args],
                               **{k: conv(J, v) for k, v in kw.items()})
    got = getattr(T, fn_name)(*[conv(T, a) for a in args],
                              **{k: conv(T, v) for k, v in kw.items()})
    return got, want


def same(fn_name, *args, tol=None, **kw):
    got, want = both(fn_name, *args, **kw)
    assert_same(got, want, tol, fn_name)
    return got, want


A = np.arange(24, dtype=np.float32).reshape(2, 3, 4)


# -- gather / scatter ---------------------------------------------------------

def test_gather_is_take_along_an_axis():
    idx = np.array([[2, 0], [1, 1]], np.int64)
    got, _ = same("gather", A, idx, axis=1)
    assert tuple(got.shape) == (2, 2, 2, 4)       # axis replaced by idx
    same("gather", A, np.array([-1, 0], np.int64), axis=2)   # -1 wraps


def test_scatter_overwrite_false_adds_into_x():
    x = np.ones((4, 3), np.float32)
    upd = np.full((3, 3), 2.0, np.float32)
    got, _ = same("scatter", x, np.array([1, 3, 1]), upd, overwrite=False)
    np.testing.assert_array_equal(got[1].numpy(), 5.0)  # 1 + 2 + 2
    # overwrite without duplicates (with them the winner is undefined)
    same("scatter", x, np.array([2, 0]), upd[:2], overwrite=True)


def test_scatter_nd_and_index_add():
    same("scatter_nd", np.array([[0, 1], [2, 2], [0, 1]]),
         np.array([1.0, 2.0, 3.0], np.float32), [3, 4])
    same("index_add", A, np.array([0, 2, 0]), axis=1,
         value=np.ones((2, 3, 4), np.float32))


# -- sort, ties, topk, unique, split ------------------------------------------

TIES = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0]], np.float32)


def test_descending_sort_and_argsort_ties():
    same("sort", TIES, axis=-1, descending=True)
    got, _ = same("argsort", TIES, axis=-1, descending=True)
    # ties keep their original order (jnp's stable descending argsort)
    np.testing.assert_array_equal(got.numpy(), [[0, 2, 5, 3, 1, 4]])
    same("argsort", TIES, axis=-1)


def test_topk_tie_order_and_smallest():
    got, _ = same("topk", TIES, 4)
    np.testing.assert_array_equal(got[1].numpy(), [[0, 2, 5, 3]])
    same("topk", TIES, 3, largest=False)
    same("topk", A, 2, axis=1)


@pytest.mark.parametrize("flags", [(False, False, False), (True, True, True),
                                   (True, False, True), (False, True, False)])
def test_unique_return_flags(flags):
    x = np.array([[3, 1, 3], [2, 1, 7]], np.int64)
    ri, rv, rc = flags
    same("unique", x, return_index=ri, return_inverse=rv, return_counts=rc)


def test_unique_along_an_axis():
    x = np.array([[1, 2], [0, 5], [1, 2], [0, 5], [9, 9]], np.int64)
    same("unique", x, return_inverse=True, return_counts=True, axis=0)


def test_split_with_minus_one_and_chunk():
    got, _ = same("split", A, [1, -1, 2], axis=2)
    assert [tuple(t.shape) for t in got] == [(2, 3, 1), (2, 3, 1), (2, 3, 2)]
    same("chunk", A, 2, axis=0)
    same("unbind", A, axis=1)


# -- integer arithmetic, promotion, rounding ----------------------------------

NEG = np.array([-7, -6, -1, 0, 5, 7], np.int32)
DIV = np.array([2, -4, 3, 5, -2, -3], np.int32)


def test_floor_divide_and_mod_follow_python_on_negatives():
    got, _ = same("floor_divide", NEG, DIV)
    np.testing.assert_array_equal(got.numpy(), NEG // DIV)
    got, _ = same("mod", NEG, DIV)
    np.testing.assert_array_equal(got.numpy(), NEG % DIV)
    same("mod", NEG.astype(np.float32) * 0.5, DIV.astype(np.float32))


def test_integer_divide_gives_a_float():
    got, _ = same("divide", NEG, DIV)
    assert got.dtype == torch.float32


def test_scalars_promote_as_weak_types():
    got, _ = same("add", NEG, 3)
    assert got.dtype == torch.int32                 # int stays int
    got, _ = same("add", NEG, 2.5)
    assert got.dtype == torch.float32               # int + float -> float32
    bf = np.array([1.0, 2.5, -3.0], np.float32)
    want = J.multiply(J.cast(J.to_tensor(bf), "bfloat16"), 3.0)
    got = T.multiply(torch.from_numpy(bf).bfloat16(), 3.0)
    assert got.dtype == torch.bfloat16              # bf16 * float -> bf16
    assert_same(got, want)
    same("maximum", NEG, 0)
    same("where", NEG > 0, NEG, 1.5)


def test_round_is_half_to_even():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.4999], np.float32)
    got, _ = same("round", x)
    np.testing.assert_array_equal(got.numpy(), [0, 2, 2, -0, -2, 2])


def test_argmax_argmin_are_int64_with_first_tie():
    x = np.array([[1, 5, 5, 0], [7, 7, 2, 7]], np.int32)
    got, _ = same("argmax", x, axis=1)
    assert got.dtype == torch.int64
    got, _ = same("argmin", x)
    assert got.dtype == torch.int64 and got.ndim == 0
    same("argmax", x, axis=None, keepdim=True)


def test_std_var_unbiased_by_default():
    x = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    got, _ = same("std", x)
    np.testing.assert_allclose(got.numpy(), x.std(ddof=1), rtol=1e-5)
    same("var", x, axis=0)
    same("var", x, axis=1, unbiased=False)


# -- clip, empty, 0-d, NaN / Inf, domains -------------------------------------

def test_clip_with_crossed_bounds():
    got, _ = same("clip", np.array([-5.0, 0.0, 5.0], np.float32),
                  min=2.0, max=1.0)
    np.testing.assert_array_equal(got.numpy(), 1.0)
    same("clip", NEG, min=-2, max=3)


def test_empty_tensors():
    e = np.zeros((0, 4), np.float32)
    same("sum", e, axis=0)
    same("mean", e, axis=0)                      # NaN, as numpy
    same("concat", [e, np.ones((2, 4), np.float32)], axis=0)
    same("exp", e)
    same("cumsum", e, axis=0)


def test_zero_d_tensors():
    s = np.array(2.5, np.float32)
    for name in ("exp", "sqrt", "sum", "mean", "abs", "flatten", "logsumexp",
                 "max", "prod", "std"):
        same(name, s)
    same("add", s, np.array([1.0, 2.0], np.float32))
    same("unsqueeze", s, axis=0)


SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -2.0],
                   np.float32)


@pytest.mark.parametrize("name", ["max", "min", "sum", "mean", "exp", "sign",
                                  "tanh", "sigmoid", "abs", "floor",
                                  "isnan", "isinf", "isfinite", "cumsum",
                                  "logsumexp", "nan_to_num", "nansum",
                                  "nanmean"])
def test_nan_inf_propagation(name):
    same(name, SPECIAL)


def test_maximum_minimum_propagate_nan_and_fmax_ignores_it():
    b = np.array([1.0, np.nan, 3.0, np.nan, 0.0, 4.0, 1.0], np.float32)
    for name in ("maximum", "minimum", "fmax", "fmin"):
        same(name, SPECIAL, b)


def test_domains_of_pow_sqrt_log():
    x = np.array([4.0, 0.0, -1.0, np.inf, -np.inf, 0.25], np.float32)
    for name in ("sqrt", "log", "log2", "log10", "log1p", "rsqrt"):
        same(name, x)
    same("pow", np.array([-2.0, -8.0, 0.0, 2.0], np.float32),
         np.array([0.5, 1.0 / 3.0, -1.0, 3.0], np.float32))
    same("pow", np.array([-2.0, 3.0], np.float32), 2)
    same("pow", NEG[NEG >= 0], 2)


def test_decompositions_up_to_sign():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 5, 4)).astype(np.float32)
    got, want = both("pinv", a)
    # a pseudo-inverse is unique: A A+ A == A on both sides
    recon = np.einsum("bij,bjk,bkl->bil", a, got.numpy(), a)
    np.testing.assert_allclose(recon, a, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-4, atol=1e-5)
    low = a @ rng.normal(size=(3, 4, 2)).astype(np.float32) @ rng.normal(
        size=(3, 2, 4)).astype(np.float32)
    same("matrix_rank", low)
    spd = a.transpose(0, 2, 1) @ a + np.eye(4, dtype=np.float32)
    got, _ = same("cholesky", spd, tol=(1e-4, 1e-5))
    L = got.numpy()
    np.testing.assert_allclose(L @ L.transpose(0, 2, 1), spd, rtol=1e-4,
                               atol=1e-4)
    same("slogdet", spd, tol=(1e-4, 1e-5))


def test_failed_cholesky_is_nan():
    bad = np.array([[[1.0, 2.0], [2.0, 1.0]]], np.float32)
    got, _ = same("cholesky", bad)
    # the factor's lower triangle is NaN, its upper one 0 (jnp's)
    assert np.isnan(np.tril(got.numpy()[0])[np.tril_indices(2)]).all()


# -- the in-place surface -----------------------------------------------------

@pytest.mark.parametrize("name,args,kw", [
    ("add_", (A, 2.0), {}), ("exp_", (A / 10,), {}),
    ("clip_", (A,), {"min": 3.0, "max": 9.0}),
    ("reshape_", (A,), {"shape": [6, 4]}), ("t_", (A[0],), {}),
    ("squeeze_", (A[:1],), {"axis": 0}),
    ("equal_", (A, A * (A > 5)), {}), ("cast_", (A, "int32"), {}),
    ("scale_", (A,), {"scale": 0.5, "bias": 1.0}),
    ("where_", (A > 10, A, -A), {}),
])
def test_in_place_writes_the_reference_value_into_x(name, args, kw):
    jx = [J.to_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    tx = [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a
          for a in args]
    w = 1 if name == "where_" else 0
    want = getattr(J, name)(*jx, **kw)
    got = getattr(T, name)(*tx, **kw)
    assert got is tx[w]                                  # x itself
    assert_same(got, want, None, name)
    assert_same(tx[w], jx[w], None, name)


def test_in_place_on_a_leaf_that_requires_grad_raises():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="in-place"):
        T.add_(x, 1.0)


def test_in_place_gradient_flows_through_the_old_value():
    x0 = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    y = torch.tensor([4.0, 5.0, 6.0], requires_grad=True)
    x = x0 * 1.0
    T.multiply_(x, y)
    T.exp_(x)
    x.sum().backward()
    np.testing.assert_allclose(x0.grad.numpy(),
                               (y * torch.exp(x0 * y)).detach().numpy())
    np.testing.assert_allclose(y.grad.numpy(),
                               (x0 * torch.exp(x0 * y)).detach().numpy())


# -- check_nan_inf ------------------------------------------------------------

@pytest.fixture
def nan_check():
    saved = TF.flag_value("check_nan_inf"), JF.flag_value("check_nan_inf")
    TF.set_flags({"check_nan_inf": True})
    JF.set_flags({"check_nan_inf": True})
    yield
    TF.set_flags({"check_nan_inf": saved[0]})
    JF.set_flags({"check_nan_inf": saved[1]})


def test_check_nan_inf_names_the_op(nan_check):
    x = np.array([-1.0, 4.0], np.float32)
    for mod, t in ((J, J.to_tensor(x)), (T, torch.from_numpy(x))):
        with pytest.raises(FloatingPointError, match="op 'log'"):
            mod.log(t)
        with pytest.raises(FloatingPointError, match="op 'divide'"):
            mod.divide(t, mod.zeros_like(t))
        mod.sqrt(mod.abs(t))                  # finite: no error
        mod.equal(t, t)                       # a bool output is not checked


# -- the monitor: op counters and tensor bytes --------------------------------

@pytest.fixture
def mon():
    JM.reset()
    TM.reset()
    JF.set_flags({"enable_monitor": True})
    TF.set_flags({"enable_monitor": True})
    yield
    JF.set_flags({"enable_monitor": False})
    TF.set_flags({"enable_monitor": False})
    JM.reset()
    TM.reset()


def _flat_calls(P, to):
    x = to(np.ones((4, 4), np.float32))
    y = to(np.full((4, 4), 2.0, np.float32))
    z = P.add(x, y)
    z = P.matmul(P.multiply(z, y), x, transpose_y=True)
    parts = P.split(z, 2, axis=0)
    w = P.concat(parts, axis=1)
    P.sum(w, axis=1)
    P.mean(P.exp(P.tanh(w)))
    P.nn.functional.softmax(w, axis=-1)
    P.nn.functional.relu(P.subtract(w, 3.0))
    P.clip_(w, min=0.0, max=1.0)
    P.reshape(P.transpose(w, perm=[1, 0]), shape=[-1])
    P.topk(w, 2)
    P.cast(w, "float16")


def _op_counts(snap):
    return {k: v for k, v in snap.get("counters", {}).items()
            if k.startswith("op.")}


def test_op_counters_agree_with_the_reference(mon):
    _flat_calls(J, J.to_tensor)
    _flat_calls(T, torch.from_numpy)
    want, got = JM.snapshot(), TM.snapshot()
    assert _op_counts(got) == _op_counts(want)
    assert _op_counts(got)["op.add.calls"] == 1
    n = sum(_op_counts(got).values())
    assert got["histograms"]["op.dispatch.wall_ns"]["count"] == n == \
        want["histograms"]["op.dispatch.wall_ns"]["count"]


def test_python_operators_count_nothing(mon):
    x = torch.ones(3)
    _ = x + x
    assert "counters" not in TM.snapshot()


def test_flag_off_registers_no_counter():
    TM.reset()
    x = torch.ones(2)
    T.add(x, x)
    T.to_tensor(np.ones(3, np.float32))
    assert TM.snapshot() == {}


def _live():
    return TM.snapshot().get("gauges", {}).get("tensor.bytes.live", 0)


def _jlive():
    return JM.snapshot().get("gauges", {}).get("tensor.bytes.live", 0)


def test_live_and_peak_track_construction(mon):
    for P, live, snap in ((J, _jlive, JM.snapshot), (T, _live, TM.snapshot)):
        before = live()
        t = P.to_tensor(np.zeros((128, 128), "float32"))
        after = live()
        assert after - before == 128 * 128 * 4
        assert snap()["gauges"]["tensor.bytes.peak"] >= after
        del t
        gc.collect()
        assert live() == before


def test_flat_op_outputs_count_as_the_reference(mon):
    x = np.ones((8, 16), np.float32)
    for P, to, live in ((J, J.to_tensor, _jlive),
                        (T, torch.from_numpy, _live)):
        a = to(x)                       # counted by J.to_tensor only
        base = live()
        y = P.exp(a)
        z = P.add(y, a)
        parts = P.split(z, 2, axis=1)   # two halves
        assert live() - base == 3 * 8 * 16 * 4
        del y, z, parts
        gc.collect()
        assert live() == base
    assert TM.snapshot()["gauges"]["tensor.bytes.peak"] == \
        JM.snapshot()["gauges"]["tensor.bytes.peak"] - 8 * 16 * 4


def test_peak_survives_frees(mon):
    t = T.to_tensor(np.zeros((256, 256), "float32"))
    peak = TM.snapshot()["gauges"]["tensor.bytes.peak"]
    del t
    gc.collect()
    assert TM.snapshot()["gauges"]["tensor.bytes.peak"] == peak


def test_flag_flip_does_not_pin_live(mon):
    t = T.to_tensor(np.zeros((64, 64), "float32"))
    live_on = _live()
    TF.set_flags({"FLAGS_enable_monitor": False})
    del t
    gc.collect()
    TF.set_flags({"FLAGS_enable_monitor": True})
    assert _live() <= live_on - 64 * 64 * 4


def test_reset_drops_straggler_frees(mon):
    t = T.zeros([64, 64])
    TM.reset()
    del t
    gc.collect()
    assert "tensor.bytes.live" not in TM.snapshot().get("gauges", {})


def test_straggler_free_cannot_corrupt_next_generation(mon):
    t1 = T.to_tensor(np.zeros((256, 256), "float32"))
    TM.reset()
    t2 = T.ones([8, 8])
    del t1
    gc.collect()
    assert TM.snapshot()["gauges"]["tensor.bytes.live"] == 8 * 8 * 4
    del t2


# -- the profiler's op spans ------------------------------------------------

def test_a_flat_op_is_one_span_under_the_reference_name():
    x = torch.ones(4, 4)
    p = TP.Profiler()
    with p:
        T.nn.functional.softmax(x, axis=-1)
        T.matmul(x, x, transpose_y=True)
        T.nn.functional.relu(x)
        T.concat([x, x], axis=0)
        _ = x + x                          # a torch call: its own span
    names = [e["name"] for e in p.events()]
    assert names == ["softmax", "matmul", "relu", "concat", "add"]
    from paddle_tpu_torch.ops import _op
    assert _op._PROFILE_HOOK is None
