"""``paddle_tpu_torch.amp`` against the reference's ``paddle_tpu.amp``.

- The reference's own AMP cases (``tests/test_amp.py``), each run the same
  way on both packages and compared: the dtypes, the values at the
  working type's tolerance, the scaler's scale and its skipped steps.
  The port has no ``SGD`` and no ``Sequential`` / ``LayerNorm`` yet, so
  those cases run ``Adam`` and a small ``Layer`` of ``Linear``,
  ``RMSNorm``, ``Linear`` on both sides.
- The dispatch seam's rules: positional inputs only, custom lists,
  nesting and ``enable=False``, O2's black list without the white names,
  and a float32 parameter's gradient under O1 (float32, the value of the
  cast product's).
- ``llama_tiny`` (2 layers) ``LlamaForCausalLM`` in three arms, O1 bf16,
  O1 float16 and O2 bf16, from one set of weights: the loss, the logits
  and the dtype each op ran in against the reference's eager model under
  its ``amp``; the gradients against ``jax.value_and_grad`` of the
  reference's forward with traced parameters (its tape cannot give them:
  ``test_reference_amp_backward_raises``). Tolerances, relative to the
  largest value: bf16 logits 1e-2 and gradients 3e-2 (0.0070 and 0.0148
  measured: both round every product to bf16, at other places), float16
  2e-3 and 5e-3 (0.00084 and 0.0018 measured); losses rtol 1e-3 in bf16,
  1e-4 in float16.
- ``GradScaler``: both packages' scalers on the same gradients, set by
  hand, through a step with an inf.
- ``amp.debugging``: operator stats through the profile hook (a
  profiler's hook put back), the tensor checker, ``check_numerics``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.amp as JA
import paddle_tpu.nn as Jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as Jopt
from paddle_tpu.models import llama as JL
from paddle_tpu.ops import _op as J_op
import paddle_tpu_torch as T
import paddle_tpu_torch.amp as TA
import paddle_tpu_torch.nn as Tnn
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.optimizer as Topt
from paddle_tpu_torch import device as TD
from paddle_tpu_torch.core import enforce as TE
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops import _op as T_op

BF16_TOL = {"logits": 1e-2, "grads": 3e-2, "loss": 1e-3}
F16_TOL = {"logits": 2e-3, "grads": 5e-3, "loss": 1e-4}
ARMS = {"O1-bf16": ("bfloat16", "O1", BF16_TOL),
        "O1-fp16": ("float16", "O1", F16_TOL),
        "O2-bf16": ("bfloat16", "O2", BF16_TOL)}
V = 256


@pytest.fixture(autouse=True)
def _cpu():
    prev = TD._current_device
    T.set_device("cpu")
    yield
    TD._current_device = prev


def _np(t):
    if hasattr(t, "_data"):
        return np.asarray(t._data, np.float32)
    return t.detach().float().numpy().copy()


def _dt(t):
    d = t._data.dtype if hasattr(t, "_data") else t.dtype
    return str(d).replace("torch.", "")


def _pair(seed, *shape):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return J.to_tensor(a), torch.from_numpy(a.copy())


# -- the reference's cases, on both packages ----------------------------------

@pytest.mark.parametrize("op,args,white,want", [
    ("matmul", 2, None, "bfloat16"),           # a white op
    ("exp", 1, None, "float32"),               # a black op
    ("exp", 1, {"exp"}, "bfloat16"),           # a custom white op
    ("add", 2, None, "float32"),               # neither: the inputs' dtype
])
def test_op_dtype_under_auto_cast(op, args, white, want):
    ja, ta = zip(*[_pair(i, 4, 4) for i in range(args)])
    with JA.auto_cast(dtype="bfloat16", custom_white_list=white):
        jo = getattr(J, op)(*ja)
    with TA.auto_cast(dtype="bfloat16", custom_white_list=white):
        to = getattr(T, op)(*ta)
    assert _dt(jo) == _dt(to) == want
    np.testing.assert_allclose(_np(to), _np(jo), rtol=1e-2, atol=1e-2)
    assert _dt(getattr(T, op)(*ta)) == "float32"       # off outside


def test_python_operators_keep_their_dtype():
    _, x = _pair(0, 4)
    with TA.auto_cast():
        assert (x + x).dtype == torch.float32


def test_nested_and_disabled_restore():
    for A in (JA, TA):
        with A.auto_cast():
            assert A.is_auto_cast_enabled()
            with A.auto_cast(enable=False):
                assert not A.is_auto_cast_enabled()
            assert A.is_auto_cast_enabled()
        assert not A.is_auto_cast_enabled()
    with TA.auto_cast(enable=False):
        _, a = _pair(0, 2, 2)
        assert T.matmul(a, a).dtype == torch.float32


class _TNet(Tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1, self.norm, self.fc2 = (Tnn.Linear(4, 8), Tnn.RMSNorm(8),
                                         Tnn.Linear(8, 2))


class _JNet(Jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1, self.norm, self.fc2 = (Jnn.Linear(4, 8), Jnn.RMSNorm(8),
                                         Jnn.Linear(8, 2))


def test_o2_casts_params_but_not_norms():
    nets = []
    for A, net in ((JA, _JNet()), (TA, _TNet())):
        A.decorate(net, level="O2", dtype="bfloat16")
        nets.append({n: _dt(p) for n, p in net.named_parameters()})
    assert nets[0] == nets[1]
    assert nets[1]["fc1.weight"] == "bfloat16"
    assert nets[1]["norm.weight"] == "float32"
    tnet = _TNet()
    w = tnet.fc1.weight
    TA.decorate(tnet, level="O2")
    assert tnet.fc1.weight is w            # the same Parameter, cast


def test_o2_sets_multi_precision():
    for A, Opt, net in ((JA, Jopt, Jnn.Linear(4, 4)),
                        (TA, Topt, Tnn.Linear(4, 4))):
        o = Opt.AdamW(parameters=net.parameters())
        out = A.decorate(net, o, level="O2")
        assert o._multi_precision and out == (net, o)


def _linear_pair(din, dout, seed=0):
    J.seed(seed)
    jn = Jnn.Linear(din, dout)
    tn = Tnn.Linear(din, dout)
    tn.set_state_dict({k: v.numpy() for k, v in jn.state_dict().items()})
    return jn, tn


@pytest.mark.parametrize("dtype,scaled", [("bfloat16", False),
                                          ("float16", True)])
def test_linear_trains_under_auto_cast(dtype, scaled):
    """The reference's two training loops: 40 bf16 steps, and 30 float16
    steps with a ``GradScaler(1024)``; the same losses in both packages
    (at the working type's tolerance) and falling."""
    steps = 30 if scaled else 40
    jn, tn = _linear_pair(8, 4)
    x, y = (np.random.default_rng(s).standard_normal(
        (8 if scaled else 16, d)).astype(np.float32) for s, d in
        ((1, 8), (2, 4)))
    jo = Jopt.Adam(learning_rate=1e-2, parameters=jn.parameters())
    to = Topt.Adam(learning_rate=1e-2, parameters=tn.parameters())
    js = JA.GradScaler(init_loss_scaling=1024.0)
    ts = TA.GradScaler(init_loss_scaling=1024.0)
    losses = {"ref": [], "port": []}
    for _ in range(steps):
        with JA.auto_cast(dtype=dtype):
            out = jn(J.to_tensor(x))
        loss = J.mean((out.astype("float32") - J.to_tensor(y)) ** 2)
        if scaled:
            js.scale(loss).backward()
            js.step(jo)
            js.update()
        else:
            loss.backward()
            jo.step()
        jo.clear_grad()
        losses["ref"].append(float(loss))
        with TA.auto_cast(dtype=dtype):
            out = tn(torch.from_numpy(x))
        loss = T.mean((out.float() - torch.from_numpy(y)) ** 2)
        if scaled:
            ts.scale(loss).backward()
            ts.step(to)
            ts.update()
        else:
            loss.backward()
            to.step()
        to.clear_grad()
        losses["port"].append(float(loss))
    for side in losses.values():
        assert side[-1] < side[0]
    np.testing.assert_allclose(losses["port"], losses["ref"],
                               rtol=2e-2 if dtype == "bfloat16" else 2e-3)
    if scaled:
        assert ts.get_loss_scaling() == js.get_loss_scaling()


def _params(pkg, values):
    if pkg is J:
        return [J.Parameter(J.to_tensor(np.asarray(v, np.float32))._data)
                for v in values]
    return [T.Parameter(torch.tensor(v, dtype=torch.float32))
            for v in values]


def _grad(pkg, values):
    a = np.asarray(values, np.float32)
    return J.to_tensor(a) if pkg is J else torch.from_numpy(a)


def _val(p):
    return _np(p).tolist()


def test_scale_multiplies():
    for A, pkg in ((JA, J), (TA, T)):
        s = A.GradScaler(init_loss_scaling=8.0)
        loss = (J.to_tensor(np.float32(2.0)) if pkg is J
                else torch.tensor(2.0))
        assert float(s.scale(loss)) == 16.0


def test_unscale_restores_grads():
    got = []
    for A, pkg, Opt in ((JA, J, Jopt), (TA, T, Topt)):
        p, = _params(pkg, [[1.0, 2.0]])
        s = A.GradScaler(init_loss_scaling=4.0)
        s.scale(pkg.sum(p * 3.0)).backward()
        g0 = _np(p.grad).tolist()
        s.unscale_(Opt.Adam(learning_rate=0.0, parameters=[p]))
        got.append((g0, _np(p.grad).tolist()))
    assert got[0] == got[1] == ([12.0, 12.0], [3.0, 3.0])


def test_inf_skips_step_and_decreases_scale():
    got = []
    for A, pkg, Opt in ((JA, J, Jopt), (TA, T, Topt)):
        p, = _params(pkg, [[1.0]])
        o = Opt.Adam(learning_rate=1.0, parameters=[p])
        s = A.GradScaler(init_loss_scaling=64.0, decr_ratio=0.5)
        p.grad = _grad(pkg, [float("inf")])
        s.step(o)
        s.update()
        got.append((_val(p), s.get_loss_scaling()))
    assert got[0] == got[1] == ([1.0], 32.0)


def test_good_steps_increase_scale():
    got = []
    for A, pkg, Opt in ((JA, J, Jopt), (TA, T, Topt)):
        p, = _params(pkg, [[1.0]])
        o = Opt.Adam(learning_rate=0.1, parameters=[p])
        s = A.GradScaler(init_loss_scaling=2.0, incr_every_n_steps=2,
                         incr_ratio=2.0)
        for _ in range(2):
            s.scale(pkg.sum(p * 1.0)).backward()
            s.step(o)
            s.update()
            o.clear_grad()
        got.append((_val(p), s.get_loss_scaling()))
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=1e-6)
    assert got[0][1] == got[1][1] == 4.0


def test_per_optimizer_found_inf():
    got = []
    for A, pkg, Opt in ((JA, J, Jopt), (TA, T, Topt)):
        p1, p2 = _params(pkg, [[1.0], [1.0]])
        o1 = Opt.Adam(learning_rate=1.0, parameters=[p1])
        o2 = Opt.Adam(learning_rate=1.0, parameters=[p2])
        s = A.GradScaler(init_loss_scaling=2.0)
        p1.grad = _grad(pkg, [float("inf")])
        p2.grad = _grad(pkg, [2.0])
        s.unscale_(o1)
        s.unscale_(o2)
        s.step(o1)
        s.step(o2)
        got.append((_val(p1), _val(p2),
                    [s._opt_states[id(o)][1] for o in (o1, o2)]))
    np.testing.assert_allclose(got[1][1], got[0][1], atol=1e-6)
    assert got[0][0] == got[1][0] == [1.0]       # skipped
    assert got[0][2] == got[1][2] == [True, False]


def test_double_step_and_unscale_after_step_raise():
    for A, pkg, Opt, err in ((JA, J, Jopt, RuntimeError),
                             (TA, T, Topt, TE.PreconditionNotMetError)):
        p, = _params(pkg, [[1.0]])
        o = Opt.Adam(learning_rate=0.1, parameters=[p])
        s = A.GradScaler(init_loss_scaling=2.0)
        p.grad = _grad(pkg, [2.0])
        s.step(o)
        with pytest.raises(err):
            s.step(o)
        with pytest.raises(err):
            s.unscale_(o)
        s.update()
        s.step(o)                          # allowed again after update


def test_state_dict_round_trip():
    for A in (JA, TA):
        s = A.GradScaler(init_loss_scaling=7.0, incr_every_n_steps=3)
        s._good_steps, s._bad_steps = 2, 1
        st = s.state_dict()
        s2 = A.GradScaler()
        s2.load_state_dict(st)
        assert (s2.get_loss_scaling(), s2._good_steps, s2._bad_steps) == \
            (7.0, 2, 1)
    assert (JA.GradScaler(init_loss_scaling=7.0).state_dict()
            == TA.GradScaler(init_loss_scaling=7.0).state_dict())


def test_scalers_agree_on_the_same_gradients():
    """Three steps of both scalers on gradients set by hand (the second
    with an inf): unscaled gradients, found-inf, the skipped step, the
    scale and the counters agree, and so do the parameters after Adam."""
    rng = np.random.default_rng(7)
    grads = [rng.standard_normal((3, 4)).astype(np.float32) * 512
             for _ in range(3)]
    grads[1][1, 2] = np.inf
    trace = {}
    for A, pkg, Opt in ((JA, J, Jopt), (TA, T, Topt)):
        ps = _params(pkg, [np.ones((3, 4), np.float32),
                           np.zeros(4, np.float32)])
        o = Opt.Adam(learning_rate=0.1, parameters=ps)
        s = A.GradScaler(init_loss_scaling=256.0, incr_every_n_steps=2,
                         decr_every_n_nan_or_inf=1)
        rows = []
        for g in grads:
            ps[0].grad = _grad(pkg, g)
            ps[1].grad = _grad(pkg, g.sum(0))
            s.unscale_(o)
            unscaled = [_np(p.grad) for p in ps]
            found = s._opt_states[id(o)][1]
            s.step(o)
            s.update()
            o.clear_grad()
            rows.append((unscaled, found, s.get_loss_scaling(),
                         s._good_steps, s._bad_steps, [_np(p) for p in ps]))
        trace[pkg.__name__] = rows
    for r, t in zip(trace["paddle_tpu"], trace["paddle_tpu_torch"]):
        for a, b in zip(t[0], r[0]):
            np.testing.assert_allclose(a, b, rtol=1e-6)
        assert t[1:5] == r[1:5]
        for a, b in zip(t[5], r[5]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert [r[1] for r in trace["paddle_tpu_torch"]] == [False, True, False]


# -- the seam's rules ---------------------------------------------------------

def test_seam_casts_positional_inputs_only():
    """``linear``'s weight given by keyword stays float32: the reference
    casts positional inputs only."""
    ja, ta = _pair(0, 3, 4)
    jw, tw = _pair(1, 4, 5)
    for A, F, x, w in ((JA, JF, ja, jw), (TA, TF, ta, tw)):
        with A.auto_cast(dtype="bfloat16"):
            assert _dt(F.linear(x, w)) == "bfloat16"
            assert _dt(F.linear(x, weight=w)) == "float32"


def test_custom_black_list_and_o2_lists():
    _, x = _pair(0, 4, 4)
    with TA.auto_cast(dtype="bfloat16", custom_black_list={"matmul"}):
        assert T.matmul(x, x).dtype == torch.float32
        assert "matmul" not in TA.white_list()
    for A in (JA, TA):
        with A.auto_cast(level="O2", custom_white_list={"mean"}):
            assert "mean" in A.white_list()
            assert not (set(A.white_list()) & set(A.black_list()))
    with TA.auto_cast(level="O2", custom_white_list={"mean"}):
        assert T.mean(x).dtype == torch.bfloat16


def test_float32_parameter_gets_a_float32_gradient():
    """Under O1 a float32 weight of a bf16 product gets a float32
    gradient: the bf16 product's, cast back inside autograd."""
    _, x = _pair(0, 3, 4)
    w = T.Parameter(torch.from_numpy(np.random.default_rng(1)
                                     .standard_normal((4, 5))
                                     .astype(np.float32)))
    with TA.auto_cast(dtype="bfloat16"):
        out = TF.linear(x, w)
    out.float().sum().backward()
    assert w.grad.dtype == torch.float32
    want = x.bfloat16().float().t() @ torch.ones(3, 5)
    np.testing.assert_allclose(w.grad.numpy(), want.numpy(), rtol=1e-2)


def test_amp_off_adds_no_cast():
    _, x = _pair(0, 4, 4)
    assert not T_op._AMP.enabled
    assert T.matmul(x, x).dtype == torch.float32


def test_float16_support_probe():
    assert TA.is_bfloat16_supported()
    assert not TA.is_float16_supported("cpu")
    assert TA.is_float16_supported() == (TD._current_device is not None
                                         and torch.cuda.is_available())


# -- llama_tiny under AMP -----------------------------------------------------

def _llama_pair(seed=0):
    J.seed(seed)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(num_hidden_layers=2))
    tm = TL.LlamaForCausalLM(TL.llama_tiny(num_hidden_layers=2))
    rng = np.random.default_rng(100 + seed)
    sd = {k: v.numpy() for k, v in jm.state_dict().items()}
    for k, v in sd.items():
        if "norm" in k:
            sd[k] = (1 + 0.3 * rng.normal(size=v.shape)).astype(np.float32)
    jm.set_state_dict(sd)
    tm.set_state_dict(sd)
    return jm, tm


class _DtypeRecorder:
    """The float dtypes each registered op's outputs had, by op name:
    the port's through the seam's instrumented call, the reference's
    through its profile hook and the ``wrap`` of each output."""

    def __init__(self, monkeypatch):
        self.port, self.ref = {}, {}
        stack = []
        orig_inst = T_op._instrumented

        def inst(opname, run, args, kwargs):
            out = orig_inst(opname, run, args, kwargs)
            for o in T_op._outputs(out):
                if o.is_floating_point():
                    self.port.setdefault(opname, set()).add(_dt(o))
            return out
        monkeypatch.setattr(T_op, "_instrumented", inst)
        T_op.set_profile_hook(lambda n: None, lambda: None)
        orig_wrap = J_op.wrap

        def wrap(x):
            if stack and jnp.issubdtype(getattr(x, "dtype", np.int32),
                                        jnp.floating):
                self.ref.setdefault(stack[-1], set()).add(str(x.dtype))
            return orig_wrap(x)
        monkeypatch.setattr(J_op, "wrap", wrap)
        J_op.set_profile_hook(stack.append, lambda: stack.pop())

    def close(self):
        T_op.set_profile_hook(None, None)
        J_op.set_profile_hook(None, None)


@pytest.mark.parametrize("arm", list(ARMS))
def test_llama_tiny_amp_arm_matches_the_reference(arm, monkeypatch):
    dtype, level, tol = ARMS[arm]
    jm, tm = _llama_pair()
    data = np.random.default_rng(1).integers(0, V, (2, 17))
    if level == "O2":
        jo = Jopt.AdamW(parameters=jm.parameters())
        to = Topt.AdamW(parameters=tm.parameters())
        JA.decorate(jm, jo, level="O2", dtype=dtype)
        TA.decorate(tm, to, level="O2", dtype=dtype)
        assert to._multi_precision
        kinds = {n: _dt(p) for n, p in tm.named_parameters()}
        assert kinds == {n: _dt(p) for n, p in jm.named_parameters()}
        assert {k for k, v in kinds.items() if v == "float32"} == {
            k for k in kinds if "norm" in k}
    jin, jtgt = J.to_tensor(data[:, :-1]), J.to_tensor(data[:, 1:])
    params = {n: p._data for n, p in jm.named_parameters()}

    def ref_loss(arrays):
        for n, p in jm.named_parameters():
            p._data = arrays[n]
        with J.no_grad(), JA.auto_cast(dtype=dtype, level=level):
            logits = jm(jin)
            loss = JF.cross_entropy(logits.reshape([-1, V]),
                                    jtgt.reshape([-1]))
        return loss._data, logits._data

    (want_loss, want_logits), want_grads = jax.value_and_grad(
        ref_loss, has_aux=True)(params)
    for n, p in jm.named_parameters():
        p._data = params[n]

    rec = _DtypeRecorder(monkeypatch)
    try:
        with JA.auto_cast(dtype=dtype, level=level):
            JF.cross_entropy(jm(jin).reshape([-1, V]), jtgt.reshape([-1]))
        with TA.auto_cast(dtype=dtype, level=level):
            logits = tm(torch.from_numpy(data[:, :-1]))
            loss = TF.cross_entropy(logits.reshape([-1, V]),
                                    torch.from_numpy(data[:, 1:]).reshape(-1))
    finally:
        rec.close()
    common = set(rec.port) & set(rec.ref)
    assert {"linear", "_sdpa_op", "rms_norm", "cross_entropy"} <= common
    assert {op: rec.port[op] for op in common} == \
        {op: rec.ref[op] for op in common}
    assert rec.port["linear"] == rec.port["_sdpa_op"] == {dtype}
    assert rec.port["rms_norm"] == rec.port["cross_entropy"] == {"float32"}

    assert _dt(logits) == str(want_logits.dtype) == dtype
    wl = np.asarray(want_logits, np.float32)
    assert np.abs(_np(logits) - wl).max() <= tol["logits"] * np.abs(wl).max()
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=tol["loss"])
    loss.backward()
    for n, p in tm.named_parameters():
        w = want_grads[n]
        assert p.grad.dtype == p.dtype and str(w.dtype) == _dt(p), n
        w = np.asarray(w, np.float32)
        err = np.abs(_np(p.grad) - w).max()
        assert err <= tol["grads"] * np.abs(w).max(), (n, err)


def test_reference_amp_backward_raises():
    """The reference differentiates with respect to the cast arrays, so
    under ``auto_cast`` a producer of a cast input receives a cotangent of
    the cast type and its backward raises: its eager models cannot train
    under AMP (the port's train, above). Pinned so that a change shows."""
    J.seed(0)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(num_hidden_layers=2))
    data = np.random.default_rng(1).integers(0, V, (2, 9))
    with JA.auto_cast(dtype="bfloat16"):
        loss = JF.cross_entropy(jm(J.to_tensor(data[:, :-1])).reshape(
            [-1, V]), J.to_tensor(data[:, 1:]).reshape([-1]))
    with pytest.raises(ValueError, match="unexpected JAX type"):
        loss.backward()


# -- amp.debugging ------------------------------------------------------------

def test_operator_stats_count_and_restore_the_hook(capsys):
    import paddle_tpu.amp.debugging as JD
    import paddle_tpu_torch.amp.debugging as TD_
    calls = []
    T_op.set_profile_hook(calls.append, lambda: None)
    try:
        _, x = _pair(0, 3)
        for D, pkg, xx in ((JD, J, J.to_tensor(np.ones(3, np.float32))),
                           (TD_, T, x)):
            with D.collect_operator_stats():
                pkg.exp(xx)
                pkg.exp(xx)
                pkg.sum(xx)
            out = capsys.readouterr().out
            assert "exp" in out and "calls: 2" in out and "sum" in out
        assert T_op._PROFILE_HOOK[0] == calls.append    # put back
        T.exp(x)
        assert calls == ["exp"]
    finally:
        T_op.set_profile_hook(None, None)


def test_tensor_checker_and_check_numerics():
    import paddle_tpu.amp.debugging as JD
    import paddle_tpu_torch.amp.debugging as TD_
    bad = np.array([1.0, np.nan, np.inf], np.float32)
    for D, to, err in ((JD, J.to_tensor, Exception),
                       (TD_, torch.from_numpy, TE.PreconditionNotMetError)):
        with pytest.raises(err, match="1 nan / 1 inf"):
            D.check_numerics(to(bad), "op", "x")
        ok = to(np.ones(2, np.float32))
        assert D.check_numerics(ok) is ok
    TD_.enable_tensor_checker(TD_.TensorCheckerConfig())
    try:
        assert T.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
        with pytest.raises(FloatingPointError):
            T.log(torch.tensor([-1.0]))
    finally:
        TD_.disable_tensor_checker()
    assert not T.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]

    class Net(Tnn.Layer):
        @TD_.check_layer_numerics
        def forward(self, x):
            return x * 2
    with pytest.raises(TE.PreconditionNotMetError):
        Net()(torch.tensor([np.inf]))
    with pytest.raises(NotImplementedError):
        TD_.compare_accuracy("a", "b", "c")
