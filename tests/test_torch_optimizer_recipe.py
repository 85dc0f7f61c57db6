"""Port parity: the rest of the eager optimizer (``optimizer/optimizer.py``)
against the JAX package's, and the training recipe that uses it.

- Options, on a few named parameters with the same numpy gradients for
  3 steps: the three gradient clips, ``L1Decay`` / ``L2Decay``,
  ``amsgrad`` (its ``moment2_max``), AdamW's ``lr_ratio`` (taken, not
  used), an ``LRScheduler`` as the learning rate, and the global-norm
  clip on bfloat16 parameters with and without a float32 master.
- The recipe on the eager ``LlamaForCausalLM`` (``llama_tiny``, 2 layers,
  float32): ``AdamW`` (beta2 0.95, weight decay 0.1) under
  ``LinearWarmup`` over ``CosineAnnealingDecay`` with
  ``ClipGradByGlobalNorm(CLIP)``, 3 steps beside the JAX eager model.
  ``CLIP`` is 0.05, below the step-1 gradient norm (1.49), so the clip
  binds from step 1 on (checked).
- A JAX optimizer's ``state_dict`` after 2 steps, carried across as
  numpy into the port's ``set_state_dict`` with the weights, after which
  step 3 agrees; and the port's own round trip after step 2 gives step
  3 bit for bit.

Tolerances: float32 parameters and moments within ``1e-6 * max |ref|``
of each tensor for the options (the same operations in the same order);
bfloat16 parameters within one bfloat16 ulp (one rounding of float32
numbers that may differ in the last bit). The recipe: losses ``rtol
1e-5``, step-1 gradients ``1e-5 * max |g|``, parameters after the steps
within ``1e-5`` of each tensor's norm (Adam amplifies summation-order
noise where ``|g| ~ eps``; ``tests/test_torch_eager_llama.py``).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jpaddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
import paddle_tpu.optimizer.lr as jlr
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.models import llama as JL
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import device as TD
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.tensor import from_numpy
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.optimizer import lr as tlr

SHAPES = {"w0": (4, 8), "b0": (8,), "w1": (3, 5)}
STEPS = 3
CLIP = 0.05


@pytest.fixture
def cpu_device():
    prev = TD._current_device
    tpaddle.set_device("cpu")
    yield
    TD._current_device = prev


def _data(dtype, seed=0):
    rng = np.random.default_rng(seed)
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    if dtype == "bfloat16":
        cast = lambda a: a.astype(ml_dtypes.bfloat16)  # noqa: E731
        init = {k: cast(v) for k, v in init.items()}
        grads = [{k: cast(v) for k, v in g.items()} for g in grads]
    return init, grads


def _schedule(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(1e-2, T_max=10), 2,
                          2e-3, 1e-2)


# name -> (class name, keyword arguments over the package's optimizer
# module M and lr module S)
_OPTIONS = {
    "clip_value": ("AdamW", lambda M, S: {
        "grad_clip": M.ClipGradByValue(0.5)}),
    "clip_value_range": ("Adam", lambda M, S: {
        "grad_clip": M.ClipGradByValue(1.5, min=-0.25)}),
    "clip_norm": ("Adam", lambda M, S: {
        "grad_clip": M.ClipGradByNorm(1.0)}),
    "clip_global_norm": ("AdamW", lambda M, S: {
        "grad_clip": M.ClipGradByGlobalNorm(1.0)}),
    "l1_decay": ("Adam", lambda M, S: {"weight_decay": M.L1Decay(0.05)}),
    "l2_decay": ("Adam", lambda M, S: {"weight_decay": M.L2Decay(0.05)}),
    "amsgrad": ("AdamW", lambda M, S: {"amsgrad": True}),
    "amsgrad_l2": ("Adam", lambda M, S: {"amsgrad": True,
                                         "weight_decay": 0.05}),
    "lr_ratio": ("AdamW", lambda M, S: {"lr_ratio": 0.5}),
    "scheduler": ("AdamW", lambda M, S: {"learning_rate": _schedule(S)}),
}


def _run_jax(cls, kw, init, grads):
    params = [JParameter(jnp.asarray(v), name=k) for k, v in init.items()]
    kw = {"learning_rate": 1e-2, **kw}
    o = getattr(jopt, cls)(parameters=params, **kw)
    for g in grads:
        for p in params:
            p.grad = JTensor(jnp.asarray(g[p.name]))
        o.step()
        o.clear_grad()
        if isinstance(kw["learning_rate"], jlr.LRScheduler):
            kw["learning_rate"].step()
    st = [{k: np.asarray(v) for k, v in o._accumulators[id(p)].items()}
          for p in params]
    return [np.asarray(p._data) for p in params], st


def _run_port(cls, kw, init, grads):
    params = []
    for k, v in init.items():
        p = torch.nn.Parameter(from_numpy(v))
        p.param_name = k
        params.append(p)
    kw = {"learning_rate": 1e-2, **kw}
    o = getattr(topt, cls)(parameters=params, **kw)
    for g in grads:
        for p in params:
            p.grad = from_numpy(g[p.param_name])
        o.step()
        o.clear_grad()
        if isinstance(kw["learning_rate"], tlr.LRScheduler):
            kw["learning_rate"].step()
    st = [{k: v.numpy() for k, v in o._accumulators[id(p)].items()}
          for p in params]
    return [p.detach() for p in params], st


def _close_f32(got, want, tol=1e-6):
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert np.abs(a - b).max() <= tol * np.abs(b).max()


def _close_state(got, want):
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        _close_f32([a[k] for k in a], [b[k] for k in a])


@pytest.mark.parametrize("name", sorted(_OPTIONS))
def test_option_matches_jax(name):
    cls, kw = _OPTIONS[name]
    init, grads = _data("float32", seed=1)
    want_p, want_st = _run_jax(cls, kw(jopt, jlr), init, grads)
    got_p, got_st = _run_port(cls, kw(topt, tlr), init, grads)
    _close_f32(got_p, want_p)
    _close_state(got_st, want_st)
    if "amsgrad" in name:
        assert all("moment2_max" in s for s in got_st)


@pytest.mark.parametrize("multi_precision", [False, True])
def test_global_norm_clip_on_bfloat16_matches_jax(multi_precision):
    """The sums of squares run in bfloat16, as the reference's."""
    init, grads = _data("bfloat16", seed=2)
    kw = lambda M: {"grad_clip": M.ClipGradByGlobalNorm(1.0),  # noqa: E731
                    "multi_precision": multi_precision}
    want_p, want_st = _run_jax("AdamW", kw(jopt), init, grads)
    got_p, got_st = _run_port("AdamW", kw(topt), init, grads)
    for a, b in zip(got_p, want_p):
        assert a.dtype == torch.bfloat16
        a = a.float().numpy()
        b = np.asarray(b, np.float32)
        ulp = np.spacing(np.abs(b).astype(ml_dtypes.bfloat16)).astype(
            np.float32)
        assert np.all(np.abs(a - b) <= ulp)
    _close_state(got_st, want_st)


def test_clips_bind_at_their_limits():
    g = [torch.full((4,), 3.0), torch.full((2,), -4.0)]
    out = topt.ClipGradByGlobalNorm(1.0)._clip(g)
    norm = float(torch.sqrt(sum((x * x).sum() for x in out)))
    assert abs(norm - 1.0) < 1e-6
    out = topt.ClipGradByNorm(1.0)._clip(g)
    assert all(abs(float(x.norm()) - 1.0) < 1e-6 for x in out)
    out = topt.ClipGradByValue(2.0, min=-1.0)._clip(g)
    assert float(out[0].max()) == 2.0 and float(out[1].min()) == -1.0


def _recipe(M, S, params):
    sched = S.LinearWarmup(S.CosineAnnealingDecay(3e-3, T_max=10), 2,
                           1e-3, 3e-3)
    return M.AdamW(learning_rate=sched, beta2=0.95, weight_decay=0.1,
                   grad_clip=M.ClipGradByGlobalNorm(CLIP),
                   parameters=params), sched


def _models(seed):
    jpaddle.seed(seed)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(num_hidden_layers=2))
    tm = TL.LlamaForCausalLM(TL.llama_tiny(num_hidden_layers=2))
    assert not any(tm.set_state_dict({k: v.numpy() for k, v in
                                      jm.state_dict().items()}))
    return jm, tm


def _batch(seed):
    ids = np.random.default_rng(seed).integers(0, 256, (4, 17))
    return ids[:, :-1], ids[:, 1:]


def _jax_step(m, o, sched, ids):
    loss = JF.cross_entropy(m(jpaddle.to_tensor(ids[0])).reshape([-1, 256]),
                            jpaddle.to_tensor(ids[1]).reshape([-1]))
    loss.backward()
    grads = {k: v.grad.numpy() for k, v in m.state_dict().items()}
    o.step()
    o.clear_grad()
    sched.step()
    return float(loss), grads


def _port_step(m, o, sched, ids):
    loss = TF.cross_entropy(m(tpaddle.to_tensor(ids[0])).reshape([-1, 256]),
                            tpaddle.to_tensor(ids[1]).reshape([-1]))
    loss.backward()
    grads = {k: v.grad.clone() for k, v in m.state_dict().items()}
    o.step()
    o.clear_grad()
    sched.step()
    return float(loss.detach()), grads


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _params_close(tm, jm):
    jsd = jm.state_dict()
    for k, v in tm.state_dict().items():
        got, want = v.detach().numpy(), jsd[k].numpy()
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want), k


def test_recipe_three_eager_steps_match_jax(cpu_device):
    jm, tm = _models(0)
    jo, js = _recipe(jopt, jlr, jm.parameters())
    to, ts = _recipe(topt, tlr, tm.parameters())
    jl, tl = [], []
    for i in range(3):
        batch = _batch(i)
        lj, gj = _jax_step(jm, jo, js, batch)
        lt, gt = _port_step(tm, to, ts, batch)
        jl.append(lj)
        tl.append(lt)
        if i == 0:
            norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                               for g in gj.values()))
            assert norm > 10 * CLIP        # the clip binds at step 1
            for k in gj:
                assert _rel(gt[k].numpy(), gj[k]) <= 1e-5, k
        assert to.get_lr() == jo.get_lr()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _params_close(tm, jm)


def _numpy_state(state):
    return {k: (v.numpy() if hasattr(v, "numpy") else v)
            for k, v in state.items()}


def test_jax_state_dict_carries_into_the_port(cpu_device):
    """Two JAX steps; the port takes the JAX weights and optimizer state
    (numpy) into a fresh model and optimizer; step 3 agrees."""
    jm, tm = _models(1)
    jo, js = _recipe(jopt, jlr, jm.parameters())
    for i in range(2):
        _jax_step(jm, jo, js, _batch(10 + i))
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    to, ts = _recipe(topt, tlr, tm.parameters())
    state = _numpy_state(jo.state_dict())
    assert state["global_step"] == 2 and "param_0.moment1" in state
    to.set_state_dict(state)
    assert to._global_step == 2 and to.get_lr() == jo.get_lr()
    lj, _ = _jax_step(jm, jo, js, _batch(12))
    lt, _ = _port_step(tm, to, ts, _batch(12))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    _params_close(tm, jm)
    jst = _numpy_state(jo.state_dict())
    for k, v in to.state_dict().items():
        if k.endswith("moment1"):
            assert _rel(v.numpy(), jst[k]) <= 1e-5, k


def test_port_state_dict_round_trip_is_bit_for_bit(cpu_device):
    """Uninterrupted 3 steps against 2 steps, a ``state_dict`` into a
    fresh optimizer (and scheduler), then step 3."""
    _, ta = _models(2)
    _, tb = _models(2)
    oa, sa = _recipe(topt, tlr, ta.parameters())
    ob, sb = _recipe(topt, tlr, tb.parameters())
    for i in range(2):
        _port_step(ta, oa, sa, _batch(20 + i))
        _port_step(tb, ob, sb, _batch(20 + i))
    saved = ob.state_dict()
    ob, sb = _recipe(topt, tlr, tb.parameters())
    ob.set_state_dict(saved)
    _port_step(ta, oa, sa, _batch(22))
    _port_step(tb, ob, sb, _batch(22))
    for (k, a), b in zip(ta.state_dict().items(), tb.state_dict().values()):
        assert torch.equal(a, b), k
