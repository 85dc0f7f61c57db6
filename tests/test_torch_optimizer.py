"""Port parity: the eager ``Adam`` / ``AdamW`` (``optimizer/optimizer.py``)
against the JAX package's, three steps on a few named parameters with
the same numpy gradients.

Cases: AdamW with ``weight_decay`` 0 and 0.01, with an
``apply_decay_param_fun`` that decays only the weights named ``w*``;
Adam without decay and with a coupled (L2) decay of 0.01; a bfloat16
parameter with ``multi_precision`` on (float32 master) and off.

Tolerances: float32 parameters and moments within ``1e-6 * max |ref|``
of each tensor (the same operations in the same order; a division by a
scalar may round differently in the last bit). bfloat16 parameters
within one bfloat16 ulp of each value (one rounding of float32 numbers
that may differ in the last bit).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.tensor import from_numpy

SHAPES = {"w0": (4, 8), "b0": (8,), "w1": (3, 5)}
STEPS = 3


def _data(dtype, seed=0):
    rng = np.random.default_rng(seed)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in
            SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in
              SHAPES.items()} for _ in range(STEPS)]
    if dtype == "bfloat16":
        cast = lambda a: a.astype(ml_dtypes.bfloat16)  # noqa: E731
        init = {k: cast(v) for k, v in init.items()}
        grads = [{k: cast(v) for k, v in g.items()} for g in grads]
    return init, grads


def _run_jax(cls, kw, init, grads):
    params = [JParameter(jnp.asarray(v), name=k) for k, v in init.items()]
    o = cls(learning_rate=1e-2, parameters=params, **kw)
    for g in grads:
        for p in params:
            p.grad = JTensor(jnp.asarray(g[p.name]))
        o.step()
        o.clear_grad()
    moments = [np.asarray(o._accumulators[id(p)]["moment1"]) for p in params]
    return [np.asarray(p._data) for p in params], moments


def _run_port(cls, kw, init, grads):
    params = []
    for k, v in init.items():
        p = torch.nn.Parameter(from_numpy(v))
        p.param_name = k
        params.append(p)
    o = cls(learning_rate=1e-2, parameters=params, **kw)
    for g in grads:
        for p in params:
            p.grad = from_numpy(g[p.param_name])
        o.step()
        o.clear_grad()
        assert all(p.grad is None for p in params)
    moments = [o._accumulators[id(p)]["moment1"] for p in params]
    for m in moments:
        assert m.dtype == torch.float32
    return [p.detach() for p in params], [m.numpy() for m in moments]


def _close_f32(got, want):
    for a, b in zip(got, want):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), \
            np.abs(a - b).max()


def _close_bf16_ulp(got, want):
    for a, b in zip(got, want):
        a = np.asarray(a.float(), np.float32)
        b = np.asarray(b, np.float32)
        mag = np.maximum(np.abs(a), np.abs(b))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert (np.abs(a - b) <= ulp).all(), np.abs(a - b).max()


def _decay_w(name):
    return name.startswith("w")


CASES = {
    "adamw_wd0": ("AdamW", dict(weight_decay=0.0)),
    "adamw_wd001": ("AdamW", dict(weight_decay=0.01)),
    "adamw_decay_fun": ("AdamW", dict(weight_decay=0.01,
                                      apply_decay_param_fun=_decay_w)),
    "adam": ("Adam", dict()),
    "adam_l2": ("Adam", dict(weight_decay=0.01)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_float32_matches_jax(case):
    name, kw = CASES[case]
    init, grads = _data("float32")
    want_p, want_m = _run_jax(getattr(jopt, name), kw, init, grads)
    got_p, got_m = _run_port(getattr(topt, name), kw, init, grads)
    for p in got_p:
        assert p.dtype == torch.float32
    _close_f32([p.numpy() for p in got_p], want_p)
    _close_f32(got_m, want_m)


def test_decay_fun_decays_only_the_named_weights():
    """With ``weight_decay`` and ``apply_decay_param_fun``, the bias takes
    the undecayed update exactly."""
    init, grads = _data("float32")
    plain, _ = _run_port(topt.AdamW, dict(weight_decay=0.0), init, grads)
    decayed, _ = _run_port(topt.AdamW, dict(weight_decay=0.01,
                                            apply_decay_param_fun=_decay_w),
                           init, grads)
    names = list(SHAPES)
    for k, a, b in zip(names, plain, decayed):
        assert torch.equal(a, b) == (not k.startswith("w")), k


@pytest.mark.parametrize("multi_precision", [True, False])
def test_bfloat16_matches_jax(multi_precision):
    kw = dict(weight_decay=0.01, multi_precision=multi_precision)
    init, grads = _data("bfloat16", seed=1)
    want_p, want_m = _run_jax(jopt.AdamW, kw, init, grads)
    got_p, got_m = _run_port(topt.AdamW, kw, init, grads)
    for p in got_p:
        assert p.dtype == torch.bfloat16
    _close_bf16_ulp(got_p, want_p)
    _close_f32(got_m, want_m)


def test_unported_options_raise():
    """Named for when these options raised; they are ported now
    (``tests/test_torch_optimizer_recipe.py`` holds them to JAX). What
    still raises is what the reference refuses: ``set_lr`` under a
    scheduler."""
    from paddle_tpu_torch.core import enforce as E
    from paddle_tpu_torch.optimizer import lr as tlr
    p = torch.nn.Parameter(torch.zeros(2))
    sched = tlr.CosineAnnealingDecay(1e-3, T_max=10)
    o = topt.AdamW(learning_rate=sched, parameters=[p], amsgrad=True,
                   grad_clip=topt.ClipGradByGlobalNorm(1.0), lr_ratio=0.5,
                   weight_decay=topt.L2Decay(0.1))
    assert o.get_lr() == 1e-3
    with pytest.raises(E.PreconditionNotMetError):
        o.set_lr(1e-4)
    topt.Adam(parameters=[p], weight_decay=topt.L1Decay(0.1))
    o = topt.Adam(parameters=[p])
    p.grad = torch.ones(2).to_sparse()
    o.step()
    assert torch.all(p < 0)


def test_lr_get_set_and_weight_decay_default():
    p = torch.nn.Parameter(torch.zeros(2))
    o = topt.AdamW(learning_rate=3e-4, parameters=[p])
    assert o.get_lr() == 3e-4 and o._decay_coeff() == 0.01
    o.set_lr(1e-3)
    assert o.get_lr() == 1e-3
    assert topt.Adam(parameters=[p])._decay_coeff() == 0.0
