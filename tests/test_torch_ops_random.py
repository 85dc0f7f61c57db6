"""The random ops of the op library, held by their distributions: the
draws of the port's seeded torch generator differ from JAX's keys, so
each op is checked on both packages for its dtype, range and moments
(within 6 standard errors of the expected mean on 20000 draws), and the
port for determinism under ``seed`` and ``get_rng_state`` /
``set_rng_state``."""
from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.ops._op import registered_ops as ref_registry
from paddle_tpu_torch import device as TD
from paddle_tpu_torch.ops._op import registered_ops as port_registry

N = (200, 100)
EULER = 0.5772156649015329


@pytest.fixture(autouse=True)
def _cpu():
    prev = TD._current_device
    T.set_device("cpu")
    T.seed(11)
    yield
    TD._current_device = prev


def _np(t):
    return np.asarray(t._data) if hasattr(t, "_data") else t.numpy()


def _mean_close(x, mean, var):
    se = math.sqrt(var / x.size)
    assert abs(float(x.mean()) - mean) < 6 * se, (float(x.mean()), mean)


def _pair(name, make_ref, make_port):
    """The op through both packages: numpy draws of each."""
    return _np(make_ref(ref_registry()[name])), \
        _np(make_port(port_registry()[name]))


def test_bernoulli():
    p = np.full(N, 0.3, np.float32)
    for x in _pair("bernoulli", lambda f: f(J.to_tensor(p)),
                   lambda f: f(torch.from_numpy(p))):
        assert x.dtype == np.float32 and set(np.unique(x)) <= {0.0, 1.0}
        _mean_close(x, 0.3, 0.21)


def test_gumbel():
    for x in _pair("gumbel", lambda f: f(list(N)), lambda f: f(list(N))):
        assert x.dtype == np.float32 and np.isfinite(x).all()
        _mean_close(x, EULER, math.pi ** 2 / 6)
        assert abs(x.var() - math.pi ** 2 / 6) < 0.1


@pytest.mark.parametrize("name,kw,check", [
    ("exponential_", {"lam": 2.0},
     lambda x: (x.min() >= 0) and _mean_close(x, 0.5, 0.25) is None),
    ("uniform_", {"min": -2.0, "max": 3.0},
     lambda x: (x.min() >= -2.0) and (x.max() <= 3.0)
     and _mean_close(x, 0.5, 25 / 12) is None),
    ("normal_", {"mean": 1.0, "std": 2.0},
     lambda x: _mean_close(x, 1.0, 4.0) is None and abs(x.std() - 2) < 0.1),
    ("cauchy_", {"loc": 1.0, "scale": 2.0},
     lambda x: abs(np.median(x) - 1.0) < 0.15
     and abs(np.subtract(*np.percentile(x, [75, 25])) - 4.0) < 0.3),
    ("geometric_", {"probs": 0.3},
     lambda x: (x.min() >= 1) and np.all(x == np.round(x))
     and _mean_close(x, 1 / 0.3, 0.7 / 0.09) is None),
])
def test_random_fills(name, kw, check):
    z = np.zeros(N, np.float32)
    jx, tx = J.to_tensor(z), torch.from_numpy(z.copy())
    got_j = ref_registry()[name](jx, **kw)
    got_t = port_registry()[name](tx, **kw)
    assert got_t is tx                              # filled in place
    for x in (_np(jx), _np(tx), _np(got_j)):
        assert x.dtype == np.float32 and x.shape == N
        assert check(x) is not False


def test_dropout_p_keeps_and_scales():
    x = np.ones(N, np.float32)
    kw = dict(p=0.25, training=True, mode="upscale_in_train")
    outs = (_np(ref_registry()["dropout_p"](J.to_tensor(x), **kw,
                                           key=jax.random.PRNGKey(0))),
            _np(port_registry()["dropout_p"](
                torch.from_numpy(x), **kw,
                generator=torch.Generator().manual_seed(0))))
    for y in outs:
        assert set(np.unique(y)) <= {0.0, np.float32(1 / 0.75)}
        _mean_close((y == 0).astype(np.float64), 0.25, 0.1875)
    # not training: the identity
    y = port_registry()["dropout_p"](torch.from_numpy(x), p=0.25,
                                     training=False, mode="upscale_in_train",
                                     generator=None)
    assert torch.equal(y, torch.from_numpy(x))


def test_alpha_dropout_p_keeps_selu_moments():
    x = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    outs = (_np(ref_registry()["alpha_dropout_p"](
        J.to_tensor(x), p=0.2, key=jax.random.PRNGKey(1))),
        _np(port_registry()["alpha_dropout_p"](
            torch.from_numpy(x), p=0.2,
            generator=torch.Generator().manual_seed(1))))
    for y in outs:
        assert abs(y.mean()) < 0.05 and abs(y.var() - 1.0) < 0.05


def test_gumbel_softmax_and_rrelu_draw_from_the_generator():
    import paddle_tpu_torch.nn.functional as F
    x = torch.zeros(N)
    y = F.gumbel_softmax(x, temperature=1.0, hard=True, axis=-1)
    assert torch.equal(y.sum(-1), torch.ones(N[0]))
    # each class wins about equally often
    assert y.sum(0).max() < 3 * N[0] / N[1] + 20
    g = torch.Generator().manual_seed(3)
    neg = -torch.ones(N)
    a = -port_registry()["rrelu"](neg, lower=0.1, upper=0.3, training=True,
                                  generator=g)
    assert 0.1 <= float(a.min()) and float(a.max()) <= 0.3
    _mean_close(a.numpy(), 0.2, 0.04 / 12)


@pytest.mark.parametrize("name,args,check", [
    ("uniform", ([*N],), lambda x: x.min() >= -1 and x.max() <= 1),
    ("rand", ([*N],), lambda x: x.min() >= 0 and x.max() <= 1
     and _mean_close(x, 0.5, 1 / 12) is None),
    ("randn", ([*N],), lambda x: _mean_close(x, 0.0, 1.0) is None),
    ("standard_normal", ([*N],), lambda x: abs(x.std() - 1) < 0.05),
    ("normal", (2.0, 0.5, [*N]), lambda x: _mean_close(x, 2.0, 0.25) is None),
    ("randint", (3, 9, [*N]), lambda x: x.min() == 3 and x.max() == 8),
    ("randperm", (1000,), lambda x: sorted(x) == list(range(1000))),
])
def test_draw_functions(name, args, check):
    for mod in (J, T):
        x = _np(getattr(mod, name)(*args))
        assert check(x) is not False, (mod.__name__, name)
    assert getattr(T, name)(*args).dtype == (
        torch.int64 if name in ("randint", "randperm") else torch.float32)


def test_multinomial_poisson_shuffle():
    p = np.array([0.1, 0.2, 0.7], np.float32)
    for mod, to in ((J, J.to_tensor), (T, torch.from_numpy)):
        draws = _np(mod.multinomial(to(p), 20000, replacement=True))
        freq = np.bincount(draws, minlength=3) / draws.size
        np.testing.assert_allclose(freq, p, atol=0.02)
        no_rep = _np(mod.multinomial(to(p), 3))
        assert sorted(no_rep.tolist()) == [0, 1, 2]
        lam = np.full(N, 4.0, np.float32)
        _mean_close(_np(mod.poisson(to(lam))), 4.0, 4.0)
        a = np.arange(50, dtype=np.float32)
        s = _np(mod.shuffle(to(a)))
        assert sorted(s.tolist()) == a.tolist() and not np.array_equal(s, a)


def test_seed_makes_draws_repeat():
    T.seed(123)
    a = (T.randn([5]), T.rand([3]), T.randint(0, 9, [4]), T.randperm(7))
    T.seed(123)
    b = (T.randn([5]), T.rand([3]), T.randint(0, 9, [4]), T.randperm(7))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    T.seed(124)
    assert not torch.equal(T.randn([5]), a[0])


def test_rng_state_round_trip():
    state = T.get_rng_state()
    x = T.uniform([8])
    T.normal_(torch.zeros(3))
    T.set_rng_state(state)
    assert torch.equal(T.uniform([8]), x)


def test_randint_like():
    x = np.zeros(N, np.float32)
    for out in _pair("randint_like",
                     lambda f: f(J.to_tensor(x), low=2, high=9),
                     lambda f: f(torch.from_numpy(x), low=2, high=9)):
        assert out.dtype == np.float32 and out.shape == N
        assert out.min() == 2 and out.max() == 8
        assert np.all(out == np.round(out))
        _mean_close(out, 5.0, (7 ** 2 - 1) / 12)


def test_binomial():
    count = np.full(N, 12, np.int64)
    prob = np.full(N, 0.3, np.float32)
    for out in _pair("binomial",
                     lambda f: f(J.to_tensor(count), J.to_tensor(prob)),
                     lambda f: f(torch.from_numpy(count),
                                 torch.from_numpy(prob))):
        assert out.dtype in (np.int32, np.int64)
        assert out.min() >= 0 and out.max() <= 12
        _mean_close(out.astype(np.float64), 3.6, 12 * 0.3 * 0.7)
    assert port_registry()["binomial"](torch.from_numpy(count),
                                       torch.from_numpy(prob)).dtype \
        == torch.int64


def test_standard_gamma():
    alpha = np.full(N, 2.5, np.float32)
    for out in _pair("standard_gamma",
                     lambda f: f(J.to_tensor(alpha)),
                     lambda f: f(torch.from_numpy(alpha))):
        assert out.dtype == np.float32 and out.min() > 0
        _mean_close(out, 2.5, 2.5)
        assert abs(out.var() - 2.5) < 0.2


def test_top_p_sampling_keeps_the_nucleus():
    """Each row draws only among the most probable tokens whose mass
    before them is at most ``ps`` (0.85: the first three of logits
    log([0.5, 0.3, 0.15, 0.05])), in proportion to their renormalized
    probabilities, in both packages."""
    probs = np.array([0.5, 0.3, 0.15, 0.05], np.float32)
    x = np.tile(np.log(probs), (4000, 1)).astype(np.float32)
    ps = np.full(4000, 0.85, np.float32)
    for vals, ids in (
            [_np(t) for t in ref_registry()["top_p_sampling"](
                J.to_tensor(x), J.to_tensor(ps))],
            [_np(t) for t in port_registry()["top_p_sampling"](
                torch.from_numpy(x), torch.from_numpy(ps))]):
        assert ids.shape == (4000, 1) and vals.shape == (4000, 1)
        np.testing.assert_allclose(vals[:, 0], np.log(probs)[ids[:, 0]])
        freq = np.bincount(ids[:, 0], minlength=4) / 4000
        assert freq[3] == 0
        np.testing.assert_allclose(freq[:3], probs[:3] / probs[:3].sum(),
                                   atol=0.03)
    g = port_registry()["top_p_sampling"]
    a = g(torch.from_numpy(x[:50]), torch.from_numpy(ps[:50]), seed=7)[1]
    b = g(torch.from_numpy(x[:50]), torch.from_numpy(ps[:50]), seed=7)[1]
    assert torch.equal(a, b)
