"""The op library against the JAX reference, name by name.

- Coverage: the port registers every name the reference registers from
  the modules this slice ports (``ops``, ``ops.creation``, ``.math``,
  ``.reduction``, ``.manipulation``, ``.logic``, ``.linalg``,
  ``.random`` and the five ported ``nn.functional`` modules), under the
  same module, and no other.
- Values: every such name on the seeded inputs of
  ``paddle_tpu_torch.testing.op_cases`` through both registered
  functions, outputs held under ``_torch_ops_common.DTYPE_MAP``: float32
  at rtol 1e-5 / atol 1e-6 unless the case states another tolerance and
  why, bfloat16 at 3e-2 (rtol = atol), integers and booleans exactly.
  Random ops are held by their statistics (``test_torch_ops_random.py``).
- bfloat16: the float ops of the elementwise, reduction and activation
  modules once more in bfloat16 at 3e-2.
- Gradients: every differentiable op's float32 gradients against
  ``jax.vjp`` of the reference's ``get_op(name).pure_fn`` (the reference's
  eager tape for a composite, which has none) with one seeded cotangent;
  an op the reference does not differentiate must give outputs that do
  not require grad.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.ops._op import registered_ops as ref_registry
from paddle_tpu_torch import device as TD
from paddle_tpu_torch.ops._op import registered_ops as port_registry
from paddle_tpu_torch.testing import op_cases as OC

from _torch_ops_common import (assert_same, compare_factors, flat, inputs,
                               port_grad_of, port_tensor, ref_cotangent,
                               ref_tensor, seed_of, slice_names, to_port,
                               to_ref)

REF = slice_names(ref_registry(), "paddle_tpu.")
PORT = slice_names(port_registry(), "paddle_tpu_torch.")
# reference names this slice leaves out, each with its reason (none)
EXCEPTIONS: dict = {}

VALUE_NAMES = sorted(n for n in REF if not OC.case_for(n).random)
HALF_MODULES = ("ops.math", "ops.math_ext", "ops.reduction",
                "nn.functional.activation")


@pytest.fixture(autouse=True)
def _cpu():
    prev = TD._current_device
    T.set_device("cpu")
    yield
    TD._current_device = prev


def test_registry_covers_the_reference():
    want = {n: m for n, m in REF.items() if n not in EXCEPTIONS}
    assert PORT == want
    by_module = {}
    for m in REF.values():
        by_module[m] = by_module.get(m, 0) + 1
    assert sum(v for m, v in by_module.items()
               if m.startswith("ops")) == 454
    assert sum(v for m, v in by_module.items()
               if m.startswith("nn.")) == 78
    # masked_select's case serves its composite name; the signal framing
    # ops are the port's registered names the sweep on the card covers
    assert set(OC.CASES) <= set(REF) | {"masked_select", "signal_frame",
                                        "signal_overlap_add"}


def _ref_args(name, args, kw):
    a, k = to_ref(args), to_ref(kw)
    if name == "getitem":
        # the registered op takes a raw index (the public getitem unwraps)
        k["idx"] = OC.to_tensors(kw["idx"], jnp.asarray)
    if name in ("index_put", "index_put_"):
        a = (a[0], OC.to_tensors(args[1], jnp.asarray), a[2])
    return a, k


def call_ref(name, args, kw):
    a, k = _ref_args(name, args, kw)
    return ref_registry()[name](*a, **k)


@pytest.mark.parametrize("name", VALUE_NAMES)
def test_value_matches_reference(name):
    case, (args, kw) = inputs(name)
    want = call_ref(name, args, kw)
    got = port_registry()[name](*to_port(args), **to_port(kw))
    if case.compare:
        compare_factors(case.compare, got, want, case.tol, name)
    else:
        assert_same(got, want, case.tol, name)


def _is_f32(a):
    return isinstance(a, np.ndarray) and a.dtype == np.float32


def _is_diff(a):
    """A differentiated input: float32, or complex64 (gradients in the
    port's convention, ``_torch_ops_common.ref_cotangent``)."""
    return isinstance(a, np.ndarray) and a.dtype in (np.float32,
                                                     np.complex64)


HALF_NAMES = sorted(
    n for n in VALUE_NAMES if REF[n] in HALF_MODULES and not n.endswith("_")
    and OC.case_for(n).half
    and any(_is_f32(a) for a in inputs(n)[1][0]))


@pytest.mark.parametrize("name", HALF_NAMES)
def test_bfloat16_value_matches_reference(name):
    case, (args, kw) = inputs(name)
    ra = [J.to_tensor(jnp.asarray(a, jnp.bfloat16)) if _is_f32(a)
          else to_ref(a) for a in args]
    ta = [port_tensor(a).bfloat16() if _is_f32(a) else to_port(a)
          for a in args]
    want = ref_registry()[name](*ra, **to_ref(kw))
    got = port_registry()[name](*ta, **to_port(kw))
    assert_same(got, want, None, name)


GRAD_NAMES = sorted(
    n for n in VALUE_NAMES if OC.case_for(n).grad
    and any(_is_diff(a) for a in inputs(n)[1][0]))
# gradient tolerance where the value's is tighter: a backward adds one
# more float32 reduction in another order
GRAD_TOL = (1e-5, 1e-5)


def _ref_grads(name, args, kw, diff, cots):
    """Reference gradients of the float outputs against ``cots``:
    ``jax.vjp`` of the registered op's pure function, or the eager tape
    for a composite."""
    fn = ref_registry()[name]
    pure = getattr(fn, "pure_fn", None)
    a, k = _ref_args(name, args, kw)
    if pure is not None:
        raw = [x._data if hasattr(x, "_data") else x for x in a]
        rk = {key: (v._data if hasattr(v, "_data") else v)
              for key, v in k.items()}

        def closed(*d):
            full = list(raw)
            for i, x in zip(diff, d):
                full[i] = x
            return pure(*full, **rk)

        primals = [raw[i] for i in diff]
        out = jax.eval_shape(closed, *primals)
        ct = []
        it = iter(cots)
        for o in flat(out):
            ct.append(jnp.asarray(ref_cotangent(next(it)), o.dtype)
                      if jnp.issubdtype(o.dtype, jnp.inexact)
                      else np.zeros(o.shape, jax.dtypes.float0))
        ct = tuple(ct) if isinstance(out, (tuple, list)) else ct[0]
        if isinstance(out, list):
            ct = list(ct)

        # one compiled program of the forward and its vjp (op-by-op
        # dispatch compiles each primitive apart, several times slower)
        @jax.jit
        def grads(primals, ct):
            return jax.vjp(closed, *primals)[1](ct)

        return [np.asarray(g) for g in grads(primals, ct)]
    leaves = {i: ref_tensor(args[i], stop_gradient=False) for i in diff}
    a = [leaves.get(i, x) for i, x in enumerate(a)]
    if name.endswith("_"):
        # the written argument is a non-leaf copy, as on the port's side
        w = 1 if name == "where_" else 0
        a[w] = J.clone(a[w])
    outs = [o for o in flat(fn(*a, **k))
            if jnp.issubdtype(o._data.dtype, jnp.inexact)]
    grads = J.grad(outs, [leaves[i] for i in diff],
                   grad_outputs=[J.to_tensor(jnp.asarray(ref_cotangent(c),
                                                         o._data.dtype))
                                 for o, c in zip(outs, cots)],
                   allow_unused=True)
    return [np.zeros(args[i].shape, np.float32) if g is None
            else np.asarray(g._data) for i, g in zip(diff, grads)]


@pytest.mark.parametrize("name", GRAD_NAMES)
def test_grad_matches_jax_vjp(name):
    case, (args, kw) = inputs(name)
    diff = [i for i, a in enumerate(args) if _is_diff(a)]
    # the reference's own verdict on differentiability
    ra, rk = _ref_args(name, args, kw)
    ra = [ref_tensor(args[i], stop_gradient=False) if i in diff else x
          for i, x in enumerate(ra)]
    rout = [o for o in flat(ref_registry()[name](*ra, **rk))
            if jnp.issubdtype(o._data.dtype, jnp.inexact)]
    ref_diff = any(not o.stop_gradient for o in rout)

    leaves = {i: port_tensor(args[i], requires_grad=True) for i in diff}
    ta = [leaves[i] if i in diff else to_port(a) for i, a in enumerate(args)]
    if name.endswith("_"):
        # an in-place op writes into a non-leaf (where_ into its x)
        w = 1 if name == "where_" else 0
        ta[w] = ta[w].clone()
    tout = [o for o in flat(port_registry()[name](*ta, **to_port(kw)))
            if o.is_floating_point() or o.is_complex()]
    port_diff = any(o.requires_grad for o in tout)
    rng = np.random.default_rng(seed_of(name) + 1)
    cots = [(rng.standard_normal(tuple(o.shape)).astype(np.float32)
             + 1j * rng.standard_normal(tuple(o.shape)).astype(np.float32)
             ).astype(np.complex64) if o.is_complex() else
            rng.standard_normal(tuple(o.shape)).astype(np.float32)
            for o in tout]
    if not port_diff and ref_diff:
        # a port output outside autograd (zeros_like, ...): the
        # reference's gradient must be zero
        for g in _ref_grads(name, args, kw, diff, cots):
            assert not np.any(g), name
        return
    assert port_diff == ref_diff, name
    if not ref_diff:
        return
    want = _ref_grads(name, args, kw, diff, cots)
    live = [(o, torch.from_numpy(c).to(o.dtype)) for o, c in zip(tout, cots)
            if o.requires_grad]
    got = torch.autograd.grad([o for o, _ in live],
                              [leaves[i] for i in diff],
                              [c for _, c in live], allow_unused=True)
    tol = case.tol or GRAD_TOL
    for i, g, w in zip(diff, got, want):
        g = (np.zeros(args[i].shape, np.float32)
             if g is None or g._is_zerotensor() else g.resolve_conj().numpy())
        w = port_grad_of(w, np.iscomplexobj(args[i]))
        np.testing.assert_allclose(g, w, rtol=tol[0], atol=max(tol[1], 1e-5),
                                   err_msg=f"{name} d/darg{i}")
