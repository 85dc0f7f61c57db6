"""The op library's ``_ext`` modules beyond the value table of
``test_torch_ops.py``: the factorizations' gradients through functions
that do not depend on the sign or phase of a factor's columns, the
random low-rank SVDs by reconstruction, the LU pivots, the reference's
index rule of ``cummax`` / ``cummin`` on ties, the host-side ops and the
flat names the ``_ext`` modules own."""
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

from _torch_ops_common import _spectrum_gap

# float32 factorizations in LAPACK (torch) and XLA's own: roundoff grows
# with the condition number of the small well-conditioned inputs below
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = TD._current_device
    T.set_device("cpu")
    yield
    TD._current_device = prev


def _rng(seed):
    return np.random.default_rng(seed)


def _grads(name, x, loss_jax, loss_torch, **kw):
    """d loss / dx of a sign-free function of the op's outputs: JAX's
    gradient through the reference's pure function, torch's through the
    port's registered op."""
    pure = ref_registry()[name].pure_fn
    want = jax.grad(lambda a: loss_jax(pure(a, **kw)))(jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    loss_torch(port_registry()[name](xt, **kw)).backward()
    return xt.grad.numpy(), np.asarray(want)


def test_svd_gradient_through_spectrum_and_reconstruction():
    r = _rng(1)
    x = r.standard_normal((2, 5, 4)).astype(np.float32)
    c1 = r.standard_normal((2, 4)).astype(np.float32)
    c2 = r.standard_normal((2, 5, 4)).astype(np.float32)

    def lj(out):
        u, s, vh = out
        return jnp.sum(s * c1) + jnp.sum(((u * s[..., None, :]) @ vh) ** 2
                                         * c2)

    def lt(out):
        u, s, vh = out
        return (torch.sum(s * torch.from_numpy(c1))
                + torch.sum(((u * s[..., None, :]) @ vh) ** 2
                            * torch.from_numpy(c2)))
    got, want = _grads("svd", x, lj, lt, full_matrices=False)
    np.testing.assert_allclose(got, want, **TOL)


def test_qr_gradient_through_product_and_abs_r():
    r = _rng(2)
    x = r.standard_normal((2, 6, 4)).astype(np.float32)
    c1 = r.standard_normal((2, 6, 4)).astype(np.float32)
    c2 = r.standard_normal((2, 4, 4)).astype(np.float32)
    got, want = _grads(
        "qr_op", x,
        lambda o: jnp.sum((o[0] @ o[1]) ** 2 * c1) + jnp.sum(jnp.abs(o[1])
                                                            * c2),
        lambda o: (torch.sum((o[0] @ o[1]) ** 2 * torch.from_numpy(c1))
                   + torch.sum(o[1].abs() * torch.from_numpy(c2))))
    np.testing.assert_allclose(got, want, **TOL)


def test_eigh_gradient_through_eigenvalues_and_projector():
    r = _rng(3)
    a = r.standard_normal((2, 4, 4)).astype(np.float32)
    x = (a @ a.transpose(0, 2, 1) / 4 + np.eye(4, dtype=np.float32))
    c1 = r.standard_normal((2, 4)).astype(np.float32)
    c2 = r.standard_normal((2, 4, 4)).astype(np.float32)

    def lj(out):
        w, v = out
        top = v[..., -1:]                 # the largest eigenvalue's projector
        return jnp.sum(w * c1) + jnp.sum(top @ jnp.swapaxes(top, -1, -2)
                                         * c2)

    def lt(out):
        w, v = out
        top = v[..., -1:]
        return (torch.sum(w * torch.from_numpy(c1))
                + torch.sum(top @ top.transpose(-1, -2)
                            * torch.from_numpy(c2)))
    got, want = _grads("eigh_op", x, lj, lt)
    # the reference differentiates a symmetric input's upper and lower
    # triangles apart; the symmetric part of each gradient is the one
    # that moves a symmetric input
    sym = lambda g: (g + g.transpose(0, 2, 1)) / 2      # noqa: E731
    np.testing.assert_allclose(sym(got), sym(want), **TOL)


def test_eig_reconstructs_and_is_complex():
    x = (_rng(4).standard_normal((3, 5, 5)) / 3
         + 2 * np.eye(5)).astype(np.float32)
    w, v = T.linalg.eig(torch.from_numpy(x))
    assert w.dtype == v.dtype == torch.complex64
    rec = (v * w[..., None, :]) @ torch.linalg.inv(v)
    np.testing.assert_allclose(rec.real.numpy(), x, **TOL)
    np.testing.assert_allclose(rec.imag.numpy(), 0, atol=1e-5)
    wj = np.asarray(J.linalg.eigvals(J.to_tensor(x))._data)
    wt = T.linalg.eigvals(torch.from_numpy(x)).numpy()
    assert _spectrum_gap(wt, wj) <= 1e-4 * np.abs(wj).max()


@pytest.mark.parametrize("fn", ["svd_lowrank", "pca_lowrank"])
def test_lowrank_reconstructs_at_full_rank(fn):
    """The draws are the port's own: held by the reconstruction at full
    rank, as the reference's are."""
    x = _rng(5).standard_normal((2, 9, 6)).astype(np.float32)
    for mod, to, out in ((J, J.to_tensor, lambda t: np.asarray(t._data)),
                         (T, torch.from_numpy, lambda t: t.numpy())):
        u, s, v = getattr(mod.linalg, fn)(to(x), q=6, niter=2)
        u, s, v = out(u), out(s), out(v)
        want = x - x.mean(-2, keepdims=True) if fn == "pca_lowrank" else x
        rec = (u * s[..., None, :]) @ np.swapaxes(v, -1, -2)
        np.testing.assert_allclose(rec, want, rtol=1e-3, atol=1e-4,
                                   err_msg=mod.__name__)
    T.seed(3)
    a = T.linalg.svd_lowrank(torch.from_numpy(x), q=3)
    T.seed(3)
    b = T.linalg.svd_lowrank(torch.from_numpy(x), q=3)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_lu_pivots_and_unpack():
    x = (_rng(6).standard_normal((2, 5, 5)) + 2 * np.eye(5)).astype(
        np.float32)
    lu_t, piv_t = T.linalg.lu(torch.from_numpy(x))
    lu_j, piv_j = J.linalg.lu(J.to_tensor(x))
    assert piv_t.dtype == torch.int32
    np.testing.assert_array_equal(piv_t.numpy(), np.asarray(piv_j._data))
    assert int(piv_t.min()) >= 1           # 1-based, as Paddle's
    p, l, u = T.linalg.lu_unpack(lu_t, piv_t)
    np.testing.assert_allclose((p @ l @ u).numpy(), x, **TOL)
    pj, lj, uj = J.linalg.lu_unpack(lu_j, piv_j)
    np.testing.assert_allclose((p @ l @ u).numpy(),
                               np.asarray((pj @ lj @ uj)._data), **TOL)
    *_, info = T.linalg.lu(torch.from_numpy(x), get_infos=True)
    assert info.dtype == torch.int32 and not info.any()


@pytest.mark.parametrize("name", ["cummax", "cummin"])
def test_running_extreme_index_is_the_last_tie(name):
    x = np.array([[1, 3, 3, 2, 3, 0, 0, -1],
                  [2, 2, 2, 2, 5, 5, 1, 5]], np.float32)
    vj, ij = getattr(J, name)(J.to_tensor(x), axis=1)
    vt, it = getattr(T, name)(torch.from_numpy(x), axis=1)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj._data))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij._data))
    assert it.dtype == torch.int64


def test_unique_consecutive_along_an_axis():
    x = np.array([[1, 1, 2, 2, 2, 3], [1, 1, 2, 2, 0, 3]], np.int64).T
    kw = dict(return_inverse=True, return_counts=True, axis=0)
    got = T.unique_consecutive(torch.from_numpy(x), **kw)
    want = J.unique_consecutive(J.to_tensor(x), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w._data))


def test_histograms_bucket_like_numpy():
    x = _rng(7).standard_normal(1000).astype(np.float32)
    h = T.histogram(torch.from_numpy(x), bins=9, min=-2, max=2)
    want, _ = np.histogram(x, bins=9, range=(-2, 2))
    np.testing.assert_array_equal(h.numpy(), want)
    pts = _rng(8).standard_normal((500, 2)).astype(np.float32)
    hd, edges = T.histogramdd(torch.from_numpy(pts), bins=[3, 4],
                              ranges=[-1.0, 1.0, -2.0, 2.0])
    want, wedges = np.histogramdd(pts, bins=[3, 4],
                                  range=[(-1, 1), (-2, 2)])
    np.testing.assert_array_equal(hd.numpy(), want)
    for e, w in zip(edges, wedges):
        np.testing.assert_allclose(e.numpy(), w, rtol=1e-6)


def test_ext_modules_own_their_flat_names():
    """The names the core op modules leave to the ``_ext`` modules resolve to
    them in the flat namespaces, as the reference's do."""
    mods = {"remainder": "math_ext", "remainder_": "math_ext",
            "add_n": "math_ext", "increment": "math_ext",
            "broadcast_tensors": "manipulation_ext",
            "vector_norm": "linalg_ext"}
    for name, mod in mods.items():
        for pkg, tensor_ns in ((J, J.tensor), (T, T.tensor)):
            for ns in (pkg, tensor_ns):
                fn = getattr(ns, name)
                assert fn.__module__.endswith(f"ops.{mod}"), (ns, name)
    x = torch.tensor([5.0, -3.0])
    assert torch.equal(T.remainder(x, torch.tensor(2.0)),
                       torch.tensor([1.0, 1.0]))
    y = x.clone()
    assert T.remainder_(y, torch.tensor(2.0)) is y and torch.equal(
        y, torch.tensor([1.0, 1.0]))
    assert torch.equal(T.add_n([x, x, x]), 3 * x)
    c = torch.zeros(())
    assert T.increment(c, 2.0) is c and float(c) == 2.0
    a, b = T.broadcast_tensors([torch.ones(2, 1), torch.ones(3)])
    assert a.shape == b.shape == (2, 3)
    np.testing.assert_allclose(
        T.vector_norm(x, p=3.0).numpy(),
        np.asarray(J.vector_norm(J.to_tensor(x.numpy()), p=3.0)._data),
        rtol=1e-6)
