"""The ``fft``, ``linalg`` and ``signal`` namespaces against the
reference's: their names, the public wrappers' defaults (``fft2``'s last
two axes, ``stft``'s window padding), the frequency grids, and the
signal round trips ``stft`` -> ``istft`` and ``frame`` ->
``overlap_add``."""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import device as TD

# float32 FFTs in other butterfly orders (pocketfft, XLA)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _cpu():
    prev = TD._current_device
    T.set_device("cpu")
    yield
    TD._current_device = prev


def _np(t):
    return np.asarray(t._data) if hasattr(t, "_data") else \
        t.detach().resolve_conj().numpy()


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("ns", ["fft", "linalg", "signal"])
def test_namespaces_match_the_reference(ns):
    port = importlib.import_module(f"paddle_tpu_torch.{ns}")
    ref = importlib.import_module(f"paddle_tpu.{ns}")
    assert getattr(T, ns) is port
    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in port.__all__:
        assert callable(getattr(port, name)), name


def test_linalg_is_the_namespace_not_the_op_module():
    from paddle_tpu_torch.ops import linalg as ops_linalg
    assert T.linalg is not ops_linalg
    assert T.linalg.__name__ == "paddle_tpu_torch.linalg"
    assert T.stft is T.signal.stft and T.istft is T.signal.istft
    assert T.tensor.stft is T.stft


@pytest.mark.parametrize("name,kw", [
    ("fft2", {}), ("ifft2", {"norm": "ortho"}), ("rfft2", {}),
    ("fftn", {"axes": [0, 2]}), ("ihfft2", {}), ("fft", {"n": 7}),
    ("fftshift", {}), ("ifftshift", {"axes": [1]})])
def test_public_wrappers_match(name, kw):
    x = _x(3, 4, 6)
    got = getattr(T.fft, name)(torch.from_numpy(x), **kw)
    want = getattr(J.fft, name)(J.to_tensor(x), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("name", ["fftfreq", "rfftfreq"])
def test_frequency_grids(name):
    got = getattr(T.fft, name)(10, d=0.5)
    want = getattr(J.fft, name)(10, d=0.5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    assert got.dtype == torch.float32
    assert getattr(T.fft, name)(8, dtype="float64").dtype == torch.float64


@pytest.mark.parametrize("win_length,center", [(None, True), (12, True),
                                               (16, False)])
def test_stft_matches_and_istft_inverts(win_length, center):
    x = _x(2, 160)
    window = np.hanning(win_length or 16).astype(np.float32)
    kw = dict(n_fft=16, hop_length=4, win_length=win_length, center=center)
    spec_t = T.signal.stft(torch.from_numpy(x),
                           window=torch.from_numpy(window), **kw)
    spec_j = J.signal.stft(J.to_tensor(x), window=J.to_tensor(window), **kw)
    assert spec_t.dtype == torch.complex64
    np.testing.assert_allclose(_np(spec_t), _np(spec_j), **TOL)
    back_t = T.signal.istft(spec_t, window=torch.from_numpy(window),
                            length=160 if center else None, **kw)
    back_j = J.signal.istft(spec_j, window=J.to_tensor(window),
                            length=160 if center else None, **kw)
    np.testing.assert_allclose(_np(back_t), _np(back_j), **TOL)
    if center:                  # the window overlap covers every sample
        np.testing.assert_allclose(_np(back_t), x, rtol=1e-4, atol=1e-4)


def test_stft_gradient_of_a_real_loss():
    """``abs(stft(x))`` summed: a real loss of a complex output, the same
    gradient in both packages (the complex-gradient convention does not
    enter a real loss)."""
    import jax
    import jax.numpy as jnp
    x = _x(1, 64, seed=3)
    w = np.hanning(16).astype(np.float32)
    kw = dict(n_fft=16, hop_length=4, center=True, pad_mode="reflect",
              normalized=False, onesided=True)
    pure = J.ops.get_op("stft_op").pure_fn
    want = jax.grad(lambda a: jnp.sum(jnp.abs(pure(a, jnp.asarray(w),
                                                   **kw))))(jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    T.ops.get_op("stft_op")(xt, torch.from_numpy(w), **kw).abs().sum() \
        .backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("axis", [-1, 0])
def test_frame_and_overlap_add(axis):
    x = _x(50, 3) if axis == 0 else _x(3, 50)
    ft = T.signal.frame(torch.from_numpy(x), 8, 3, axis=axis)
    fj = J.signal.frame(J.to_tensor(x), 8, 3, axis=axis)
    np.testing.assert_array_equal(_np(ft), _np(fj))
    ot = T.signal.overlap_add(ft, 3, axis=axis)
    oj = J.signal.overlap_add(fj, 3, axis=axis)
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=1e-6, atol=1e-6)
    # hop == frame length: overlap_add undoes frame exactly
    ft = T.signal.frame(torch.from_numpy(x), 5, 5, axis=axis)
    back = T.signal.overlap_add(ft, 5, axis=axis)
    np.testing.assert_array_equal(back.numpy(), x)


def test_frame_refuses_what_the_reference_refuses():
    from paddle_tpu_torch.core import enforce as E
    x = torch.zeros(3, 10)
    with pytest.raises(E.InvalidArgumentError):
        T.signal.frame(x, 12, 2)
    with pytest.raises(E.InvalidArgumentError):
        T.signal.frame(torch.zeros(2, 3, 10), 4, 2, axis=1)
