"""Shared helpers of the op-library parity tests: the same seeded numpy
inputs through the JAX reference (``paddle_tpu``) and the port
(``paddle_tpu_torch``), outputs compared under one dtype table."""
from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as J
from paddle_tpu_torch.testing import op_cases as OC

# the reference's registered names that this slice ports, by module
SLICE_MODULES = ("ops", "ops.creation", "ops.math", "ops.reduction",
                 "ops.manipulation", "ops.logic", "ops.linalg", "ops.random",
                 "ops.math_ext", "ops.manipulation_ext", "ops.linalg_ext",
                 "ops.misc_ext", "ops.fft_ops",
                 "nn.functional.activation", "nn.functional.attention",
                 "nn.functional.common", "nn.functional.loss",
                 "nn.functional.norm")

# the reference runs without x64: its 64-bit results are 32-bit. A port
# dtype may stand for a reference dtype only as this table says.
DTYPE_MAP = {
    "int32": {"int32", "int64"}, "int64": {"int64"},
    "float32": {"float32"}, "bool": {"bool"}, "bfloat16": {"bfloat16"},
    "float16": {"float16"}, "complex64": {"complex64"},
    "uint8": {"uint8"}, "int8": {"int8"}, "int16": {"int16"},
}

F32_TOL = (1e-5, 1e-6)

# Complex gradients. torch's autograd takes a gradient output g for a
# complex output and returns, for a complex input, the conjugate
# Wirtinger gradient; JAX's vjp takes the cotangent conj(g) for the same
# real loss and returns the conjugate of torch's for a complex input.
# So: the reference's cotangent is conj of the port's gradient output,
# and a complex input's reference gradient is conjugated before it is
# compared (a real input's is compared as it is).


def ref_cotangent(g):
    """The reference's cotangent for the port's gradient output ``g``."""
    return np.conj(g) if np.iscomplexobj(g) else g


def port_grad_of(ref_grad, complex_input):
    """The reference's gradient of an input in the port's convention."""
    return np.conj(ref_grad) if complex_input else ref_grad
HALF_TOL = {"float16": 1e-2, "bfloat16": 3e-2}   # rtol = atol, as _close


def slice_names(registry, prefix):
    out = {}
    for name, fn in registry.items():
        mod = getattr(fn, "__module__", "")
        if mod.startswith(prefix) and mod[len(prefix):] in SLICE_MODULES:
            out[name] = mod[len(prefix):]
    return out


def seed_of(name):
    return zlib.crc32(name.encode())


def inputs(name, shapes=OC.SMALL):
    case = OC.case_for(name)
    return case, case.make(OC.Inputs(seed_of(name)), shapes)


def ref_tensor(a, stop_gradient=True):
    return J.to_tensor(a, stop_gradient=stop_gradient)


def port_tensor(a, requires_grad=False):
    t = torch.from_numpy(np.array(a))
    if requires_grad:
        t.requires_grad_()
    return t


def to_ref(obj):
    return OC.to_tensors(obj, ref_tensor)


def to_port(obj):
    return OC.to_tensors(obj, port_tensor)


def ref_numpy(x):
    if hasattr(x, "_data"):
        x = x._data
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def port_numpy(x):
    x = x.detach().resolve_conj()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()


def dtype_name(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    d = x._data.dtype if hasattr(x, "_data") else x.dtype
    return str(np.dtype(d))


def flat(out):
    if isinstance(out, (tuple, list)):
        return [o for x in out for o in flat(x)]
    return [out]


def _recon_svd(out):
    u, s, vh = out
    return (u * s[..., None, :]) @ vh


def _spectrum_gap(a, b):
    """The largest distance from an eigenvalue of either side to the
    nearest of the other's: spectra compared as sets, since a conjugate
    pair's order depends on roundoff."""
    d = np.abs(np.asarray(a)[..., :, None] - np.asarray(b)[..., None, :])
    return max(float(d.min(-1).max()), float(d.min(-2).max()))


def compare_factors(kind, got, want, tol, what=""):
    """A factorization's outputs compared where they are unique: the
    spectrum, and each side's reconstruction of its input (``kind`` as
    ``op_cases.Case.compare``)."""
    g = [port_numpy(x) for x in flat(got)]
    w = [ref_numpy(x) for x in flat(want)]
    rtol, atol = tol or F32_TOL

    def close(a, b, part):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {part}")
    if kind == "svd":
        close(g[1], w[1], "singular values")
        close(_recon_svd(g), _recon_svd(w), "U S Vh")
    elif kind == "qr":
        close(g[0] @ g[1], w[0] @ w[1], "Q R")
        close(np.abs(np.diagonal(g[1], 0, -2, -1)),
              np.abs(np.diagonal(w[1], 0, -2, -1)), "|diag R|")
        eye = np.eye(g[0].shape[-1], dtype=np.float32)
        close(g[0].swapaxes(-1, -2) @ g[0], np.broadcast_to(
            eye, g[0].shape[:-2] + eye.shape), "Q^T Q")
    elif kind == "eigh":
        close(g[0], w[0], "eigenvalues")
        close((g[1] * g[0][..., None, :]) @ g[1].swapaxes(-1, -2),
              (w[1] * w[0][..., None, :]) @ w[1].swapaxes(-1, -2),
              "V diag(w) V^T")
    elif kind == "eig":
        assert _spectrum_gap(g[0], w[0]) <= rtol * np.abs(w[0]).max() + atol, \
            (what, "eigenvalues")
        close((g[1] * g[0][..., None, :]) @ np.linalg.inv(g[1]),
              (w[1] * w[0][..., None, :]) @ np.linalg.inv(w[1]),
              "V diag(w) V^-1")
    elif kind == "eigvals":
        assert _spectrum_gap(g[0], w[0]) <= rtol * np.abs(w[0]).max() + atol, \
            (what, "eigenvalues")
    else:
        raise KeyError(kind)


def assert_same(got, want, tol=None, what=""):
    """Port output(s) ``got`` against reference output(s) ``want``."""
    g, w = flat(got), flat(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for a, b in zip(g, w):
        if not isinstance(a, torch.Tensor):
            assert a == (b.item() if hasattr(b, "item") else b), what
            continue
        wd, gd = dtype_name(b), dtype_name(a)
        assert gd in DTYPE_MAP.get(wd, {wd}), (what, gd, wd)
        an, bn = port_numpy(a), ref_numpy(b)
        assert an.shape == bn.shape, (what, an.shape, bn.shape)
        if wd in HALF_TOL:
            r = HALF_TOL[wd]
            np.testing.assert_allclose(an, bn, rtol=r, atol=r,
                                       equal_nan=True, err_msg=what)
        elif an.dtype.kind in "fc":
            rtol, atol = tol or F32_TOL
            np.testing.assert_allclose(an, bn, rtol=rtol, atol=atol,
                                       equal_nan=True, err_msg=what)
        else:
            np.testing.assert_array_equal(an, bn, err_msg=what)
