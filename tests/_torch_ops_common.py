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
    x = x.detach()
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
