"""``core/`` of the op library against the reference: dtype names and
``convert_dtype`` (64-bit types kept, mapped through one table),
the default dtype and the predicates; ``Tensor`` / ``Parameter`` /
``is_tensor``; ``SelectedRows`` (``coalesce``, ``to_dense``, ``+``,
``nbytes``) against ``paddle_tpu.core.selected_rows`` on the same rows,
and its round trip with the sparse embedding gradient; the
``paddle.tensor`` namespace."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.core import dtype as JD
from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu_torch import device as TD
from paddle_tpu_torch.core import dtype as TDT
from paddle_tpu_torch.core.selected_rows import SelectedRows, is_selected_rows

# the reference canonicalises 64-bit types without x64; the port keeps
# them: reference name -> the port's dtype
DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16, "float32": torch.float32, "fp32": torch.float32,
    "float64": torch.float64, "fp64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
CANONICAL_64 = {"int64": "int32", "float64": "float32", "fp64": "float32",
                "complex128": "complex64"}


@pytest.fixture(autouse=True)
def _cpu():
    prev = TD._current_device
    T.set_device("cpu")
    yield
    TD._current_device = prev


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_convert_dtype_names(name):
    got = TDT.convert_dtype(name)
    assert got is DTYPES[name]
    ref = str(np.dtype(JD.convert_dtype(name)))
    port_name = str(got).replace("torch.", "")
    assert ref == CANONICAL_64.get(name, port_name)
    assert TDT.convert_dtype(got) is got
    assert TDT.is_floating_point(got) == JD.is_floating_point(
        JD.convert_dtype(name))
    assert TDT.is_integer(got) == JD.is_integer(JD.convert_dtype(name))
    assert TDT.is_complex(got) == JD.is_complex(JD.convert_dtype(name))


def test_convert_dtype_others():
    assert TDT.convert_dtype(None) is None
    assert TDT.convert_dtype(np.float32) is torch.float32
    assert TDT.convert_dtype(np.dtype("int16")) is torch.int16
    assert TDT.convert_dtype(bool) is torch.bool
    with pytest.raises(Exception, match="Unknown dtype"):
        TDT.convert_dtype("float8")
    # the old home keeps working
    from paddle_tpu_torch.core.tensor import convert_dtype
    assert convert_dtype is TDT.convert_dtype


def test_dtype_names_and_default_dtype():
    for name in ("bool_", "uint8", "int8", "int16", "int32", "int64",
                 "float16", "bfloat16", "float32", "float64", "complex64",
                 "complex128"):
        assert getattr(T, name) is getattr(TDT, name)
        assert hasattr(J, name)
    assert T.get_default_dtype() is torch.float32
    try:
        T.set_default_dtype("bfloat16")
        J.set_default_dtype("bfloat16")
        assert T.zeros([2]).dtype == torch.bfloat16
        assert T.ones_like(T.zeros([2])).dtype == torch.bfloat16
        assert str(J.zeros([2]).dtype) == "bfloat16"
        for mod in (T, J):
            with pytest.raises(TypeError):
                mod.set_default_dtype("int32")
    finally:
        T.set_default_dtype("float32")
        J.set_default_dtype("float32")


def test_tensor_parameter_is_tensor():
    assert T.Tensor is torch.Tensor
    assert T.Parameter is torch.nn.Parameter
    assert T.is_tensor(torch.ones(1)) and not T.is_tensor(np.ones(1))
    p = T.create_parameter([4, 6], "float32")
    assert isinstance(p, T.Parameter) and p.requires_grad
    bound = np.sqrt(6.0 / 10)
    assert float(p.abs().max()) <= bound
    b = T.create_parameter([6], "bfloat16", is_bias=True)
    assert b.dtype == torch.bfloat16 and not b.any()
    c = T.create_parameter(
        [3], "float32",
        default_initializer=lambda s, d: torch.full(s, 2.0, dtype=d))
    assert torch.equal(c, torch.full((3,), 2.0))
    t = T.create_tensor("int32")
    assert t.dtype == torch.int32 and t.ndim == 0


ROWS = np.array([4, 1, 4, 0, 7, 1, 1], np.int64)


def _sr_pair(rows=ROWS, seed=0, shape=(9, 3)):
    vals = np.random.default_rng(seed).normal(
        size=(len(rows), shape[1])).astype(np.float32)
    return (JSR(jnp.asarray(rows, jnp.int32), jnp.asarray(vals), shape),
            SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals),
                         shape))


def test_selected_rows_coalesce_and_to_dense_match_the_reference():
    j, t = _sr_pair()
    np.testing.assert_allclose(t.to_dense().numpy(),
                               np.asarray(j.to_dense_array()), rtol=1e-6)
    jc, tc = j.coalesce(), t.coalesce()
    np.testing.assert_array_equal(tc.rows.numpy(), np.asarray(jc.rows))
    np.testing.assert_allclose(tc.values.numpy(), np.asarray(jc.values),
                               rtol=1e-6, atol=1e-7)
    # the sentinel slots past the unique rows hold dense_shape[0] and 0
    assert (tc.rows.numpy()[4:] == 9).all() and not tc.values[4:].any()
    np.testing.assert_allclose(tc.to_dense().numpy(),
                               np.asarray(jc.to_dense_array()), rtol=1e-6,
                               atol=1e-7)
    assert t.nbytes == ROWS.size * 8 + ROWS.size * 3 * 4
    assert j.nbytes == ROWS.size * 4 + ROWS.size * 3 * 4   # int32 rows
    one = SelectedRows(torch.tensor([2]), torch.ones(1, 3), (9, 3))
    assert one.coalesce() is one


def test_selected_rows_add_matches_the_reference():
    (j1, t1), (j2, t2) = _sr_pair(), _sr_pair(np.array([2, 4]), seed=1)
    js, ts = j1 + j2, t1 + t2
    assert isinstance(ts, SelectedRows) and ts.rows.shape[0] == 9
    np.testing.assert_allclose(ts.to_dense().numpy(),
                               np.asarray(js.to_dense_array()), rtol=1e-6)
    dense = np.ones((9, 3), np.float32)
    np.testing.assert_allclose((t1 + torch.from_numpy(dense)).numpy(),
                               np.asarray(j1 + jnp.asarray(dense)),
                               rtol=1e-6)
    np.testing.assert_allclose((torch.from_numpy(dense) + t1).numpy(),
                               np.asarray(jnp.asarray(dense) + j1),
                               rtol=1e-6)
    with pytest.raises(Exception, match="shape mismatch"):
        t1 + SelectedRows(torch.tensor([0]), torch.ones(1, 3), (5, 3))
    t3 = t1.with_values(t1.values * 2)
    assert t3.rows is t1.rows and torch.equal(t3.to_dense(),
                                              2 * t1.to_dense())


def test_selected_rows_and_the_sparse_embedding_gradient():
    import paddle_tpu_torch.nn.functional as F
    w = torch.randn(9, 3, requires_grad=True)
    ids = torch.from_numpy(ROWS)
    F.embedding(ids, w, padding_idx=7, sparse=True).sum().backward()
    assert is_selected_rows(w.grad) and not is_selected_rows(torch.ones(2))
    sr = SelectedRows.from_sparse(w.grad)
    assert is_selected_rows(sr)
    dense = sr.to_dense()
    want = torch.zeros(9, 3).index_add(0, ids, torch.ones(len(ROWS), 3))
    want[7] = 0
    assert torch.equal(dense, want)
    back = sr.coalesce().to_sparse()
    assert back.is_coalesced() and torch.equal(back.to_dense(), dense)
    assert torch.equal(back.indices()[0], torch.tensor([0, 1, 4, 7]))


def test_paddle_tensor_namespace():
    from paddle_tpu_torch import tensor as TT
    assert TT.search is TT.logic and TT.stat is TT.reduction
    assert TT.attribute is TT.logic and TT.einsum is TT.math
    assert TT.add is T.add and TT.creation.zeros is T.zeros
    f = TT.fill_constant([2, 3], "int32", 7)
    assert f.dtype == torch.int32 and int(f.sum()) == 42
    arr = TT.create_array()
    TT.array_write(torch.ones(1), 0, arr)
    TT.array_write(torch.zeros(1), 1, arr)
    assert TT.array_length(arr) == 2 and TT.array_read(arr, 1).item() == 0
    with pytest.raises(IndexError):
        TT.array_write(torch.ones(1), 5, arr)
    assert not hasattr(T, "linalg") or T.linalg is not TT.linalg
