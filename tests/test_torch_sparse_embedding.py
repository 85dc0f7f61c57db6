"""Port parity: row-sparse embedding gradients (``nn.Embedding(sparse=True)``,
``F.embedding(sparse=True)``) and the optimizer's sparse step, against
the JAX package's SelectedRows on the same numpy weights and ids.

The model: an embedding table ``[16, 8]`` (row 0 its ``padding_idx``)
and a dense scale ``w [8]``, loss ``sum(c * (E[ids] * w).sum(-1))`` for
fixed ``c``; ids repeat rows and name the padding row. Checked: the
port's gradient is a ``torch.sparse_coo`` tensor whose dense form is
JAX's; 3 steps of ``Adam`` / ``AdamW``, lazy and not, with coupled and
decoupled decay, ``amsgrad`` and a float32 master; the clips on the
sparse gradient's values (and a ``ClipGradByValue`` range without 0,
which densifies). Tolerance: float32 parameters and moments within
``1e-6 * max |ref|`` of each tensor (coalescing sums duplicate rows in
another order); the bfloat16 table within one bfloat16 ulp.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jpaddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JParameter
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import device as TD
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.tensor import from_numpy

V, D, STEPS = 16, 8, 3


@pytest.fixture
def cpu_device():
    prev = TD._current_device
    tpaddle.set_device("cpu")
    yield
    TD._current_device = prev


def _data(seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    w = (1 + 0.3 * rng.normal(size=D)).astype(np.float32)
    batches = []
    for _ in range(STEPS):
        ids = rng.integers(0, 6, (3, 5))      # rows 0-5 only, repeated
        c = rng.normal(size=(3, 5)).astype(np.float32)
        batches.append((ids, c))
    return table, w, batches


def _jax_run(table, w, batches, cls, kw, dtype):
    emb = jpaddle.nn.Embedding(V, D, padding_idx=0, sparse=True)
    if dtype != np.float32:
        emb.to(dtype="bfloat16")
    emb.weight.set_value(table.astype(dtype))
    wp = JParameter(jnp.asarray(w), name="w")
    o = getattr(jopt, cls)(learning_rate=1e-2,
                           parameters=[emb.weight, wp], **kw)
    grads = []
    for ids, c in batches:
        out = emb(jpaddle.to_tensor(ids))
        loss = ((out * wp).sum(axis=-1) * jpaddle.to_tensor(c)).sum()
        loss.backward()
        assert emb.weight.grad.is_selected_rows()
        # through the payload: a dense-style read would densify the grad
        grads.append(np.asarray(emb.weight.grad.sr.to_dense_array(),
                                np.float32))
        o.step()
        o.clear_grad()
    st = {k: np.asarray(v)
          for k, v in o._accumulators[id(emb.weight)].items()}
    return np.asarray(emb.weight._data), np.asarray(wp._data), st, grads


def _port_run(table, w, batches, cls, kw, dtype):
    emb = tnn.Embedding(V, D, padding_idx=0, sparse=True)
    with torch.no_grad():
        emb.weight.copy_(from_numpy(table.astype(dtype)))
    if dtype != np.float32:
        emb.to(dtype="bfloat16")
    wp = torch.nn.Parameter(torch.as_tensor(w))
    o = getattr(topt, cls)(learning_rate=1e-2,
                           parameters=[emb.weight, wp], **kw)
    grads = []
    for ids, c in batches:
        out = emb(torch.as_tensor(ids))
        loss = ((out * wp).sum(-1) * torch.as_tensor(c)).sum()
        loss.backward()
        assert emb.weight.grad.is_sparse and not wp.grad.is_sparse
        grads.append(emb.weight.grad.to_dense().float().numpy())
        o.step()
        o.clear_grad()
    st = {k: v.float().numpy()
          for k, v in o._accumulators[id(emb.weight)].items()}
    return (emb.weight.detach().float().numpy(), wp.detach().numpy(), st,
            grads)


def _close(a, b, tol=1e-6):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


_CASES = {
    "adam": ("Adam", {}),
    "adam_lazy": ("Adam", {"lazy_mode": True}),
    "adam_lazy_l2_amsgrad": ("Adam", {"lazy_mode": True, "amsgrad": True,
                                      "weight_decay": 0.05}),
    "adam_l1": ("Adam", {"weight_decay": topt.L1Decay(0.05)}),
    "adamw": ("AdamW", {"weight_decay": 0.1}),
    "adamw_lazy": ("AdamW", {"lazy_mode": True, "weight_decay": 0.1}),
    "clip_global_norm": ("AdamW", {"grad_clip": "global"}),
    "clip_value": ("Adam", {"lazy_mode": True, "grad_clip": "value"}),
    "clip_value_without_zero": ("Adam", {"lazy_mode": True,
                                         "grad_clip": "value_pos"}),
}


def _kw(kw, M):
    kw = dict(kw)
    clip = kw.pop("grad_clip", None)
    if clip == "global":
        kw["grad_clip"] = M.ClipGradByGlobalNorm(0.5)
    elif clip == "value":
        kw["grad_clip"] = M.ClipGradByValue(0.3)
    elif clip == "value_pos":
        kw["grad_clip"] = M.ClipGradByValue(1.0, min=0.1)
    wd = kw.get("weight_decay")
    if isinstance(wd, topt.L1Decay):
        kw["weight_decay"] = M.L1Decay(wd.coeff)
    return kw


@pytest.mark.parametrize("name", sorted(_CASES))
def test_sparse_steps_match_jax(cpu_device, name):
    cls, kw = _CASES[name]
    table, w, batches = _data(1)
    jt, jw, jst, jg = _jax_run(table, w, batches, cls, _kw(kw, jopt),
                               np.float32)
    tt, tw, tst, tg = _port_run(table, w, batches, cls, _kw(kw, topt),
                                np.float32)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        assert not b[0].any()                       # the padding row
    _close(tt, jt)
    _close(tw, jw)
    assert tst.keys() == jst.keys()
    for k in tst:
        _close(tst[k], jst[k])
    if kw.get("lazy_mode") and name != "clip_value_without_zero":
        # rows no id named keep their values and moments exactly
        np.testing.assert_array_equal(tt[6:], table[6:])
        assert not tst["moment1"][6:].any()


@pytest.mark.parametrize("multi_precision", [False, True])
def test_sparse_bfloat16_table_matches_jax(cpu_device, multi_precision):
    table, w, batches = _data(2)
    kw = {"lazy_mode": True, "weight_decay": 0.1,
          "multi_precision": multi_precision}
    jt, _, _, _ = _jax_run(table, w, batches, "AdamW", kw,
                           ml_dtypes.bfloat16)
    tt, _, _, _ = _port_run(table, w, batches, "AdamW", kw,
                            ml_dtypes.bfloat16)
    jt = np.asarray(jt, np.float32)
    ulp = np.spacing(np.abs(jt).astype(ml_dtypes.bfloat16)).astype(
        np.float32)
    assert np.all(np.abs(tt - jt) <= ulp)


def test_dense_embedding_and_no_grad_stay_dense(cpu_device):
    emb = tnn.Embedding(V, D, sparse=True)
    with torch.no_grad():
        out = emb(torch.as_tensor([[1, 2]]))
    assert not out.requires_grad
    dense = tnn.Embedding(V, D)
    dense(torch.as_tensor([[1, 2, 2]])).sum().backward()
    assert not dense.weight.grad.is_sparse
    np.testing.assert_array_equal(dense.weight.grad[2].numpy(),
                                  np.full(D, 2.0, np.float32))
