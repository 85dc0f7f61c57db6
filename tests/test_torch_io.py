"""Port parity: ``paddle.save`` / ``paddle.load`` and the asynchronous
save (``paddle_tpu_torch/framework/io.py`` against
``paddle_tpu/framework/io.py``).

Files cross between the packages both ways and load bit for bit: nested
dicts, lists and tuples of float32 and integer tensors (the reference
holds integers as int32, its JAX default, so integer values are compared
as values), a ``llama_tiny`` state dict, and bfloat16 tensors, which the
port writes as the ``ml_dtypes.bfloat16`` arrays JAX pickles without
importing ``ml_dtypes`` and reads back through its restricted
unpickler. ``stop_gradient`` and ``name`` cross as well. Atomicity (a
save that raises mid-pickle leaves the old file and no staging file),
the ``RuntimeError`` of a truncated or foreign file, and ``async_save``'s
synchronous snapshot (the writer held on an ``Event``, never a sleep)
are the reference's behaviour, checked on both packages.
"""
import os
import pickle
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.framework import io as jio
from paddle_tpu.models import llama as JL
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import device as TD
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.models import llama as TL


@pytest.fixture(autouse=True)
def cpu_device():
    prev = TD._current_device
    tpaddle.set_device("cpu")
    yield
    TD._current_device = prev


def _nested_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "layers": [{"b": rng.normal(size=(5,)).astype(np.float32)},
                       (rng.integers(-9, 9, (2, 3)).astype(np.int64),)],
            "step": 7, "name": "run"}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree) if isinstance(tree, np.ndarray) else tree


def _assert_tree_equal(got, want):
    """``got`` (tensors of either package, or arrays) against ``want``
    (numpy), containers and their types included; integers by value."""
    assert type(got) is type(want) or (
        isinstance(want, np.ndarray)), (type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_tree_equal(a, b)
    elif isinstance(want, np.ndarray):
        g = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
        assert g.shape == want.shape
        if want.dtype.kind == "f":
            assert g.dtype == want.dtype
            assert np.array_equal(g.view(np.uint32), want.view(np.uint32))
        else:
            assert np.array_equal(g.astype(np.int64), want)
    else:
        assert got == want


def test_port_file_loads_in_the_reference(tmp_path):
    want = _nested_np()
    path = str(tmp_path / "port.pdparams")
    tpaddle.save(_map(torch.from_numpy, want), path)
    _assert_tree_equal(jpaddle.load(path), want)
    _assert_tree_equal(jpaddle.load(path, return_numpy=True), want)
    _assert_tree_equal(tpaddle.load(path), want)


def test_reference_file_loads_in_the_port(tmp_path):
    want = _nested_np(1)
    path = str(tmp_path / "ref.pdparams")
    jpaddle.save(_map(jpaddle.to_tensor, want), path)
    got = tpaddle.load(path)
    _assert_tree_equal(got, want)
    assert all(t.device.type == "cpu" for t in (got["w"],
                                                got["layers"][1][0]))
    _assert_tree_equal(tpaddle.load(path, return_numpy=True), want)


def test_stop_gradient_and_name_cross_both_ways(tmp_path):
    p = torch.nn.Parameter(torch.ones(3))
    p.param_name = "linear_0.w_0"
    tpaddle.save({"p": p, "c": torch.zeros(2)}, str(tmp_path / "a"))
    with open(tmp_path / "a", "rb") as f:
        raw = pickle.load(f)
    assert raw["p"]["stop_gradient"] is False and \
        raw["p"]["name"] == "linear_0.w_0"
    assert raw["c"]["stop_gradient"] is True and raw["c"]["name"] is None
    j = jpaddle.load(str(tmp_path / "a"))
    assert j["p"].stop_gradient is False and j["p"].name == "linear_0.w_0"
    jpaddle.save(j, str(tmp_path / "b"))
    t = tpaddle.load(str(tmp_path / "b"))
    assert t["p"].requires_grad and t["p"].param_name == "linear_0.w_0"
    assert not t["c"].requires_grad


def test_llama_state_dict_crosses_both_ways(tmp_path):
    jpaddle.seed(0)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(num_hidden_layers=2))
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    jpaddle.save(jm.state_dict(), str(tmp_path / "j.pdparams"))
    tm = TL.LlamaForCausalLM(TL.llama_tiny(num_hidden_layers=2))
    missing, unexpected = tm.set_state_dict(
        tpaddle.load(str(tmp_path / "j.pdparams")))
    assert not missing and not unexpected
    _assert_tree_equal({k: v.detach() for k, v in tm.state_dict().items()},
                       want)
    tpaddle.save(tm.state_dict(), str(tmp_path / "t.pdparams"))
    jm2 = JL.LlamaForCausalLM(JL.llama_tiny(num_hidden_layers=2))
    jm2.set_state_dict(jpaddle.load(str(tmp_path / "t.pdparams")))
    _assert_tree_equal({k: np.asarray(v.numpy())
                        for k, v in jm2.state_dict().items()}, want)


def _bf16_bits(seed=2):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(4, 6)).astype(np.float32).astype(ml_dtypes.bfloat16)
    # an inf, a NaN payload and a subnormal cross untouched too
    a.reshape(-1)[:3] = np.array([np.inf, np.nan, 1e-40]).astype(
        ml_dtypes.bfloat16)
    return a.view(np.uint16)


def _torch_bits(t):
    return t.detach().view(torch.int16).numpy().view(np.uint16)


def test_bf16_round_trips_in_the_port_without_ml_dtypes(tmp_path,
                                                        monkeypatch):
    bits = _bf16_bits()
    t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    tpaddle.save({"x": t, "l": [t[0]]}, str(tmp_path / "b"))
    # the port's loader never imports ml_dtypes
    monkeypatch.setitem(__import__("sys").modules, "ml_dtypes", None)
    got = tpaddle.load(str(tmp_path / "b"))
    assert got["x"].dtype == torch.bfloat16
    assert np.array_equal(_torch_bits(got["x"]), bits)
    assert np.array_equal(_torch_bits(got["l"][0]), bits[0])
    f32 = tpaddle.load(str(tmp_path / "b"), return_numpy=True)["x"]
    assert f32.dtype == np.float32
    assert np.array_equal(f32.view(np.uint32) >> 16, bits.astype(np.uint32))


def test_bf16_crosses_both_ways(tmp_path):
    """The reference's bf16 files load in the port bit for bit, and the
    port's in the reference (as ``ml_dtypes.bfloat16`` arrays)."""
    bits = _bf16_bits(3)
    jpaddle.save({"x": jpaddle.to_tensor(jnp.asarray(
        bits.view(ml_dtypes.bfloat16)))}, str(tmp_path / "j"))
    got = tpaddle.load(str(tmp_path / "j"))["x"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_torch_bits(got), bits)
    tpaddle.save({"x": got}, str(tmp_path / "t"))
    back = jpaddle.load(str(tmp_path / "t"))["x"]
    arr = np.asarray(back.numpy())
    assert arr.dtype == ml_dtypes.bfloat16
    assert np.array_equal(arr.view(np.uint16), bits)


class _Boom:
    def __reduce__(self):
        raise RuntimeError("boom mid-pickle")


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_failed_save_keeps_the_old_file(tmp_path, pkg):
    save = tpaddle.save if pkg == "torch" else jpaddle.save
    load = tpaddle.load if pkg == "torch" else jpaddle.load
    path = str(tmp_path / "ck.pdparams")
    save({"v": 1}, path)
    with pytest.raises(RuntimeError, match="boom"):
        save({"v": 2, "bad": _Boom()}, path)
    assert load(path) == {"v": 1}
    assert os.listdir(tmp_path) == ["ck.pdparams"]


@pytest.mark.parametrize("pkg", ["torch", "jax"])
@pytest.mark.parametrize("damage", ["truncated", "foreign", "empty"])
def test_a_corrupt_file_raises_runtime_error(tmp_path, pkg, damage):
    save = tpaddle.save if pkg == "torch" else jpaddle.save
    load = tpaddle.load if pkg == "torch" else jpaddle.load
    path = tmp_path / "ck.pdparams"
    save({"w": np.arange(64, dtype=np.float32)}, str(path))
    raw = path.read_bytes()
    path.write_bytes({"truncated": raw[: len(raw) // 2],
                      "foreign": b"not a pickle at all",
                      "empty": b""}[damage])
    with pytest.raises(RuntimeError, match="failed to unpickle"):
        load(str(path))
    with pytest.raises(FileNotFoundError):
        load(str(tmp_path / "missing"))


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_async_save_snapshots_before_it_returns(tmp_path, monkeypatch,
                                                pkg):
    """The write waits on an ``Event``; the value is changed after
    ``async_save`` returned, and the file holds the old one."""
    mod, P = (tio, tpaddle) if pkg == "torch" else (jio, jpaddle)
    name = "_write" if pkg == "torch" else "save"
    real = getattr(mod, name)
    gate = threading.Event()

    def held(*a, **kw):
        gate.wait(30)
        return real(*a, **kw)
    monkeypatch.setattr(mod, name, held)
    if pkg == "torch":
        t = torch.zeros(4)
        th = P.async_save({"t": t}, str(tmp_path / "a"))
        t.add_(1.0)
    else:
        t = P.to_tensor(np.zeros(4, np.float32))
        th = P.async_save({"t": t}, str(tmp_path / "a"))
        t.set_value(np.ones(4, np.float32))
    assert th.is_alive()
    gate.set()
    P.clear_async_save_task_queue()
    assert not th.is_alive()
    got = P.load(str(tmp_path / "a"))["t"]
    assert np.array_equal(np.asarray(got.numpy()), np.zeros(4, np.float32))
