"""``chip_smoke.py``'s ``[ops_block]`` on the CPU: one Llama decoder layer
written with the flat ops and ``F.*`` (``chip_smoke.ops_block``), the
same function over both packages at ``llama_tiny`` widths in float32:
its output against the reference's and against ``models/llama.py``
``_block`` (rtol 1e-5 / atol 1e-6 of the values; gradients of every leaf
at 1e-5 of each one's max), and its ``op.<name>.calls`` with the monitor
on equal to the reference's (the table the card's run is held to)."""
from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.nn.functional as JF_
import paddle_tpu_torch as T
from paddle_tpu import monitor as JM
from paddle_tpu.core import flags as JFL
from paddle_tpu_torch import device as TD
from paddle_tpu_torch.models import llama as L


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_ops", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


C = _chip_smoke()
CFG = L.llama_tiny(dtype=torch.float32)
B, S = 2, 16


@pytest.fixture(autouse=True)
def _cpu():
    prev = TD._current_device
    T.set_device("cpu")
    yield
    TD._current_device = prev


def _setup():
    return C.ops_block_setup(torch, CFG, torch.device("cpu"), B, S)


def test_op_built_layer_matches_block_and_its_gradients():
    setup = _setup()
    y, g = C.ops_block_run(torch, "ops", CFG, *setup)
    g = {k: v.clone() for k, v in g.items()}
    y_ref, g_ref = C.ops_block_run(torch, "block", CFG, *setup)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    for k in g_ref:
        assert C._rel(g[k], g_ref[k]) <= 1e-5, k


def _ref_layer(setup):
    x, lp, cos, sin, _ = setup
    to = lambda t: J.to_tensor(t.detach().numpy())  # noqa: E731
    return C.ops_block(J, JF_, to(x), {k: to(w) for k, w in lp.items()},
                       to(cos), to(sin), CFG)


def test_op_built_layer_matches_the_reference_and_its_op_counts():
    setup = _setup()
    JM.reset()
    JFL.set_flags({"enable_monitor": True})
    try:
        want = _ref_layer(setup)
        snap = JM.snapshot()
    finally:
        JFL.set_flags({"enable_monitor": False})
        JM.reset()
    got = C.ops_block(T, T.nn.functional, *setup[:4], CFG)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want._data), rtol=1e-5, atol=1e-5)
    ref_calls = {k: v for k, v in snap["counters"].items()
                 if k.startswith("op.")}
    calls, hist, peak, wall_ns = C.ops_block_counts(
        torch, CFG, torch.device("cpu"), B, S)
    assert calls == ref_calls
    assert hist == sum(calls.values()) == \
        snap["histograms"]["op.dispatch.wall_ns"]["count"]
    assert peak > 0 and wall_ns > 0


def test_seam_cost_is_measured_both_ways():
    got = C.ops_seam_ns(torch, torch.device("cpu"), calls=200)
    assert set(got) == {"off", "on"}
