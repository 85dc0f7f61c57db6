"""Port parity: the fault-injection harness
(``paddle_tpu_torch/testing/faults.py``, a copy of
``paddle_tpu/testing/faults.py``).

The reference's semantics, each checked on the port and, where the two
take the same calls, on the JAX module beside it: the ``nth`` trigger,
``every`` (sustained firing), ``delay``, ``raise``, the one-shot latch,
corrupt actions counted only at value points, the
``point:action[:nth[:delay_s]]`` spec parser, ``corrupt`` over a torch
tensor, a numpy array and a nested dict (floating leaves NaN or +Inf,
signed integers their minimum, unsigned their maximum), and the engine's
one injection point: ``begin_drain`` fires ``serving.drain``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.testing import faults

BOTH = [faults, jfaults]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for f in BOTH:
        f.clear()


@pytest.mark.parametrize("f", BOTH, ids=["port", "jax"])
def test_nth_trigger_and_one_shot_latch(f):
    with f.injected("t.nth", action="raise", nth=3):
        f.hit("t.nth")
        f.hit("t.nth")
        with pytest.raises(f.FaultInjected, match="t.nth"):
            f.hit("t.nth")
        f.hit("t.nth")                  # latched: no second firing
        assert f._POINTS["t.nth"].fired
    assert not f.armed()


@pytest.mark.parametrize("f", BOTH, ids=["port", "jax"])
def test_every_mode_fires_repeatedly(f):
    with f.injected("t.every", action="delay", nth=2, delay_s=0.0,
                    every=True):
        for _ in range(5):
            f.hit("t.every")
        inj = f._POINTS["t.every"]
        assert inj.hits == 5 and not inj.fired


def test_delay_sleeps_and_counts(monkeypatch):
    slept = []
    monkeypatch.setattr(faults.time, "sleep", slept.append)
    before = faults.hit_count("t.delay")
    with faults.injected("t.delay", action="delay", delay_s=0.25):
        faults.hit("t.delay")
        faults.hit("t.delay")
    assert slept == [0.25]
    assert faults.hit_count("t.delay") == before + 2


def test_disarmed_hit_is_free_and_uncounted():
    assert not faults.armed()
    before = faults.hit_count("t.free")
    faults.hit("t.free")
    assert faults.hit_count("t.free") == before
    x = torch.ones(3)
    assert faults.corrupt("t.free", x) is x


def test_unknown_action_and_bad_nth_refused():
    for f in BOTH:
        with pytest.raises(ValueError, match="unknown fault action"):
            f.inject("t.bad", action="explode")
        with pytest.raises(ValueError, match="nth"):
            f.inject("t.bad", action="raise", nth=0)


@pytest.mark.parametrize("f", BOTH, ids=["port", "jax"])
def test_spec_parser_arms_each_entry(f):
    f._arm_from_spec("a.b:raise:2, c.d:delay:1:0.5 ,e.f:corrupt")
    pts = f._POINTS
    assert (pts["a.b"].action, pts["a.b"].nth) == ("raise", 2)
    assert (pts["c.d"].action, pts["c.d"].delay_s) == ("delay", 0.5)
    assert (pts["e.f"].action, pts["e.f"].nth) == ("corrupt", 1)
    with pytest.raises(ValueError, match="point:action"):
        f._arm_from_spec("lonely")


def test_spec_from_the_flag_in_a_fresh_process(tmp_path):
    import os
    import subprocess
    import sys
    code = ("from paddle_tpu_torch.testing import faults as f; "
            "print(f.armed(), f._POINTS['serving.drain'].action)")
    env = dict(os.environ, FLAGS_fault_injection="serving.drain:raise:1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.split() == ["True", "raise"]


def test_corrupt_counts_only_at_value_points():
    with faults.injected("t.val", action="corrupt", nth=2):
        faults.hit("t.val")                     # neither fires nor counts
        x = torch.ones(4)
        assert faults.corrupt("t.val", x) is x  # first value hit
        y = faults.corrupt("t.val", x)          # second: poisoned copy
        assert torch.isnan(y[0]) and torch.all(y[1:] == 1)
        assert torch.all(x == 1)                # the input is untouched


def test_corrupt_a_torch_tensor_numpy_array_and_nested_dict():
    cases = [
        (torch.ones(2, 3), "corrupt", lambda t: torch.isnan(t[0, 0])),
        (torch.ones(2, dtype=torch.bfloat16), "corrupt_inf",
         lambda t: torch.isinf(t[0]) and t.dtype == torch.bfloat16),
        (torch.arange(5, dtype=torch.int32), "corrupt",
         lambda t: t[0] == torch.iinfo(torch.int32).min),
        (np.ones(3, np.float32), "corrupt_inf", lambda a: np.isinf(a[0])),
        (np.arange(4, dtype=np.int64), "corrupt",
         lambda a: a[0] == np.iinfo(np.int64).min),
        (np.arange(4, dtype=np.uint8), "corrupt",
         lambda a: a[0] == np.iinfo(np.uint8).max),
    ]
    for value, action, poisoned in cases:
        with faults.injected("t.leaf", action=action):
            got = faults.corrupt("t.leaf", value)
        assert type(got) is type(value) and bool(poisoned(got)), value
        assert got is not value
    tree = {"step": 3, "meta": None,
            "batch": {"ids": torch.arange(6).reshape(2, 3),
                      "mask": np.ones(2, bool)}}
    with faults.injected("t.tree", action="corrupt"):
        got = faults.corrupt("t.tree", tree)
    assert got["step"] == 3 and got["meta"] is None
    assert got["batch"]["ids"][0, 0] == torch.iinfo(torch.int64).min
    assert tree["batch"]["ids"][0, 0] == 0      # a copy was poisoned
    # nothing poisonable: the value passes through
    with faults.injected("t.none", action="corrupt"):
        assert faults.corrupt("t.none", {"a": 1}) == {"a": 1}


def test_corrupt_matches_the_reference_on_numpy_leaves():
    for action in ("corrupt", "corrupt_inf"):
        for arr in (np.ones((2, 2), np.float32), np.arange(3, dtype=np.int16),
                    np.arange(3, dtype=np.uint32)):
            got = []
            for f in BOTH:
                with f.injected("t.np", action=action):
                    got.append(f.corrupt("t.np", {"x": arr})["x"])
            np.testing.assert_array_equal(got[0], np.asarray(got[1]))


def test_begin_drain_fires_serving_drain():
    cfg = TL.llama_tiny(num_hidden_layers=1)
    eng = ServingEngine(TL, TL.init_params(cfg, device="cpu"), cfg,
                        device="cpu", num_slots=1, max_len=16, page_size=4)
    with faults.injected("serving.drain", action="raise"):
        before = faults.hit_count("serving.drain")
        with pytest.raises(faults.FaultInjected, match="serving.drain"):
            eng.begin_drain()
        assert faults.hit_count("serving.drain") == before + 1
    assert not eng.draining        # the fault fired before the transition
    eng.begin_drain()
    assert eng.draining and eng.drain_complete
