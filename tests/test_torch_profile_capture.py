"""The on-demand profiler capture (``paddle_tpu_torch/monitor/
profile_capture.py``, the reference's ``paddle_tpu/monitor/
profile_capture.py`` on ``torch.profiler``).

- Capture directories: ``capture_root`` / ``keep_captures`` read the
  reference's environment names, and ``list_captures`` / ``_evict_old``
  keep and evict the same ``cap_*`` directories as the reference's on
  the same layout, under ``PADDLE_TPU_PROFILE_KEEP``.
- Annotations: idle, ``annotate`` and ``annotate_step`` return the
  shared null context (as the reference's do); while a capture is live
  they return ``torch.profiler.record_function``.
- Exclusivity: a second window while one runs raises ``CaptureBusy``,
  and so does a window while a foreign ``torch.profiler`` session runs
  (which keeps its events); the server's ``/profile`` answers 409 to
  the second of two concurrent requests.
- A CPU capture during a ``llama_tiny`` serve writes a chrome trace that
  holds the engine's ``serving.prefill`` and ``serving.decode_chunk``
  annotations (the engine steps on another thread than the capture),
  and the result carries the reference's keys.

The trace format is torch's, not XLA's (the module docstring).
"""
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.monitor import profile_capture as jpc
from paddle_tpu_torch import monitor as TM
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.monitor import profile_capture as tpc


@pytest.fixture(autouse=True)
def _idle():
    tpc._ACTIVE[0] = None
    yield
    tpc._ACTIVE[0] = None
    TM.server.stop_server()


def _layout(root, names):
    for n in names:
        os.makedirs(os.path.join(root, n))
    open(os.path.join(root, "cap_file_not_dir"), "w").close()


CAPS = [f"cap_20260101_0000{i:02d}_000000" for i in range(7)]


@pytest.mark.parametrize("keep", [None, "1", "3", "junk", "0"])
def test_capture_dirs_and_eviction_match_the_reference(tmp_path, monkeypatch,
                                                       keep):
    if keep is None:
        monkeypatch.delenv("PADDLE_TPU_PROFILE_KEEP", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_PROFILE_KEEP", keep)
    monkeypatch.setenv("PADDLE_TPU_PROFILE_DIR", str(tmp_path / "root"))
    assert tpc.capture_root() == jpc.capture_root() == str(
        tmp_path / "root")
    assert tpc.keep_captures() == jpc.keep_captures()
    out = {}
    for name, mod in (("torch", tpc), ("jax", jpc)):
        root = str(tmp_path / name)
        _layout(root, CAPS + ["other_dir"])
        listed = mod.list_captures(root)
        evicted = mod._evict_old(root)
        out[name] = (listed, evicted, mod.list_captures(root),
                     sorted(os.listdir(root)))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == sorted(CAPS, reverse=True)
    assert len(out["torch"][2]) == tpc.keep_captures()
    assert tpc.list_captures(str(tmp_path / "missing")) == []


def test_annotations_null_when_idle_record_function_when_live():
    for mod in (tpc, jpc):
        assert mod.annotate("serving.prefill") is mod._NULL
        assert mod.annotate_step("serving.decode_chunk", 3) is mod._NULL
        with mod.annotate("x"):
            pass
    assert not tpc.capturing()
    tpc._ACTIVE[0] = {"dir": "d"}
    assert tpc.capturing()
    for ctx in (tpc.annotate("serving.prefill", group=2),
                tpc.annotate_step("serving.decode_chunk", 3)):
        assert isinstance(ctx, torch.profiler.record_function)
        with ctx:
            pass


def test_bad_seconds_and_busy_window(tmp_path):
    with pytest.raises(ValueError, match="> 0"):
        tpc.capture_sync(0, str(tmp_path))
    tpc._ACTIVE[0] = {"dir": "elsewhere"}
    with pytest.raises(tpc.CaptureBusy, match="already running"):
        tpc.capture_sync(0.01, str(tmp_path))
    assert not os.path.exists(tmp_path) or tpc.list_captures(
        str(tmp_path)) == []


def test_foreign_profiler_session_is_busy_and_keeps_its_events(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer.work"):
            with pytest.raises(tpc.CaptureBusy, match="unavailable"):
                tpc.capture_sync(0.01, str(tmp_path))
            torch.ones(4).sum()
    assert "outer.work" in [e.name for e in prof.events()]
    assert not tpc.capturing()
    assert tpc.list_captures(str(tmp_path)) == []


def _engine():
    cfg = TL.llama_tiny()
    return ServingEngine(TL, TL.init_params(cfg, device="cpu"), cfg,
                         device="cpu", num_slots=2, max_len=64,
                         page_size=4, decode_chunk=2), cfg


def test_capture_during_a_serve_holds_the_engine_annotations(tmp_path):
    """The serve starts once the window is open and keeps stepping
    (refilled with requests) until it closes."""
    eng, cfg = _engine()
    rng = np.random.default_rng(0)
    TM.reset()
    TF.set_flags({"enable_monitor": True})
    result = {}
    th = threading.Thread(target=lambda: result.update(
        tpc.capture_sync(1.0, str(tmp_path))))
    try:
        th.start()
        deadline = time.monotonic() + 30
        while not tpc.capturing() and time.monotonic() < deadline:
            time.sleep(0.001)
        rid = 0
        while th.is_alive():
            if not eng.queue and all(s is None for s in eng.slots):
                for _ in range(2):
                    eng.submit(Request(rid=rid, prompt=rng.integers(
                        0, cfg.vocab_size, (6,)).astype(np.int32),
                        max_new_tokens=12))
                    rid += 1
            eng.step()
        th.join()
        counters = TM.snapshot()["counters"]
    finally:
        TF.set_flags({"enable_monitor": False})
        TM.reset()
    assert set(result) == {"dir", "seconds", "files", "evicted", "kept"}
    assert result["seconds"] == 1.0 and result["evicted"] == 0
    assert [f["path"] for f in result["files"]] == [tpc.TRACE_FILE]
    assert result["kept"] == [os.path.basename(result["dir"])]
    assert counters["monitor.profile.captures"] == 1
    with open(os.path.join(result["dir"], tpc.TRACE_FILE)) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("serving.decode_chunk") > 0, sorted(set(names))
    assert names.count("serving.prefill") > 0, rid
    assert not tpc.capturing()


def test_profile_route_answers_409_to_a_second_window(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PROFILE_DIR", str(tmp_path))
    srv = TM.server.start_server(port=0)
    got = {}

    def first():
        with urllib.request.urlopen(srv.url + "/profile?seconds=0.4",
                                    timeout=60) as r:
            got["first"] = (r.status, json.loads(r.read()))

    th = threading.Thread(target=first)
    th.start()
    deadline = time.monotonic() + 30
    while not tpc.capturing() and time.monotonic() < deadline:
        time.sleep(0.002)
    try:
        urllib.request.urlopen(srv.url + "/profile?seconds=0.1",
                               timeout=60)
        second = (200, None)
    except urllib.error.HTTPError as e:
        second = (e.code, json.loads(e.read()))
    th.join()
    assert second[0] == 409 and "already running" in second[1]["error"]
    st, info = got["first"]
    assert st == 200 and info["dir"].startswith(str(tmp_path))
    assert os.path.exists(os.path.join(info["dir"], tpc.TRACE_FILE))
