"""Port parity: the rank-keyed half of ``distributed/heartbeat.py`` (rank
beats and their staleness check, the key-value watcher and relay, the
dead-peer and abort markers; ROADMAP A10) against
``paddle_tpu/distributed/heartbeat.py``.

The reference's own cases (``tests/test_heartbeat_kv.py``) run on the
port, over the dict-backed fake client and over the port's
``StoreClient`` on a real ``torch.distributed`` store. The file formats
cross: markers one package writes, the other reads, and
``clear_run_markers`` leaves the same files on the same directory.
"""
import json
import os
import time

import pytest
import torch.distributed as dist

from paddle_tpu.distributed import heartbeat as jhb
from paddle_tpu_torch.distributed import heartbeat as hb


class FakeKV:
    """Dict-backed stand-in for the store client."""

    def __init__(self):
        self.d = {}

    def key_value_set(self, k, v, allow_overwrite=False):
        if not allow_overwrite and k in self.d:
            raise RuntimeError(f"key exists: {k}")
        self.d[k] = v

    def key_value_try_get(self, k):
        if k not in self.d:
            raise KeyError(k)
        return self.d[k]

    def key_value_delete(self, k):
        self.d.pop(k, None)


def _clients():
    return {"fake": FakeKV(), "store": hb.StoreClient(dist.HashStore())}


@pytest.fixture(params=["fake", "store"])
def kv(request):
    return _clients()[request.param]


def _publish(kv, kind, rank, payload):
    kv.key_value_set(f"{hb._KV_PREFIX}/{kind}/rank{rank}",
                     json.dumps(payload), allow_overwrite=True)


def test_constants_are_the_references():
    for name in ("_AUTO_SUFFIX", "_PROGRESS_SUFFIX", "_DEAD_SUFFIX",
                 "_KV_PREFIX", "_DEAD_KV_PREFIX", "_ABORT_KV_PREFIX",
                 "_NAMED_KV_PREFIX"):
        assert getattr(hb, name) == getattr(jhb, name), name


def test_never_published_grace_then_stale(kv):
    w = hb.KVHeartbeatWatcher(kv)
    t0 = time.time()
    assert w.check([0], auto_timeout=10, progress_timeout=0,
                   started_at=t0) == {}
    stale = w.check([0], auto_timeout=0.0001, progress_timeout=0,
                    started_at=t0 - 5)
    assert 0 in stale and "never published" in stale[0]


def test_value_change_resets_age_regardless_of_timestamps(kv):
    w = hb.KVHeartbeatWatcher(kv)
    _publish(kv, "auto", 0, {"t": 0.0, "seq": 1})
    assert w.check([0], auto_timeout=0.2, progress_timeout=0) == {}
    time.sleep(0.3)
    stale = w.check([0], auto_timeout=0.2, progress_timeout=0)
    assert 0 in stale and "no liveness beat" in stale[0]
    _publish(kv, "auto", 0, {"t": 0.0, "seq": 2})
    assert w.check([0], auto_timeout=0.2, progress_timeout=0) == {}


def test_wedged_but_alive_detected_via_progress(kv):
    w = hb.KVHeartbeatWatcher(kv)
    _publish(kv, "auto", 0, {"seq": 1})
    _publish(kv, "progress", 0, {"step": 5, "seq": 1})
    assert w.check([0], auto_timeout=5, progress_timeout=0.2) == {}
    time.sleep(0.3)
    _publish(kv, "auto", 0, {"seq": 2})
    stale = w.check([0], auto_timeout=5, progress_timeout=0.2)
    assert 0 in stale and "no training progress" in stale[0]
    assert w.latest("progress", 0)["step"] == 5
    # no progress opt-in: no wedge check
    _publish(kv, "auto", 1, {"seq": 1})
    assert w.check([1], auto_timeout=5, progress_timeout=0.1) == {}


def test_relay_mirrors_kv_beats_to_files(tmp_path, kv):
    _publish(kv, "auto", 0, {"t": 1.0, "seq": 1})
    _publish(kv, "auto", 1, {"t": 1.0, "seq": 1})
    _publish(kv, "progress", 1, {"step": 3, "seq": 1})
    stop = hb.start_kv_relay(str(tmp_path), [0, 1], interval=0.05,
                             client=kv)
    try:
        deadline = time.time() + 5
        want = {"rank0.alive", "rank1.alive", "rank1.progress"}
        while time.time() < deadline:
            if want <= set(os.listdir(tmp_path)):
                break
            time.sleep(0.05)
        assert want <= set(os.listdir(tmp_path)), os.listdir(tmp_path)
        # both packages' file watchers see the mirrored beats as fresh
        for mod in (hb, jhb):
            assert mod.check_stale(str(tmp_path), [0, 1], auto_timeout=30,
                                   progress_timeout=0) == {}
        mt = os.stat(tmp_path / "rank0.alive").st_mtime
        time.sleep(0.2)
        assert os.stat(tmp_path / "rank0.alive").st_mtime == mt
    finally:
        stop.set()


def test_relay_without_a_process_group_returns_none(monkeypatch):
    assert not dist.is_initialized()
    assert hb._kv_client() is None
    assert hb.start_kv_relay("/nonexistent-relay-dir", [0]) is None


def test_rank_beats_and_staleness_match_the_reference(tmp_path,
                                                      monkeypatch):
    """``start`` / ``beat`` / ``stop`` write the reference's files, and
    ``check_stale`` gives the reference's verdicts over one directory:
    a live rank, a rank whose progress went stale, a rank that never
    beat (within and past the startup grace)."""
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.delenv("PADDLE_HEARTBEAT_DIR", raising=False)
    d = str(tmp_path)
    assert hb.start(dir_path=d, rank=0, interval=0.05)
    try:
        hb.beat(step=3)
        deadline = time.time() + 5
        while not os.path.exists(os.path.join(d, "rank0.alive")) \
                and time.time() < deadline:
            time.sleep(0.02)
        with open(os.path.join(d, "rank0.progress")) as f:
            assert json.load(f)["step"] == 3
        # rank 1: alive, progress 10 s old
        jhb._touch(os.path.join(d, "rank1.alive"))
        jhb._touch(os.path.join(d, "rank1.progress"), {"step": 1})
        old = time.time() - 10
        os.utime(os.path.join(d, "rank1.progress"), (old, old))
        for started in (time.time(), time.time() - 60):
            kw = dict(auto_timeout=5, progress_timeout=2,
                      started_at=started)
            got = hb.check_stale(d, [0, 1, 2], **kw)
            want = jhb.check_stale(d, [0, 1, 2], **kw)
            assert sorted(got) == sorted(want)
            assert {r: v.split(" for ")[0].split(" (")[0]
                    for r, v in got.items()} == \
                {r: v.split(" for ")[0].split(" (")[0]
                 for r, v in want.items()}
        assert set(hb.check_stale(d, [0, 1, 2], 5, 2,
                                  started_at=time.time() - 60)) == {1, 2}
    finally:
        hb.stop()
    assert hb._state["thread"] is None


def test_kv_leg_of_the_beats_rides_the_store(monkeypatch):
    """With a client the beats publish under the reference's keys; the
    watcher on the same store reads them."""
    store = hb.StoreClient(dist.HashStore())
    monkeypatch.setattr(hb, "_kv_client", lambda: store)
    monkeypatch.setattr(hb, "_state", dict(hb._state, rank=4, dir=None))
    monkeypatch.delenv("PADDLE_HEARTBEAT_DIR", raising=False)
    hb.beat(step=9)
    w = hb.KVHeartbeatWatcher(store)
    assert w.latest("progress", 4)["step"] == 9


@pytest.mark.parametrize("writer,reader", [(hb, jhb), (jhb, hb)],
                         ids=["port_writes", "reference_writes"])
def test_markers_cross_between_the_packages(tmp_path, monkeypatch, writer,
                                            reader):
    """Death and abort markers one package writes, the other reads, by
    generation and job; another job's marker is not honoured."""
    d = str(tmp_path)
    monkeypatch.setenv("PADDLE_ELASTIC_RUN", "2")
    monkeypatch.setenv("PADDLE_MASTER", "127.0.0.1:4000")
    assert hb.elastic_generation() == jhb.elastic_generation() == 2
    writer.mark_dead(1, "worker exited rc=3", dir_path=d)
    writer.mark_dead(2, "wedged", dir_path=d, generation=1)
    writer.mark_dead(3, "other job", dir_path=d, job="127.0.0.1:5000")
    assert reader.dead_ranks(range(4), dir_path=d) == \
        {1: "worker exited rc=3"}
    assert reader.dead_ranks(range(4), dir_path=d, generation=1) == \
        {2: "wedged"}
    writer.write_abort_marker(0, {"kind": "timeout"}, dir_path=d)
    got = reader.read_abort_marker(dir_path=d)
    assert got["kind"] == "timeout" and got["rank"] == 0 and \
        got["gen"] == 2
    assert reader.read_abort_marker(dir_path=d, generation=1) is None


def test_kv_markers_match_the_reference_keys(monkeypatch):
    monkeypatch.delenv("PADDLE_HEARTBEAT_DIR", raising=False)
    monkeypatch.delenv("PADDLE_MASTER", raising=False)
    tkv, jkv = FakeKV(), FakeKV()
    for mod, kv in ((hb, tkv), (jhb, jkv)):
        mod.mark_dead(1, "gone", client=kv, generation=3)
        mod.write_abort_marker(0, {"why": "x"}, client=kv, generation=3)
        mod.write_abort_marker(0, {"why": "y"}, client=kv, generation=4)
    assert sorted(tkv.d) == sorted(jkv.d)
    assert hb.dead_ranks([0, 1], client=tkv, generation=3) == {1: "gone"}
    assert hb.read_abort_marker(client=tkv, generation=4)["why"] == "y"
    assert hb.read_abort_marker(client=tkv, generation=3) is None


def test_clear_run_markers_keeps_what_the_reference_keeps(tmp_path):
    names = ["rank0.g0.dead", "rank1.g1.dead", "rank2.g1.dead",
             "rank5.g1.dead", "rank3.g2.dead", "abort.g0.json",
             "abort.g1.json", "rank9.dead", "rank0.alive", "notes.txt"]
    dirs = {}
    for side, mod in (("torch", hb), ("jax", jhb)):
        d = tmp_path / side
        d.mkdir()
        for n in names:
            (d / n).write_text("{}")
        mod.clear_run_markers(str(d), generation=1, own_ranks=[1, 2])
        dirs[side] = sorted(os.listdir(d))
    assert dirs["torch"] == dirs["jax"]
    assert "rank5.g1.dead" in dirs["torch"]      # a peer node's, kept
    assert "rank1.g1.dead" not in dirs["torch"]  # this node's, swept
