"""Port parity: the training restart loops of ``fleet/elastic.py``
(``ElasticManager.run``, ``run_elastic``,
``AdaptiveElasticManager.run_adaptive``; ROADMAP A10) against
``paddle_tpu/distributed/fleet/elastic.py``.

The policy is held to the reference's on scripted launchers: the same
exit codes in the same order give the same returned code, the same
events (status and detail) and the same launches (world size, the
exported ``PADDLE_ELASTIC_RUN``, the per-world log directory). Then real
worlds over the port's launcher: a failing script exhausts the budget
and returns its rc in both packages; ``llama_tiny`` gloo workers
(``paddle_tpu_torch/training/elastic_worker.py``) killed after step 3
resume from the last committed checkpoint with the losses of an
uninterrupted run, bit for bit; and a world of 3 whose rank 2 keeps
failing scales in to 2 and completes.
"""
import json
import os
import time

import pytest

from paddle_tpu.distributed.fleet import elastic as JE
from paddle_tpu_torch.distributed.fleet import elastic as TE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "paddle_tpu_torch", "training",
                      "elastic_worker.py")


class ScriptedLauncher:
    """A launcher that records each launch and returns the next scripted
    exit code; a callable entry runs first (given the launch kwargs) and
    returns the code."""

    def __init__(self, rcs):
        self.rcs = list(rcs)
        self.calls = []

    def __call__(self, script, script_args=(), nproc_per_node=1,
                 extra_env=None, **kw):
        self.calls.append({
            "script": script, "args": list(script_args),
            "nproc": nproc_per_node,
            "run": (extra_env or {}).get("PADDLE_ELASTIC_RUN"),
            "ckpt": (extra_env or {}).get("PADDLE_ELASTIC_CKPT_DIR"),
            "log_dir": kw.get("log_dir"),
            "control_dir": "control_dir" in kw})
        rc = self.rcs.pop(0)
        return rc(kw) if callable(rc) else rc


def _events(mgr):
    return [(status, detail) for _, status, detail in mgr.events]


def _both(make, run, rcs):
    """``run(manager)`` on the port's and the reference's manager, each
    over its own scripted launcher: ``{side: (rc, events, calls)}``."""
    out = {}
    for side, mod in (("torch", TE), ("jax", JE)):
        launcher = ScriptedLauncher(rcs)
        mgr = make(mod, launcher)
        rc = run(mgr)
        out[side] = (rc, _events(mgr), launcher.calls)
    return out


RUN_CASES = {
    "complete": (dict(), [0], 0),
    "restart_then_complete": (dict(), [137, 0], 0),
    "budget_exhausted": (dict(max_restarts=3), [137] * 4, 137),
    "scale_in": (dict(max_restarts=4, min_nproc=1), [1, 1, 1, 1, 0], 0),
    "peer_failure_never_scales_in": (dict(max_restarts=4, min_nproc=1),
                                     [123, 123, 123, 0], 0),
    "peer_failure_budget": (dict(max_restarts=2, min_nproc=1),
                            [123] * 3, 123),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_matches_the_reference_policy(case):
    kw, rcs, want_rc = RUN_CASES[case]
    got = _both(
        lambda mod, launcher: mod.ElasticManager(
            restart_delay=0, launcher=launcher, **kw),
        lambda m: m.run("train.py", ["--x"], nproc_per_node=3,
                        log_dir="logs", extra_env={"A": "1"}),
        rcs)
    assert got["torch"] == got["jax"]
    rc, events, calls = got["torch"]
    assert rc == want_rc
    assert [c["run"] for c in calls] == [str(i) for i in range(len(rcs))]
    if case == "peer_failure_never_scales_in":
        assert {c["nproc"] for c in calls} == {3}
    if case == "scale_in":
        assert [c["nproc"] for c in calls] == [3, 3, 3, 2, 1]


def _scale_out(membership):
    """A launch that announces a re-admitted worker, then waits for the
    manager's rescale flag and stops as the launcher does (125)."""
    def launch(kw):
        open(os.path.join(membership, "worker0.up"), "w").close()
        flag = os.path.join(kw["control_dir"], "rescale")
        deadline = time.time() + 30
        while not os.path.exists(flag) and time.time() < deadline:
            time.sleep(0.01)
        return TE.RESCALE_RC
    return launch


@pytest.mark.parametrize("case", ["crash_then_complete", "scale_out",
                                  "below_min", "peer_failure_full_size",
                                  "budget_exhausted"])
def test_run_adaptive_matches_the_reference_policy(case, tmp_path):
    membership = str(tmp_path / "members")
    os.makedirs(membership)
    kw = dict(min_nproc=2)
    rcs = {"crash_then_complete": [137, 0],
           "scale_out": [137, _scale_out(membership), 0],
           "below_min": [137],
           "peer_failure_full_size": [123, 0],
           "budget_exhausted": [137, 137, 137]}[case]
    if case == "below_min":
        kw = dict(min_nproc=3)
    if case == "budget_exhausted":
        kw = dict(min_nproc=1, max_restarts=2)

    def run(m):
        for f in os.listdir(membership):
            os.remove(os.path.join(membership, f))
        return m.run_adaptive("train.py", nproc_per_node=3,
                              membership_dir=membership,
                              ckpt_dir=str(tmp_path / "ckpt"),
                              poll_interval=0.02,
                              log_dir=str(tmp_path / "logs"))

    got = _both(lambda mod, launcher: mod.AdaptiveElasticManager(
        restart_delay=0, launcher=launcher, **kw), run, rcs)
    assert got["torch"] == got["jax"]
    rc, events, calls = got["torch"]
    assert all(c["control_dir"] and c["ckpt"] == str(tmp_path / "ckpt")
               for c in calls)
    assert [c["log_dir"] for c in calls] == [
        str(tmp_path / "logs" / f"run{i}") for i in range(len(calls))]
    nprocs = [c["nproc"] for c in calls]
    if case == "scale_out":
        assert rc == 0 and nprocs == [3, 2, 3]
        assert [d.get("reason") for _, d in events][:2] == [
            "worker-failure", "scale-out"]
    if case == "peer_failure_full_size":
        assert nprocs == [3, 3]
    if case == "below_min":
        assert rc == 137 and events[-1][1]["reason"] == "below min_nproc"


def test_capacity_readmission_matches_the_reference(tmp_path):
    for mod in (TE, JE):
        m = mod.AdaptiveElasticManager(readmit_after=0.2)
        assert m._capacity(3, None) == 3
        m._down_times.append(time.time())
        assert m._capacity(3, None) == 2
        time.sleep(0.25)
        assert m._capacity(3, None) == 3          # backoff expiry
        m = mod.AdaptiveElasticManager()
        d = tmp_path / mod.__name__
        d.mkdir()
        m._down_times.append(time.time())
        assert m._capacity(3, str(d)) == 2
        (d / "worker0.up").touch()
        assert m._capacity(3, str(d)) == 3
        m._down_times.append(time.time())
        assert m._capacity(3, str(d)) == 2         # consumed once


def test_run_elastic_returns_the_workers_rc_when_the_budget_ends(
        tmp_path):
    """A script that always fails, through each package's real launcher
    and ``run_elastic`` with one restart: both return its rc after two
    worlds."""
    bad = tmp_path / "bad.py"
    bad.write_text("import sys\nsys.exit(7)\n")
    env = {"PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    for mod in (TE, JE):
        t0 = time.time()
        rc = mod.run_elastic(str(bad), nproc_per_node=2, max_restarts=1,
                             peer_grace=0.1, extra_env=env,
                             log_dir=str(tmp_path / mod.__name__))
        assert rc == 7, mod.__name__
        assert time.time() - t0 < 60


def _losses(path):
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "step" in rec:
                out.setdefault(rec["run"], {})[rec["step"]] = rec
    return out


def _world(tmp_path, name, args, nproc, **mgr_kw):
    out = tmp_path / name
    out.mkdir()
    env = {"PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1",
           "PADDLE_ELASTIC_CKPT_DIR": str(out / "ckpt")}
    mgr = TE.ElasticManager(restart_delay=0.1, **mgr_kw)
    rc = mgr.run(WORKER, ["--out", str(out), "--device", "cpu",
                          "--max-seconds", "150", *args],
                 nproc_per_node=nproc, extra_env=env, peer_grace=0.3,
                 log_dir=str(out / "logs"))
    logs = ""
    for f in sorted((out / "logs").glob("workerlog.*")):
        logs += f"--- {f.name} ---\n" + f.read_text()[-3000:]
    return rc, mgr, out, logs


def test_killed_world_resumes_from_the_last_checkpoint(tmp_path):
    """Two gloo ranks train ``llama_tiny`` with an asynchronous
    checkpoint every 2 steps; the first world exits hard after step 3;
    ``ElasticManager`` relaunches it with ``PADDLE_ELASTIC_RUN`` 1,
    which resumes from the last committed checkpoint (step 2, or step 0
    if the kill caught step 2's save before its commit) and finishes:
    its losses from there on equal an uninterrupted world's bit for bit;
    the markers of the killed world were swept."""
    steps = ["--steps", "5", "--save-every", "2"]
    rc, mgr, out, logs = _world(tmp_path, "killed",
                                steps + ["--kill-at", "3"], 2,
                                max_restarts=2)
    assert rc == 0, logs
    ref_rc, _, ref, ref_logs = _world(tmp_path, "whole", steps, 2)
    assert ref_rc == 0, ref_logs
    got, want = _losses(out / "losses.jsonl"), _losses(ref /
                                                       "losses.jsonl")
    assert sorted(got) == [0, 1] and sorted(got[0]) == [1, 2, 3]
    resumed = {r["resumed_from"] for r in got[1].values()}
    assert resumed in ({2}, {0}), resumed
    start = resumed.pop()
    assert sorted(got[1]) == list(range(start + 1, 6))
    for step in (1, 2, 3):
        assert got[0][step]["loss"] == want[0][step]["loss"], step
    for step in got[1]:
        assert got[1][step]["loss"] == want[0][step]["loss"], step
    assert [s for _, s, _ in mgr.events] == ["restart", "completed"]
    assert mgr.events[0][2]["rc"] == 137
    from paddle_tpu_torch.distributed import heartbeat as hb
    hbd = str(out / "logs" / "heartbeats")
    assert hb.dead_ranks([0, 1], dir_path=hbd, generation=0) == {}
    assert set(hb.dead_ranks([0, 1], dir_path=hbd, generation=1)) == {0, 1}


def test_sick_rank_scales_the_world_in(tmp_path):
    """A world of 3 whose rank 2 exits at start while the world has more
    than 2 ranks: two failed worlds of 3 spend half of a budget of 2,
    the manager scales in to 2 (``min_nproc``), and the world of 2
    trains to the end."""
    rc, mgr, out, logs = _world(
        tmp_path, "sick", ["--steps", "2", "--fail-ranks", "2",
                           "--min-world", "2"], 3, max_restarts=2,
        min_nproc=2)
    assert rc == 0, logs
    events = _events(mgr)
    assert [s for s, _ in events] == ["restart", "restart", "completed"]
    assert [d["nproc"] for _, d in events] == [3, 2, 2]
    assert all(d.get("reason") == "worker-failure" for _, d in events[:2])
    got = _losses(out / "losses.jsonl")
    assert list(got) == [2] and {r["world"] for r in got[2].values()} == {2}
