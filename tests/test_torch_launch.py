"""Port parity: the launch controller (``python -m
paddle_tpu_torch.distributed.launch``) and ``distributed/env.py``
(ROADMAP A10) against ``paddle_tpu/distributed/launch`` and
``tests/test_launch.py``'s behaviour.

Workers here are small scripts on the CPU: the same script goes through
both launchers and the exit codes, each rank's ``PADDLE_*`` environment
and the death markers left in the heartbeat directory are compared. The
port's workers join a gloo group at ``PADDLE_MASTER``
(``init_parallel_env(device="cpu")``) and all-reduce across ranks; a
worker that stops beating progress is killed with rc 124. Every
subprocess has its own timeout.
"""
import json
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
           OMP_NUM_THREADS="1")
LAUNCHERS = {"torch": "paddle_tpu_torch.distributed.launch",
             "jax": "paddle_tpu.distributed.launch"}


def _launch(module, args, timeout=120):
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", module, *map(str, args)],
                       capture_output=True, text=True, timeout=timeout,
                       env=ENV, cwd=REPO)
    return r, time.time() - t0


def _logs(log_dir, n):
    out = ""
    for rank in range(n):
        p = os.path.join(log_dir, f"workerlog.{rank}")
        if os.path.exists(p):
            out += f"--- rank {rank} ---\n" + open(p).read()
    return out


def test_cli_help():
    r, _ = _launch(LAUNCHERS["torch"], ["--help"])
    assert r.returncode == 0
    assert "nproc_per_node" in r.stdout and "peer_grace" in r.stdout
    assert "paddle_tpu_torch.distributed.launch" in r.stdout


def test_protocol_codes_are_the_references():
    # the packages' ``main`` names are the CLI functions: reach the
    # modules through importlib
    import importlib
    jmain = importlib.import_module("paddle_tpu.distributed.launch.main")
    tmain = importlib.import_module(
        "paddle_tpu_torch.distributed.launch.main")
    for name in ("RESCALE_RC", "PEER_FAILURE_RC", "COLLECTIVE_TIMEOUT_RC"):
        assert getattr(tmain, name) == getattr(jmain, name), name
    assert tmain._parse(["w.py", "a"]) == jmain._parse(["w.py", "a"])


ENV_KEYS = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
            "PADDLE_RANK_IN_NODE", "PADDLE_LOCAL_SIZE", "PADDLE_JOB_ID",
            "PADDLE_ELASTIC_RUN")


def test_failing_worker_fails_fast_and_leaves_the_references_markers(
        tmp_path):
    """Rank 1 exits 3 while rank 0 sleeps: both launchers return 3 well
    before the sleep ends, each rank saw the reference's rendezvous
    environment, and the heartbeat directory holds the same markers
    (rank 1's death by its rc; rank 0, swept by SIGTERM, none)."""
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import json, os, sys, time\n"
        f"keys = {ENV_KEYS!r}\n"
        "rank = os.environ['PADDLE_TRAINER_ID']\n"
        "out = os.path.join(sys.argv[1], f'env{rank}.json')\n"
        "json.dump({k: os.environ.get(k) for k in keys} | {\n"
        "    'master': os.environ['PADDLE_MASTER'] == \n"
        "    os.environ['MASTER_ADDR'] + ':' + os.environ['MASTER_PORT'],\n"
        "    'hb': bool(os.environ.get('PADDLE_HEARTBEAT_DIR'))},\n"
        "    open(out, 'w'))\n"
        "if rank == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n")
    seen = {}
    for side, module in LAUNCHERS.items():
        out = tmp_path / side
        out.mkdir()
        r, dt = _launch(module, ["--nproc_per_node", 2, "--peer_grace",
                                 0.3, "--log_dir", out / "logs", bad, out])
        assert r.returncode == 3, (side, r.stderr[-2000:])
        assert dt < 55, (side, dt)
        envs = [json.load(open(out / f"env{i}.json")) for i in range(2)]
        markers = sorted(os.listdir(out / "logs" / "heartbeats"))
        reasons = {m: json.load(open(out / "logs" / "heartbeats" / m))[
            "reason"] for m in markers}
        seen[side] = (envs, reasons)
    assert seen["torch"] == seen["jax"]
    envs, reasons = seen["torch"]
    assert [e["PADDLE_TRAINER_ID"] for e in envs] == ["0", "1"]
    assert all(e["PADDLE_TRAINERS_NUM"] == "2" and e["master"] and e["hb"]
               for e in envs)
    assert reasons == {"rank1.g0.dead": "worker exited rc=3"}


def test_gloo_world_rendezvous_and_all_reduce(tmp_path):
    """Two workers join one gloo group at ``PADDLE_MASTER`` through
    ``init_parallel_env(device="cpu")`` and all-reduce their ranks;
    ``ParallelEnv`` and the rank helpers read the world; with liveness
    and progress timeouts set, healthy workers that beat run to the end
    (rc 0) and every clean exit leaves its marker."""
    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys, torch\n"
        "import torch.distributed as dist\n"
        "from paddle_tpu_torch import distributed as D\n"
        "from paddle_tpu_torch.distributed import heartbeat\n"
        "D.init_parallel_env(device='cpu')\n"
        "env = D.ParallelEnv()\n"
        "t = torch.tensor([float(D.get_rank() + 1)])\n"
        "dist.all_reduce(t)\n"
        "for i in range(3):\n"
        "    heartbeat.beat(step=i)\n"
        "print(f'WORLD_OK rank={env.rank} of={env.world_size} '\n"
        "      f'local={env.local_rank} sum={t.item()} '\n"
        "      f'init={D.is_initialized()} '\n"
        "      f'beat={heartbeat._state[\"thread\"] is not None}')\n"
        "dist.destroy_process_group()\n")
    logs = tmp_path / "logs"
    r, _ = _launch(LAUNCHERS["torch"], [
        "--nproc_per_node", 2, "--log_dir", logs, "--heartbeat_timeout",
        45, "--progress_timeout", 45, script], timeout=180)
    text = _logs(logs, 2)
    assert r.returncode == 0, text[-3000:]
    for rank in range(2):
        assert (f"WORLD_OK rank={rank} of=2 local={rank} sum=3.0 "
                "init=True beat=True") in text, text[-3000:]
        assert os.path.exists(logs / "heartbeats" / f"rank{rank}.alive")
    from paddle_tpu_torch.distributed import heartbeat as hb
    assert hb.dead_ranks([0, 1], dir_path=str(logs / "heartbeats"),
                         generation=0) == {0: "worker exited rc=0",
                                           1: "worker exited rc=0"}


def test_wedged_worker_detected_via_progress_beats(tmp_path):
    """Rank 1 beats progress, then stops while its liveness thread keeps
    it looking alive: the progress timeout kills the job with rc 124
    and names the wedge; the wedged rank's marker says why."""
    script = tmp_path / "w.py"
    script.write_text(
        "import os, time\n"
        "from paddle_tpu_torch.distributed import heartbeat\n"
        "heartbeat.start(interval=0.2)\n"
        "for i in range(3):\n"
        "    heartbeat.beat(step=i)\n"
        "    time.sleep(0.1)\n"
        "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
        "    time.sleep(120)\n"
        "else:\n"
        "    for i in range(1200):\n"
        "        heartbeat.beat(step=i)\n"
        "        time.sleep(0.1)\n")
    logs = tmp_path / "logs"
    r, dt = _launch(LAUNCHERS["torch"], [
        "--nproc_per_node", 2, "--log_dir", logs, "--progress_timeout", 3,
        script], timeout=150)
    assert r.returncode == 124, (r.returncode, r.stderr[-1500:])
    assert "wedged" in r.stderr and "no training progress" in r.stderr
    assert dt < 100, dt
    from paddle_tpu_torch.distributed import heartbeat as hb
    dead = hb.dead_ranks([0, 1], dir_path=str(logs / "heartbeats"),
                         generation=0)
    assert dead[1].startswith("wedged: no training progress")


def test_init_parallel_env_on_the_card_needs_one(monkeypatch):
    """Without ``device="cpu"`` a worker needs a card: no quiet CPU
    fallback."""
    import torch
    from paddle_tpu_torch.core import enforce as TE
    from paddle_tpu_torch.distributed import env
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(env, "_initialized", False)
    with pytest.raises(TE.UnavailableError):
        env.init_parallel_env()
    assert not env.is_initialized()
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_RANK_IN_NODE", "1")
    pe = env.ParallelEnv()
    assert (pe.rank, pe.world_size, pe.local_rank, pe.nranks,
            pe.dev_id) == (3, 4, 1, 4, 1)
