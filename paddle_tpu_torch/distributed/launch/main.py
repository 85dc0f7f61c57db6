"""The distributed launch controller (port of
``paddle_tpu/distributed/launch/main.py``): ``python -m
paddle_tpu_torch.distributed.launch``.

One process a rank (``nproc_per_node`` on each of ``nnodes`` hosts;
on the card one process a GPU), each started with the rendezvous
environment under the reference's ``PADDLE_*`` names
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_RANK_IN_NODE``,
``PADDLE_LOCAL_SIZE``, ``PADDLE_MASTER`` with ``MASTER_ADDR`` /
``MASTER_PORT``, ``PADDLE_JOB_ID``, ``PADDLE_HEARTBEAT_DIR``); the workers
join one ``torch.distributed`` group at ``PADDLE_MASTER``
(``distributed/env.py`` ``init_parallel_env``: NCCL on the card, gloo on
the CPU). The controller watches them: one failed worker fails the job
(after a ``peer_grace`` for the survivors), a stale liveness or progress
beat (``heartbeat.check_stale``) kills it with rc 124, a rescale flag
in ``control_dir`` stops it with ``RESCALE_RC``; every exit leaves a
generation-keyed death marker in the heartbeat directory.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

__all__ = ["launch", "main"]


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="paddle.distributed.launch parity CLI")
    p.add_argument("--nproc_per_node", "--nprocs", type=int, default=None,
                   help="processes on this node (default: 1; on the card "
                        "one process a GPU)")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--master", default=None,
                   help="coordinator host:port (defaults to 127.0.0.1 with "
                        "a free port for single-node runs)")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--devices", default=None,
                   help="accepted for reference-CLI parity (each worker "
                        "takes the GPU of its PADDLE_RANK_IN_NODE)")
    p.add_argument("--job_id", default="default")
    p.add_argument("script", help="training script to run")
    p.add_argument("--heartbeat_timeout", type=float, default=0.0,
                   help="seconds without a liveness beat before a worker "
                        "is declared dead (0 = off)")
    p.add_argument("--progress_timeout", type=float, default=0.0,
                   help="seconds without a training-progress beat before "
                        "an opted-in worker is declared wedged (0 = off)")
    p.add_argument("--peer_grace", type=float, default=None,
                   help="seconds survivors get to observe a dead peer's "
                        "tombstone and abort typed before the SIGTERM "
                        "sweep (default 4, env PADDLE_TPU_PEER_GRACE_S)")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill_all(procs, alive):
    """Terminate every still-alive worker: SIGTERM, a shared 10s grace
    window, then SIGKILL (both failure paths share this shutdown)."""
    for j in alive:
        procs[j].terminate()
    deadline = time.time() + 10
    for j in alive:
        try:
            procs[j].wait(max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            procs[j].kill()
    alive.clear()


RESCALE_RC = 125   # controlled stop for an elastic re-scale (not a failure)
# Coordinated abort: an INNOCENT rank exiting because a peer is
# CONFIRMED dead (its marker). The elastic manager maps this to "peer
# failure — restart the world" and never treats the exiting rank as the
# sick one (no scale-in off its rc).
PEER_FAILURE_RC = 123
# Coordinated abort on a collective timeout: a contribution is MISSING
# but nothing confirmed the peer dead — it may be wedged-but-alive (a
# deterministic wedge would otherwise restart at full size forever),
# so this rc deliberately engages the manager's ordinary
# worker-failure path, scale-in heuristic included.
COLLECTIVE_TIMEOUT_RC = 122


def launch(script, script_args=(), nproc_per_node=1, nnodes=1, node_rank=0,
           master=None, log_dir=None, job_id="default",
           extra_env=None, heartbeat_timeout: float = 0.0,
           progress_timeout: float = 0.0, control_dir=None,
           peer_grace: float = None) -> int:
    """Spawn ``nproc_per_node`` worker processes with rendezvous env and
    watch them (the reference's controller loop). Returns the exit
    code: 0 iff every worker exited 0; on any failure the remaining
    workers are terminated (the watcher's fail-fast).

    ``heartbeat_timeout``/``progress_timeout`` (seconds; 0 = off) enable
    the elastic liveness layer (distributed/heartbeat.py): workers beat
    per-rank files; a worker whose liveness beat goes stale — or whose
    training-progress beat goes stale after it opted in — is declared
    WEDGED and the job is killed (rc=124) so the elastic manager can
    restart it.

    Dead-peer tombstones: every worker exit — crash or clean — writes a
    generation-keyed death marker into the heartbeat dir
    (``heartbeat.dead_ranks`` reads them). On the first worker failure
    the controller gives survivors a short ``peer_grace`` window
    (default 4s; env ``PADDLE_TPU_PEER_GRACE_S``) to observe the marker
    and exit with their typed error in their own logs before the
    SIGTERM sweep."""
    if master is None:
        master = f"127.0.0.1:{_free_port()}"
    host, port = master.rsplit(":", 1)
    world = nnodes * nproc_per_node
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    import tempfile
    # the heartbeat dir always exists: it also carries the death markers
    # (the staleness WATCHER below only runs when a timeout is set)
    hb_tmp = None
    if log_dir:
        hb_dir = os.path.join(log_dir, "heartbeats")
    else:
        hb_dir = hb_tmp = tempfile.mkdtemp(prefix="paddle_hb_")
    os.makedirs(hb_dir, exist_ok=True)
    if peer_grace is None:
        try:
            peer_grace = float(
                os.environ.get("PADDLE_TPU_PEER_GRACE_S", "") or 4.0)
        except ValueError:
            peer_grace = 4.0
    # marker generation: elastic relaunches share a heartbeat dir, so
    # markers are keyed by the run index the manager exports to workers
    try:
        death_gen = int((extra_env or {}).get(
            "PADDLE_ELASTIC_RUN",
            os.environ.get("PADDLE_ELASTIC_RUN", "0")) or 0)
    except ValueError:
        death_gen = 0

    procs = []
    logs = []
    for local in range(nproc_per_node):
        rank = node_rank * nproc_per_node + local
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_RANK_IN_NODE": str(local),
            "PADDLE_LOCAL_SIZE": str(nproc_per_node),
            "PADDLE_MASTER": master,
            "MASTER_ADDR": host,
            "MASTER_PORT": port,
            "PADDLE_JOB_ID": str(job_id),
        })
        if hb_dir:
            env["PADDLE_HEARTBEAT_DIR"] = hb_dir
        env.update(extra_env or {})
        if log_dir:
            log = open(os.path.join(log_dir, f"workerlog.{rank}"), "wb")
            out = err = log
        else:
            log = None
            out = err = None
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-u", script, *script_args], env=env,
            stdout=out, stderr=err))

    rc = 0
    job_start = time.time()
    try:
        from .. import heartbeat as _hb
        # a relaunch into the same log_dir must not inherit stale
        # markers: older generations, this node's own ranks, and
        # pre-start abort markers are swept; other nodes' live
        # same-generation tombstones survive
        _hb.clear_run_markers(
            hb_dir, generation=death_gen,
            own_ranks=[node_rank * nproc_per_node + l
                       for l in range(nproc_per_node)])
        alive = set(range(len(procs)))
        rescale_flag = os.path.join(control_dir, "rescale") \
            if control_dir else None

        def _tombstone(local, r):
            # job-scoped (master addr): a later job reusing this
            # log_dir at the same generation must never honor these
            _hb.mark_dead(node_rank * nproc_per_node + local,
                          f"worker exited rc={r}", dir_path=hb_dir,
                          generation=death_gen, job=master)

        while alive:
            time.sleep(0.2)
            # poll exits BEFORE honoring a rescale flag: a world whose
            # workers all just finished must report success, not be
            # relaunched because capacity grew in the same instant
            for i in list(alive):
                r = procs[i].poll()
                if r is None:
                    continue
                alive.discard(i)
                # death marker on EVERY exit: a rank that left — even
                # cleanly — can never contribute to a survivor's pending
                # collective, so survivors should fail fast and typed
                # instead of waiting out the deadline
                _tombstone(i, r)
                if r != 0:
                    # fail fast: one dead worker kills the job — but
                    # first give survivors a grace window to observe
                    # the tombstone and exit on their own, with their
                    # errors in their own logs. rc stays the
                    # PRIMARY failure's; secondary exits during the
                    # grace are reaped and tombstoned only.
                    rc = r
                    print(f"[launch] rank "
                          f"{node_rank * nproc_per_node + i} failed "
                          f"(rc={r}); tombstoned, giving peers "
                          f"{peer_grace:.1f}s to abort typed",
                          file=sys.stderr)
                    deadline = time.time() + max(peer_grace, 0.0)
                    while alive and time.time() < deadline:
                        for j in list(alive):
                            rj = procs[j].poll()
                            if rj is not None:
                                alive.discard(j)
                                _tombstone(j, rj)
                        time.sleep(0.05)
                    _kill_all(procs, alive)
                    break
            if not alive:
                break
            if rescale_flag and os.path.exists(rescale_flag):
                # elastic re-scale request (fleet/elastic.py): stop the
                # world cleanly so the manager can relaunch at the new
                # size; workers resume from their latest checkpoint
                print("[launch] re-scale requested; stopping world for "
                      "elastic relaunch", file=sys.stderr)
                rc = RESCALE_RC
                _kill_all(procs, alive)
                break
            if hb_dir and (heartbeat_timeout > 0 or progress_timeout > 0):
                my_ranks = [node_rank * nproc_per_node + l
                            for l in range(nproc_per_node)]
                stale = _hb.check_stale(
                    hb_dir, my_ranks,
                    auto_timeout=heartbeat_timeout,
                    progress_timeout=progress_timeout,
                    started_at=job_start)
                stale = {r - node_rank * nproc_per_node: why
                         for r, why in stale.items()}
                stale = {r: why for r, why in stale.items() if r in alive}
                if stale:
                    for r, why in stale.items():
                        print(f"[launch] rank {r} wedged: {why}; "
                              "killing job for elastic restart",
                              file=sys.stderr)
                        # tombstone the wedged rank too: peers of a
                        # multi-NODE job (other controllers' workers)
                        # see the marker through shared storage
                        _hb.mark_dead(node_rank * nproc_per_node + r,
                                      f"wedged: {why}", dir_path=hb_dir,
                                      generation=death_gen, job=master)
                    rc = 124
                    _kill_all(procs, alive)
                    break
    except KeyboardInterrupt:
        for pr in procs:
            pr.send_signal(signal.SIGTERM)
        rc = 130
    finally:
        for log in logs:
            if log:
                log.close()
        if hb_tmp is not None:
            # launcher-owned temp heartbeat dir: every worker is dead by
            # now, so the beats/markers have no remaining reader — an
            # elastic manager churning restarts must not leak one temp
            # dir per attempt
            import shutil
            shutil.rmtree(hb_tmp, ignore_errors=True)
    return rc


def main(argv=None):
    args = _parse(argv if argv is not None else sys.argv[1:])
    nproc = args.nproc_per_node or 1
    rc = launch(args.script, args.script_args, nproc_per_node=nproc,
                nnodes=args.nnodes, node_rank=args.node_rank,
                master=args.master, log_dir=args.log_dir,
                job_id=args.job_id,
                heartbeat_timeout=args.heartbeat_timeout,
                progress_timeout=args.progress_timeout,
                peer_grace=args.peer_grace)
    sys.exit(rc)


if __name__ == "__main__":
    main()
