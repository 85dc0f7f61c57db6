"""Multi-rank helpers of the port's mesh tests (not collected).

``launch`` runs ``tests/_torch_mesh_worker.py`` as ``world`` gloo
processes, once for a test module's cases: every rank joins the group
through a ``file://`` rendezvous under ``tmp`` (no TCP port, so parallel
test workers never collide), runs each named case in order, and the
cases write their results as ``.npz`` / ``.json`` files under ``tmp``.
Inputs go the same way: ``save_tree`` writes a nested dict of arrays as
one ``.npz`` whose keys are ``/``-joined paths.

``launched`` is the module fixtures' entry: under pytest-xdist the tests
of one module may land on several workers, each with its own module
fixture, so the first worker to arrive prepares the inputs and launches
the ranks under a file lock in the session's shared temporary root, and
the others wait for it and read the same results (a failed launch is
re-raised on each). A second lock, shared by the whole test run, lets
one module's world run at a time.

``one_rank_mesh`` is a mesh of one rank in this process (gloo over a
``HashStore``), torn down on exit so no later test sees a process group.
"""
from __future__ import annotations

import contextlib
import fcntl
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

WORKER = os.path.join(os.path.dirname(__file__), "_torch_mesh_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def unflat(arrays):
    out = {}
    for key, v in arrays.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def save_tree(path, tree):
    np.savez(path, **flat(tree))


def load_tree(path):
    with np.load(path) as z:
        return unflat({k: z[k] for k in z.files})


def load_json(path):
    with open(path) as f:
        return json.load(f)


# seconds for a launch's ranks to start, import and join their group
JOIN_TIMEOUT_S = 600.0


def launch(tmp, world: int, cases, timeout: float = 600.0):
    """Run ``cases`` on ``world`` gloo ranks. Two caps: ``JOIN_TIMEOUT_S``
    for the ranks to start, import and join the group (each writes
    ``joined_r<rank>``), then ``timeout`` for their cases, counted from
    the moment the last rank joined, so a slow start under load does not
    eat the cases' time. Raises with each failed rank's rc (or
    ``"timeout"``), the seconds waited and the ranks' log tails if any
    rank fails."""
    tmp = str(tmp)
    t0 = time.time()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
               JAX_PLATFORMS="cpu", MESH_LAUNCH_T0=repr(t0))
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, tmp, str(rank), str(world), *cases],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
    joined_at = None
    deadline = t0 + JOIN_TIMEOUT_S
    rcs = [None] * world
    try:
        while any(rc is None for rc in rcs):
            for r, p in enumerate(procs):
                if rcs[r] is None:
                    rcs[r] = p.poll()
            if any(rc not in (None, 0) for rc in rcs):
                break                    # a rank failed: stop the rest
            if joined_at is None and all(os.path.exists(os.path.join(
                    tmp, f"joined_r{r}")) for r in range(world)):
                joined_at = time.time()
                deadline = joined_at + timeout
            if time.time() > deadline:
                break
            time.sleep(0.1)
    finally:
        # a rank still running at the deadline timed out; one still
        # running when another failed is stopped
        late = "timeout" if time.time() > deadline else "stopped"
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                p.wait()
                rcs[r] = late
            elif rcs[r] is None:
                rcs[r] = p.returncode
        for log in logs:
            log.close()
    waited = time.time() - t0
    failed = [r for r, rc in enumerate(rcs) if rc != 0]
    if failed:
        joined = ("never all joined" if joined_at is None
                  else f"all joined after {joined_at - t0:.1f}s")
        tails = []
        for rank in failed[:3]:
            with open(os.path.join(tmp, f"rank{rank}.log")) as f:
                tails.append(f"--- rank {rank} ---\n" + f.read()[-3000:])
        raise RuntimeError(
            f"mesh worker failed on ranks {failed} of {world} after "
            f"{waited:.1f}s ({joined}; caps {JOIN_TIMEOUT_S:.0f}s to join, "
            f"{timeout:.0f}s after), rcs {dict(enumerate(rcs))}, cases "
            f"{list(cases)}:\n" + "\n".join(tails))


def launched(tmp_path_factory, name: str, world: int, cases, prepare):
    """The directory holding the results of ``cases`` run once on
    ``world`` ranks for this test session; ``prepare(dir)`` writes the
    inputs first."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        tmp = tmp_path_factory.mktemp(name)
        prepare(tmp)
        launch(tmp, world, cases)
        return tmp
    root = pathlib.Path(tmp_path_factory.getbasetemp()).parent
    tmp = root / f"mesh_{name}"
    tmp.mkdir(exist_ok=True)
    with open(tmp / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (tmp / "failed").exists():
            raise RuntimeError((tmp / "failed").read_text())
        if not (tmp / "done").exists():
            try:
                prepare(tmp)
                # one multi-rank world at a time across the test run's
                # workers: the modules' worlds (up to 8 ranks each) do
                # not pile up on the cores and the memory together
                with open(root / "mesh_worlds.lock", "w") as worlds:
                    fcntl.flock(worlds, fcntl.LOCK_EX)
                    launch(tmp, world, cases)
            except Exception as e:
                (tmp / "failed").write_text(str(e))
                raise
            (tmp / "done").write_text("")
    return tmp


@contextlib.contextmanager
def one_rank_mesh(names, shape=None):
    """A CPU mesh of one rank with axis ``names``, its process group
    destroyed on exit."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import spmd
    made = not dist.is_initialized()
    try:
        yield spmd.make_mesh(shape or (1,) * len(names), names,
                             device="cpu")
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
