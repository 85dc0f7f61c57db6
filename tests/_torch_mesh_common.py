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
re-raised on each).

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


def launch(tmp, world: int, cases, timeout: float = 600.0):
    """Run ``cases`` on ``world`` gloo ranks; raises with the ranks'
    errors if any rank fails."""
    tmp = str(tmp)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
               JAX_PLATFORMS="cpu")
    procs = []
    for rank in range(world):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, tmp, str(rank), str(world), *cases],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT), log))
    failed = []
    for rank, (p, log) in enumerate(procs):
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append(rank)
    if failed:
        tails = []
        for rank in failed[:2]:
            with open(os.path.join(tmp, f"rank{rank}.log")) as f:
                tails.append(f"--- rank {rank} ---\n" + f.read()[-4000:])
        raise RuntimeError("mesh worker failed on ranks "
                           f"{failed}:\n" + "\n".join(tails))


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
