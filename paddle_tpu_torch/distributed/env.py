"""Distributed environment basics: rank, world size and the process
group (port of ``paddle_tpu/distributed/env.py``).

The launcher (``distributed/launch``) starts each worker with the
reference's ``PADDLE_*`` environment; :func:`init_parallel_env` joins
the workers into one ``torch.distributed`` group at ``PADDLE_MASTER``
(``tcp://``, rank ``PADDLE_TRAINER_ID`` of ``PADDLE_TRAINERS_NUM``):
NCCL for workers on the card (each on the GPU of its
``PADDLE_RANK_IN_NODE``), gloo for workers asked to run on the CPU
(``device="cpu"``). A single worker joins no group, as the reference
starts no coordination service for one process. It also starts the
worker's liveness beats when the launcher set a heartbeat directory,
and on rank 0 the key-value relay when ``PADDLE_HEARTBEAT_KV_RELAY``
names a directory.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..core import resolve_device

__all__ = ["get_rank", "get_world_size", "is_initialized",
           "init_parallel_env", "ParallelEnv"]

_initialized = False


def _group_live() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    if _group_live():
        return dist.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size() -> int:
    if _group_live():
        return dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def is_initialized() -> bool:
    return _initialized


def init_parallel_env(device=None):
    """Join the launched world (idempotent). ``device`` None means the
    card: the worker takes the GPU of its ``PADDLE_RANK_IN_NODE`` and the
    group runs NCCL, and without a card this raises (a worker never
    drops to the CPU quietly); ``"cpu"`` runs gloo."""
    global _initialized
    if _initialized:
        return
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        resolve_device(None)            # raises without a card
        local = int(os.environ.get("PADDLE_RANK_IN_NODE", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    coord = os.environ.get("PADDLE_MASTER") or \
        os.environ.get("MASTER_ADDR")
    nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    pid = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if coord and nprocs > 1 and not _group_live():
        port = os.environ.get("MASTER_PORT", coord.split(":")[-1]
                              if ":" in coord else "8476")
        dist.init_process_group(
            "gloo" if cpu else "nccl",
            init_method=f"tcp://{coord.split(':')[0]}:{port}",
            rank=pid, world_size=nprocs)
    # elastic liveness: auto-beat when the launcher asked for it
    try:
        from . import heartbeat as _hb
        _hb.start()
        # multi-host relay: rank 0 mirrors every rank's KV beats into
        # the primary controller's heartbeat dir, so its file watcher
        # covers hosts with no shared filesystem
        relay_dir = os.environ.get("PADDLE_HEARTBEAT_KV_RELAY")
        if relay_dir and get_rank() == 0:
            _hb.start_kv_relay(relay_dir, range(get_world_size()))
    except Exception:
        pass
    _initialized = True


class ParallelEnv:
    """The reference's ``ParallelEnv``: this worker's place in the
    launched world."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return int(os.environ.get("PADDLE_RANK_IN_NODE", "0"))

    @property
    def nranks(self):
        return get_world_size()

    @property
    def dev_id(self):
        return self.local_rank
