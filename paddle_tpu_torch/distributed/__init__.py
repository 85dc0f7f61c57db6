"""Distributed runtime (port of ``paddle_tpu/distributed/``).

- ``spmd``: meshes (``torch.distributed.device_mesh``) with the
  reference's axis names, its partition specs (``P``) as DTensor
  placements, sharding constraints as ``redistribute``, and the process
  group (gloo on the CPU, a one-rank NCCL group on the card);
- ``introspect``: the sharding inspector behind ``/sharding``;
- ``env``: rank, world size and ``init_parallel_env`` (the launched
  world's process group: NCCL on the card, gloo on the CPU);
- ``launch``: ``python -m paddle_tpu_torch.distributed.launch``, the
  launch controller (rendezvous environment, fail-fast watch, liveness
  and progress timeouts, death markers, the rescale stop);
- ``heartbeat``: rank beats and their staleness check, the named
  participants' transport (serving replicas' beats, telemetry frames and
  admission journals), the dead-peer and abort markers; its key-value
  leg rides the default process group's store;
- ``checkpoint``: save / load with reshard-on-load and the atomic commit
  protocol, async saves and ``CheckpointManager`` (retention, restore of
  the newest committed step, the preemption hook);
- ``fleet``: the training restart loops, the elastic serving
  controller and the elastic worker's checkpointed resume point.
"""
from . import (checkpoint, env, fleet, heartbeat, introspect,  # noqa: F401
               launch, spmd)
from .checkpoint import (CheckpointManager, load_state_dict,  # noqa: F401
                         save_state_dict)
from .env import (ParallelEnv, get_rank, get_world_size,  # noqa: F401
                  init_parallel_env, is_initialized)

__all__ = ["checkpoint", "env", "fleet", "heartbeat", "introspect",
           "launch", "spmd", "CheckpointManager", "save_state_dict",
           "load_state_dict", "ParallelEnv", "get_rank", "get_world_size",
           "init_parallel_env", "is_initialized"]
