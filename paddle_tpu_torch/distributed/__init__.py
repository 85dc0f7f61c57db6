"""Distributed runtime (port of ``paddle_tpu/distributed/``).

- ``spmd``: meshes (``torch.distributed.device_mesh``) with the
  reference's axis names, its partition specs (``P``) as DTensor
  placements, sharding constraints as ``redistribute``, and the process
  group (gloo on the CPU, a one-rank NCCL group on the card);
- ``introspect``: the sharding inspector behind ``/sharding``;
- ``heartbeat``: the named-participant transport (serving replicas'
  beats, telemetry frames and admission journals), whose key-value leg
  rides the default process group's store;
- ``checkpoint``: save / load with reshard-on-load and the atomic commit
  protocol, async saves and ``CheckpointManager`` (retention, restore of
  the newest committed step, the preemption hook);
- ``fleet``: the elastic serving controller and the elastic worker's
  checkpointed resume point.

The launcher and the training restart loops are ROADMAP A10.
"""
from . import checkpoint, fleet, heartbeat, introspect, spmd  # noqa: F401
from .checkpoint import (CheckpointManager, load_state_dict,  # noqa: F401
                         save_state_dict)

__all__ = ["checkpoint", "fleet", "heartbeat", "introspect", "spmd",
           "CheckpointManager", "save_state_dict", "load_state_dict"]
