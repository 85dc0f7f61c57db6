"""Distributed runtime (port of ``paddle_tpu/distributed/``).

- ``spmd``: meshes (``torch.distributed.device_mesh``) with the
  reference's axis names, its partition specs (``P``) as DTensor
  placements, sharding constraints as ``redistribute``, and the process
  group (gloo on the CPU, a one-rank NCCL group on the card);
- ``introspect``: the sharding inspector behind ``/sharding``;
- ``heartbeat``: the named-participant transport (serving replicas'
  beats, telemetry frames and admission journals), whose key-value leg
  rides the default process group's store;
- ``fleet``: the elastic serving controller.

The launcher, checkpoints and the training fleet are ROADMAP A10.
"""
from . import fleet, heartbeat, introspect, spmd  # noqa: F401

__all__ = ["fleet", "heartbeat", "introspect", "spmd"]
