"""paddle_tpu_torch.training — train-loop lifecycle subsystems (port of
``paddle_tpu/training``).

The model families (``models/``) define the step; this package holds
the host-side machinery that keeps a long run alive around it:
``guards`` (the anomaly definition and the all-or-nothing update gate)
and ``sentinel`` (anomaly detection, skip / rollback auto-recovery, the
hang watchdog). Checkpointing lives in ``distributed.checkpoint``; the
sentinel composes with its ``CheckpointManager`` for rollback.
"""
from . import guards  # noqa: F401
from . import sentinel  # noqa: F401

__all__ = ["guards", "sentinel"]
