"""Fleet control (port of ``paddle_tpu/distributed/fleet/``): so far
``elastic.py``, the training restart loops and the elastic serving
controller. The training fleet (the pipeline schedules, mp / pp layers,
recompute, topology) is ROADMAP A10.
"""
from . import elastic  # noqa: F401

__all__ = ["elastic"]
