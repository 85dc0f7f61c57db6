"""Fleet control (port of ``paddle_tpu/distributed/fleet/``): so far the
elastic serving controller of ``elastic.py``. The training fleet (the
pipeline schedules, mp / pp layers, recompute, topology) is ROADMAP A10.
"""
from . import elastic  # noqa: F401

__all__ = ["elastic"]
