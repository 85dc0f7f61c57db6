"""Distributed runtime (port of ``paddle_tpu/distributed/``). So far only
the named-participant transport of ``heartbeat.py``, which the serving
engine's admission journal publishes on; process groups, collectives and
the elastic controllers are ROADMAP A9 / A10.
"""
from . import heartbeat  # noqa: F401

__all__ = ["heartbeat"]
