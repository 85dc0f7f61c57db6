"""Distributed runtime (port of ``paddle_tpu/distributed/``). So far the
named-participant transport of ``heartbeat.py`` (serving replicas'
beats, telemetry frames and admission journals) and the elastic serving
controller of ``fleet/elastic.py``. Process groups and collectives are
ROADMAP A9; the launcher, checkpoints and the training fleet are A10.
"""
from . import fleet, heartbeat  # noqa: F401

__all__ = ["fleet", "heartbeat"]
