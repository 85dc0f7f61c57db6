"""Monitor planes (port of ``paddle_tpu/monitor/``). So far only the
serving demand model of ``slo.py``, which the engine's shedding reads with
the monitor off; the metrics registry, the SLO plane, trace, forensics
and the servers are ROADMAP A7(c).
"""
from . import slo  # noqa: F401

__all__ = ["slo"]
