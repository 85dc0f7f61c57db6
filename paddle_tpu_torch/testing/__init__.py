"""Test-support utilities that ship with the port (port of
``paddle_tpu/testing/``): :mod:`paddle_tpu_torch.testing.faults`, the
deterministic fault-injection harness, armable from tests and through
``FLAGS_fault_injection``.
"""
from . import faults  # noqa: F401

__all__ = ["faults"]
