"""Test-support utilities that ship with the port (port of
``paddle_tpu/testing/``): :mod:`paddle_tpu_torch.testing.faults`, the
deterministic fault-injection harness, armable from tests and through
``FLAGS_fault_injection``; and ``op_cases``, the seeded inputs of every
registered op, shared by the CPU parity tests and ``chip_smoke.py``'s
``[ops]`` phase (imported by its users, not here).
"""
from . import faults  # noqa: F401

__all__ = ["faults"]
