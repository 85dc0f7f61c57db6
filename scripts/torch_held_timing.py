#!/usr/bin/env python3
"""Check of ``chip_smoke.py``'s fallback device timing on the card.

``chip_smoke.py`` takes kernel device times from ``torch.profiler``
(``_kernel_us``) and, when every trace comes back without a kernel, from
CUDA events around the run with the stream held while the host enqueues
it (``_held_ms``). This script times 200 back-to-back ``torch.mm`` calls
on ``[256, 256]`` float32 both ways, checks that ``_kernel_us`` returns
``{}`` when no kernel name matches, and that the held time is within
0.5-3x of the profiler's:

    python3 scripts/torch_held_timing.py

Prints the card's name and power limit, then one line with both times
a call; exits non-zero without a CUDA device or when a check fails.
"""
from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CALLS = 200


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_held_timing: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    a = torch.randn(256, 256, device="cuda")

    def run():
        for _ in range(CALLS):
            torch.mm(a, a)

    run()
    torch.cuda.synchronize()
    prof = sum(cs._kernel_us(run).values()) / CALLS / 1e3
    none = cs._kernel_us(run, lambda key: False)
    held = cs._held_ms(run) / CALLS
    print(f"[held_check] profiler_ms={prof} held_ms={held} "
          f"empty={none == {}}")
    assert none == {} and prof > 0 and 0.5 * prof < held < 3 * prof, \
        (prof, held)
    return 0


if __name__ == "__main__":
    sys.exit(main())
