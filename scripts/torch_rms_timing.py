#!/usr/bin/env python3
"""Device time of the RMSNorm backward, row pass and dw pass apart.

Times ``rms_norm_bwd`` of the ``paddle_tpu_torch`` package under
``--root`` (default: this checkout) with ``chip_smoke.py``'s
``rms_bwd_timing`` from this checkout: ``torch.profiler``'s device time
of the row pass and of the ``dw`` pass, beside the back-to-back wrapper
time, ``F.rms_norm``'s autograd backward and ``torch.add`` over the same
bytes (read x and dy, write dx), at the eager path's ``[8192, 4096]``
bfloat16 and at float32, d 5120, 8192 and 16384 with n chosen so that x
holds 64 MiB (above the 50 MB L2). Because the timing code comes from
this checkout, another tree (``git archive`` of an earlier commit,
unpacked) is timed by the same code:

    python3 scripts/torch_rms_timing.py [--root DIR] [--rounds N]

``--plans G,R,T,S[;G,R,T,S...]`` times the eager shape alone under each
given bulk-route plan (grid, row groups a block, threads a group, ring
stages a group) beside the wrapper's own, in turns: what the number of
row stages in flight, and the blocks an SM, cost.

Prints the card's name and power limit, one line per shape and round,
and exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X_BYTES = 64 << 20          # x at every timed shape


def shapes(torch):
    """``(name, n, d, x dtype, w dtype)`` of each timed shape."""
    bf16, f32 = torch.bfloat16, torch.float32
    out = []
    for name, d, dt in (("eager", 4096, bf16), ("f32", 4096, f32),
                        ("d5120", 5120, bf16), ("d8192", 8192, bf16),
                        ("d16384", 16384, bf16), ("d16384_f32", 16384, f32)):
        out.append((name, X_BYTES // (d * dt.itemsize), d, dt, dt))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose paddle_tpu_torch is timed")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times each shape is timed, in turns")
    ap.add_argument("--plans", default=None,
                    help="bulk-route plans G,R,T,S separated by ';' "
                    "(eager shape only)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "rms_timing_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import rms_norm as RN
    assert os.path.dirname(RN.__file__).startswith(root), RN.__file__
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_all(["rms_norm"])
    dev = torch.device("cuda", 0)
    cases = shapes(torch)
    plans = [None]
    if args.plans:
        cases = cases[:1]
        plans += [tuple(int(v) for v in p.split(","))
                  for p in args.plans.split(";")]
    own_plan = getattr(RN, "bwd_plan", None)
    for rnd in range(args.rounds):
        for plan in plans:
            if plan is not None:
                RN.bwd_plan = lambda n, *_, p=plan, **__: RN.BwdPlan(
                    "bulk", *p, -(-n // (p[0] * p[1])))
            for name, n, d, xdt, wdt in cases:
                res = cs.rms_bwd_timing(torch, dev, RN, n, d, xdt, wdt)
                cs._say("rms_timing", root=root, round=rnd, case=name,
                        dtype=str(xdt).split(".")[-1], **res)
                torch.cuda.empty_cache()
            RN.bwd_plan = own_plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
