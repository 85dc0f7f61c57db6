#!/usr/bin/env python3
"""Device time of the paged decode kernel, both arms, at three shapes.

Times ``ragged_paged_attention`` of the ``paddle_tpu_torch`` package
under ``--root`` (default: this checkout) with ``chip_smoke.py``'s
``decode_timing`` from this checkout: bf16 pages of 16 and int8 pages of
32, Llama-3-8B heads (32 / 8, head_dim 128), at the main path's first
and second decode waves and at 32 sequences over the full 2048-position
table. Each number is ``torch.profiler``'s device time of the decode
kernels (split and combine) over a rotation of pools that exceeds the
L2 twice, beside the back-to-back wrapper time (``wrapper_ms``) and the
plain version's. Because the timing code comes from this checkout,
another tree (``git archive`` of an earlier commit, unpacked) is timed
by the same code:

    python3 scripts/torch_decode_timing.py [--root DIR]

Prints the card's name and power limit, one line per arm and shape, and
exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose paddle_tpu_torch is timed")
    ap.add_argument("--split-positions", type=int, default=None,
                    help="the split plan's chunk, about this many "
                    "positions (default: the wrapper's SPLIT_POSITIONS)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "decode_timing_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as PA
    assert os.path.dirname(PA.__file__).startswith(root), PA.__file__
    if args.split_positions:
        PA.SPLIT_POSITIONS = args.split_positions
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_all(["paged_decode"])
    dev = torch.device("cuda", 0)
    first, second = cs.decode_wave_lengths(cs._main_requests(128256))
    for name, ps, quant in (("paged_decode", 16, False),
                            ("paged_decode_int8", 32, True)):
        width = 2048 // ps
        for shape, lengths in cs.decode_timing_shapes(first, second,
                                                      width * ps):
            t = cs.decode_timing(torch, dev, PA, lengths, ps, width, quant,
                                 4 if not quant else 13)
            cs._say("decode_timing", root=root, kernel=name, timing=shape,
                    split_positions=getattr(PA, "SPLIT_POSITIONS", None),
                    **t)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
