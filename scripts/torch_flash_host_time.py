#!/usr/bin/env python3
"""Host time of the flash forward wrapper, directly and through its
registered op, then DiT-XL/2 sampling (``chip_smoke.py``
``phase_dit_sample``).

Times the ``paddle_tpu_torch`` package under ``--root`` (default: this
checkout) with the code of this checkout, so that an unpacked earlier
tree is timed by the same code:

    python3 scripts/torch_flash_host_time.py [--root DIR] [--dit-sample]

At DiT-XL/2's sampling shape ``[16, 256, 16, 72]`` and the training
shape ``[4, 2048, 32 / 8, 128]`` (bf16, the tensor-core route), each
route's host microseconds a call are the wall time of ``CALLS``
back-to-back calls over ``CALLS``, the median of ``ROUNDS`` rounds
(the card runs each call in about 0.03 ms and 0.3 ms, so the queue never
fills and the host time is the enqueue's): ``wrapper``
(``flash_attention_fwd``), ``function`` (``flash_attention`` on inputs
that require grad: the autograd Function, which calls the wrapper),
and, where the tree has them, ``function_through_op`` (the same inside
``through_ops()``, as under remat ``"attn"``) and ``op``
(``torch.ops.paddle_tpu_torch.flash_fwd``). Prints the card's name and
power limit first; exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS, ROUNDS = 200, 7
SHAPES = {"dit_sample": ((16, 256, 16, 72), 16, False),
          "train": ((4, 2048, 32, 128), 8, True)}


def host_us(torch, fn, calls=CALLS, rounds=ROUNDS):
    """Median over ``rounds`` of the host wall time of ``calls`` calls of
    ``fn``, in microseconds a call (the card drained before each
    round)."""
    fn()
    per = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(per)[len(per) // 2]


def flash_routes(torch, dev, FA):
    """``{shape: {route: host us a call}}``."""
    out = {}
    for name, ((b, s, h, d), kvh, causal) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(b, s, h, d, generator=g, device=dev,
                        dtype=torch.bfloat16)
        k = torch.randn(b, s, kvh, d, generator=g, device=dev,
                        dtype=torch.bfloat16)
        qg, kg = q.clone().requires_grad_(), k.clone().requires_grad_()
        routes = {
            "wrapper": lambda: FA.flash_attention_fwd(q, k, k,
                                                      causal=causal),
            "function": lambda: FA.flash_attention(qg, kg, kg,
                                                   causal=causal)}
        if getattr(FA, "FLASH_FWD_OPS", ()):        # the tree has the ops
            def through():
                with FA.through_ops():
                    return FA.flash_attention(qg, kg, kg, causal=causal)
            scale = 1.0 / d ** 0.5
            routes["function_through_op"] = through
            routes["op"] = lambda: torch.ops.paddle_tpu_torch.flash_fwd(
                q, k, k, causal, scale)
        out[name] = {r: round(host_us(torch, fn), 2)
                     for r, fn in routes.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose paddle_tpu_torch is timed")
    ap.add_argument("--dit-sample", action="store_true",
                    help="then run chip_smoke.py's DiT-XL/2 sampling phase")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "flash_host_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as FA
    assert os.path.dirname(FA.__file__).startswith(root), FA.__file__
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    _build.build_all(["flash_fwd"])
    dev = torch.device("cuda", 0)
    print(json.dumps({"root": root, "host_us": flash_routes(torch, dev,
                                                            FA)}))
    if args.dit_sample:
        cs.phase_dit_sample(torch, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
