#!/usr/bin/env python3
"""Where the port's serving time goes on one CUDA card.

Serves the same 16 requests as ``chip_smoke.py``'s main path (Llama-3-8B
widths, random bf16 weights, 8 slots) once to warm up and once under
``torch.profiler``, then prints, on the card:

- host wall time of the run, split by the engine into prefill groups and
  decode chunks (each ends in a download, so it includes waiting for the
  card);
- device time by kernel class (flash forward, paged decode and its int8
  arm, matrix products, the dequantization of weight-only weights,
  everything else), their launch counts, and the device busy share
  (summed kernel time over wall time).

Run from the repo root: ``python3 scripts/torch_serving_profile.py``;
``--kv-quant`` serves with int8 KV pages (``chip_smoke.py``'s
``main_kvq``), and ``--weights int8`` (or ``int4``) with weight-only
quantized weights as well (``main_wq``). The dequantization class is the
device time of the kernels launched inside ``models.llama._dequant``,
which this script wraps in a profiler range.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _classify(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:      # either route (flash_fwd_[tc_]kernel)
        return "flash_fwd"
    if "paged_decode" in n:
        # the split kernel and its combine pass; the int8 arm is each
        # instantiated on int8_t pages
        return "paged_decode_int8" if ("signed char" in n or "int8" in n) \
            else "paged_decode"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "sm90_xmma",
                            "nvjet", "matmul")):
        return "matmul"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV pages (kv_quant=True)")
    ap.add_argument("--weights", choices=("bf16", "int8", "int4"),
                    default="bf16", help="weight-only quantized weights")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from chip_smoke import _main_requests
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import llama as L
    import paddle_tpu_torch
    # the page size the readings in PERF.md were taken at (16, int8 32),
    # not one the autotuner would pick
    paddle_tpu_torch.set_flags({"use_autotune": False})

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_all()
    cfg = L.llama_3_8b(num_hidden_layers=args.layers)
    params = L.init_params(cfg, seed=0)
    if args.weights != "bf16":
        params = L.quantize_weights(params, args.weights)
        torch.cuda.empty_cache()
    dequant = L._dequant

    def traced_dequant(*a, **kw):
        with record_function("weight_dequant"):
            return dequant(*a, **kw)
    L._dequant = traced_dequant

    def serve():
        eng = ServingEngine(L, params, cfg, num_slots=8, max_len=2048,
                            kv_quant=args.kv_quant)
        t0 = time.perf_counter()
        eng.run(_main_requests(cfg.vocab_size))
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    serve()                                            # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng, wall = serve()
    st = eng.stats
    print(f"layers={args.layers} kv_quant={args.kv_quant} "
          f"weights={args.weights} wall_s={wall:.4f} "
          f"prefill_s={st.prefill_s:.4f} decode_s={st.decode_s:.4f} "
          f"prefill_tokens={st.tokens_prefilled} "
          f"decode_tokens={st.tokens_decoded} "
          f"decode_steps={st.decode_steps}")
    by = {}
    for evt in prof.key_averages():
        dt = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        if not dt or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        cls = _classify(evt.key)
        ms, n = by.get(cls, (0.0, 0))
        by[cls] = (ms + dt / 1e3, n + evt.count)
    # the dequantization kernels, counted under the "other" class above,
    # are moved to their own class by the range around them
    for evt in prof.key_averages():
        if evt.key == "weight_dequant":
            ms = getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0)) / 1e3
            if ms:
                other_ms, other_n = by["other"]
                by["other"] = (other_ms - ms, other_n)
                by["weight_dequant"] = (ms, evt.count)
    busy = sum(ms for ms, _ in by.values())
    for cls, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0]):
        print(f"device class={cls} ms={ms:.3f} launches={n} "
              f"share_of_busy={ms / busy:.4f}")
    print(f"device busy_ms={busy:.3f} wall_ms={wall * 1e3:.3f} "
          f"busy_share={busy / (wall * 1e3):.4f} "
          f"idle_share={1 - busy / (wall * 1e3):.4f}")
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: -getattr(e, "self_device_time_total", 0))
    for e in top[:12]:
        print(f"kernel ms={getattr(e, 'self_device_time_total', 0) / 1e3:.3f}"
              f" count={e.count} name={e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
