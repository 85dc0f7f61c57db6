#!/usr/bin/env python3
"""Where the port's training time goes on one CUDA card.

Builds ``chip_smoke.py``'s dense training main path (Llama-3-8B widths,
4 layers, random bf16 weights from seed 0, float32 AdamW moments, batch
4 x 2048, remat ``"dots"``, blockwise cross entropy), with ``--packed``
its packed training main path (the same widths at vocab 32000, bf16
moments, materialising cross entropy, the packed trace's ``[7, 2048]``
batch), with ``--eager`` its eager main path (the Paddle-surface
``LlamaForCausalLM`` at the same widths, bf16, no remat,
``F.cross_entropy``, ``optimizer.AdamW``, batch 4 x 2048), or with
``--moe`` its MoE training main path (DeepSeekMoE-16B widths, 2 layers,
capacity dispatch, remat ``"dots"``, materialising cross entropy, bf16
moments, batch 8 x 1024), with ``--dit`` its DiT training main path
(DiT-XL/2, bf16, remat, float32 moments, 32 latents of 256 tokens), or
with ``--dit-sample`` one denoising step of its DiT sampling main path
(a 1-step ``ddim_sample`` of 8 labels under guidance 4.0: one forward
over 16 rows), takes two warm-up steps, then one step under
``torch.profiler``, and prints, on the card:

- host wall time of the profiled step (it ends in a synchronize);
- device time and launches by class: the segment (packed) flash kernels,
  the dense flash backward and forward kernels, the RMSNorm kernels
  (eager), cuBLAS matmuls of the
  model, the cross entropy (the blockwise chunks with their matmuls, or
  the materialising loss's forward and its logsumexp / gather
  backwards), the AdamW update, and everything else; a kernel is put in
  a class by its own name (flash) or by the profiler range it was
  launched from (cross entropy, optimizer; then matmuls by name), and
  "other" is the rest of the device busy time. With ``--moe`` two more
  classes: ``moe_routing``, the router (its float32 product, softmax,
  top-k, aux loss) and the capacity dispatch and combine (slot
  bookkeeping, gathers, weighted sum), forward and its remat recompute,
  plus the backward kernels of the autograd nodes of the gathers and the
  router softmax (``IndexBackward``, ``SoftmaxBackward``; the
  embedding's gather backward falls here too); and ``experts``, the
  routed experts' batched products and SwiGLU, forward and
  ``BmmBackward``;
- the device busy share (summed kernel time over wall time) and its
  complement, the idle share;
- the dozen kernels that took the most device time.

Run from the repo root: ``python3 scripts/torch_train_profile.py
[--packed | --eager | --moe | --dit | --dit-sample]``.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CLASSES = ("segment", "flash_bwd", "flash_fwd", "rms_norm", "moe_routing",
           "experts", "matmul", "cross_entropy", "optimizer", "other")
# classed by kernel name
NAMED = ("segment", "flash_bwd", "flash_fwd", "rms_norm")
# the script's own ranges; the profiler also shows each as a span on the
# device's timeline, which is no kernel and is left out of every sum
RANGES = ("cross_entropy", "adamw_update")
# ranges around the MoE family's router, its dispatch / combine, and its
# expert products (--moe)
MOE_RANGES = ("moe_router", "moe_dispatch", "moe_experts")
# the autograd nodes of the routing ops' and the experts' backward
MOE_ROUTING_BACKWARD = ("IndexBackward", "SoftmaxBackward")
EXPERTS_BACKWARD = ("BmmBackward",)
# the autograd nodes of the materialising losses' backward
CE_BACKWARD = ("LogsumexpBackward", "LogSoftmaxBackward", "GatherBackward")
# the profiler's own markers on the host: one that stalls a launch (the
# launch queue is full) or a buffer request carries the id of the op
# around it and lists that op's kernels a second time
MARKERS = ("Command Buffer Full", "Activity Buffer Request")


def _classify(kernel: str, ranges) -> str:
    n = kernel.lower()
    # either route's policy (SegmentMask, SegmentTC) names the segment pair
    if "flash" in n and "segment" in n:
        return "segment"
    if "flash_bwd" in n:
        return "flash_bwd"
    if "flash_fwd" in n:      # either route (flash_fwd_[tc_]kernel)
        return "flash_fwd"
    # the backward's either route (rms_bwd_[scalar_]kernel), its dw pass
    if any(k in n for k in ("rms_fwd_kernel", "rms_bwd", "rms_dw_kernel")):
        return "rms_norm"
    if any("_BlockwiseCE" in r or r == RANGES[0]
           or any(b in r for b in CE_BACKWARD) for r in ranges):
        return "cross_entropy"
    if any(r == "adamw_update" for r in ranges):
        return "optimizer"
    if any(r == MOE_RANGES[2] or any(b in r for b in EXPERTS_BACKWARD)
           for r in ranges):
        return "experts"
    if any(r in MOE_RANGES[:2] or any(b in r for b in MOE_ROUTING_BACKWARD)
           for r in ranges):
        return "moe_routing"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "sm90_xmma",
                            "nvjet", "matmul")):
        return "matmul"
    return "other"


def _ranges(evt):
    """Names of a CPU event and of every range around it."""
    out = []
    while evt is not None:
        out.append(evt.name)
        evt = evt.cpu_parent
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--packed", action="store_true",
                    help="profile the packed training main path")
    ap.add_argument("--eager", action="store_true",
                    help="profile the eager (Paddle-surface) main path")
    ap.add_argument("--moe", action="store_true",
                    help="profile the MoE training main path")
    ap.add_argument("--dit", action="store_true",
                    help="profile the DiT-XL/2 training main path")
    ap.add_argument("--dit-sample", action="store_true",
                    help="profile one DiT-XL/2 denoising step")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from chip_smoke import (DIT_GUIDANCE, DIT_LABELS, DIT_TRAIN_BATCH,
                            MOE_TRAIN_BATCH, MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ,
                            TRAIN_BATCH, TRAIN_LAYERS, TRAIN_SEQ, dit_labels,
                            dit_train_setup, dit_xl_setup, eager_step,
                            eager_train_setup, moe_train_setup,
                            packed_train_setup, train_setup)
    import paddle_tpu_torch.nn.functional as PF
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_ce as FCE
    from paddle_tpu_torch.models import dit as DIT
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.models import moe as M

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_all()
    dev = torch.device("cuda", 0)

    # named ranges around the two pieces that have no kernel of their own
    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    L._adamw_update = ranged(RANGES[1], L._adamw_update)
    O.AdamW.step = ranged(RANGES[1], O.AdamW.step)
    PF.cross_entropy = ranged(RANGES[0], PF.cross_entropy)
    K.dispatched_fused_ce = ranged(RANGES[0], K.dispatched_fused_ce)
    FCE.masked_xent_from_logits = ranged(RANGES[0],
                                         FCE.masked_xent_from_logits)
    M._route = ranged(MOE_RANGES[0], M._route)
    M._moe_mlp_capacity = ranged(MOE_RANGES[1], M._moe_mlp_capacity)
    M._moe_mlp_dense = ranged(MOE_RANGES[1], M._moe_mlp_dense)
    M._expert_ffn = ranged(MOE_RANGES[2], M._expert_ffn)
    layers = TRAIN_LAYERS

    if args.eager:
        model, opt, inp, tgt = eager_train_setup(
            torch, L.llama_3_8b(num_hidden_layers=TRAIN_LAYERS))
        shape = f"{TRAIN_BATCH}x{TRAIN_SEQ} eager"

        def run():
            return eager_step(model, opt, inp, tgt)
    elif args.dit_sample:
        cfg, params = dit_xl_setup(torch, dev)
        labels = dit_labels(torch, dev, cfg)
        layers = cfg.num_hidden_layers
        shape = f"{2 * DIT_LABELS}x{cfg.num_patches} dit_sample"

        def run():
            return DIT.ddim_sample(params, labels, cfg, steps=1,
                                   guidance_scale=DIT_GUIDANCE).std()
    else:
        if args.packed:
            _, params, state, step, batch, _, packed = packed_train_setup(
                torch, dev)
            shape = "x".join(map(str, packed["ids"].shape)) + " packed"
        elif args.moe:
            _, params, state, step, batch = moe_train_setup(torch, dev)
            shape = f"{MOE_TRAIN_BATCH}x{MOE_TRAIN_SEQ} moe"
            layers = MOE_TRAIN_LAYERS
        elif args.dit:
            cfg, params, state, step, batch = dit_train_setup(torch, dev)
            shape = f"{DIT_TRAIN_BATCH}x{cfg.num_patches} dit"
            layers = cfg.num_hidden_layers
        else:
            _, params, state, step, batch = train_setup(torch, dev)
            shape = f"{TRAIN_BATCH}x{TRAIN_SEQ}"

        def run():
            return step(params, state, batch)[2]
    for _ in range(2):                                   # warm-up
        run()
    torch.cuda.synchronize()
    K.reset_dispatch_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = float(run())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"layers={layers} batch={shape} "
          f"loss={loss} wall_ms={wall * 1e3:.3f} "
          f"launches={K.dispatch_stats()}")

    # flash kernels by their own names, over every device event; the
    # rest by the range their launch was made in, through the CPU op
    # each kernel is linked to; "other" is what remains of the busy time
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in RANGES + MOE_RANGES]
    by = {c: [0.0, 0] for c in CLASSES}
    for e in device:
        cls = _classify(e.key, ())
        if cls in NAMED:
            by[cls][0] += getattr(e, "self_device_time_total", 0) / 1e3
            by[cls][1] += e.count
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU \
                or not evt.kernels or evt.name in MARKERS:
            continue
        ranges = _ranges(evt)
        for k in evt.kernels:
            if k.name in RANGES + MOE_RANGES:
                continue
            cls = _classify(k.name, ranges)
            if cls not in NAMED + ("other",):
                by[cls][0] += k.duration / 1e3
                by[cls][1] += 1
    busy = sum(getattr(e, "self_device_time_total", 0) for e in device) / 1e3
    launches = sum(e.count for e in device)
    by["other"] = [busy - sum(ms for ms, _ in by.values()),
                   launches - sum(n for _, n in by.values())]
    for cls in CLASSES:
        ms, n = by[cls]
        print(f"device class={cls} ms={ms:.3f} launches={n} "
              f"share_of_busy={ms / busy:.4f}")
    print(f"device busy_ms={busy:.3f} wall_ms={wall * 1e3:.3f} "
          f"busy_share={busy / (wall * 1e3):.4f} "
          f"idle_share={1 - busy / (wall * 1e3):.4f}")
    for e in sorted(device, key=lambda e: -getattr(
            e, "self_device_time_total", 0))[:12]:
        print(f"kernel ms={getattr(e, 'self_device_time_total', 0) / 1e3:.3f}"
              f" count={e.count} name={e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
