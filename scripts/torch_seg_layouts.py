#!/usr/bin/env python3
"""Where the segment (sequence-packed) flash kernels lose time, on one
NVIDIA H100.

Times the bf16 segment kernels (``flash_attention_segments_fwd`` /
``_bwd``, the tensor-core route at head dim 128) at the packed training
path's shape, ``[7, 2048]`` with 32 query and 8 kv heads, on four
layouts of segment ids, and the dense causal kernels on the same
tensors:

- ``trace``: the packed rung's documents (``chip_smoke.packed_trace``);
- ``one_doc``: one document a row, the dense kernels' work exactly, so
  the two differ only by the segment policy (tile list, staged ids,
  masks at document boundaries);
- ``docs512`` / ``docs128``: rows of 4 x 512 or 16 x 128 documents, where
  each q tile runs few key tiles and a block's fixed cost (its launch,
  Q load, tile list and epilogue) weighs more.

For each: visible pairs a head, tiles run at 128 x 128 and 64 x 64,
kernel ms on stats computed once (and with the stats computed in the
call), the stats' own ms, and TFLOP/s over the visible pairs (4 D
operations a pair and head forward, 10 backward). Every time is CUDA
events over 20 calls after 3 warm-ups. Prints the card's name and power
limit first.

Run from the repo root: ``python3 scripts/torch_seg_layouts.py``.
"""
from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

H, KVH, D = 32, 8, 128
ROWS, SEQ = 7, 2048


def _time_ms(torch, fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _layout(torch, dev, lens):
    """(seg, pos) int32 [ROWS, SEQ]: the same documents in every row."""
    seg = torch.full((ROWS, SEQ), -1, dtype=torch.int32)
    pos = torch.zeros(ROWS, SEQ, dtype=torch.int32)
    o = 0
    for i, n in enumerate(lens):
        seg[:, o:o + n], pos[:, o:o + n] = i, torch.arange(n)
        o += n
    return seg.to(dev), pos.to(dev)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_seg_layouts: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from paddle_tpu_torch.kernels import flash_attention as FA
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, dout = (torch.randn(ROWS, SEQ, h, D, generator=gen,
                                 device=dev).bfloat16()
                     for h in (H, KVH, KVH, H))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    fwd = _time_ms(torch, lambda: FA.flash_attention_fwd(q, k, v,
                                                         causal=True))
    bwd = _time_ms(torch, lambda: FA.flash_attention_bwd(
        q, k, v, out, lse, dout, causal=True))
    print(f"dense B{ROWS}xS{SEQ} causal: fwd_ms={fwd:.4f} "
          f"bwd_ms={bwd:.4f}", flush=True)
    _, packed = C.packed_trace()
    layouts = {
        "trace": tuple(torch.as_tensor(packed[key], device=dev)
                       for key in ("segment_ids", "positions")),
        "one_doc": _layout(torch, dev, [SEQ]),
        "docs512": _layout(torch, dev, [512] * 4),
        "docs128": _layout(torch, dev, [128] * 16)}
    for name, (seg, pos) in layouts.items():
        segs = (seg, seg, pos, pos)
        stats_f = FA._tile_stats(segs, FA.seg_tiles(q))
        stats_b = FA._tile_stats(segs, FA.seg_tiles(q, backward=True))
        out, lse = FA.flash_attention_segments_fwd(q, k, v, *segs,
                                                   causal=True)
        fwd = _time_ms(torch, lambda: FA.flash_attention_segments_fwd(
            q, k, v, *segs, causal=True, stats=stats_f))
        fwd_s = _time_ms(torch, lambda: FA.flash_attention_segments_fwd(
            q, k, v, *segs, causal=True))
        bwd = _time_ms(torch, lambda: FA.flash_attention_segments_bwd(
            q, k, v, out, lse, dout, *segs, causal=True, stats=stats_b))
        bwd_s = _time_ms(torch, lambda: FA.flash_attention_segments_bwd(
            q, k, v, out, lse, dout, *segs, causal=True))
        stats_ms = _time_ms(torch, lambda: FA._tile_stats(
            segs, FA.seg_tiles(q)))
        visible = int(FA._seg_mask(*segs, True).sum())
        ran = {t: FA.count_skipped_blocks(*segs, t, t, True)
               for t in (128, 64)}
        print(f"{name}: visible_pairs_per_head={visible} "
              f"tiles128={ran[128][1] - ran[128][0]} "
              f"tiles64={ran[64][1] - ran[64][0]} fwd_ms={fwd:.4f} "
              f"fwd_with_stats_ms={fwd_s:.4f} bwd_ms={bwd:.4f} "
              f"bwd_with_stats_ms={bwd_s:.4f} stats_ms={stats_ms:.4f} "
              f"fwd_tflops={4 * D * H * visible / fwd / 1e9:.0f} "
              f"bwd_tflops={10 * D * H * visible / bwd / 1e9:.0f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
