#!/usr/bin/env python3
"""A CPU model of how the decode kernel's mixed (q, page) pairs round p,
and what ``chip_smoke.py``'s ``[paged_mixed]`` checks make of it.

``csrc/paged_decode.cu`` rounds p to a 2-byte page type before P.V, but
against the running max of each row group (a warp's ``32 / dtp`` groups of
``dtp = pow2ceil(D / 8)`` lanes, ``ROWS = 4`` rows of each ``nrg * ROWS``
tile, tile t to warp ``t % 4``, the max updated once a tile, each split of
``decode_split_plan`` on its own), and combines the groups' partials in
float32. This script computes that in float32 on the CPU at the shapes of
``paged_mixed_checks`` (float32 q, CPU random inputs of the same kind) and
prints, for each shape and 2-byte page type:

- the model's max |difference| from the plain version (p float32) and from
  ``chip_smoke.paged_ref_round_p`` (p rounded against the row's max);
- the RMS ratio ``chip_smoke`` bounds by ``MIXED_RMS_BAND``, for the
  model rounding at the page type, not rounding, and rounding at the
  other 2-byte type.

    python3 scripts/torch_mixed_rounding_model.py

Exits non-zero when the page type's ratio leaves the band or either wrong
model's ratio falls inside it.
"""
from __future__ import annotations

import importlib.util
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROWS, WARPS = 4, 4          # csrc/paged_decode.cu


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_model", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_model(torch, PA, q, kp, vp, bt, ln, round_to):
    """The kernel's output in float32, p rounded to ``round_to`` (None:
    not rounded) against each row group's running max."""
    B, nh, D = q.shape
    P, kv, ps, _ = kp.shape
    maxp = bt.shape[1]
    idx = bt.clamp(0, P - 1).reshape(-1).long()
    kf, vf = (x[idx].reshape(B, maxp, kv, ps, D).float().permute(
        0, 2, 1, 3, 4).reshape(B, kv, maxp * ps, D) for x in (kp, vp))
    s = torch.einsum("bkgd,bkld->bkgl", q.float().reshape(B, kv, -1, D),
                     kf) * (math.log2(math.e) / math.sqrt(D))
    pos = torch.arange(maxp * ps)
    s = torch.where(pos < ln.long()[:, None, None, None], s, -math.inf)
    pps, _ = PA.decode_split_plan(B, kv, ps, maxp)
    chunk = pps * ps
    dtp = 1
    while dtp < D // 8:
        dtp *= 2
    nrg = 32 // dtp
    tile = nrg * ROWS
    loc = pos % chunk
    t = loc // tile
    group = ((pos // chunk) * WARPS + t % WARPS) * nrg + (loc % tile) % nrg
    order = t // WARPS
    ng, no = int(group.max()) + 1, int(order.max()) + 1
    flat = (group * no + order).expand(s.shape)
    tmax = torch.full(s.shape[:-1] + (ng * no,), -math.inf).scatter_reduce(
        -1, flat, s, "amax")
    run = tmax.reshape(s.shape[:-1] + (ng, no)).cummax(-1).values
    m = run.reshape(s.shape[:-1] + (ng * no,)).gather(-1, flat)
    mu = torch.where(m == -math.inf, 0.0, m)
    p = torch.exp2(s - mu)
    pr = p.to(round_to).float() if round_to is not None else p
    top = s.amax(-1, keepdim=True)
    w = torch.exp2(mu - torch.where(top == -math.inf, 0.0, top))
    l = (p * w).sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    return torch.einsum("bkgl,bkld->bkgd", pr * w / l, vf).reshape(B, nh, D)


def main():
    import torch
    from paddle_tpu_torch.kernels import paged_attention as PA
    C = _chip_smoke()
    lo, hi = C.MIXED_RMS_BAND
    main_lengths, _ = C.decode_wave_lengths(C._main_requests(32000))
    maxp, PS = 128, 16
    gen = torch.Generator().manual_seed(21)
    shapes = [("edge", (NH, 8, D), [0, 1, 15, 16, 17, 300, 777, maxp * PS])
              for NH, D in ((8, 64), (16, 64), (32, 128), (64, 128))]
    shapes.append(("main", (32, 8, 128), list(main_lengths)))
    other = {torch.bfloat16: torch.float16, torch.float16: torch.bfloat16}
    ok = True
    for name, (NH, KVH, D), lengths in shapes:
        P = sum(-(-n // PS) for n in lengths) + 4
        kf = torch.randn(P, KVH, PS, D, generator=gen)
        vf = torch.randn(P, KVH, PS, D, generator=gen)
        bt = C._page_tables(torch, "cpu", lengths, PS, maxp, P, 22)
        ln = torch.tensor(lengths, dtype=torch.int32)
        q = torch.randn(len(lengths), NH, D, generator=gen)
        for pdt in (torch.bfloat16, torch.float16):
            kp, vp = kf.to(pdt), vf.to(pdt)
            plain = PA.paged_attention_ref(q, kp, vp, bt, ln)
            rnd = C.paged_ref_round_p(torch, q, kp, vp, bt, ln)
            base = C._rms(rnd - plain)
            ratio = {}
            for label, to in (("page", pdt), ("none", None),
                              ("other", other[pdt])):
                out = kernel_model(torch, PA, q, kp, vp, bt, ln, to)
                ratio[label] = C._rms(out - plain) / base
                if label == "page":
                    err, err_rnd = C._err(out, plain), C._err(out, rnd)
            print(f"shape={name} heads={NH}/{KVH} D={D} "
                  f"pages={str(pdt).split('.')[-1]} vs_plain={err:.3e} "
                  f"vs_rounded_ref={err_rnd:.3e} "
                  f"ratio_page={ratio['page']:.3f} "
                  f"ratio_none={ratio['none']:.2e} "
                  f"ratio_other={ratio['other']:.3f}")
            ok &= lo <= ratio["page"] <= hi
            ok &= not any(lo <= ratio[k] <= hi for k in ("none", "other"))
    print(f"band {C.MIXED_RMS_BAND}: {'separates' if ok else 'FAILS'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
