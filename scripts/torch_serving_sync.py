#!/usr/bin/env python3
"""Serving rates of a tree's data plane, and the host syncs it makes.

Serves ``chip_smoke.py``'s 16 main-path requests at Llama-3-8B widths
(random bf16 weights from seed 0) with the ``paddle_tpu_torch`` package
under ``--root`` (default: this checkout), through ``chip_smoke.py``'s
``phase_main`` from this checkout, so that another tree (``git
archive`` of an earlier commit, unpacked) is measured by the same code:
``[main]`` (bf16 pages) and ``[main_kvq]`` (int8 pages) print prefill
and decode tokens/s and TTFT. Then one more serve of each under
``torch.cuda.set_sync_debug_mode("warn")`` counts the operations that
made the host wait for the card (``[sync_count]``: syncs per prefill
group and per decode chunk, the engine's own reads and uploads
included):

    python3 scripts/torch_serving_sync.py [--root DIR] [--layers N]

Prints the card's name and power limit first, and exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def count_syncs(torch, L, cfg, params, requests, kv_quant):
    """One serve under the sync debug mode "warn": the syncs it reports,
    and the engine's prefill groups and decode chunks."""
    from paddle_tpu_torch.inference import Request, ServingEngine
    eng = ServingEngine(L, params, cfg, num_slots=8, max_len=2048,
                        kv_quant=kv_quant)
    reqs = [Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens) for r in requests]
    groups = chunks = 0
    prefill, step = eng._prefill_group, eng.step

    def counted_prefill(*a, **k):
        nonlocal groups
        groups += 1
        return prefill(*a, **k)

    eng._prefill_group = counted_prefill
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for r in reqs:
                eng.submit(r)
            while True:
                before = eng.stats.decode_steps
                if not step():
                    break
                chunks += eng.stats.decode_steps > before
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in seen)
    return syncs, groups, chunks, eng.stats.decode_steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose paddle_tpu_torch serves")
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "serving_sync_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import llama as L
    assert os.path.dirname(L.__file__).startswith(root), L.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    _build.build_all()
    dev = torch.device("cuda", 0)
    cfg = L.llama_3_8b(num_hidden_layers=args.layers)
    requests = cs._main_requests(cfg.vocab_size)
    params = L.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    for kv_quant in (False, True):
        phase = "main_kvq" if kv_quant else "main"
        cs._say(phase, root=root, layers=args.layers)
        cs.phase_main(torch, dev, cfg, params, requests, smi, phase=phase,
                      kv_quant=kv_quant)
        torch.cuda.empty_cache()
    for kv_quant in (False, True):
        syncs, groups, chunks, steps = count_syncs(torch, L, cfg, params,
                                                   requests, kv_quant)
        cs._say("sync_count", root=root, kv_quant=kv_quant, syncs=syncs,
                prefill_groups=groups, decode_chunks=chunks,
                decode_steps=steps,
                syncs_per_group_and_chunk=syncs / (groups + chunks))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
