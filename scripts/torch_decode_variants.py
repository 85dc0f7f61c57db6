#!/usr/bin/env python3
"""What the paged decode kernel's time is made of, on one CUDA card.

Builds ``paddle_tpu_torch/csrc/paged_decode.cu`` as it is and in
variants that each drop one part of the per-tile work (so their outputs
are wrong by design), then times every build with ``chip_smoke.py``'s
``decode_timing`` (device time of the split and combine kernels, cold
L2) for both arms, bf16 pages of 16 and int8 pages of 32, at the main
path's first decode wave and at 32 sequences over the full table:

- ``as_built``: the kernel;
- ``no_shuffle``: the butterfly over a row group's lanes left out;
- ``no_exp``: the softmax's ``ex2`` replaced by a multiply-add;
- ``no_convert``: int8 codes reinterpreted instead of converted;
- ``no_pv``: the P.V multiply-adds left out;
- ``no_copy``: only each warp's first ring of tiles copied, so the loop
  runs on what shared memory holds (the kernel's arithmetic alone).

The time a variant saves is what that part costs where the kernel is
bound by its arithmetic rather than by memory. Run from the repo root:

    python3 scripts/torch_decode_variants.py [--rounds N]
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# each variant: (text in the source, its replacement)
VARIANTS = {
    "as_built": None,
    "no_shuffle": ("s[r][h] += __shfl_xor_sync(0xffffffffu, s[r][h], o);",
                   "s[r][h] += 1e-30f * o;"),
    "no_exp": ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
               "y = fmaf(x, 1e-3f, 1.f);"),
    "no_convert": ("__uint_as_float(__byte_perm(w[i], 0x4B000000u, "
                   "0x7650u | j)) -\n          8388736.f;",
                   "__uint_as_float(w[i] + j);"),
    "no_pv": ("for (int e = 0; e < 8; ++e) acc[h][e] = fmaf(s[r][h], vf[e], "
              "acc[h][e]);", "acc[h][r] += s[r][h] + vf[h];"),
    "no_copy": ("    for (int k = lane; k < ncopy; k += 32) {",
                "    for (int k = lane; k < (i < STAGES ? ncopy : 0); "
                "k += 32) {"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2,
                    help="times each build is timed, in turns")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "decode_variants_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as PA

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    source = (_build.CSRC / _build.SOURCES["paged_decode"]).read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edit in VARIANTS.items():
        text = source
        if edit is not None:
            assert edit[0] in text, f"{name}: the source changed"
            text = text.replace(edit[0], edit[1])
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out_dir / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}: nvcc failed\n{log}"
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        PA._bind(libs[name])

    class Build:
        """``ragged_paged_attention`` through one build's C entries."""
        paged_attention_ref = staticmethod(PA.paged_attention_ref)
        decode_split_plan = staticmethod(PA.decode_split_plan)

        def __init__(self, lib):
            self.lib = lib

        def ragged_paged_attention(self, q, kp, vp, bt, ln, *,
                                   k_scales=None, v_scales=None):
            out = torch.empty_like(q)
            PA._launch(self.lib, q, kp, vp, bt, ln, out,
                       1.0 / math.sqrt(q.shape[-1]), k_scales, v_scales)
            return out

    dev = torch.device("cuda", 0)
    first, _ = cs.decode_wave_lengths(cs._main_requests(128256))
    for rnd in range(args.rounds):
        for name in VARIANTS:
            for arm, ps, quant in (("paged_decode", 16, False),
                                   ("paged_decode_int8", 32, True)):
                for shape, lengths in (("first_wave", first),
                                       ("bandwidth", [2048] * 32)):
                    t = cs.decode_timing(torch, dev, Build(libs[name]),
                                         lengths, ps, 2048 // ps, quant, 4,
                                         check=name == "as_built")
                    cs._say("decode_variant", round=rnd, variant=name,
                            kernel=arm, timing=shape, ms=t["ms"],
                            split_ms=t["split_ms"],
                            bound_share=t["bound_share"],
                            max_abs_err=t["max_abs_err"])
                    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
