"""The op library's card phases alone, on one H100: build the kernels,
run ``chip_smoke.py``'s ``[ops]`` (every registered op, card against CPU)
and ``[ops_block]`` (the op-built Llama layer against ``_block``), then
the op library's card tests.

    python3 scripts/torch_ops_phases.py
"""
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as CS  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_ops_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print("card", smi, flush=True)
    t0 = time.perf_counter()
    print("build", _build.build_all(), round(time.perf_counter() - t0, 1),
          flush=True)
    t0 = time.perf_counter()
    CS.phase_ops(torch, dev, smi)
    print("ops_s", round(time.perf_counter() - t0, 1), flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    print("ops_block", CS.phase_ops_block(torch, dev, smi), flush=True)
    print("ops_block_s", round(time.perf_counter() - t0, 1), flush=True)
    r = subprocess.run([sys.executable, "-m", "pytest",
                        "tests/test_torch_cuda.py", "-m", "cuda", "-q",
                        "-p", "no:cacheprovider", "-k",
                        "op_library or op_built"], cwd=ROOT)
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
