"""Build and bind the port's CUDA kernels.

Each source under ``paddle_tpu_torch/csrc/`` exports a plain C function
and is compiled on its own by ``nvcc`` for ``sm_90a`` into a shared
library, loaded with ``ctypes``. Nothing includes PyTorch's headers, so a
build takes seconds. Libraries land in ``build/kernels/`` at the repo
root (listed in ``.gitignore``), named by a hash of source, shared
headers and flags, so an edited source is rebuilt and an unchanged one is
reused. The build runs at first use; ``build_all`` starts one ``nvcc`` per
source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from ..core import enforce as E

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "paged_decode": "paged_decode.cu", "rms_norm": "rms_norm.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    E.enforce(found is not None, "nvcc not found; the CUDA kernels cannot "
              "be built", error=E.UnavailableError,
              hint="set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers
    beside it (``csrc/*.cuh``) and the flags."""
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` process per source, all started together. Returns the wall
    seconds of each compile that ran (an empty dict when all were
    cached). Raises with the compiler's output when a compile fails; the
    ``ptxas`` register and spill report is kept beside each library as
    ``<lib>.log``."""
    todo = [n for n in (SOURCES if names is None else names)
            if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)      # atomic: a concurrent loader never
        #                           sees a half-written library
    E.enforce(not failed, "kernel build failed:\n" + "\n".join(failed),
              error=E.UnavailableError)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def check_launch(name: str, err: int):
    """Raise when a kernel's C entry returned a CUDA error (its
    ``cudaGetLastError`` right after the launch)."""
    E.enforce(err == 0, f"CUDA kernel {name} failed to launch: "
              f"cudaError {err}", error=E.UnavailableError)


def check_device(t, what: str):
    """The kernels are built for ``sm_90a`` only: raise on another card."""
    major, minor = torch.cuda.get_device_capability(t.device)
    E.enforce(major == 9, f"{what}: the CUDA kernels are built for "
              f"sm_90a (Hopper); device {t.device} has capability "
              f"{major}.{minor}", error=E.UnavailableError)
