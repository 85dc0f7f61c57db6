#!/usr/bin/env python3
"""The raw rates of the file system that holds the temporary directory,
the ceiling for a checkpoint's save and load: 4 GiB written in 64 MiB
writes, read back sequentially and in 64 MiB ranges on 4 and 8 threads,
and one core's CRC32 rate (the reads are warm: the file was just
written):

    python3 scripts/torch_ckpt_probe.py

Prints the card's name and power limit first (``nvidia-smi``), then one
``[disk]`` line.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

CHUNK = 1 << 26
CHUNKS = 64                     # 4 GiB


def disk_rates():
    """``{write, read, read_4, read_8, crc}`` in GB/s under the temporary
    directory (the file removed after)."""
    buf = os.urandom(CHUNK)
    fd, path = tempfile.mkstemp(prefix="ckpt_probe_")
    os.close(fd)
    total = CHUNK * CHUNKS
    out = {}
    try:
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            for _ in range(CHUNKS):
                f.write(buf)
        out["write"] = total / (time.perf_counter() - t0) / 1e9
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            while f.read(CHUNK):
                pass
        out["read"] = total / (time.perf_counter() - t0) / 1e9
        fd = os.open(path, os.O_RDONLY)
        try:
            for threads in (4, 8):
                t0 = time.perf_counter()
                with ThreadPoolExecutor(threads) as pool:
                    list(pool.map(lambda off: os.pread(fd, CHUNK, off),
                                  range(0, total, CHUNK)))
                out[f"read_{threads}"] = total / (time.perf_counter()
                                                  - t0) / 1e9
        finally:
            os.close(fd)
    finally:
        os.remove(path)
    t0 = time.perf_counter()
    zlib.crc32(buf)
    out["crc"] = CHUNK / (time.perf_counter() - t0) / 1e9
    return out


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    print("[disk] " + " ".join(f"{k}_gb_per_s={v:.3f}"
                               for k, v in disk_rates().items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
