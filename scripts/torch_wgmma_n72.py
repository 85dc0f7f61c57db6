"""One ``wgmma`` product at N = 72 on the card, the tensor-core flash
kernels' N = D product at head dim 72 (``csrc/hopper_mma.cuh``).

A warpgroup computes ``D [64, 72] = A [64, 16] . B [16, 72]`` with A
from registers and B as an MN-major operand in shared memory, stored as
the flash kernels store a tile of 128 columns: two 64-column blocks of
128-byte rows under the 128-byte swizzle, columns 72-127 holding NaN, so
that a product reading past column 71 shows. Two ways are held to
``A.float() @ B.float()``:

- ``n72``: one ``m64n72k16`` (``wgmma_rs<72>``), the first block whole
  and 8 columns of the second, one leading offset on;
- ``n64+n8``: ``m64n64k16`` on the first block and ``m64n8k16`` on the
  second.

Needs the card and ``nvcc``; builds into ``build/probe/``. Prints one
line a way and the card's name and power limit, and exits 1 when a way
that the kernels use disagrees::

    python3 scripts/torch_wgmma_n72.py
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "paddle_tpu_torch" / "csrc"
OUT = ROOT / "build" / "probe"

SOURCE = r"""
#include "hopper_mma.cuh"
using namespace hopper;

__device__ __forceinline__ void wgmma_rs8(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <bool SPLIT>
__global__ void __launch_bounds__(128) probe(const __nv_bfloat16* A,
                                             const __nv_bfloat16* B,
                                             float* D) {
  __shared__ __align__(1024) uint8_t tile[2 * 16 * 128];
  const int tid = threadIdx.x;
  for (int idx = tid; idx < 16 * 16; idx += 128) {   // 16 rows, 16 chunks
    const int r = idx / 16, c = idx % 16;
    __nv_bfloat16* dst =
        reinterpret_cast<__nv_bfloat16*>(tile + tile_offset<16>(r, c));
    for (int e = 0; e < 8; ++e) {
      const int col = 8 * c + e;
      dst[e] = col < 72 ? B[r * 72 + col] : __float2bfloat16(NAN);
    }
  }
  fence_proxy_async();
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  auto pair = [&](int r, int c) {
    return pack_bf16(__bfloat162float(A[r * 16 + c]),
                     __bfloat162float(A[r * 16 + c + 1]));
  };
  const uint32_t a[4] = {pair(r0, c0), pair(r0 + 8, c0), pair(r0, c0 + 8),
                         pair(r0 + 8, c0 + 8)};
  const uint32_t t = smem_u32(tile);
  float d[36];
  for (int i = 0; i < 36; ++i) d[i] = 0.f;
  if constexpr (SPLIT) {
    float lo[32], hi[4];
    for (int i = 0; i < 32; ++i) lo[i] = 0.f;
    for (int i = 0; i < 4; ++i) hi[i] = 0.f;
    fence_regs(lo);
    fence_regs(hi);
    wgmma_fence();
    wgmma_rs<64, __nv_bfloat16>(lo, a, desc_mn<16>(t, 0), 0);
    wgmma_rs8(hi, a, make_desc(t + 16 * 128, 16 * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(lo);
    fence_regs(hi);
    for (int i = 0; i < 32; ++i) d[i] = lo[i];
    for (int i = 0; i < 4; ++i) d[32 + i] = hi[i];
  } else {
    fence_regs(d);
    wgmma_fence();
    wgmma_rs<72, __nv_bfloat16>(d, a, desc_mn<16>(t, 0), 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
  }
  for (int i = 0; i < 36; ++i) {
    const int row = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    D[row * 72 + col] = d[i];
  }
}

extern "C" int run_probe(const void* A, const void* B, void* D, int split,
                         void* stream) {
  const auto* a = static_cast<const __nv_bfloat16*>(A);
  const auto* b = static_cast<const __nv_bfloat16*>(B);
  auto* d = static_cast<float*>(D);
  auto s = static_cast<cudaStream_t>(stream);
  if (split) probe<true><<<1, 128, 0, s>>>(a, b, d);
  else probe<false><<<1, 128, 0, s>>>(a, b, d);
  return cudaGetLastError();
}
"""


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("torch_wgmma_n72: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib_path = OUT / "wgmma_n72.cu", OUT / "libwgmma_n72.so"
    src.write_text(SOURCE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-I", str(CSRC), "-o",
                    str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                      ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(64, 16, generator=g, device=dev).bfloat16()
    b = torch.randn(16, 72, generator=g, device=dev).bfloat16()
    want = a.float() @ b.float()
    bad = 0
    for split, name in ((0, "n72"), (1, "n64+n8")):
        d = torch.full((64, 72), float("nan"), device=dev)
        err = lib.run_probe(a.data_ptr(), b.data_ptr(), d.data_ptr(), split,
                            torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        ok = err == 0 and bool(torch.isfinite(d).all())
        diff = float((d - want).abs().max()) if ok else float("nan")
        ok = ok and diff <= 1e-5 * float(want.abs().max())
        bad += split == 0 and not ok
        print(f"[wgmma_n72] way={name} launch_err={err} finite="
              f"{bool(torch.isfinite(d).all())} max_abs_err={diff} ok={ok}",
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
