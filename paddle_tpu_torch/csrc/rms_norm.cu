// RMSNorm forward and backward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/rms_norm.py _fwd_kernel (rms_norm.py:48,
// launched by _call_fwd; entry rms_norm_fwd) and _bwd_kernel
// (rms_norm.py:55, launched by _rms_bwd; entries rms_norm_bwd and
// rms_norm_dw), the Pallas TPU kernels behind nn.RMSNorm / F.rms_norm on
// the eager Llama path.
//
// Computes, for rows x [n, d] and a weight w [d]:
//   forward:  r = rsqrt(mean(x * x) + eps), y = (x * r * w) in float32,
//             cast once to x's type; rstd [n] = r (float32), saved for the
//             backward;
//   backward: g = dy * w, dx = r * g - x * r^3 * mean(g * x) (float32,
//             cast to x's type), dw = sum over rows of dy * x * r (float32,
//             cast to w's type).
// x, y, dy and dx share one type; w and dw share one; either is float32,
// bfloat16 or float16, in any pair (the Pallas kernels keep any float
// type).
//
// Bound on the H100: a handful of flops per element against 2 (bf16) or 4
// (f32) bytes, so both passes are bounded by device-memory traffic: the
// forward reads x and writes y (plus w and rstd), the backward reads x
// and dy and writes dx (plus w, rstd and dw), at 3.35 TB/s. Each of those
// is read once from device memory.
//
// Forward: one block per row. A first sweep sums x * x in float32 with
// 16-byte loads (8 values a thread and step) and one block reduction; a
// second sweep reads the row again (from L1 / L2: one row is at most
// 64 KB) and writes y.
//
// Backward, "bulk" route (d % 8 == 0, 16-byte aligned pointers). To run
// at the memory's rate an SM must keep ~20 KB of loads in flight at all
// times (Little's law at 3.35 TB/s), which a block that loads a row,
// reduces it across a block barrier and loads it again cannot do. So:
// - a persistent grid, one block an SM (plan from the wrapper), each
//   block `groups` row groups of `threads` threads (a multiple of 32);
//   row group q of Q takes rows q, q + Q, q + 2Q, ... in order;
// - each row group has a ring of `stages` row stages in shared memory
//   (the x row, then the dy row). Its thread 0 fills a stage with two
//   1-D TMA bulk copies completing on the stage's mbarrier, so the next
//   rows are on their way while this one is reduced: at d 4096 bf16,
//   4 groups x 3 stages x 16 KB, up to 192 KB in flight an SM;
// - a row is read once from device memory: the reduction's sweep and the
//   dx sweep both read the stage. The reduction is over the row group
//   alone (warp shuffles, then a named barrier, bar.sync 1 + group), so
//   the rows of one block never wait on each other; a second named
//   barrier frees the stage, which thread 0 refills at once;
// - each thread owns the same 8-value column chunks (t, t + threads, ...;
//   at most 4) of every row it takes, so w (float32) and the dw
//   accumulator live in registers. At the end the groups' accumulators
//   meet in shared memory and the block writes one float32 partial row,
//   the groups added in order.
// Backward, "scalar" route (any other d or alignment): one block per
// strided run of rows, one scalar value a thread and step, w and the dw
// accumulator in shared memory, each row read twice. Both routes end in
// rms_norm_dw: a block per 32 columns, 8 warps each adding the partial
// rows w, w + 8, ... in order, then the 8 warp sums in order. No
// atomics: dw is the same bit for bit from launch to launch. The TPU
// kernel accumulated dw in one resident VMEM block over a sequential
// grid; Hopper's blocks run in parallel and in no order, hence the
// partials and the second pass.
//
// Layout: contiguous row-major x / y / dy / dx [n, d]; rstd float32 [n];
// w / dw [d]; partials float32 [grid, d]. 1 <= d <= 16384.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

using hopper::bar_sync;
using hopper::mbar_expect_tx;
using hopper::mbar_fence_init;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int MAX_D = 16384;
constexpr int MAX_THREADS = 256;
constexpr int CH = 8;        // values a thread takes per step (16 bytes bf16)
// the bulk route's limits: threads a block, row groups a block (named
// barriers 1..8), ring stages a group, 8-value chunks a thread
constexpr int BULK_THREADS = 512;
constexpr int MAX_GROUPS = 8;
constexpr int MAX_STAGES = 4;
constexpr int MAX_V = 4;
constexpr int DW_WARPS = 8;  // rms_dw_kernel: warps a block, one column each lane

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);       // round to nearest even, as torch's cast
}
__device__ __forceinline__ void from_f(__half* p, float v) {
  *p = __float2half(v);
}

// N values from p into v: 8 through 16-byte loads (p 16-byte aligned),
// or 1 scalar.
template <int N>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (N == CH) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (N == CH) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int N>
__device__ __forceinline__ void load(const __half* p, float* v) {
  if constexpr (N == CH) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    v[0] = __half2float(*p);
  }
}

template <int N>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (N == CH) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *p = v[0];
  }
}

template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (N == CH) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2bfloat16(v[0]);
  }
}

template <int N>
__device__ __forceinline__ void store(__half* p, const float* v) {
  if constexpr (N == CH) {
    uint4 u;
    __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2half(v[0]);
  }
}

// The block's total of v, returned to every thread; red holds one float
// per warp. The warps' sums are added in warp order, so every thread (and
// every launch) gets the same bits.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warps = blockDim.x / 32;
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < warps; ++i) s += red[i];
  __syncthreads();              // red is reused by the next call
  return s;
}

// One block per row. N: values a thread takes per step (CH or 1).
template <typename TX, typename TW, int N>
__global__ void __launch_bounds__(MAX_THREADS)
rms_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ y, float* __restrict__ rstd, int d,
               float eps) {
  __shared__ float red[MAX_THREADS / 32];
  const int64_t row = blockIdx.x;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;
  const int step = blockDim.x * N;

  float s = 0.f;
  for (int c = threadIdx.x * N; c < d; c += step) {
    float v[N];
    load<N>(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) s += v[i] * v[i];
  }
  const float r = rsqrtf(block_sum(s, red) / float(d) + eps);
  for (int c = threadIdx.x * N; c < d; c += step) {
    float v[N], wv[N];
    load<N>(xr + c, v);
    load<N>(w + c, wv);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = v[i] * r * wv[i];
    store<N>(yr + c, v);
  }
  if (threadIdx.x == 0) rstd[row] = r;
}

// `bytes` (a multiple of 16) from global src to shared dst (both 16-byte
// aligned) by one TMA bulk copy, completing on the mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The bulk route. Block: `groups` row groups of `threads` threads; V:
// 8-value chunks a thread owns (ceil(d / 8 / threads)). Dynamic shared
// memory: groups x stages x (x row, dy row).
template <typename TX, typename TW, int V>
__global__ void __launch_bounds__(BULK_THREADS, 1)
rms_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               const float* __restrict__ rstd, const TX* __restrict__ dy,
               TX* __restrict__ dx, float* __restrict__ part, int n, int d,
               int threads, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MAX_GROUPS * MAX_STAGES];
  __shared__ float red[MAX_GROUPS][BULK_THREADS / 32];
  const int groups = blockDim.x / threads;
  const int g = threadIdx.x / threads;      // uniform over each warp
  const int t = threadIdx.x % threads;
  const int chunks = d / CH;
  const uint32_t row_bytes = uint32_t(d) * sizeof(TX);
  const uint32_t stage_bytes = 2 * row_bytes;
  const uint32_t ring = smem_u32(smem) + uint32_t(g) * stages * stage_bytes;
  const unsigned char* mine = smem + size_t(g) * stages * stage_bytes;
  const int64_t q = int64_t(blockIdx.x) * groups + g;
  const int64_t nq = int64_t(gridDim.x) * groups;
  const int rows = q < n ? int((n - 1 - q) / nq + 1) : 0;
  const uint32_t bar0 = smem_u32(&full[g * MAX_STAGES]);

  if (t == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s, 1);
    mbar_fence_init();
  }
  float wv[V][CH], acc[V][CH];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = t + j * threads;
    if (c < chunks) {
      load<CH>(w + c * CH, wv[j]);
    } else {
#pragma unroll
      for (int i = 0; i < CH; ++i) wv[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) acc[j][i] = 0.f;
  }
  __syncthreads();            // the mbarriers are initialised

  // the k-th row of this group into stage k % stages
  auto fetch = [&](int k) {
    const int s = k % stages;
    const int64_t row = q + k * nq;
    const uint32_t bar = bar0 + 8 * s;
    mbar_expect_tx(bar, stage_bytes);
    bulk_load(ring + s * stage_bytes, x + row * d, row_bytes, bar);
    bulk_load(ring + s * stage_bytes + row_bytes, dy + row * d, row_bytes,
              bar);
  };
  if (t == 0)
    for (int k = 0; k < stages && k < rows; ++k) fetch(k);

  for (int k = 0; k < rows; ++k) {
    const int s = k % stages;
    const int64_t row = q + k * nq;
    const float r = rstd[row];
    const TX* xs = reinterpret_cast<const TX*>(mine + s * stage_bytes);
    const TX* dys = reinterpret_cast<const TX*>(mine + s * stage_bytes +
                                                row_bytes);
    mbar_wait(bar0 + 8 * s, (k / stages) & 1);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = t + j * threads;
      if (c < chunks) {
        float xv[CH], dv[CH];
        load<CH>(xs + c * CH, xv);
        load<CH>(dys + c * CH, dv);
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          sum += (dv[i] * wv[j][i]) * xv[i];
          acc[j][i] += dv[i] * xv[i] * r;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (t % 32 == 0) red[g][t / 32] = sum;
    bar_sync(1 + g, threads);
    float tot = 0.f;
    for (int i = 0; i < threads / 32; ++i) tot += red[g][i];
    const float mean_gx = tot / float(d);
    const float r3 = r * r * r;
    TX* dxr = dx + row * d;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = t + j * threads;
      if (c < chunks) {
        float xv[CH], dv[CH], out[CH];
        load<CH>(xs + c * CH, xv);
        load<CH>(dys + c * CH, dv);
#pragma unroll
        for (int i = 0; i < CH; ++i)
          out[i] = r * (dv[i] * wv[j][i]) - xv[i] * r3 * mean_gx;
        store<CH>(dxr + c * CH, out);
      }
    }
    // every thread is done with stage s and with red
    bar_sync(1 + g, threads);
    if (t == 0 && k + stages < rows) fetch(k + stages);
  }

  // the groups' accumulators meet in the (now idle) rings, group g's at
  // float offset g * d: each group's ring holds at least 4 * d bytes
  __syncthreads();
  float* accs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = t + j * threads;
    if (c < chunks) store<CH>(accs + size_t(g) * d + c * CH, acc[j]);
  }
  __syncthreads();
  float* pr = part + int64_t(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < groups; ++i) s += accs[size_t(i) * d + c];
    pr[c] = s;
  }
}

// The scalar route: block b takes rows b, b + grid, ...; one value a
// thread and step. Dynamic shared memory: w as float32 [d], then the
// block's dw accumulator [d]; each thread stages and accumulates only
// the columns it reads, so neither needs a barrier.
template <typename TX, typename TW>
__global__ void __launch_bounds__(MAX_THREADS)
rms_bwd_scalar_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      const float* __restrict__ rstd,
                      const TX* __restrict__ dy, TX* __restrict__ dx,
                      float* __restrict__ part, int n, int d) {
  extern __shared__ float sm[];
  __shared__ float red[MAX_THREADS / 32];
  float* ws = sm;
  float* acc = sm + d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    load<1>(w + c, ws + c);
    acc[c] = 0.f;
  }
  for (int64_t row = blockIdx.x; row < n; row += gridDim.x) {
    const TX* xr = x + row * d;
    const TX* dyr = dy + row * d;
    TX* dxr = dx + row * d;
    const float r = rstd[row];
    float s = 0.f;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float xv, gv;
      load<1>(xr + c, &xv);
      load<1>(dyr + c, &gv);
      s += (gv * ws[c]) * xv;
    }
    const float mean_gx = block_sum(s, red) / float(d);
    const float r3 = r * r * r;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float xv, dv;
      load<1>(xr + c, &xv);
      load<1>(dyr + c, &dv);
      from_f(dxr + c, r * (dv * ws[c]) - xv * r3 * mean_gx);
      acc[c] += dv * xv * r;
    }
  }
  float* pr = part + int64_t(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) pr[c] = acc[c];
}

// dw[j] = sum over the nb partial rows of part[., j]: warp k of a block
// adds rows k, k + 8, ... in order, then the 8 warp sums are added in
// order; cast to w's type.
template <typename TW>
__global__ void __launch_bounds__(DW_WARPS * 32)
rms_dw_kernel(const float* __restrict__ part, TW* __restrict__ dw, int nb,
              int d) {
  __shared__ float red[DW_WARPS][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < d) {
#pragma unroll 4
    for (int b = warp; b < nb; b += DW_WARPS) s += part[int64_t(b) * d + j];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < DW_WARPS; ++i) t += red[i][lane];
    from_f(dw + j, t);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int threads_for(int d, int n_per_thread_step) {
  const int chunks = (d + n_per_thread_step - 1) / n_per_thread_step;
  const int t = ((chunks + 31) / 32) * 32;
  return t < 32 ? 32 : (t > MAX_THREADS ? MAX_THREADS : t);
}

template <typename TX, typename TW>
int launch_fwd(const void* x, const void* w, void* y, float* rstd, int n,
               int d, float eps, bool vec, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* yp = static_cast<TX*>(y);
  if (vec) {
    rms_fwd_kernel<TX, TW, CH><<<n, threads_for(d, CH), 0, st>>>(
        xp, wp, yp, rstd, d, eps);
  } else {
    rms_fwd_kernel<TX, TW, 1><<<n, threads_for(d, 1), 0, st>>>(
        xp, wp, yp, rstd, d, eps);
  }
  return cudaGetLastError();
}

// Lets the kernel take `smem` bytes of dynamic shared memory. Always
// set: past 48 KB of static and dynamic memory together a launch needs
// it, and the kernels' static arrays count towards those 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

struct Plan {
  int grid, groups, threads, stages;   // stages 0: the scalar route
};

template <typename TX, typename TW, int V>
int launch_bulk(const TX* x, const TW* w, const float* rstd, const TX* dy,
                TX* dx, float* part, int n, int d, Plan p,
                cudaStream_t st) {
  const size_t smem = size_t(p.groups) * p.stages * 2 * d * sizeof(TX);
  auto kernel = rms_bwd_kernel<TX, TW, V>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<p.grid, p.groups * p.threads, smem, st>>>(
      x, w, rstd, dy, dx, part, n, d, p.threads, p.stages);
  return cudaGetLastError();
}

template <typename TX, typename TW>
int launch_bwd(const void* x, const void* w, const float* rstd,
               const void* dy, void* dx, float* part, int n, int d, Plan p,
               cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const TX* dyp = static_cast<const TX*>(dy);
  TX* dxp = static_cast<TX*>(dx);
  if (p.stages == 0) {
    const size_t smem = size_t(2) * d * sizeof(float);
    auto kernel = rms_bwd_scalar_kernel<TX, TW>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<p.grid, threads_for(d, 1), smem, st>>>(xp, wp, rstd, dyp, dxp,
                                                    part, n, d);
    return cudaGetLastError();
  }
  switch ((d / CH + p.threads - 1) / p.threads) {
    case 1: return launch_bulk<TX, TW, 1>(xp, wp, rstd, dyp, dxp, part, n,
                                          d, p, st);
    case 2: return launch_bulk<TX, TW, 2>(xp, wp, rstd, dyp, dxp, part, n,
                                          d, p, st);
    case 3: return launch_bulk<TX, TW, 3>(xp, wp, rstd, dyp, dxp, part, n,
                                          d, p, st);
    default: return launch_bulk<TX, TW, 4>(xp, wp, rstd, dyp, dxp, part, n,
                                           d, p, st);
  }
}

bool bad_shape(int n, int d) { return n < 1 || d < 1 || d > MAX_D; }

// Whether the bulk route takes plan p: whole 16-byte chunks and aligned
// rows, at most MAX_V chunks a thread, the rings within shared memory.
bool bulk_ok(const Plan& p, int d, int esize, const void* const* ptrs) {
  for (int i = 0; i < 4; ++i)
    if (!aligned16(ptrs[i])) return false;
  const size_t smem = size_t(p.groups) * p.stages * 2 * d * esize;
  return d % CH == 0 && p.threads >= 32 && p.threads % 32 == 0 &&
         p.groups >= 1 && p.groups <= MAX_GROUPS &&
         p.groups * p.threads <= BULK_THREADS && p.stages <= MAX_STAGES &&
         (d / CH + p.threads - 1) / p.threads <= MAX_V &&
         smem + sizeof(uint64_t) * MAX_GROUPS * MAX_STAGES +
                 sizeof(float) * MAX_GROUPS * (BULK_THREADS / 32) <=
             size_t(hopper::MAX_SMEM);
}

bool bad_dtype(int dtype) { return dtype < 0 || dtype > 2; }

// f(tag) with a null pointer of the type of code dtype (0 = float32,
// 1 = bfloat16, 2 = float16) as tag
template <typename F>
int with_type(int dtype, F&& f) {
  if (dtype == 0) return f(static_cast<float*>(nullptr));
  if (dtype == 1) return f(static_cast<__nv_bfloat16*>(nullptr));
  return f(static_cast<__half*>(nullptr));
}

}  // namespace

// x / y: xdtype, w: wdtype (0 = float32, 1 = bfloat16, 2 = float16);
// rstd float32 [n].
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y,
                            void* rstd, int n, int d, float eps, int xdtype,
                            int wdtype, void* stream) {
  if (bad_shape(n, d) || bad_dtype(xdtype) || bad_dtype(wdtype))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rs = static_cast<float*>(rstd);
  const bool vec = d % CH == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(y);
  return with_type(xdtype, [&](auto* tx) {
    return with_type(wdtype, [&](auto* tw) {
      using TX = std::remove_pointer_t<decltype(tx)>;
      using TW = std::remove_pointer_t<decltype(tw)>;
      return launch_fwd<TX, TW>(x, w, y, rs, n, d, eps, vec, st);
    });
  });
}

// dx from x, w, rstd and dy (dy / dx: xdtype), and one float32 partial dw
// row a block into part [grid, d]; follow with rms_norm_dw. The plan:
// stages >= 1 takes the bulk route (grid blocks of groups x threads, a
// ring of stages a group), stages == 0 the scalar route (grid blocks).
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* rstd,
                            const void* dy, void* dx, void* part, int n,
                            int d, int xdtype, int wdtype, int grid,
                            int groups, int threads, int stages,
                            void* stream) {
  if (bad_shape(n, d) || grid < 1 || stages < 0 || bad_dtype(xdtype) ||
      bad_dtype(wdtype))
    return cudaErrorInvalidValue;
  const Plan p{grid, groups, threads, stages};
  const void* ptrs[4] = {x, w, dy, dx};
  if (stages > 0 && !bulk_ok(p, d, xdtype == 0 ? 4 : 2, ptrs))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rs = static_cast<const float*>(rstd);
  float* pp = static_cast<float*>(part);
  return with_type(xdtype, [&](auto* tx) {
    return with_type(wdtype, [&](auto* tw) {
      using TX = std::remove_pointer_t<decltype(tx)>;
      using TW = std::remove_pointer_t<decltype(tw)>;
      return launch_bwd<TX, TW>(x, w, rs, dy, dx, pp, n, d, p, st);
    });
  });
}

// dw [d] (wdtype) = the column sums of part float32 [nb, d], in a fixed
// order.
extern "C" int rms_norm_dw(const void* part, void* dw, int nb, int d,
                           int wdtype, void* stream) {
  if (nb < 1 || d < 1 || bad_dtype(wdtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(part);
  const int blocks = (d + 31) / 32;
  return with_type(wdtype, [&](auto* tw) {
    using TW = std::remove_pointer_t<decltype(tw)>;
    rms_dw_kernel<TW><<<blocks, DW_WARPS * 32, 0, st>>>(
        pp, static_cast<TW*>(dw), nb, d);
    return int(cudaGetLastError());
  });
}
