// RMSNorm forward and backward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/rms_norm.py _fwd_kernel (launched by
// _call_fwd; entry rms_norm_fwd) and _bwd_kernel (launched by _rms_bwd;
// entries rms_norm_bwd and rms_norm_dw), the Pallas TPU kernels behind
// nn.RMSNorm / F.rms_norm on the eager Llama path.
//
// Computes, for rows x [n, d] and a weight w [d]:
//   forward:  r = rsqrt(mean(x * x) + eps), y = (x * r * w) in float32,
//             cast once to x's type; rstd [n] = r (float32), saved for the
//             backward;
//   backward: g = dy * w, dx = r * g - x * r^3 * mean(g * x) (float32,
//             cast to x's type), dw = sum over rows of dy * x * r (float32,
//             cast to w's type).
// x, y, dy and dx share one type; w and dw share one; either is float32
// or bfloat16, in any pair.
//
// Bound on the H100: a handful of flops per element against 2 (bf16) or 4
// (f32) bytes, so both passes are bounded by device-memory traffic: the
// forward reads x and writes y (plus w and rstd), the backward reads x
// and dy and writes dx (plus w, rstd and dw), at 3.35 TB/s. The design
// reads each of those once from device memory:
// - forward: one block per row. A first sweep sums x * x in float32 with
//   16-byte loads (8 values a thread and step) and one block reduction; a
//   second sweep reads the row again (from L1 / L2: one row is at most
//   64 KB) and writes y;
// - backward: one block owns a fixed run of `rows` consecutive rows. It
//   keeps w (float32) and a per-column dw accumulator in shared memory;
//   each thread owns the same columns in every row, so neither needs a
//   barrier. Per row: one sweep for mean(g * x) (one block reduction), a
//   second for dx and the dw accumulation. The block writes its partial
//   dw row to a float32 scratch [n_blocks, d]; rms_norm_dw then sums each
//   column over the blocks in block order and casts to w's type. No
//   atomics: dw is the same bit for bit from launch to launch.
// The TPU kernel accumulated dw in one resident VMEM block over a
// sequential grid; Hopper's blocks run in parallel and in no order, hence
// the scratch and the second pass.
//
// Layout: contiguous row-major x / y / dy / dx [n, d]; rstd float32 [n];
// w / dw [d]; scratch float32 [n_blocks, d], n_blocks = ceil(n / rows).
// 1 <= d <= 16384 (the backward keeps 8 * d bytes in shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 16384;
constexpr int MAX_THREADS = 256;
constexpr int CH = 8;        // values a thread takes per step (16 bytes bf16)

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);       // round to nearest even, as torch's cast
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

// One block per run of `rows` rows; dynamic shared memory: w as float32
// [d], then the block's dw accumulator [d].
template <typename TX, typename TW, int N>
__global__ void __launch_bounds__(MAX_THREADS)
rms_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               const float* __restrict__ rstd, const TX* __restrict__ dy,
               TX* __restrict__ dx, float* __restrict__ part, int n, int d,
               int rows) {
  extern __shared__ float smem[];
  __shared__ float red[MAX_THREADS / 32];
  float* ws = smem;
  float* acc = smem + d;
  const int step = blockDim.x * N;
  // each thread stages and accumulates only the columns it reads below,
  // so no barrier is needed before or after
  for (int c = threadIdx.x * N; c < d; c += step) {
    float wv[N];
    load<N>(w + c, wv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      ws[c + i] = wv[i];
      acc[c + i] = 0.f;
    }
  }
  const int64_t r0 = int64_t(blockIdx.x) * rows;
  const int64_t r1 = r0 + rows < n ? r0 + rows : int64_t(n);
  for (int64_t row = r0; row < r1; ++row) {
    const TX* xr = x + row * d;
    const TX* dyr = dy + row * d;
    TX* dxr = dx + row * d;
    const float r = rstd[row];
    float s = 0.f;
    for (int c = threadIdx.x * N; c < d; c += step) {
      float xv[N], gv[N];
      load<N>(xr + c, xv);
      load<N>(dyr + c, gv);
#pragma unroll
      for (int i = 0; i < N; ++i) s += (gv[i] * ws[c + i]) * xv[i];
    }
    const float mean_gx = block_sum(s, red) / float(d);
    const float r3 = r * r * r;
    for (int c = threadIdx.x * N; c < d; c += step) {
      float xv[N], dv[N], out[N];
      load<N>(xr + c, xv);
      load<N>(dyr + c, dv);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float g = dv[i] * ws[c + i];
        out[i] = r * g - xv[i] * r3 * mean_gx;
        acc[c + i] += dv[i] * xv[i] * r;
      }
      store<N>(dxr + c, out);
    }
  }
  float* pr = part + int64_t(blockIdx.x) * d;
  for (int c = threadIdx.x * N; c < d; c += step) {
#pragma unroll
    for (int i = 0; i < N; ++i) pr[c + i] = acc[c + i];
  }
}

// dw[j] = sum over blocks b, in order, of part[b, j]; cast to w's type.
template <typename TW>
__global__ void rms_dw_kernel(const float* __restrict__ part,
                              TW* __restrict__ dw, int nb, int d) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += part[int64_t(b) * d + j];
  from_f(dw + j, s);
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

template <typename TX, typename TW, int N>
int launch_bwd_n(const TX* x, const TW* w, const float* rstd, const TX* dy,
                 TX* dx, float* part, int n, int d, int rows,
                 cudaStream_t st) {
  const size_t smem = size_t(2) * d * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rms_bwd_kernel<TX, TW, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const int nb = (n + rows - 1) / rows;
  rms_bwd_kernel<TX, TW, N><<<nb, threads_for(d, N), smem, st>>>(
      x, w, rstd, dy, dx, part, n, d, rows);
  return cudaGetLastError();
}

template <typename TX, typename TW>
int launch_bwd(const void* x, const void* w, const float* rstd,
               const void* dy, void* dx, float* part, int n, int d, int rows,
               bool vec, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const TX* dyp = static_cast<const TX*>(dy);
  TX* dxp = static_cast<TX*>(dx);
  if (vec)
    return launch_bwd_n<TX, TW, CH>(xp, wp, rstd, dyp, dxp, part, n, d,
                                    rows, st);
  return launch_bwd_n<TX, TW, 1>(xp, wp, rstd, dyp, dxp, part, n, d, rows,
                                 st);
}

bool bad_shape(int n, int d) { return n < 1 || d < 1 || d > MAX_D; }

}  // namespace

// x / y: xdtype, w: wdtype (0 = float32, 1 = bfloat16); rstd float32 [n].
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y,
                            void* rstd, int n, int d, float eps, int xdtype,
                            int wdtype, void* stream) {
  if (bad_shape(n, d) || xdtype < 0 || xdtype > 1 || wdtype < 0 ||
      wdtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rs = static_cast<float*>(rstd);
  const bool vec = d % CH == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(y);
  if (xdtype == 0 && wdtype == 0)
    return launch_fwd<float, float>(x, w, y, rs, n, d, eps, vec, st);
  if (xdtype == 0)
    return launch_fwd<float, __nv_bfloat16>(x, w, y, rs, n, d, eps, vec, st);
  if (wdtype == 0)
    return launch_fwd<__nv_bfloat16, float>(x, w, y, rs, n, d, eps, vec, st);
  return launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, w, y, rs, n, d, eps,
                                                  vec, st);
}

// dx from x, w, rstd and dy (dy / dx: xdtype), and the per-block dw
// partials into part float32 [ceil(n / rows), d]; follow with rms_norm_dw.
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* rstd,
                            const void* dy, void* dx, void* part, int n,
                            int d, int rows, int xdtype, int wdtype,
                            void* stream) {
  if (bad_shape(n, d) || rows < 1 || xdtype < 0 || xdtype > 1 ||
      wdtype < 0 || wdtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rs = static_cast<const float*>(rstd);
  float* pp = static_cast<float*>(part);
  const bool vec = d % CH == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(dy) && aligned16(dx);
  if (xdtype == 0 && wdtype == 0)
    return launch_bwd<float, float>(x, w, rs, dy, dx, pp, n, d, rows, vec,
                                    st);
  if (xdtype == 0)
    return launch_bwd<float, __nv_bfloat16>(x, w, rs, dy, dx, pp, n, d,
                                            rows, vec, st);
  if (wdtype == 0)
    return launch_bwd<__nv_bfloat16, float>(x, w, rs, dy, dx, pp, n, d,
                                            rows, vec, st);
  return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, rs, dy, dx, pp, n,
                                                  d, rows, vec, st);
}

// dw [d] (wdtype) = the column sums of part float32 [nb, d], in block
// order.
extern "C" int rms_norm_dw(const void* part, void* dw, int nb, int d,
                           int wdtype, void* stream) {
  if (nb < 1 || d < 1 || wdtype < 0 || wdtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(part);
  const int threads = 256;
  const int blocks = (d + threads - 1) / threads;
  if (wdtype == 0)
    rms_dw_kernel<float><<<blocks, threads, 0, st>>>(
        pp, static_cast<float*>(dw), nb, d);
  else
    rms_dw_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        pp, static_cast<__nv_bfloat16*>(dw), nb, d);
  return cudaGetLastError();
}
