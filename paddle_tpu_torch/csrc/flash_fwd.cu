// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/flash_attention.py _fwd_kernel (launched by
// _fwd), the Pallas TPU kernel every prefill attention reaches through
// sdpa_raw.
//
// Computes, per (batch, query head), out = softmax(q k^T * scale) v with an
// online softmax over key tiles, float32 accumulation, GQA (query head h
// reads kv head h / (H / KVH)) and the bottom-right-aligned causal mask
// (query row r sees keys c <= r + Sk - Sq). Also writes the log-sum-exp
// lse[b, h, r] = m + log(l) that the backward will read. A row that sees
// no key gets a zero output and lse = -inf. Any Sq / Sk works: the ragged
// edge is masked, not required to divide a tile.
//
// Bound on the H100: for a long causal prefill the work is 2*B*H*S^2*D
// floating-point operations against (4*B*S*H*D) bytes, far above the
// card's ~295 operations per byte, so it is bounded by arithmetic. This
// first version does that arithmetic on the CUDA cores in float32 (no
// tensor cores yet, so it runs well under the bf16 peak). Its design keeps
// the traffic at the minimum all the same: each block loads every key and
// value tile it needs once into shared memory and reuses it for 32 query
// rows; the S x S score matrix never leaves registers; causal blocks stop
// at the diagonal, so the upper triangle costs nothing. Tensor-core
// (wgmma) tiles are the next step.
//
// Layout: q [B, Sq, H, D], k / v [B, Sk, KVH, D], out like q, all
// contiguous, float32 or bfloat16; lse float32 [B, H, Sq]. D is a
// multiple of 16, at most 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;               // query rows per block
constexpr int BN = 32;               // keys per shared-memory tile
constexpr int QUAD = 4;              // threads sharing one query row
constexpr int THREADS = BM * QUAD;   // 128

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// One block: BM query rows of one (batch, head). Four threads share a row;
// thread t of the quad owns the dims 16*i + 4*t .. 16*i + 4*t + 3 of q and
// of the accumulator, so a quad reads 64 contiguous bytes of a shared key
// row and the eight rows of a warp read the same bytes (a broadcast).
template <typename T, int NC>  // head dim D = 16 * NC
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                 float scale, int causal) {
  constexpr int D = 16 * NC;
  constexpr int D4 = D / 4;
  __shared__ float4 ks[BN][D4];
  __shared__ float4 vs[BN][D4];

  const int tid = threadIdx.x;
  const int r = tid / QUAD;
  const int t = tid % QUAD;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KVH);
  const int row = q0 + r;
  const bool row_ok = row < Sq;
  const int offset = Sk - Sq;

  float4 qv[NC];
  float4 acc[NC];
  const T* qrow = q + ((size_t(b) * Sq + (row_ok ? row : 0)) * H + h) * D;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    qv[i] = row_ok ? load4(qrow + 16 * i + 4 * t) : make_float4(0, 0, 0, 0);
    acc[i] = make_float4(0, 0, 0, 0);
  }
  float m = -INFINITY;
  float l = 0.f;

  // keys this block can see: up to the causal diagonal of its last row
  const int q_last = min(q0 + BM, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + offset + 1) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += BN) {
    for (int idx = tid; idx < BN * D4; idx += THREADS) {
      const int j = idx / D4;
      const int c = idx % D4;
      const int kr = k0 + j;
      float4 kk = make_float4(0, 0, 0, 0);
      float4 vv = kk;
      if (kr < k_end) {
        const size_t off = ((size_t(b) * Sk + kr) * KVH + kvh) * D + 4 * c;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      ks[j][c] = kk;
      vs[j][c] = vv;
    }
    __syncthreads();

    float s[BN];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) p += dot4(qv[i], ks[j][4 * i + t]);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      const int col = k0 + j;
      const bool ok = row_ok && col < Sk && (!causal || col <= row + offset);
      s[j] = ok ? p * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new != -INFINITY) {  // uniform over the quad
      const float alpha = __expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        acc[i].x *= alpha; acc[i].y *= alpha;
        acc[i].z *= alpha; acc[i].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < BN; ++j) {
        const float p = __expf(s[j] - m_new);
        psum += p;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const float4 vv = vs[j][4 * i + t];
          acc[i].x += p * vv.x; acc[i].y += p * vv.y;
          acc[i].z += p * vv.z; acc[i].w += p * vv.w;
        }
      }
      l = l * alpha + psum;
      m = m_new;
    }
    __syncthreads();
  }

  if (row_ok) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = out + ((size_t(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      store4(orow + 16 * i + 4 * t,
             make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv,
                         acc[i].w * inv));
    }
    if (t == 0) lse[size_t(bh) * Sq + row] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Sk, int H, int KVH, int D,
                   float scale, int causal, cudaStream_t stream) {
  const dim3 grid((Sq + BM - 1) / BM, B * H);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
#define FLASH_CASE(NC)                                                    \
  case NC:                                                                \
    flash_fwd_kernel<T, NC><<<grid, THREADS, 0, stream>>>(                \
        qq, kk, vv, oo, lse, Sq, Sk, H, KVH, scale, causal);              \
    break;
  switch (D / 16) {
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int Sq, int Sk, int H,
                         int KVH, int D, float scale, int causal, int dtype,
                         void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KVH <= 0 || H % KVH != 0 ||
      D % 16 != 0 || D < 16 || D > 128) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    return launch<float>(q, k, v, out, l, B, Sq, Sk, H, KVH, D, scale,
                         causal, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, out, l, B, Sq, Sk, H, KVH, D,
                                 scale, causal, s);
  }
  return cudaErrorInvalidValue;
}
