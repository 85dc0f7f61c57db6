// Ragged paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/paged_attention.py _decode_kernel (launched
// by ragged_paged_attention): the Pallas TPU kernel of every serving decode
// layer, both its full-precision arm (entry paged_decode) and its int8 arm
// (quant=True, entry paged_decode_int8, FLAGS_serving_kv_quant).
//
// Computes, for each sequence b and query head h, one decode query against
// the first lengths[b] key/value positions of that sequence, which live in
// pages named by block_tables[b, :]. Position p sits in page
// block_tables[b, p / ps] at slot p % ps. Table entries are clamped to
// [0, P - 1], so sentinel or garbage entries past a sequence's pages are
// harmless; positions >= lengths[b] are masked; lengths[b] == 0 gives a
// zero row (never NaN).
//
// Bound on the H100: every key and value byte of the live context is read
// once per step and used for 2 * group multiply-adds, so a step is bounded
// by memory traffic, 2 * B * KVH * ctx * D * sizeof(page element) bytes at
// 3.35 TB/s (int8 pages: half the bf16 bytes, plus 8 bytes of scales per
// page and kv head). The design reads exactly that: one block per
// (sequence, kv head) serves all `group` query heads of that kv head, so
// each page is read once per kv head and not once per query head; it
// walks only the sequence's own positions (no padding to the longest
// sequence); the group is not padded the way the TPU kernel pads it to 16
// sublanes. Key/value rows are loaded with 4-, 8- or 16-byte vector loads,
// 32 positions at a time, into shared memory. At small batch the grid
// (B * KVH blocks) is smaller than the card's 132 SMs; splitting the
// positions of one sequence over several blocks is the next step.
//
// The int8 arm is the same kernel instantiated on int8_t pages: each
// 4-value chunk of a key or value row is loaded as 4 codes (char4) and
// multiplied in float32 by the scale of its (page, kv head), which the
// block stages once per position of the tile. So the staged tile holds
// the plain version's dequantized values (code * scale, then attention),
// not the Pallas kernel's fold of the scale into the dot; the two differ
// only by rounding, and this order works when a 32-position tile spans
// several pages (ps 16) or part of one (ps 64). Device-memory traffic
// stays int8.
//
// Layout: q [B, NH, D], out [B, NH, D], float32 or bfloat16; pages
// [P, KVH, ps, D] of q's type, or int8 with scales float32 [P, KVH] (one
// per page and kv head); all contiguous; block_tables int32 [B, maxp];
// lengths int32 [B]. D % 8 == 0, D <= 128, group * D <= 1024.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TT = 32;       // positions per shared-memory tile (one warp)
constexpr int MAXO = 8;      // outputs per thread: group * D <= 1024

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

__device__ __forceinline__ float4 mul4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// T: the type of q and out; PageT: the page element, T (full precision)
// or int8_t (codes, dequantized with ksc / vsc, which are unused and may
// be null otherwise).
template <typename T, typename PageT>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const PageT* __restrict__ kp,
                    const PageT* __restrict__ vp,
                    const float* __restrict__ ksc,
                    const float* __restrict__ vsc, const int* __restrict__ bt,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int NH, int KVH, int ps, int D, int P, int maxp,
                    float scale) {
  constexpr bool kQuant = std::is_same<PageT, int8_t>::value;
  extern __shared__ float4 smem4[];
  const int g = NH / KVH;
  const int D4 = D / 4;
  float4* qs = smem4;                      // [g][D4]
  float4* ks = qs + g * D4;                // [TT][D4]
  float4* vs = ks + TT * D4;               // [TT][D4]
  float* sc = reinterpret_cast<float*>(vs + TT * D4);  // [g][TT]
  float* m_s = sc + g * TT;                // [g]
  float* l_s = m_s + g;                    // [g]
  float* a_s = l_s + g;                    // [g]
  float* ksc_s = a_s + g;                  // [TT], int8 pages only
  float* vsc_s = ksc_s + TT;               // [TT], int8 pages only

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = max(0, min(lengths[b], maxp * ps));

  const T* qb = q + (size_t(b) * NH + size_t(kvh) * g) * D;
  for (int i = tid; i < g * D4; i += THREADS) qs[i] = load4(qb + 4 * i);
  for (int h = tid; h < g; h += THREADS) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.f;
  }
  float acc[MAXO];
#pragma unroll
  for (int j = 0; j < MAXO; ++j) acc[j] = 0.f;
  __syncthreads();

  const int* row = bt + size_t(b) * maxp;
  for (int t0 = 0; t0 < len; t0 += TT) {
    if constexpr (kQuant) {
      // the scales of this tile's positions, read once per position
      if (tid < TT && t0 + tid < len) {
        const int pos = t0 + tid;
        const int pid = min(max(row[pos / ps], 0), P - 1);
        ksc_s[tid] = ksc[size_t(pid) * KVH + kvh];
        vsc_s[tid] = vsc[size_t(pid) * KVH + kvh];
      }
      __syncthreads();
    }
    for (int i = tid; i < TT * D4; i += THREADS) {
      const int j = i / D4;
      const int c = i % D4;
      const int pos = t0 + j;
      float4 kk = make_float4(0, 0, 0, 0);
      float4 vv = kk;
      if (pos < len) {
        const int pid = min(max(row[pos / ps], 0), P - 1);
        const size_t off =
            ((size_t(pid) * KVH + kvh) * ps + pos % ps) * D + 4 * c;
        kk = load4(kp + off);
        vv = load4(vp + off);
        if constexpr (kQuant) {
          kk = mul4(kk, ksc_s[j]);
          vv = mul4(vv, vsc_s[j]);
        }
      }
      ks[i] = kk;
      vs[i] = vv;
    }
    __syncthreads();

    // scores: a warp per position, lanes across the head dim
    for (int j = warp; j < TT; j += WARPS) {
      for (int h = 0; h < g; ++h) {
        float p = 0.f;
        for (int c = lane; c < D4; c += 32) {
          const float4 a = qs[h * D4 + c];
          const float4 kk = ks[j * D4 + c];
          p += a.x * kk.x + a.y * kk.y + a.z * kk.z + a.w * kk.w;
        }
        p = warp_sum(p);
        if (lane == 0) sc[h * TT + j] = t0 + j < len ? p * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: a warp per head, a lane per position of the tile
    for (int h = warp; h < g; h += WARPS) {
      const float s = sc[h * TT + lane];
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, warp_max(s));  // finite: t0 < len
      const float p = __expf(s - m_new);
      const float psum = warp_sum(p);
      sc[h * TT + lane] = p;
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        a_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + psum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // accumulate p @ v: thread owns outputs o = tid + j * THREADS
    const float* vsf = reinterpret_cast<const float*>(vs);
#pragma unroll
    for (int jj = 0; jj < MAXO; ++jj) {
      const int o = tid + jj * THREADS;
      if (o < g * D) {
        const int h = o / D;
        const int d = o % D;
        float a = acc[jj] * a_s[h];
        const float* ph = sc + h * TT;
#pragma unroll 8
        for (int j = 0; j < TT; ++j) a += ph[j] * vsf[j * D + d];
        acc[jj] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + (size_t(b) * NH + size_t(kvh) * g) * D;
#pragma unroll
  for (int jj = 0; jj < MAXO; ++jj) {
    const int o = tid + jj * THREADS;
    if (o < g * D) {
      const float l = l_s[o / D];
      store1(ob + o, l > 0.f ? acc[jj] / l : 0.f);
    }
  }
}

size_t smem_bytes(int g, int D, bool quant) {
  return sizeof(float) * (size_t(g) * D + 2 * size_t(TT) * D +
                          size_t(g) * TT + 3 * size_t(g) +
                          (quant ? 2 * size_t(TT) : 0));
}

bool bad_shape(int B, int NH, int KVH, int ps, int D, int P, int maxp) {
  return B <= 0 || KVH <= 0 || NH % KVH != 0 || ps <= 0 || P <= 0 ||
         maxp <= 0 || D % 8 != 0 || D <= 0 || D > 128 ||
         (NH / KVH) * D > MAXO * THREADS;
}

template <typename T, typename PageT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const float* ksc, const float* vsc, const void* block_tables,
           const void* lengths, void* out, int B, int NH, int KVH, int ps,
           int D, int P, int maxp, float scale, void* stream) {
  const dim3 grid(KVH, B);
  const size_t smem =
      smem_bytes(NH / KVH, D, std::is_same<PageT, int8_t>::value);
  paged_decode_kernel<T, PageT>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const PageT*>(k_pages),
          static_cast<const PageT*>(v_pages), ksc, vsc,
          static_cast<const int*>(block_tables),
          static_cast<const int*>(lengths), static_cast<T*>(out), NH, KVH,
          ps, D, P, maxp, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype (of q, out and the pages): 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* block_tables,
                            const void* lengths, void* out, int B, int NH,
                            int KVH, int ps, int D, int P, int maxp,
                            float scale, int dtype, void* stream) {
  if (bad_shape(B, NH, KVH, ps, D, P, maxp)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    return launch<float, float>(q, k_pages, v_pages, nullptr, nullptr,
                                block_tables, lengths, out, B, NH, KVH, ps,
                                D, P, maxp, scale, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, block_tables, lengths, out,
        B, NH, KVH, ps, D, P, maxp, scale, stream);
  }
  return cudaErrorInvalidValue;
}

// int8 pages (codes) with float32 k_scales / v_scales [P, KVH]; dtype is
// that of q and out: 0 = float32, 1 = bfloat16. Same clamping, masking and
// zero-row contract as paged_decode.
extern "C" int paged_decode_int8(const void* q, const void* k_codes,
                                 const void* v_codes, const void* k_scales,
                                 const void* v_scales,
                                 const void* block_tables,
                                 const void* lengths, void* out, int B,
                                 int NH, int KVH, int ps, int D, int P,
                                 int maxp, float scale, int dtype,
                                 void* stream) {
  if (bad_shape(B, NH, KVH, ps, D, P, maxp)) return cudaErrorInvalidValue;
  const float* ksc = static_cast<const float*>(k_scales);
  const float* vsc = static_cast<const float*>(v_scales);
  if (dtype == 0) {
    return launch<float, int8_t>(q, k_codes, v_codes, ksc, vsc,
                                 block_tables, lengths, out, B, NH, KVH, ps,
                                 D, P, maxp, scale, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, int8_t>(q, k_codes, v_codes, ksc, vsc,
                                         block_tables, lengths, out, B, NH,
                                         KVH, ps, D, P, maxp, scale, stream);
  }
  return cudaErrorInvalidValue;
}
