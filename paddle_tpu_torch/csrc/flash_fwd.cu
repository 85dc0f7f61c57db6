// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/flash_attention.py _fwd_kernel (launched by
// _fwd), the Pallas TPU kernel every prefill attention reaches through
// sdpa_raw, and _seg_fwd_kernel (launched by _seg_fwd), its
// sequence-packed (segment-masked) variant that packed training reaches.
//
// Computes, per (batch, query head), out = softmax(q k^T * scale) v with an
// online softmax over key tiles, float32 accumulation, GQA (query head h
// reads kv head h / (H / KVH)) under a mask policy:
// - DenseMask (entry flash_fwd): the bottom-right-aligned causal mask
//   (query row r sees keys c <= r + Sk - Sq), or none;
// - SegmentMask (entry flash_fwd_seg): a query sees a key only when both
//   carry the same segment id >= 0 (a negative id is padding) and, when
//   causal, the key's segment-local position is <= the query's. A
//   32 x 32 tile pair whose per-tile segment / position extrema (computed
//   once per call by the wrapper, _seg_block_stats) rule out every
//   visible pair is skipped without loading it.
// Also writes the log-sum-exp lse[b, h, r] = m + log(l) that the backward
// will read. A row that sees no key (padding, or nothing before the
// causal limit) gets a zero output and lse = -inf. Any Sq / Sk works: the
// ragged edge is masked, not required to divide a tile.
//
// Bound on the H100: for a long causal prefill the work is 2*B*H*S^2*D
// floating-point operations against (4*B*S*H*D) bytes, far above the
// card's ~295 operations per byte, so it is bounded by arithmetic (for
// packed rows, by the visible pairs only: the sum over documents of
// n(n+1)/2). This first version does that arithmetic on the CUDA cores in
// float32 (no tensor cores yet, so it runs well under the bf16 peak). Its
// design keeps the traffic at the minimum all the same: each block loads
// every key and value tile it needs once into shared memory and reuses it
// for 32 query rows; the S x S score matrix never leaves registers; causal
// blocks stop at the diagonal and segment blocks skip tiles of other
// documents, so masked tiles cost nothing. The per-key segment ids and
// positions of a tile are staged in shared memory beside it, the query's
// own stay in registers. Tensor-core (wgmma) tiles are the next step.
//
// Layout: q [B, Sq, H, D], k / v [B, Sk, KVH, D], out like q, all
// contiguous, float32 or bfloat16; lse float32 [B, H, Sq]; segment ids and
// positions int32 [B, Sq] (query side) and [B, Sk] (key side). D is a
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

// Mask policies (the same two as in flash_bwd.cu). A policy describes a
// query row (Row) and a key (Key) by what its visibility needs, stages
// the keys of one tile in shared memory (Tile), and says which keys a
// block must walk (key_end) and whether a (q tile, k tile) pair can hold
// a visible pair at all (tile_runs, uniform over the block).
struct DenseMask {
  int Sq, Sk, offset;   // offset = Sk - Sq
  int causal;

  struct Idx { int i; };   // a row or a key is its index
  using Row = Idx;
  using Key = Idx;
  struct Tile {};          // nothing to stage

  __device__ __forceinline__ Row row(int b, int i) const { return {i}; }
  __device__ __forceinline__ void stage_keys(Tile&, int b, int k0,
                                             int tid) const {}
  __device__ __forceinline__ Key tile_key(const Tile&, int k0, int j) const {
    return {k0 + j};
  }
  __device__ __forceinline__ bool visible(Row r, Key c) const {
    return r.i < Sq && c.i < Sk && (!causal || c.i <= r.i + offset);
  }
  // keys [0, key_end) hold every key rows <= q_last of batch b can see
  __device__ __forceinline__ int key_end(int b, int q_last) const {
    return causal ? min(Sk, q_last + offset + 1) : Sk;
  }
  __device__ __forceinline__ bool tile_runs(int b, int qt, int kt) const {
    return true;
  }
};

struct SegmentMask {
  const int* seg_q;   // [B, Sq]
  const int* seg_k;   // [B, Sk]
  const int* pos_q;   // [B, Sq]
  const int* pos_k;   // [B, Sk]
  // [6, B, stride]: per q tile segment min / max, per k tile segment
  // min / max, per q tile position max, per k tile position min
  const int* stats;
  int B, Sq, Sk, stride;
  int causal;

  struct Tok { int seg, pos; };
  using Row = Tok;
  using Key = Tok;
  struct Tile { int seg[BN]; int pos[BN]; };

  // past the edge: a row of segment -1 (padding) and a key of segment -2,
  // which no row matches
  __device__ __forceinline__ Row row(int b, int i) const {
    if (i >= Sq) return {-1, 0};
    const size_t o = size_t(b) * Sq + i;
    return {seg_q[o], pos_q[o]};
  }
  __device__ __forceinline__ Key key(int b, int i) const {
    if (i >= Sk) return {-2, 0};
    const size_t o = size_t(b) * Sk + i;
    return {seg_k[o], pos_k[o]};
  }
  __device__ __forceinline__ void stage_keys(Tile& t, int b, int k0,
                                             int tid) const {
    if (tid < BN) {
      const Key c = key(b, k0 + tid);
      t.seg[tid] = c.seg;
      t.pos[tid] = c.pos;
    }
  }
  __device__ __forceinline__ Key tile_key(const Tile& t, int k0,
                                          int j) const {
    return {t.seg[j], t.pos[j]};
  }
  __device__ __forceinline__ bool visible(Row r, Key c) const {
    return r.seg >= 0 && r.seg == c.seg && (!causal || c.pos <= r.pos);
  }
  __device__ __forceinline__ int key_end(int b, int q_last) const {
    return Sk;
  }
  // the reference's _seg_run_predicate: the segment intervals
  // [max(min, 0), max] overlap (conservative for any layout, exact for
  // contiguous packing) and, when causal, some key is not in the future
  // of every row (min pos_k <= max pos_q)
  __device__ __forceinline__ bool tile_runs(int b, int qt, int kt) const {
    const size_t plane = size_t(B) * stride;
    const int* st = stats + size_t(b) * stride;
    const int qsmin = st[qt], qsmax = st[plane + qt];
    const int ksmin = st[2 * plane + kt], ksmax = st[3 * plane + kt];
    bool run = qsmax >= 0 && ksmax >= 0 && max(qsmin, 0) <= ksmax &&
               max(ksmin, 0) <= qsmax;
    if (causal) run = run && st[5 * plane + kt] <= st[4 * plane + qt];
    return run;
  }
};

// One block: BM query rows of one (batch, head). Four threads share a row;
// thread t of the quad owns the dims 16*i + 4*t .. 16*i + 4*t + 3 of q and
// of the accumulator, so a quad reads 64 contiguous bytes of a shared key
// row and the eight rows of a warp read the same bytes (a broadcast).
// tiles_ran, when not null, counts the tiles the block computes.
template <typename T, int NC, typename Mask>  // head dim D = 16 * NC
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                 float scale, Mask mask, int* tiles_ran) {
  constexpr int D = 16 * NC;
  constexpr int D4 = D / 4;
  __shared__ float4 ks[BN][D4];
  __shared__ float4 vs[BN][D4];
  __shared__ typename Mask::Tile keys;

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
  const typename Mask::Row rinfo = mask.row(b, row);

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
  const int k_end = mask.key_end(b, q_last);

  for (int k0 = 0; k0 < k_end; k0 += BN) {
    if (!mask.tile_runs(b, blockIdx.x, k0 / BN)) continue;
    if (tiles_ran != nullptr && tid == 0) atomicAdd(tiles_ran, 1);
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
    mask.stage_keys(keys, b, k0, tid);
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
      const bool ok = mask.visible(rinfo, mask.tile_key(keys, k0, j));
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

template <typename T, typename Mask>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Sk, int H, int KVH, int D,
                   float scale, Mask mask, int* tiles_ran,
                   cudaStream_t stream) {
  const dim3 grid((Sq + BM - 1) / BM, B * H);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
#define FLASH_CASE(NC)                                                    \
  case NC:                                                                \
    flash_fwd_kernel<T, NC, Mask><<<grid, THREADS, 0, stream>>>(          \
        qq, kk, vv, oo, lse, Sq, Sk, H, KVH, scale, mask, tiles_ran);     \
    break;
  switch (D / 16) {
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
  return cudaGetLastError();
}

template <typename Mask>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int Sq, int Sk, int H, int KVH, int D,
                     float scale, Mask mask, int* tiles_ran, int dtype,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    return launch<float>(q, k, v, out, l, B, Sq, Sk, H, KVH, D, scale, mask,
                         tiles_ran, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, out, l, B, Sq, Sk, H, KVH, D,
                                 scale, mask, tiles_ran, s);
  }
  return cudaErrorInvalidValue;
}

bool bad_shape(int B, int Sq, int Sk, int H, int KVH, int D) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || KVH <= 0 || H % KVH != 0 ||
         D % 16 != 0 || D < 16 || D > 128;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int Sq, int Sk, int H,
                         int KVH, int D, float scale, int causal, int dtype,
                         void* stream) {
  if (bad_shape(B, Sq, Sk, H, KVH, D)) return cudaErrorInvalidValue;
  const DenseMask mask{Sq, Sk, Sk - Sq, causal};
  return dispatch(q, k, v, out, lse, B, Sq, Sk, H, KVH, D, scale, mask,
                  nullptr, dtype, stream);
}

// The segment-masked forward. seg_q / pos_q int32 [B, Sq], seg_k / pos_k
// int32 [B, Sk]; stats int32 [6, B, stride], the tile extrema at 32 x 32;
// tiles_ran, when not null, an int32 the kernel adds one to for every
// (batch, head, q tile, k tile) it computes.
extern "C" int flash_fwd_seg(const void* q, const void* k, const void* v,
                             void* out, void* lse, const void* seg_q,
                             const void* seg_k, const void* pos_q,
                             const void* pos_k, const void* stats,
                             void* tiles_ran, int B, int Sq, int Sk, int H,
                             int KVH, int D, int stride, float scale,
                             int causal, int dtype, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KVH, D) || B * H > 65535 ||
      stride < (Sq + BM - 1) / BM || stride < (Sk + BN - 1) / BN) {
    return cudaErrorInvalidValue;
  }
  const SegmentMask mask{
      static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
      static_cast<const int*>(pos_q), static_cast<const int*>(pos_k),
      static_cast<const int*>(stats), B, Sq, Sk, stride, causal};
  return dispatch(q, k, v, out, lse, B, Sq, Sk, H, KVH, D, scale, mask,
                  static_cast<int*>(tiles_ran), dtype, stream);
}
