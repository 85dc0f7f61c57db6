// Flash attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/flash_attention.py _bwd_dq_kernel and
// _bwd_dkv_kernel (launched by _bwd under the _flash custom VJP), the
// Pallas TPU kernels that give every training attention its gradient, and
// _seg_bwd_dq_kernel and _seg_bwd_dkv_kernel (launched by _seg_bwd under
// the _flash_seg custom VJP), their sequence-packed variants.
//
// Computes, from the forward's inputs q / k / v, its output o, its
// log-sum-exp lse and the output gradient dout, the gradients dq, dk, dv of
// out = softmax(q k^T * scale) v with GQA (query head h reads kv head
// h / (H / KVH)) under a mask policy: DenseMask (entry flash_bwd; bottom-
// right aligned causal, query row r sees keys c <= r + Sk - Sq, or none)
// or SegmentMask (entry flash_bwd_seg; same segment id >= 0 and, when
// causal, key position <= query position, segment-local; tile pairs that
// the tile extrema at the route's tiles rule out are skipped):
//
//   p  = exp(q.k * scale - lse)          recomputed, never stored
//   dp = dout . v
//   ds = p * (dp - delta),  delta = rowsum(dout * o)
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T dout
//
// Two kernels, launched in this order on one stream (the sizes of the
// CUDA-core route; the tensor-core pair below splits the work alike):
// - dq: one block per (batch, query head, 32 query rows). It first writes
//   delta for its rows (fused: the dkv kernel reads it), then loops over
//   the 32-key tiles that can hold a visible key, accumulating dq in
//   float32.
// - dkv: one block per (batch, kv head, 32 keys). It loops over the GQA
//   group's query heads and their 32-row tiles that can see its keys,
//   accumulating dk and dv in float32. Summing the group inside the block
//   needs no per-query-head dk / dv buffers, no group sum afterwards and
//   no atomics.
// Masked entries get p = 0 explicitly, so a row that sees no key (the
// forward wrote lse = -inf for it: padding, or nothing before the causal
// limit) gets exact zero gradients, a padding key exact zero dk / dv, and
// exp(-inf - -inf) is never formed. The segment ids and positions of the
// tile a block walks are staged in shared memory; its own stay in
// registers.
//
// Bound on the H100: 5 causal products of B*H*S^2*D operations each at
// least (q k^T, dout v^T, dv, dq, dk; for packed rows over the visible
// pairs only) against ~(8 B S H D + 2 B S KVH D) bytes: far above ~295
// operations per byte, so arithmetic bounds a long causal one. A short
// non-causal one is bounded by bytes: at DiT-XL/2's training shape
// [32, 256, 16, 72] the 24.2 GFLOP of the five products take 24.4 us at
// the bf16 peak and the 151 MB read and written 45.2 us at 3.35 TB/s.
// Both routes recompute q k^T and dout v^T in both kernels (7 products)
// and need no atomics:
// - tensor cores (bfloat16 at D = 64, 72 or 128, the route of every
//   main path, chosen alike by both entries, tc_route; the *_tc_kernel
//   pair below, over the DenseTC or SegmentTC policy): wgmma in bf16
//   with float32 sums, tiles at the stored width DS = 64 ceil(D / 64)
//   and products at the computed width D (hopper_mma.cuh). A segment
//   block lists once the 64 x 64 tile pairs it runs, each warpgroup
//   computes only its own, and only pairs that hold a document boundary,
//   a diagonal or the ragged edge mask element by element;
// - CUDA cores (float32, or bfloat16 at another D): float32 arithmetic,
//   32 rows or keys a block. Its traffic is small all the same: every
//   tile a block loads into shared memory serves 32 rows or keys, the
//   score matrix never leaves registers, and causal blocks skip the tiles
//   above the diagonal, segment blocks the 32 x 32 tiles of other
//   documents. A row or key is shared by 4 threads up to a padded head
//   dim Dp of 128 and by 8 above it, so that the dkv kernel's four
//   per-key vectors (k, v and the dk, dv sums) stay at 128 floats a
//   thread at any D; D is padded to Dp with zeros in registers and
//   shared memory (so the pad adds nothing to a score, to dout . v or to
//   delta), and the pad is never stored. The tiles (up to 64 KB at Dp
//   256) are dynamic shared memory.
//
// Layout: q / o / dout / dq [B, Sq, H, D], k / v / dk / dv [B, Sk, KVH, D],
// all contiguous, float32 or bfloat16; lse and delta float32 [B, H, Sq];
// segment ids and positions int32 [B, Sq] / [B, Sk]. D is a multiple of
// 8, from 8 to 256 (the tensor cores take bf16 at 64, 72 and 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"
#include "segment_tiles.cuh"

namespace {

constexpr int BM = 32;               // query rows per tile
constexpr int BN = 32;               // keys per tile
constexpr int MAX_D = 256;

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

__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x += a * x.x;
  acc.y += a * x.y;
  acc.z += a * x.z;
  acc.w += a * x.w;
}

__device__ __forceinline__ float4 scale4(float4 x, float a) {
  return make_float4(x.x * a, x.y * a, x.z * a, x.w * a);
}

// Sum over the G threads that share a row or key (all 32 lanes take
// part).
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < G; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Mask policies (the same two as in flash_fwd.cu). A policy describes a
// query row (Row) and a key (Key) by what its visibility needs, stages
// the keys or rows of one tile in shared memory (Tile), says which keys
// or rows a block must walk (key_end, row_begin) and whether a (q tile,
// k tile) pair can hold a visible pair at all (tile_runs, uniform over
// the block).
static_assert(BM == BN, "a staged tile serves rows and keys alike");

struct DenseMask {
  int Sq, Sk, offset;   // offset = Sk - Sq
  int causal;

  struct Idx { int i; };   // a row or a key is its index
  using Row = Idx;
  using Key = Idx;
  struct Tile {};          // nothing to stage

  __device__ __forceinline__ Row row(int b, int i) const { return {i}; }
  __device__ __forceinline__ Key key(int b, int i) const { return {i}; }
  __device__ __forceinline__ void stage_keys(Tile&, int b, int k0,
                                             int tid) const {}
  __device__ __forceinline__ void stage_rows(Tile&, int b, int q0,
                                             int tid) const {}
  __device__ __forceinline__ Key tile_key(const Tile&, int k0, int j) const {
    return {k0 + j};
  }
  __device__ __forceinline__ Row tile_row(const Tile&, int q0, int i) const {
    return {q0 + i};
  }
  __device__ __forceinline__ bool visible(Row r, Key c) const {
    return r.i < Sq && c.i < Sk && (!causal || c.i <= r.i + offset);
  }
  // keys [0, key_end) hold every key rows <= q_last of batch b can see
  __device__ __forceinline__ int key_end(int b, int q_last) const {
    return causal ? max(0, min(Sk, q_last + offset + 1)) : Sk;
  }
  // rows [row_begin, Sq) hold every row that can see a key >= k0
  __device__ __forceinline__ int row_begin(int b, int k0) const {
    return causal ? max(0, k0 - offset) : 0;
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
  // [8, B, stride] at BM x BN (segment_tiles.cuh); rows 0-5 decide
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
  __device__ __forceinline__ void stage_rows(Tile& t, int b, int q0,
                                             int tid) const {
    if (tid < BM) {
      const Row r = row(b, q0 + tid);
      t.seg[tid] = r.seg;
      t.pos[tid] = r.pos;
    }
  }
  __device__ __forceinline__ Key tile_key(const Tile& t, int k0,
                                          int j) const {
    return {t.seg[j], t.pos[j]};
  }
  __device__ __forceinline__ Row tile_row(const Tile& t, int q0,
                                          int i) const {
    return {t.seg[i], t.pos[i]};
  }
  __device__ __forceinline__ bool visible(Row r, Key c) const {
    return r.seg >= 0 && r.seg == c.seg && (!causal || c.pos <= r.pos);
  }
  __device__ __forceinline__ int key_end(int b, int q_last) const {
    return Sk;
  }
  __device__ __forceinline__ int row_begin(int b, int k0) const { return 0; }
  // the reference's _seg_run_predicate (seg::runs)
  __device__ __forceinline__ bool tile_runs(int b, int qt, int kt) const {
    return seg::runs(stats + size_t(b) * stride, size_t(B) * stride, qt, kt,
                     causal);
  }
};

// dq (and delta). G threads share a query row (4, or 8 above a padded
// head dim of 128); thread t of the group owns dims 4 G i + 4 t .. + 3
// (i < NC, Dp = 4 G NC), so the 32 / G rows of a warp read the same
// 16 G bytes of a shared key row (a broadcast). A thread's dims lie all
// below D or all past it; those past it are zeros and are not stored.
template <typename T, int G, int NC, typename Mask>
__global__ void __launch_bounds__(BM * G)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    float* __restrict__ delta, int Sq, int Sk, int H,
                    int KVH, int D, float scale, Mask mask) {
  constexpr int THREADS = BM * G;
  constexpr int D4 = G * NC;   // float4 columns of a padded row
  extern __shared__ float4 tile_mem[];
  float4(*ks)[D4] = reinterpret_cast<float4(*)[D4]>(tile_mem);
  float4(*vs)[D4] = reinterpret_cast<float4(*)[D4]>(tile_mem + BN * D4);
  __shared__ typename Mask::Tile keys;

  const int tid = threadIdx.x;
  const int r = tid / G;
  const int t = tid % G;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KVH);
  const int row = q0 + r;
  const bool row_ok = row < Sq;
  const size_t roff = ((size_t(b) * Sq + (row_ok ? row : 0)) * H + h) * D;
  const typename Mask::Row rinfo = mask.row(b, row);

  float4 qv[NC];
  float4 dov[NC];
  float4 acc[NC];
  float dlt = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 4 * (G * i + t);
    const bool in = row_ok && c < D;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    qv[i] = in ? load4(q + roff + c) : zero;
    dov[i] = in ? load4(dout + roff + c) : zero;
    dlt += dot4(dov[i], in ? load4(o + roff + c) : zero);
    acc[i] = zero;
  }
  dlt = group_sum<G>(dlt);
  const float lse_r = row_ok ? lse[size_t(bh) * Sq + row] : -INFINITY;
  if (row_ok && t == 0) delta[size_t(bh) * Sq + row] = dlt;

  const int q_last = min(q0 + BM, Sq) - 1;
  const int k_end = mask.key_end(b, q_last);

  for (int k0 = 0; k0 < k_end; k0 += BN) {
    if (!mask.tile_runs(b, blockIdx.x, k0 / BN)) continue;
    for (int idx = tid; idx < BN * D4; idx += THREADS) {
      const int j = idx / D4;
      const int c = idx % D4;
      const int kr = k0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (kr < k_end && 4 * c < D) {
        const size_t off = ((size_t(b) * Sk + kr) * KVH + kvh) * D + 4 * c;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      ks[j][c] = kk;
      vs[j][c] = vv;
    }
    mask.stage_keys(keys, b, k0, tid);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BN; ++j) {
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        s += dot4(qv[i], ks[j][G * i + t]);
        dp += dot4(dov[i], vs[j][G * i + t]);
      }
      s = group_sum<G>(s);
      dp = group_sum<G>(dp);
      const float p = mask.visible(rinfo, mask.tile_key(keys, k0, j))
                          ? __expf(s * scale - lse_r)
                          : 0.f;
      const float ds = p * (dp - dlt);
#pragma unroll
      for (int i = 0; i < NC; ++i) axpy4(acc[i], ds, ks[j][G * i + t]);
    }
    __syncthreads();
  }

  if (row_ok) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = 4 * (G * i + t);
      if (c < D) store4(dq + roff + c, scale4(acc[i], scale));
    }
  }
}

// dk and dv. G threads share a key; thread t of the group owns the same
// dims as in the dq kernel, so the 32 / G keys of a warp read the same
// 16 G bytes of a shared query row.
template <typename T, int G, int NC, typename Mask>
__global__ void __launch_bounds__(BN * G)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int KVH,
                     int D, float scale, Mask mask) {
  constexpr int THREADS = BN * G;
  constexpr int D4 = G * NC;
  extern __shared__ float4 tile_mem[];
  float4(*qs)[D4] = reinterpret_cast<float4(*)[D4]>(tile_mem);
  float4(*dos)[D4] = reinterpret_cast<float4(*)[D4]>(tile_mem + BM * D4);
  __shared__ float lses[BM];
  __shared__ float dls[BM];
  __shared__ typename Mask::Tile rows;

  const int tid = threadIdx.x;
  const int j = tid / G;
  const int t = tid % G;
  const int k0 = blockIdx.x * BN;
  const int bkv = blockIdx.y;
  const int b = bkv / KVH;
  const int kvh = bkv % KVH;
  const int group = H / KVH;
  const int col = k0 + j;
  const bool col_ok = col < Sk;
  const size_t koff = ((size_t(b) * Sk + (col_ok ? col : 0)) * KVH + kvh) * D;
  const typename Mask::Key cinfo = mask.key(b, col);

  float4 kv[NC];
  float4 vv[NC];
  float4 ak[NC];
  float4 av[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 4 * (G * i + t);
    const bool in = col_ok && c < D;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    kv[i] = in ? load4(k + koff + c) : zero;
    vv[i] = in ? load4(v + koff + c) : zero;
    ak[i] = zero;
    av[i] = zero;
  }

  const int r_begin = mask.row_begin(b, k0) / BM * BM;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const size_t bh = size_t(b) * H + h;
    for (int q0 = r_begin; q0 < Sq; q0 += BM) {
      if (!mask.tile_runs(b, q0 / BM, blockIdx.x)) continue;
      for (int idx = tid; idx < BM * D4; idx += THREADS) {
        const int i = idx / D4;
        const int c = idx % D4;
        const int rr = q0 + i;
        float4 qq = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 dd = qq;
        if (rr < Sq && 4 * c < D) {
          const size_t off = ((size_t(b) * Sq + rr) * H + h) * D + 4 * c;
          qq = load4(q + off);
          dd = load4(dout + off);
        }
        qs[i][c] = qq;
        dos[i][c] = dd;
      }
      if (tid < BM) {
        const int rr = q0 + tid;
        lses[tid] = rr < Sq ? lse[bh * Sq + rr] : -INFINITY;
        dls[tid] = rr < Sq ? delta[bh * Sq + rr] : 0.f;
      }
      mask.stage_rows(rows, b, q0, tid);
      __syncthreads();

#pragma unroll 2
      for (int i = 0; i < BM; ++i) {
        float s = 0.f;
        float dp = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          s += dot4(qs[i][G * c + t], kv[c]);
          dp += dot4(dos[i][G * c + t], vv[c]);
        }
        s = group_sum<G>(s);
        dp = group_sum<G>(dp);
        const float p = mask.visible(mask.tile_row(rows, q0, i), cinfo)
                            ? __expf(s * scale - lses[i])
                            : 0.f;
        const float ds = p * (dp - dls[i]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          axpy4(av[c], p, dos[i][G * c + t]);
          axpy4(ak[c], ds, qs[i][G * c + t]);
        }
      }
      __syncthreads();
    }
  }

  if (col_ok) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = 4 * (G * i + t);
      if (c < D) {
        store4(dk + koff + c, scale4(ak[i], scale));
        store4(dv + koff + c, av[i]);
      }
    }
  }
}

// Allow a kernel its dynamic shared memory, once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  configured = err == cudaSuccess;
  return err;
}

// One launch pair of the (G, NC) instance: each kernel's two tiles, 2 x
// 32 Dp floats, are dynamic shared memory (64 KB at Dp 256).
template <typename T, int G, int NC, typename Mask>
cudaError_t run(const T* q, const T* k, const T* v, const T* o,
                const T* dout, const float* lse, T* dq, T* dk, T* dv,
                float* delta, int B, int Sq, int Sk, int H, int KVH, int D,
                float scale, Mask mask, cudaStream_t stream) {
  constexpr int smem = 2 * BM * G * NC * int(sizeof(float4));
  static bool dq_ok = false, dkv_ok = false;
  cudaError_t err =
      allow_smem(flash_bwd_dq_kernel<T, G, NC, Mask>, smem, dq_ok);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkv_kernel<T, G, NC, Mask>, smem, dkv_ok);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((Sq + BM - 1) / BM, B * H);
  const dim3 grid_k((Sk + BN - 1) / BN, B * KVH);
  flash_bwd_dq_kernel<T, G, NC, Mask><<<grid_q, BM * G, smem, stream>>>(
      q, k, v, o, dout, lse, dq, delta, Sq, Sk, H, KVH, D, scale, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, G, NC, Mask><<<grid_k, BN * G, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, KVH, D, scale, mask);
  return cudaGetLastError();
}

// The instance of a head dim: 4 threads a row or key and Dp = 16 NC up
// to 128, 8 threads and Dp = 32 NC above.
template <typename T, typename Mask>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float* delta, int B, int Sq,
                   int Sk, int H, int KVH, int D, float scale, Mask mask,
                   cudaStream_t stream) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* oo = static_cast<const T*>(o);
  const T* gg = static_cast<const T*>(dout);
  T* dqq = static_cast<T*>(dq);
  T* dkk = static_cast<T*>(dk);
  T* dvv = static_cast<T*>(dv);
#define FLASH_BWD_CASE(G, NC)                                              \
  case NC:                                                                 \
    return run<T, G, NC, Mask>(qq, kk, vv, oo, gg, lse, dqq, dkk, dvv,     \
                               delta, B, Sq, Sk, H, KVH, D, scale, mask,   \
                               stream);
  if (D <= 128) {
    switch ((D + 15) / 16) {
      FLASH_BWD_CASE(4, 1) FLASH_BWD_CASE(4, 2) FLASH_BWD_CASE(4, 3)
      FLASH_BWD_CASE(4, 4) FLASH_BWD_CASE(4, 5) FLASH_BWD_CASE(4, 6)
      FLASH_BWD_CASE(4, 7) FLASH_BWD_CASE(4, 8)
      default: break;
    }
  } else {
    switch ((D + 31) / 32) {
      FLASH_BWD_CASE(8, 5) FLASH_BWD_CASE(8, 6) FLASH_BWD_CASE(8, 7)
      FLASH_BWD_CASE(8, 8)
      default: break;
    }
  }
#undef FLASH_BWD_CASE
  return cudaErrorInvalidValue;
}

template <typename Mask>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* lse, const void* dout,
                     void* dq, void* dk, void* dv, void* delta, int B, int Sq,
                     int Sk, int H, int KVH, int D, float scale, Mask mask,
                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) {
    return launch<float>(q, k, v, o, dout, l, dq, dk, dv, dl, B, Sq, Sk, H,
                         KVH, D, scale, mask, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, o, dout, l, dq, dk, dv, dl, B, Sq,
                                 Sk, H, KVH, D, scale, mask, s);
  }
  return cudaErrorInvalidValue;
}

// ---- the tensor-core route: bfloat16, D = 64, 72 or 128 ----------------
//
// The same two kernels on wgmma, with bf16 operands and float32 sums; P
// and dS are rounded to bf16 before they enter a product, as SDPA's
// backward rounds them. Blocks are 256 threads, two warpgroups.
// Widths: the template's D is the computed width. The products over D
// (S, dP; S^T, dP^T) take k_slices(D) k16 slices, 5 at D 72, and those
// whose N is D (dQ, dK, dV) run at N = D, 36 floats a thread at D 72;
// the tiles are stored_width(D) wide (128 at D 72, tc_bwd_smem<72> is
// tc_bwd_smem<128>). load_tile copies a row's D / 8 chunks and zeroes
// the next up to 16 k_slices(D) columns; delta and every store cover
// columns < D only.
// Bound: at DiT-XL/2's [32, 256, 16, 72] bytes (45.2 us) set it; each
// block reads its resident tiles once and streams 4 tiles of the other
// side (S 256 in 64-row tiles), so it too pays its fixed cost (the
// resident loads, the delta pass) for little work.
// - dq: 128 query rows of one (batch, head), 64 rows a warpgroup. Q and
//   dout stay in shared memory; K / V tiles of 64 keys stream through a
//   2-stage cp.async ring. Per tile: S = Q K^T and dP = dout V^T (wgmma,
//   both operands in shared memory), P = exp2(S scale log2 e - lse log2 e),
//   dS = P (dP - delta) in registers, dQ += dS K (A = dS from registers,
//   K as an MN-major B). Writes delta for its rows first, as above.
// - dkv: 128 keys of one (batch, kv head), 64 keys a warpgroup. K and V
//   stay in shared memory; the GQA group's query heads and their 64-row
//   Q / dout tiles (with lse and delta) stream through the ring. It
//   computes the transposes, S^T = K Q^T and dP^T = V dout^T, so that both
//   accumulating products take A from registers: dV += P^T dout and
//   dK += dS^T Q, dout and Q as MN-major B operands (FlashAttention-3's
//   layout).
// The mask is a policy (DenseTC, SegmentTC below): it says which tiles a
// block walks (a list; dkv walks it once for each query head of its
// group), whether each warpgroup computes a tile at all (one test a
// warpgroup, around both its products and their waits), whether it masks
// the tile element by element, and which pairs of such a tile are
// visible. Masked entries get p = 0 by a select, so rows that see no key
// get exact zero dq and keys no row sees exact zero dk / dv; a block
// with an empty list writes zeros. Dense blocks launch their longest
// tiles first.
constexpr int TC_THREADS = 256;
constexpr int TC_ROWS = 128;   // dq: query rows a block; dkv: keys a block
constexpr int TC_TILE = 64;    // dq: keys a tile; dkv: query rows a tile
constexpr float LOG2E = 1.4426950408889634f;

// at head dim D: two resident tiles of TC_ROWS rows, a 2-stage ring of
// two TC_TILE-row tiles (all at the stored width), 2 KB of row statistics
// and staged segment ids, alignment
template <int D>
constexpr int tc_bwd_smem() {
  return (2 * TC_ROWS + 4 * TC_TILE) * hopper::stored_width(D) * 2 +
         4 * TC_ROWS * 4 + 1024;
}

// The dense mask: bottom-right-aligned causal (query row r sees keys
// c <= r + offset), or none. A dq block walks key tiles 0 .. count - 1,
// up to the diagonal of its last row; a dkv block the q tiles from the
// diagonal down.
struct DenseTC {
  int Sq, Sk, offset;   // offset = Sk - Sq
  int causal;
  static constexpr bool kStages = false;
  struct Idx { int i; };   // a row or a key is its index
  using Row = Idx;
  using Key = Idx;

  int extra_smem() const { return 0; }
  // the tiles of a dq block of rows q0 ..: entries first .. first + count
  __device__ __forceinline__ int count_dq(const int*, int q0) const {
    const int q_last = min(q0 + TC_ROWS, Sq) - 1;
    const int k_end = causal ? min(Sk, q_last + offset + 1) : Sk;
    return k_end > 0 ? (k_end + TC_TILE - 1) / TC_TILE : 0;
  }
  // q tiles [first, n_qt) of each query head can see a key >= k0
  __device__ __forceinline__ int count_dkv(const int*, int k0,
                                           int& first) const {
    const int n_qt = (Sq + TC_TILE - 1) / TC_TILE;
    first = causal ? min(n_qt, max(0, k0 - offset) / TC_TILE) : 0;
    return n_qt - first;
  }
  __device__ __forceinline__ int entry(const int*, int j) const { return j; }
  __device__ __forceinline__ static int tile(int e) { return e; }
  // a warpgroup's 64 rows from rows0 against 64 keys from keys0
  __device__ __forceinline__ bool runs(int e, int wg, int rows0,
                                       int keys0) const {
    return !causal || keys0 <= rows0 + 63 + offset;
  }
  __device__ __forceinline__ bool edge(int e, int wg, int rows0,
                                       int keys0) const {
    return rows0 + 64 > Sq || keys0 + 64 > Sk ||
           (causal && keys0 + 63 > rows0 + offset);
  }
  __device__ __forceinline__ Row row(int b, int i) const { return {i}; }
  __device__ __forceinline__ Key key(int b, int i) const { return {i}; }
  // the staged ids of entry c of a tile that starts at i0
  __device__ __forceinline__ Idx at(const int*, int c, int i0) const {
    return {i0 + c};
  }
  __device__ __forceinline__ void stage_keys(uint32_t, const int*, int b,
                                             int k0, int tid) const {}
  __device__ __forceinline__ void stage_rows(uint32_t, const int*, int b,
                                             int r0, int tid) const {}
  __device__ __forceinline__ bool visible(Row r, Key c) const {
    return r.i < Sq && c.i < Sk && (!causal || c.i <= r.i + offset);
  }
};

// The segment mask (SegmentMask's, on the tensor cores). warp 0 lists
// the tiles that either warpgroup runs at 64 x 64 (stats at TC_TILE x
// TC_TILE), with each warpgroup's flags (segment_tiles.cuh). The tile's
// keys (dq) or rows (dkv) have their (segment, position) staged beside
// the tile, seg[64] then pos[64]; the block's own stay in registers. Rows
// past Sq have segment -1, keys past Sk -2, which no row has.
struct SegmentTC {
  const int* seg_q;   // [B, Sq]
  const int* seg_k;   // [B, Sk]
  const int* pos_q;   // [B, Sq]
  const int* pos_k;   // [B, Sk]
  const int* stats;   // [8, B, stride] at TC_TILE x TC_TILE
  int B, Sq, Sk, stride;
  int causal;
  static constexpr bool kStages = true;
  struct Tok { int seg, pos; };
  using Row = Tok;
  using Key = Tok;

  int extra_smem() const {
    const int n = max((Sq + TC_TILE - 1) / TC_TILE,
                      (Sk + TC_TILE - 1) / TC_TILE);
    return 4 * (1 + n);
  }
  __device__ __forceinline__ void build_dq(int* list, int b, int qt0,
                                           int tid) const {
    if (tid >= 32) return;
    const int* st = stats + size_t(b) * stride;
    const size_t plane = size_t(B) * stride;
    const int nq = (Sq + TC_TILE - 1) / TC_TILE;
    seg::compact(list, (Sk + TC_TILE - 1) / TC_TILE, tid, [&](int kt) {
      int e = 0;
      for (int w = 0; w < 2 && qt0 + w < nq; ++w) {
        const int qt = qt0 + w;
        e |= seg::flags(st, plane, qt, kt, causal,
                        (qt + 1) * TC_TILE > Sq || (kt + 1) * TC_TILE > Sk,
                        w);
      }
      return e != 0 ? kt | e : -1;
    });
  }
  __device__ __forceinline__ void build_dkv(int* list, int b, int kt0,
                                            int tid) const {
    if (tid >= 32) return;
    const int* st = stats + size_t(b) * stride;
    const size_t plane = size_t(B) * stride;
    const int nk = (Sk + TC_TILE - 1) / TC_TILE;
    seg::compact(list, (Sq + TC_TILE - 1) / TC_TILE, tid, [&](int qt) {
      int e = 0;
      for (int w = 0; w < 2 && kt0 + w < nk; ++w) {
        const int kt = kt0 + w;
        e |= seg::flags(st, plane, qt, kt, causal,
                        (qt + 1) * TC_TILE > Sq || (kt + 1) * TC_TILE > Sk,
                        w);
      }
      return e != 0 ? qt | e : -1;
    });
  }
  __device__ __forceinline__ int count_dq(const int* list, int q0) const {
    return list[0];
  }
  __device__ __forceinline__ int count_dkv(const int* list, int k0,
                                           int& first) const {
    first = 0;
    return list[0];
  }
  __device__ __forceinline__ int entry(const int* list, int j) const {
    return list[1 + j];
  }
  __device__ __forceinline__ static int tile(int e) { return e & seg::TILE; }
  __device__ __forceinline__ bool runs(int e, int wg, int rows0,
                                       int keys0) const {
    return (e & (seg::RUN0 << wg)) != 0;
  }
  __device__ __forceinline__ bool edge(int e, int wg, int rows0,
                                       int keys0) const {
    return (e & (seg::EDGE0 << wg)) != 0;
  }
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
  __device__ __forceinline__ Tok at(const int* staged, int c, int i0) const {
    return {staged[c], staged[TC_TILE + c]};
  }
  // threads 0 .. 127 of the block: entry tid % 64 of seg (tid < 64) or
  // pos, by cp.async from [B, S] ids; past S, `pad` and 0 by a store
  __device__ __forceinline__ static void stage(uint32_t dst, const int* ids,
                                               const int* pos, int b, int S,
                                               int i0, int pad, int tid) {
    if (tid >= 2 * TC_TILE) return;
    const int i = i0 + tid % TC_TILE;
    if (i < S) {
      hopper::cp_async4(dst + 4 * tid,
                        (tid < TC_TILE ? ids : pos) + size_t(b) * S + i, true);
    } else {
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst + 4 * tid),
                   "r"(tid < TC_TILE ? pad : 0)
                   : "memory");
    }
  }
  __device__ __forceinline__ void stage_keys(uint32_t dst, const int*, int b,
                                             int k0, int tid) const {
    stage(dst, seg_k, pos_k, b, Sk, k0, -2, tid);
  }
  __device__ __forceinline__ void stage_rows(uint32_t dst, const int*, int b,
                                             int r0, int tid) const {
    stage(dst, seg_q, pos_q, b, Sq, r0, -1, tid);
  }
  __device__ __forceinline__ bool visible(Row r, Key c) const {
    return r.seg >= 0 && r.seg == c.seg && (!causal || c.pos <= r.pos);
  }
};

template <int D, typename Mask>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       __nv_bfloat16* __restrict__ dq,
                       float* __restrict__ delta, int Sq, int Sk, int H,
                       int KVH, float scale, const Mask mask) {
  using namespace hopper;
  constexpr int DS = stored_width(D);
  constexpr uint32_t TILE = TC_TILE * DS * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sDO = sQ + TC_ROWS * DS * 2;
  const uint32_t sK = sDO + TC_ROWS * DS * 2;
  const uint32_t sV = sK + 2 * TILE;
  float* rowstat = reinterpret_cast<float*>(
      smem_raw + (sV + 2 * TILE - smem_u32(smem_raw)));
  float* lse2_s = rowstat;              // lse * log2(e), [TC_ROWS]
  float* delta_s = rowstat + TC_ROWS;   // [TC_ROWS]
  // the policy's: staged ids of each K / V stage [2][seg, pos][64], then
  // the tile list
  const uint32_t sKeys = sV + 2 * TILE + 2 * TC_ROWS * 4;
  const int* keys_s = reinterpret_cast<const int*>(rowstat + 2 * TC_ROWS);
  int* list = reinterpret_cast<int*>(rowstat + 4 * TC_ROWS);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;   // longest first
  if constexpr (Mask::kStages) {
    mask.build_dq(list, b, q0 / TC_TILE, tid);
    __syncthreads();
  }
  const int n_kt = mask.count_dq(list, q0);
  const size_t q_stride = size_t(H) * D;
  const size_t kv_stride = size_t(KVH) * D;
  const size_t qoff = (size_t(b) * Sq * H + h) * D;
  const __nv_bfloat16* kg = k + (size_t(b) * Sk * KVH + kvh) * D;
  const __nv_bfloat16* vg = v + (size_t(b) * Sk * KVH + kvh) * D;
  // the K / V tiles of list entry j, and their keys' ids, into stage st
  auto load_kv = [&](int j, uint32_t st) {
    const int k0 = Mask::tile(mask.entry(list, j)) * TC_TILE;
    load_tile<TC_TILE, D>(sK + st * TILE, kg, k0, Sk, kv_stride, tid,
                          TC_THREADS);
    load_tile<TC_TILE, D>(sV + st * TILE, vg, k0, Sk, kv_stride, tid,
                          TC_THREADS);
    mask.stage_keys(sKeys + st * 2 * TC_TILE * 4, list, b, k0, tid);
  };

  load_tile<TC_ROWS, D>(sQ, q + qoff, q0, Sq, q_stride, tid, TC_THREADS);
  load_tile<TC_ROWS, D>(sDO, dout + qoff, q0, Sq, q_stride, tid, TC_THREADS);
  if (n_kt > 0) load_kv(0, 0);
  cp_async_commit();

  // delta = rowsum(dout * o) of the block's rows over their D columns,
  // two threads a row
  {
    const int r = tid / 2;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Sq) {
      const __nv_bfloat16* dr = dout + qoff + size_t(row) * q_stride;
      const __nv_bfloat16* orow = o + qoff + size_t(row) * q_stride;
#pragma unroll
      for (int c = (tid & 1) * 8; c < D; c += 16) {
        const uint4 du = *reinterpret_cast<const uint4*>(dr + c);
        const uint4 ou = *reinterpret_cast<const uint4*>(orow + c);
        const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(&du);
        const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ou);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 df = __bfloat1622float2(d2[e]);
          const float2 of = __bfloat1622float2(o2[e]);
          acc += df.x * of.x + df.y * of.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = acc;
      lse2_s[r] = row < Sq ? lse[size_t(bh) * Sq + row] * LOG2E : 0.f;
      if (row < Sq) delta[size_t(bh) * Sq + row] = acc;
    }
  }
  __syncthreads();
  const int rw0 = q0 + 64 * wg;                   // this warpgroup's rows
  const int lr0 = 64 * wg + 16 * warp + lane / 4;   // this thread's, local
  const float lse2[2] = {lse2_s[lr0], lse2_s[lr0 + 8]};
  const float dl[2] = {delta_s[lr0], delta_s[lr0 + 8]};
  const typename Mask::Row rows[2] = {mask.row(b, q0 + lr0),
                                      mask.row(b, q0 + lr0 + 8)};
  const float scale_log2 = scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      load_kv(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t kt = sK + (j & 1) * TILE;
    const uint32_t vt = sV + (j & 1) * TILE;
    const int* kid = keys_s + (j & 1) * 2 * TC_TILE;
    const int e = mask.entry(list, j);
    const int k0 = Mask::tile(e) * TC_TILE;
    if (mask.runs(e, wg, rw0, k0)) {   // uniform: warpgroup
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < k_slices(D); ++kk) {
        wgmma_ss<TC_TILE>(s, desc_k<TC_ROWS>(sQ, 64 * wg, kk),
                          desc_k<TC_TILE>(kt, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < k_slices(D); ++kk) {
        wgmma_ss<TC_TILE>(dp, desc_k<TC_ROWS>(sDO, 64 * wg, kk),
                          desc_k<TC_TILE>(vt, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const bool edge = mask.edge(e, wg, rw0, k0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2_approx(s[i] * scale_log2 - lse2[r]);
        if (edge) {
          const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (!mask.visible(rows[r], mask.at(kid, c, k0))) p = 0.f;
        }
        s[i] = p * (dp[i] - dl[r]);   // dS
      }
      uint32_t a[TC_TILE / 16][4];
#pragma unroll
      for (int kk = 0; kk < TC_TILE / 16; ++kk) pack_a(s, kk, a[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_TILE / 16; ++kk) {
        wgmma_rs<D>(acc, a[kk], desc_mn<TC_TILE>(kt, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + lr0 + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* drow = dq + qoff + size_t(row) * q_stride;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      *reinterpret_cast<uint32_t*>(drow + 8 * jn + 2 * (lane & 3)) =
          pack_bf16(acc[4 * jn + 2 * r] * scale,
                    acc[4 * jn + 2 * r + 1] * scale);
    }
  }
}

template <int D, typename Mask>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                        int H, int KVH, float scale, const Mask mask) {
  using namespace hopper;
  constexpr int DS = stored_width(D);
  constexpr uint32_t TILE = TC_TILE * DS * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = sK + TC_ROWS * DS * 2;
  const uint32_t sQ = sV + TC_ROWS * DS * 2;
  const uint32_t sDO = sQ + 2 * TILE;
  const uint32_t sStat = sDO + 2 * TILE;   // [2 stages][lse, delta][64]
  const float* stat = reinterpret_cast<const float*>(
      smem_raw + (sStat - smem_u32(smem_raw)));
  // the policy's: staged ids of each Q stage [2][seg, pos][64], then the
  // tile list
  const uint32_t sRows = sStat + 4 * TC_TILE * 4;
  const int* rows_s = reinterpret_cast<const int*>(stat + 4 * TC_TILE);
  int* list = reinterpret_cast<int*>(
      smem_raw + (sStat + 8 * TC_TILE * 4 - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bkv = blockIdx.x;
  const int b = bkv / KVH;
  const int kvh = bkv % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.y * TC_ROWS;   // the first key tiles see most
  const size_t q_stride = size_t(H) * D;
  const size_t kv_stride = size_t(KVH) * D;
  const size_t kvoff = (size_t(b) * Sk * KVH + kvh) * D;
  if constexpr (Mask::kStages) {
    mask.build_dkv(list, b, k0 / TC_TILE, tid);
    __syncthreads();
  }

  // list entries [first, first + per_head) of each query head of the
  // group can see a key of this block
  int first;
  const int per_head = mask.count_dkv(list, k0, first);
  const int n_it = group * per_head;

  // the stage's Q / dout tiles and their rows' lse, delta and ids
  auto load_stage = [&](int it, uint32_t st) {
    const int hh = kvh * group + it / per_head;
    const int r0 = Mask::tile(mask.entry(list, first + it % per_head)) *
                   TC_TILE;
    const size_t qoff = (size_t(b) * Sq * H + hh) * D;
    load_tile<TC_TILE, D>(sQ + st * TILE, q + qoff, r0, Sq, q_stride, tid,
                          TC_THREADS);
    load_tile<TC_TILE, D>(sDO + st * TILE, dout + qoff, r0, Sq, q_stride,
                          tid, TC_THREADS);
    if (tid < 2 * TC_TILE) {
      const int r = tid % TC_TILE;
      const float* src = (tid < TC_TILE ? lse : delta) +
                         (size_t(b) * H + hh) * Sq + min(r0 + r, Sq - 1);
      cp_async4(sStat + (st * 2 * TC_TILE + tid) * 4, src, r0 + r < Sq);
    } else {
      mask.stage_rows(sRows + st * 2 * TC_TILE * 4, list, b, r0,
                      tid - 2 * TC_TILE);
    }
  };

  load_tile<TC_ROWS, D>(sK, k + kvoff, k0, Sk, kv_stride, tid, TC_THREADS);
  load_tile<TC_ROWS, D>(sV, v + kvoff, k0, Sk, kv_stride, tid, TC_THREADS);
  if (n_it > 0) load_stage(0, 0);
  cp_async_commit();

  const int kw0 = k0 + 64 * wg;                    // this warpgroup's keys
  const int key0 = kw0 + 16 * warp + lane / 4;     // this thread's, +8
  const float scale_log2 = scale * LOG2E;
  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    adk[i] = 0.f;
    adv[i] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      load_stage(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t st = it & 1;
    const uint32_t qt = sQ + st * TILE;
    const uint32_t dot = sDO + st * TILE;
    const float* lse_s = stat + st * 2 * TC_TILE;
    const float* delta_s = lse_s + TC_TILE;
    const int* rid = rows_s + st * 2 * TC_TILE;
    const int e = mask.entry(list, first + it % per_head);
    const int r0 = Mask::tile(e) * TC_TILE;
    if (mask.runs(e, wg, r0, kw0)) {   // uniform: warpgroup
      float sT[32], dpT[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < k_slices(D); ++kk) {
        wgmma_ss<TC_TILE>(sT, desc_k<TC_ROWS>(sK, 64 * wg, kk),
                          desc_k<TC_TILE>(qt, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < k_slices(D); ++kk) {
        wgmma_ss<TC_TILE>(dpT, desc_k<TC_ROWS>(sV, 64 * wg, kk),
                          desc_k<TC_TILE>(dot, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sT);
      fence_regs(dpT);
      const bool edge = mask.edge(e, wg, r0, kw0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int lr = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);   // column
        float p = exp2_approx(fmaf(sT[i], scale_log2, -lse_s[lr] * LOG2E));
        if (edge) {   // this thread's keys' ids are read here, not kept
          const auto key = mask.key(b, key0 + 8 * ((i >> 1) & 1));
          if (!mask.visible(mask.at(rid, lr, r0), key)) p = 0.f;
        }
        sT[i] = p;                             // P^T
        dpT[i] = p * (dpT[i] - delta_s[lr]);   // dS^T
      }
      uint32_t ap[TC_TILE / 16][4], ads[TC_TILE / 16][4];
#pragma unroll
      for (int kk = 0; kk < TC_TILE / 16; ++kk) {
        pack_a(sT, kk, ap[kk]);
        pack_a(dpT, kk, ads[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_TILE / 16; ++kk) {
        wgmma_rs<D>(adv, ap[kk], desc_mn<TC_TILE>(dot, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < TC_TILE / 16; ++kk) {
        wgmma_rs<D>(adk, ads[kk], desc_mn<TC_TILE>(qt, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adv);
      fence_regs(adk);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
    const size_t off = kvoff + size_t(key) * kv_stride;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      const int c = 8 * jn + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(dk + off + c) = pack_bf16(
          adk[4 * jn + 2 * r] * scale, adk[4 * jn + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + c) =
          pack_bf16(adv[4 * jn + 2 * r], adv[4 * jn + 2 * r + 1]);
    }
  }
}

template <int D, typename Mask>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, void* dk, void* dv, float* delta, int B,
                      int Sq, int Sk, int H, int KVH, float scale,
                      const Mask& mask, cudaStream_t stream) {
  const int smem = tc_bwd_smem<D>() + mask.extra_smem();
  if (smem > hopper::MAX_SMEM) return cudaErrorInvalidValue;
  static int configured = 0;   // the shared memory the kernels may take
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<D, Mask>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D, Mask>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    }
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  using bf16 = __nv_bfloat16;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const dim3 grid_q(B * H, (Sq + TC_ROWS - 1) / TC_ROWS);
  flash_bwd_dq_tc_kernel<D, Mask><<<grid_q, TC_THREADS, smem, stream>>>(
      qq, kk, vv, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), delta, Sq,
      Sk, H, KVH, scale, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k(B * KVH, (Sk + TC_ROWS - 1) / TC_ROWS);
  flash_bwd_dkv_tc_kernel<D, Mask><<<grid_k, TC_THREADS, smem, stream>>>(
      qq, kk, vv, static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H, KVH, scale,
      mask);
  return cudaGetLastError();
}

template <typename Mask>
cudaError_t dispatch_tc(const void* q, const void* k, const void* v,
                        const void* o, const void* lse, const void* dout,
                        void* dq, void* dk, void* dv, void* delta, int B,
                        int Sq, int Sk, int H, int KVH, int D, float scale,
                        const Mask& mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (D) {   // one instance for each D that tc_route takes
    case 64:
      return launch_tc<64>(q, k, v, o, dout, l, dq, dk, dv, dl, B, Sq, Sk, H,
                           KVH, scale, mask, s);
    case 72:
      return launch_tc<72>(q, k, v, o, dout, l, dq, dk, dv, dl, B, Sq, Sk, H,
                           KVH, scale, mask, s);
    case 128:
      return launch_tc<128>(q, k, v, o, dout, l, dq, dk, dv, dl, B, Sq, Sk,
                            H, KVH, scale, mask, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The route of a launch, dense or segment: bf16 at D = 64, 72 or 128
// takes the tensor cores (kernels.flash_attention.tensor_core_route is
// its mirror).
bool tc_route(int dtype, int D) {
  return dtype == 1 && (D == 64 || D == 72 || D == 128);
}

bool bad_shape(int B, int Sq, int Sk, int H, int KVH, int D) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || KVH <= 0 || H % KVH != 0 ||
         D % 8 != 0 || D < 8 || D > MAX_D || B * H > 65535 ||
         B * KVH > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. delta is float32 scratch [B, H, Sq]
// that the dq kernel fills and the dkv kernel reads. Returns the
// cudaError_t of the launches.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* o, const void* lse, const void* dout,
                         void* dq, void* dk, void* dv, void* delta, int B,
                         int Sq, int Sk, int H, int KVH, int D, float scale,
                         int causal, int dtype, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KVH, D)) return cudaErrorInvalidValue;
  if (tc_route(dtype, D)) {
    const DenseTC mask{Sq, Sk, Sk - Sq, causal};
    return dispatch_tc(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk,
                       H, KVH, D, scale, mask, stream);
  }
  const DenseMask mask{Sq, Sk, Sk - Sq, causal};
  return dispatch(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H,
                  KVH, D, scale, mask, dtype, stream);
}

// The segment-masked backward: flash_bwd's arguments plus seg_q / pos_q
// int32 [B, Sq], seg_k / pos_k int32 [B, Sk] and the tile extrema stats
// int32 [8, B, stride] at tile_q x tile_k, which must be the route's
// tiles (64 x 64 on the tensor cores, 32 x 32 on the CUDA cores).
extern "C" int flash_bwd_seg(const void* q, const void* k, const void* v,
                             const void* o, const void* lse,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* delta, const void* seg_q,
                             const void* seg_k, const void* pos_q,
                             const void* pos_k, const void* stats, int B,
                             int Sq, int Sk, int H, int KVH, int D,
                             int stride, int tile_q, int tile_k, float scale,
                             int causal, int dtype, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KVH, D)) return cudaErrorInvalidValue;
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  const int* pq = static_cast<const int*>(pos_q);
  const int* pk = static_cast<const int*>(pos_k);
  const int* st = static_cast<const int*>(stats);
  if (tc_route(dtype, D)) {
    if (seg::bad_tiles(Sq, Sk, stride, tile_q, tile_k, TC_TILE, TC_TILE)) {
      return cudaErrorInvalidValue;
    }
    const SegmentTC mask{sq, sk, pq, pk, st, B, Sq, Sk, stride, causal};
    return dispatch_tc(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk,
                       H, KVH, D, scale, mask, stream);
  }
  if (seg::bad_tiles(Sq, Sk, stride, tile_q, tile_k, BM, BN)) {
    return cudaErrorInvalidValue;
  }
  const SegmentMask mask{sq, sk, pq, pk, st, B, Sq, Sk, stride, causal};
  return dispatch(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H,
                  KVH, D, scale, mask, dtype, stream);
}
