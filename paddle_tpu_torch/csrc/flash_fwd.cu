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
//   causal, the key's segment-local position is <= the query's. A tile
//   pair whose per-tile segment / position extrema (computed once per
//   call by the wrapper, _seg_block_stats, at the route's tiles) rule out
//   every visible pair is skipped without loading it.
// Also writes the log-sum-exp lse[b, h, r] = m + log(l) that the backward
// will read. A row that sees no key (padding, or nothing before the
// causal limit) gets a zero output and lse = -inf. Any Sq / Sk works: the
// ragged edge is masked, not required to divide a tile.
//
// Bound on the H100: for a long causal prefill the work is 2*B*H*S^2*D
// floating-point operations against (4*B*S*H*D) bytes, far above the
// card's ~295 operations per byte, so it is bounded by arithmetic (for
// packed rows, by the visible pairs only: the sum over documents of
// n(n+1)/2). A short non-causal one is bounded by bytes instead: at
// DiT-XL/2's sampling shape [16, 256, 16, 72] the 4.8 GFLOP take 4.9 us
// at the bf16 peak and the 38.0 MB of q, k, v, out and lse 11.3 us at
// 3.35 TB/s. Two routes, chosen alike by both entries (tc_route):
// - tensor cores (bfloat16 at D = 64, 72 or 128, the route of every
//   main path; flash_fwd_tc_kernel below, over the DenseTC or SegmentTC
//   policy): wgmma products in bf16 with float32 sums, 128 query rows a
//   block, K / V tiles of 128 keys through TMA rings, a producer
//   warpgroup and two consumers. D is the computed width and DS =
//   64 ceil(D / 64) the stored one (hopper_mma.cuh): D 72 runs in D
//   128's tiles, S = Q K^T over 5 k16 slices, O += P V at N = 72, and
//   the columns past 72 are TMA's zero fill, which reads no memory, so
//   each block moves only its q tile, the key tiles it walks and its
//   output. A segment block lists once the key tiles it runs (128 x 128
//   pairs) and walks only those; the keys' segment ids and positions are
//   staged beside each K stage, and only tiles that hold a document
//   boundary, a diagonal or the ragged edge mask element by element;
// - CUDA cores (float32, or bfloat16 at another D): the arithmetic in
//   float32, 32 query rows a block. Its traffic is at the minimum all the
//   same: each block loads every key and value tile it needs once into
//   shared memory and reuses it for 32 query rows; the S x S score matrix
//   never leaves registers; causal blocks stop at the diagonal and
//   segment blocks skip 32 x 32 tiles of other documents, so masked tiles
//   cost nothing. The per-key segment ids and positions of a tile are
//   staged in shared memory beside it, the query's own stay in registers.
//   A row is shared by 4 threads up to a padded head dim Dp of 128 and by
//   8 above it, so that a thread holds at most 32 floats of q and 32 of
//   the accumulator at any D; D is padded to Dp (a multiple of 16, or of
//   32 above 128) with zeros in registers and shared memory, and the pad
//   is never stored. The tiles (up to 64 KB at Dp 256) are dynamic shared
//   memory.
//
// Layout: q [B, Sq, H, D], k / v [B, Sk, KVH, D], out like q, all
// contiguous, float32 or bfloat16; lse float32 [B, H, Sq]; segment ids and
// positions int32 [B, Sq] (query side) and [B, Sk] (key side). D is a
// multiple of 8, from 8 to 256 (the tensor cores take bf16 at 64, 72 and
// 128).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"
#include "segment_tiles.cuh"

namespace {

constexpr int BM = 32;               // query rows per block
constexpr int BN = 32;               // keys per shared-memory tile
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

// Sum over the G threads that share a row (all 32 lanes take part).
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < G; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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
  // the reference's _seg_run_predicate (seg::runs)
  __device__ __forceinline__ bool tile_runs(int b, int qt, int kt) const {
    return seg::runs(stats + size_t(b) * stride, size_t(B) * stride, qt, kt,
                     causal);
  }
};

// One block: BM query rows of one (batch, head). G threads share a row
// (4, or 8 above a padded head dim of 128); thread t of the group owns the
// dims 4 G i + 4 t .. 4 G i + 4 t + 3 of q and of the accumulator (i <
// NC), so a group reads 16 G contiguous bytes of a shared key row and the
// 32 / G rows of a warp read the same bytes (a broadcast). Dp = 4 G NC is
// D rounded up; a thread's dims lie all below D or all at or past it (D
// is a multiple of 8), those past it hold zeros in q and in the tiles, so
// they add nothing to a score, and are not stored.
// tiles_ran, when not null, counts the tiles the block computes.
template <typename T, int G, int NC, typename Mask>
__global__ void __launch_bounds__(BM * G)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                 int D, float scale, Mask mask, int* tiles_ran) {
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
  const typename Mask::Row rinfo = mask.row(b, row);

  float4 qv[NC];
  float4 acc[NC];
  const T* qrow = q + ((size_t(b) * Sq + (row_ok ? row : 0)) * H + h) * D;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 4 * (G * i + t);
    qv[i] = row_ok && c < D ? load4(qrow + c) : make_float4(0, 0, 0, 0);
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

    float s[BN];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) p += dot4(qv[i], ks[j][G * i + t]);
      p = group_sum<G>(p);
      const bool ok = mask.visible(rinfo, mask.tile_key(keys, k0, j));
      s[j] = ok ? p * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new != -INFINITY) {  // uniform over the group
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
          const float4 vv = vs[j][G * i + t];
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
      const int c = 4 * (G * i + t);
      if (c < D) {
        store4(orow + c, make_float4(acc[i].x * inv, acc[i].y * inv,
                                     acc[i].z * inv, acc[i].w * inv));
      }
    }
    if (t == 0) lse[size_t(bh) * Sq + row] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

// One launch of the (G, NC) instance: its K and V tiles, 2 BN Dp floats,
// are dynamic shared memory (64 KB at Dp 256), which the kernel is
// allowed once.
template <typename T, int G, int NC, typename Mask>
cudaError_t run(const T* q, const T* k, const T* v, T* out, float* lse,
                int B, int Sq, int Sk, int H, int KVH, int D, float scale,
                Mask mask, int* tiles_ran, cudaStream_t stream) {
  constexpr int smem = 2 * BN * G * NC * int(sizeof(float4));
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, G, NC, Mask>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_fwd_kernel<T, G, NC, Mask><<<grid, BM * G, smem, stream>>>(
      q, k, v, out, lse, Sq, Sk, H, KVH, D, scale, mask, tiles_ran);
  return cudaGetLastError();
}

// The instance of a head dim: 4 threads a row and Dp = 16 NC up to 128,
// 8 threads a row and Dp = 32 NC above.
template <typename T, typename Mask>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Sk, int H, int KVH, int D,
                   float scale, Mask mask, int* tiles_ran,
                   cudaStream_t stream) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
#define FLASH_CASE(G, NC)                                                   \
  case NC:                                                                  \
    return run<T, G, NC, Mask>(qq, kk, vv, oo, lse, B, Sq, Sk, H, KVH, D,   \
                               scale, mask, tiles_ran, stream);
  if (D <= 128) {
    switch ((D + 15) / 16) {
      FLASH_CASE(4, 1) FLASH_CASE(4, 2) FLASH_CASE(4, 3) FLASH_CASE(4, 4)
      FLASH_CASE(4, 5) FLASH_CASE(4, 6) FLASH_CASE(4, 7) FLASH_CASE(4, 8)
      default: break;
    }
  } else {
    switch ((D + 31) / 32) {
      FLASH_CASE(8, 5) FLASH_CASE(8, 6) FLASH_CASE(8, 7) FLASH_CASE(8, 8)
      default: break;
    }
  }
#undef FLASH_CASE
  return cudaErrorInvalidValue;
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

// ---- the tensor-core route: bfloat16, D = 64, 72 or 128 ----------------
//
// Widths: the template's D is the computed width, the count of every
// product (S over k_slices(D) k16 slices, O at N = D: 36 floats a thread
// at D 72); tiles, TMA boxes and shared memory are at the stored width
// stored_width(D) (128 at D 72: tc_fwd_smem<72> is tc_fwd_smem<128>).
// The TMA maps carry the real D, so a box past it reads zeros and its
// expected-tx count stays the whole box.
//
// Bound: at DiT-XL/2's [16, 256, 16, 72] bytes (11.3 us) set it, and a
// 128-row block sees only 2 key tiles of S 256, so its fixed cost (the
// Q load, the ring's fill, the epilogue) is paid for little work; the
// 512 blocks keep every SM busy for about four waves.
//
// One block holds 128 query rows of one (batch, head) in three warpgroups
// (FlashAttention-3's roles):
// - the producer (warpgroup 2): one thread loads the Q tile once and
//   streams the K and V tiles of 128 keys through two 2-stage rings in
//   shared memory with TMA (128-byte swizzle; rows past the end read as
//   zeros). Each stage has a "full" mbarrier (the copies' bytes) and an
//   "empty" one (all 256 consumer threads are done with it: a K tile after
//   its S product, a V tile after its P V product);
// - two consumer warpgroups of 64 rows each. Per key tile: S = Q K^T is a
//   wgmma with both operands in shared memory (K-major); the online
//   softmax runs on S in registers (base-2 exponentials, one FFMA a score
//   with scale * log2(e)); P is rounded to bf16 in registers and O += P V
//   is a wgmma with A from registers and V as an MN-major B from shared
//   memory. The warpgroups take turns at issuing S (named barriers), so
//   that one's softmax overlaps the other's products; O is rescaled only
//   when a row maximum moved.
// The mask is a policy (DenseTC, SegmentTC below). A block walks a list
// of key tiles that its producer and consumers read alike, so that no
// product and no wait sits under a data-dependent condition; only tiles
// the list marks as edges mask element by element. Blocks go out longest
// first (the last q tiles of every head, which see the most keys under
// the dense causal mask).
constexpr int TC_CONSUMERS = 256;
constexpr int TC_THREADS = TC_CONSUMERS + 128;
constexpr int TC_BM = 128;   // query rows a block
constexpr int TC_BN = 128;   // keys a tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// named barriers 1 and 2: the warpgroups' turns
constexpr int BAR_TURN = 1;
// stages of the K and V rings; byte offsets of their mbarriers (one a
// stage) from the first
constexpr int STAGES = 2;
constexpr uint32_t KFULL = 0, KEMPTY = 8 * STAGES, VFULL = 16 * STAGES,
                   VEMPTY = 24 * STAGES, QFULL = 32 * STAGES;
// a policy's shared memory starts this far past the mbarriers
constexpr int TC_EXTRA = 128;
// producer threads that stage a segment tile's key ids and positions (two
// keys each; the last two warps of the producer warpgroup)
constexpr int TC_STAGERS = TC_BN / 2;

// at head dim D: Q, STAGES x (K, V) at the stored width, the mbarriers,
// alignment
template <int D>
constexpr int tc_fwd_smem() {
  return (TC_BM + 2 * STAGES * TC_BN) * hopper::stored_width(D) * 2 +
         32 * STAGES + 8 + 1024;
}

// The dense mask: bottom-right-aligned causal, or none. A q tile walks
// key tiles 0 .. count - 1, up to the causal diagonal of its last row;
// tiles that cross the diagonal or the ragged edge are edges.
struct DenseTC {
  int Sq, Sk, offset;   // offset = Sk - Sq
  int causal;
  static constexpr bool kStagesKeys = false;
  struct Row { int i; };

  int extra_smem() const { return 0; }
  __device__ __forceinline__ void build(int*, int b, int qt, int tid) const {}
  __device__ __forceinline__ int count(const int*, int q0) const {
    const int q_last = min(q0 + TC_BM, Sq) - 1;
    const int k_end = causal ? min(Sk, q_last + offset + 1) : Sk;
    return k_end > 0 ? (k_end + TC_BN - 1) / TC_BN : 0;
  }
  __device__ __forceinline__ int entry(const int*, int j) const { return j; }
  __device__ __forceinline__ static int tile(int e) { return e; }
  __device__ __forceinline__ bool edge(int e, int k0, int wg_first) const {
    return k0 + TC_BN > Sk || (causal && k0 + TC_BN - 1 > wg_first + offset);
  }
  __device__ __forceinline__ Row row(int b, int i) const { return {i}; }
  // scores of keys past Sk or after the diagonal to -inf
  __device__ __forceinline__ void apply(float (&s)[64], const int4*, int k0,
                                        const Row (&r)[2], int lane) const {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int row = r[(i >> 1) & 1].i;
      const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (col >= Sk || (causal && col > row + offset)) s[i] = -INFINITY;
    }
  }
};

// The segment mask (SegmentMask's, on the tensor cores). warp 0 lists the
// key tiles of the block's q tile that the run predicate keeps, at 128 x
// 128 (stats at TC_BM x TC_BN); an entry is an edge unless every pair of
// the tile is visible. The producer's stagers copy each key tile's
// (segment, position) pairs into shared memory beside its K stage (keys
// past Sk get segment -2, which no row has); each consumer keeps its two
// rows' pairs in registers (rows past Sq get segment -1).
struct SegmentTC {
  const int* seg_q;   // [B, Sq]
  const int* seg_k;   // [B, Sk]
  const int* pos_q;   // [B, Sq]
  const int* pos_k;   // [B, Sk]
  const int* stats;   // [8, B, stride] at TC_BM x TC_BN
  int* tiles_ran;     // when not null, += the tiles the block computes
  int B, Sq, Sk, stride;
  int causal;
  static constexpr bool kStagesKeys = true;
  struct Row { int seg, pos; };

  // the key stages (int2 a key), then the list
  int extra_smem() const {
    return TC_EXTRA + STAGES * TC_BN * 8 + 4 * (1 + (Sk + TC_BN - 1) / TC_BN);
  }
  __device__ __forceinline__ void build(int* list, int b, int qt,
                                        int tid) const {
    if (tid >= 32) return;
    const int* st = stats + size_t(b) * stride;
    const size_t plane = size_t(B) * stride;
    const int n = seg::compact(
        list, (Sk + TC_BN - 1) / TC_BN, tid, [&](int kt) {
          const int f = seg::flags(st, plane, qt, kt, causal,
                                   (kt + 1) * TC_BN > Sk, 0);
          return f != 0 ? kt | f : -1;
        });
    if (tid == 0 && tiles_ran != nullptr) atomicAdd(tiles_ran, n);
  }
  __device__ __forceinline__ int count(const int* list, int q0) const {
    return list[0];
  }
  __device__ __forceinline__ int entry(const int* list, int j) const {
    return list[1 + j];
  }
  __device__ __forceinline__ static int tile(int e) { return e & seg::TILE; }
  __device__ __forceinline__ bool edge(int e, int k0, int wg_first) const {
    return (e & seg::EDGE0) != 0;
  }
  __device__ __forceinline__ Row row(int b, int i) const {
    if (i >= Sq) return {-1, 0};
    const size_t o = size_t(b) * Sq + i;
    return {seg_q[o], pos_q[o]};
  }
  // stager t's keys k0 + 2 t, k0 + 2 t + 1 as (seg, pos, seg, pos)
  __device__ __forceinline__ int4 load_keys(int b, int k0, int t) const {
    int v[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = k0 + 2 * t + e;
      const size_t o = size_t(b) * Sk + i;
      v[2 * e] = i < Sk ? seg_k[o] : -2;
      v[2 * e + 1] = i < Sk ? pos_k[o] : 0;
    }
    return make_int4(v[0], v[1], v[2], v[3]);
  }
  // keys holds the stage's (segment, position) pairs two keys an int4;
  // this thread's columns 8 g + 2 (lane % 4) + {0, 1} are int4 4 g + lane % 4
  __device__ __forceinline__ void apply(float (&s)[64], const int4* keys,
                                        int k0, const Row (&r)[2],
                                        int lane) const {
#pragma unroll
    for (int g = 0; g < TC_BN / 8; ++g) {
      const int4 kk = keys[4 * g + (lane & 3)];
#pragma unroll
      for (int i = 4 * g; i < 4 * g + 4; ++i) {
        const Row& rr = r[(i >> 1) & 1];
        const int kseg = (i & 1) ? kk.z : kk.x;
        const int kpos = (i & 1) ? kk.w : kk.y;
        if (!(rr.seg >= 0 && kseg == rr.seg && (!causal || kpos <= rr.pos))) {
          s[i] = -INFINITY;
        }
      }
    }
  }
};

// The consumer warpgroups' part of flash_fwd_tc_kernel.
template <int D, typename Mask>
__device__ __forceinline__ void consume(
    uint32_t sQ, uint32_t sK, uint32_t sV, uint32_t bars,
    const int4* __restrict__ keys, const int* __restrict__ list,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int b, int h,
    int q0, int n_kt, int Sq, int H, float scale_log2, const Mask& mask) {
  using namespace hopper;
  constexpr uint32_t TILE = TC_BN * stored_width(D) * 2;
  constexpr int NO = D / 2;   // O's 64 x D accumulator, floats a thread
  const int tid = threadIdx.x;
  const int wg = warpgroup_index();
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bh = b * H + h;
  const size_t q_stride = size_t(H) * D;
  mbar_wait(bars + QFULL, 0);

  // this thread's two rows (accumulator registers with (i / 2) % 2 = 0, 1)
  const int wg_first = q0 + 64 * wg;
  const int row0 = wg_first + 16 * warp + lane / 4;
  const typename Mask::Row rows[2] = {mask.row(b, row0),
                                      mask.row(b, row0 + 8)};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  uint32_t a[TC_BN / 16][4];   // P_{j-1} as bf16 A fragments

  // scores times scale * log2(e) = (flip ? -s : s) times sl2 > 0; FLT_MIN
  // for a zero scale keeps a masked -inf from becoming -inf * 0 = NaN
  const bool flip = scale_log2 < 0.f;
  const float sl2 = fmaxf(fabsf(scale_log2), FLT_MIN);

  // No wgmma and no wait sits under a condition (ptxas serialises every
  // wgmma of a kernel whose products it cannot pair with their waits),
  // and a warpgroup's P V is done before its next S is issued: with S, P
  // and O all live across products the consumers need more than the
  // 168 registers a thread ptxas allocates them.
  auto issue_s = [&](int j, float(&s)[64]) {   // S_j = Q K_j^T
    const uint32_t kt = sK + (j % STAGES) * TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < k_slices(D); ++kk) {
      wgmma_ss<TC_BN>(s, desc_k<TC_BM>(sQ, 64 * wg, kk),
                      desc_k<TC_BN>(kt, 0, kk), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int j) {   // O += P_j V_j
    const uint32_t vt = sV + (j % STAGES) * TILE;
    fence_regs(o);
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BN / 16; ++kk) {
      wgmma_rs<D>(o, a[kk], desc_mn<TC_BN>(vt, kk), 1);
    }
    wgmma_commit();
  };
  auto wait_k = [&](int j) {
    mbar_wait(bars + KFULL + 8 * (j % STAGES), (j / STAGES) & 1);
  };
  auto wait_v = [&](int j) {
    mbar_wait(bars + VFULL + 8 * (j % STAGES), (j / STAGES) & 1);
  };
  // the warpgroups take turns at issuing products; warpgroup 1 does not
  // hand back its last turn, which nobody takes
  auto take_turn = [&]() { bar_sync(BAR_TURN + wg, TC_CONSUMERS); };
  auto pass_turn = [&](bool last) {
    if (wg == 0 || !last) bar_arrive(BAR_TURN + 1 - wg, TC_CONSUMERS);
  };
  // the online softmax of tile j on S_j (done): P_j in s, alpha the
  // factor of O's rescale; K_j (and its staged keys) is released
  auto softmax = [&](int j, float(&s)[64], float(&alpha)[2]) {
    fence_regs(s);
    if constexpr (!Mask::kStagesKeys) {
      mbar_arrive(bars + KEMPTY + 8 * (j % STAGES));
    }
    if (flip) {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = -s[i];
    }
    const int e = mask.entry(list, j);
    const int k0 = Mask::tile(e) * TC_BN;
    if (mask.edge(e, k0, wg_first)) {
      mask.apply(s, keys + (j % STAGES) * (TC_BN / 2), k0, rows, lane);
    }
    if constexpr (Mask::kStagesKeys) {
      mbar_arrive(bars + KEMPTY + 8 * (j % STAGES));
    }
    // the row maximum of the raw scores (a positive scale commutes with
    // max); each probability is then one FFMA and one exponential
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl2);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;   // no -inf - -inf
      alpha[r] = exp2_approx(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2_approx(fmaf(s[i], sl2, -mu[r]));
      l[r] += s[i];
    }
  };

  if (n_kt > 0) {   // uniform over the block
    if (wg == 1) bar_arrive(BAR_TURN, TC_CONSUMERS);   // warpgroup 0 first
    for (int j = 0; j < n_kt; ++j) {
      float s[64], alpha[2];
      wait_k(j);
      take_turn();
      issue_s(j, s);
      pass_turn(j == n_kt - 1);
      wgmma_wait<0>();
      softmax(j, s, alpha);
      // alpha is exactly 1 where a row's maximum did not move: most tiles
      // after the first few skip the rescale (decided a warp at a time)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
#pragma unroll
      for (int kk = 0; kk < TC_BN / 16; ++kk) pack_a(s, kk, a[kk]);
      wait_v(j);
      issue_pv(j);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(a);
      mbar_arrive(bars + VEMPTY + 8 * (j % STAGES));
    }
  }

  // a row that saw no key (l = 0: an empty list, padding, nothing before
  // the causal limit) writes zeros and lse = -inf
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* orow = out + (size_t(b) * Sq + row) * q_stride + h * D;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      *reinterpret_cast<uint32_t*>(orow + 8 * jn + 2 * (lane & 3)) =
          pack_bf16(o[4 * jn + 2 * r] * inv, o[4 * jn + 2 * r + 1] * inv);
    }
    if ((lane & 3) == 0) {
      lse[size_t(bh) * Sq + row] =
          l[r] > 0.f ? (m[r] + __log2f(l[r])) * LN2 : -INFINITY;
    }
  }
}

template <int D, typename Mask>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int Sq, int H, int KVH, float scale_log2,
                    const Mask mask) {
  using namespace hopper;
  constexpr int DS = stored_width(D);
  constexpr uint32_t TILE = TC_BN * DS * 2;   // bytes of a K or V tile
  constexpr uint32_t HALF = TC_BN * 128;      // bytes of a 64-column block
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + TC_BM * DS * 2;
  const uint32_t sV = sK + STAGES * TILE;
  // mbarriers, one a stage: K full, K empty, V full, V empty; Q full
  const uint32_t bars = sV + STAGES * TILE;
  // the policy's: staged keys of each K stage, then the tile list
  int2* keys = reinterpret_cast<int2*>(
      smem_raw + (bars + TC_EXTRA - smem_u32(smem_raw)));
  int* list = reinterpret_cast<int*>(keys + STAGES * TC_BN);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BM;   // longest first

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      // K full: the TMA thread's arrival with its bytes, and each stager's
      mbar_init(bars + KFULL + 8 * st, Mask::kStagesKeys ? 1 + TC_STAGERS : 1);
      mbar_init(bars + KEMPTY + 8 * st, TC_CONSUMERS);
      mbar_init(bars + VFULL + 8 * st, 1);
      mbar_init(bars + VEMPTY + 8 * st, TC_CONSUMERS);
    }
    mbar_init(bars + QFULL, 1);
    mbar_fence_init();
  }
  mask.build(list, b, q0 / TC_BM, tid);
  __syncthreads();
  const int n_kt = mask.count(list, q0);

  const int wg = warpgroup_index();
  if (wg == 2) {   // the producer
    // (setmaxnreg does not lift ptxas's 168 registers for the consumers;
    // the stagers need more than 24, so the segment policy keeps both)
    if constexpr (!Mask::kStagesKeys) regs_dealloc<24>();
    const int pt = tid - TC_CONSUMERS;
    if (pt == 0) {
      // every box counts whole, its columns past D (zeros) included
      mbar_expect_tx(bars + QFULL, TC_BM * DS * 2);
#pragma unroll
      for (int c = 0; c < DS / 64; ++c) {
        tma_load_4d(sQ + c * TC_BM * 128, &q_map, bars + QFULL, 64 * c, h,
                    q0, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % STAGES;
        const uint32_t parity = (j / STAGES - 1) & 1;   // the stage's last use
        const int k0 = Mask::tile(mask.entry(list, j)) * TC_BN;
        if (j >= STAGES) mbar_wait(bars + KEMPTY + 8 * st, parity);
        mbar_expect_tx(bars + KFULL + 8 * st, TILE);
#pragma unroll
        for (int c = 0; c < DS / 64; ++c) {
          tma_load_4d(sK + st * TILE + c * HALF, &k_map, bars + KFULL + 8 * st,
                      64 * c, kvh, k0, b);
        }
        if (j >= STAGES) mbar_wait(bars + VEMPTY + 8 * st, parity);
        mbar_expect_tx(bars + VFULL + 8 * st, TILE);
#pragma unroll
        for (int c = 0; c < DS / 64; ++c) {
          tma_load_4d(sV + st * TILE + c * HALF, &v_map, bars + VFULL + 8 * st,
                      64 * c, kvh, k0, b);
        }
      }
    } else if constexpr (Mask::kStagesKeys) {
      if (pt >= 128 - TC_STAGERS) {   // the stagers
        const int t = pt - (128 - TC_STAGERS);
        for (int j = 0; j < n_kt; ++j) {
          const int st = j % STAGES;
          const uint32_t parity = (j / STAGES - 1) & 1;
          // the ids load while the stage is still in use
          const int4 ids = mask.load_keys(
              b, Mask::tile(mask.entry(list, j)) * TC_BN, t);
          if (j >= STAGES) mbar_wait(bars + KEMPTY + 8 * st, parity);
          reinterpret_cast<int4*>(keys + st * TC_BN)[t] = ids;
          mbar_arrive(bars + KFULL + 8 * st);
        }
      }
    }
  } else {
    if constexpr (!Mask::kStagesKeys) regs_alloc<240>();
    consume<D>(sQ, sK, sV, bars, reinterpret_cast<const int4*>(keys), list,
               out, lse, b, h, q0, n_kt, Sq, H, scale_log2, mask);
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// that the library links nothing beyond the CUDA runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A TMA map of a contiguous bf16 [B, S, NH, D] tensor whose box is 64
// columns of `rows` rows of one (batch, head), swizzled by 128 bytes: the
// shared-memory layout of one 64-column block of a tile (hopper_mma.cuh).
// Rows past S, and columns past D (the second box at D 72 holds 8 real
// columns), read as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int NH,
                int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(NH), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(NH) * D * 2,
                                 cuuint64_t(S) * NH * D * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, typename Mask>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      float* lse, int B, int Sq, int Sk, int H, int KVH,
                      float scale, const Mask& mask, cudaStream_t stream) {
  const int smem = tc_fwd_smem<D>() + mask.extra_smem();
  if (smem > hopper::MAX_SMEM) return cudaErrorInvalidValue;
  static int configured = 0;   // the shared memory the kernel may take
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<D, Mask>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  CUtensorMap q_map, k_map, v_map;
  if (!tensor_map(&q_map, q, B, Sq, H, D, TC_BM) ||
      !tensor_map(&k_map, k, B, Sk, KVH, D, TC_BN) ||
      !tensor_map(&v_map, v, B, Sk, KVH, D, TC_BN)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(B * H, (Sq + TC_BM - 1) / TC_BM);
  flash_fwd_tc_kernel<D, Mask><<<grid, TC_THREADS, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, Sq, H, KVH,
      scale * LOG2E, mask);
  return cudaGetLastError();
}

template <typename Mask>
cudaError_t dispatch_tc(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int Sq, int Sk, int H,
                        int KVH, int D, float scale, const Mask& mask,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {   // one instance for each D that tc_route takes
    case 64:
      return launch_tc<64>(q, k, v, out, l, B, Sq, Sk, H, KVH, scale, mask,
                           s);
    case 72:
      return launch_tc<72>(q, k, v, out, l, B, Sq, Sk, H, KVH, scale, mask,
                           s);
    case 128:
      return launch_tc<128>(q, k, v, out, l, B, Sq, Sk, H, KVH, scale, mask,
                            s);
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
         D % 8 != 0 || D < 8 || D > MAX_D;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int Sq, int Sk, int H,
                         int KVH, int D, float scale, int causal, int dtype,
                         void* stream) {
  if (bad_shape(B, Sq, Sk, H, KVH, D)) return cudaErrorInvalidValue;
  if (tc_route(dtype, D)) {
    const DenseTC mask{Sq, Sk, Sk - Sq, causal};
    return dispatch_tc(q, k, v, out, lse, B, Sq, Sk, H, KVH, D, scale, mask,
                       stream);
  }
  const DenseMask mask{Sq, Sk, Sk - Sq, causal};
  return dispatch(q, k, v, out, lse, B, Sq, Sk, H, KVH, D, scale, mask,
                  nullptr, dtype, stream);
}

// The segment-masked forward. seg_q / pos_q int32 [B, Sq], seg_k / pos_k
// int32 [B, Sk]; stats int32 [8, B, stride], the tile extrema at tile_q x
// tile_k, which must be the route's tiles (128 x 128 on the tensor cores,
// 32 x 32 on the CUDA cores); tiles_ran, when not null, an int32 the
// kernel adds one to for every (batch, head, q tile, k tile) it computes.
extern "C" int flash_fwd_seg(const void* q, const void* k, const void* v,
                             void* out, void* lse, const void* seg_q,
                             const void* seg_k, const void* pos_q,
                             const void* pos_k, const void* stats,
                             void* tiles_ran, int B, int Sq, int Sk, int H,
                             int KVH, int D, int stride, int tile_q,
                             int tile_k, float scale, int causal, int dtype,
                             void* stream) {
  if (bad_shape(B, Sq, Sk, H, KVH, D) || B * H > 65535) {
    return cudaErrorInvalidValue;
  }
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  const int* pq = static_cast<const int*>(pos_q);
  const int* pk = static_cast<const int*>(pos_k);
  const int* st = static_cast<const int*>(stats);
  int* ran = static_cast<int*>(tiles_ran);
  if (tc_route(dtype, D)) {
    if (seg::bad_tiles(Sq, Sk, stride, tile_q, tile_k, TC_BM, TC_BN)) {
      return cudaErrorInvalidValue;
    }
    const SegmentTC mask{sq, sk, pq, pk, st, ran, B, Sq, Sk, stride, causal};
    return dispatch_tc(q, k, v, out, lse, B, Sq, Sk, H, KVH, D, scale, mask,
                       stream);
  }
  if (seg::bad_tiles(Sq, Sk, stride, tile_q, tile_k, BM, BN)) {
    return cudaErrorInvalidValue;
  }
  const SegmentMask mask{sq, sk, pq, pk, st, B, Sq, Sk, stride, causal};
  return dispatch(q, k, v, out, lse, B, Sq, Sk, H, KVH, D, scale, mask, ran,
                  dtype, stream);
}
