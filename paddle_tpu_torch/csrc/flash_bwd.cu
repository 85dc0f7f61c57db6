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
// the forward's tile extrema rule out are skipped):
//
//   p  = exp(q.k * scale - lse)          recomputed, never stored
//   dp = dout . v
//   ds = p * (dp - delta),  delta = rowsum(dout * o)
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T dout
//
// Two kernels, launched in this order on one stream:
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
// operations per byte, so arithmetic bounds it. This first version
// recomputes q k^T and dout v^T in both kernels (7 products) and runs them
// on the CUDA cores in float32, well under the bf16 tensor core peak. Its
// traffic is small all the same: every tile a block loads into shared
// memory serves 32 rows or keys, the score matrix never leaves registers,
// and causal blocks skip the tiles above the diagonal, segment blocks
// those of other documents. Tensor-core (wgmma) tiles are the next step.
//
// Layout: q / o / dout / dq [B, Sq, H, D], k / v / dk / dv [B, Sk, KVH, D],
// all contiguous, float32 or bfloat16; lse and delta float32 [B, H, Sq];
// segment ids and positions int32 [B, Sq] / [B, Sk]. D is a multiple of
// 16, at most 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;               // query rows per tile
constexpr int BN = 32;               // keys per tile
constexpr int QUAD = 4;              // threads sharing one row or key
constexpr int THREADS = 32 * QUAD;   // 128

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

// Sum over the four threads of a quad (all 32 lanes take part).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
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
  // the reference's _seg_run_predicate (see flash_fwd.cu)
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

// dq (and delta). Four threads share a query row; thread t of the quad
// owns dims 16*i + 4*t .. 16*i + 4*t + 3, so the eight rows of a warp read
// the same 64 bytes of a shared key row (a broadcast).
template <typename T, int NC, typename Mask>  // head dim D = 16 * NC
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    float* __restrict__ delta, int Sq, int Sk, int H,
                    int KVH, float scale, Mask mask) {
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
  const size_t roff = ((size_t(b) * Sq + (row_ok ? row : 0)) * H + h) * D;
  const typename Mask::Row rinfo = mask.row(b, row);

  float4 qv[NC];
  float4 dov[NC];
  float4 acc[NC];
  float dlt = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 16 * i + 4 * t;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    qv[i] = row_ok ? load4(q + roff + c) : zero;
    dov[i] = row_ok ? load4(dout + roff + c) : zero;
    dlt += dot4(dov[i], row_ok ? load4(o + roff + c) : zero);
    acc[i] = zero;
  }
  dlt = quad_sum(dlt);
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

#pragma unroll 2
    for (int j = 0; j < BN; ++j) {
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        s += dot4(qv[i], ks[j][4 * i + t]);
        dp += dot4(dov[i], vs[j][4 * i + t]);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const float p = mask.visible(rinfo, mask.tile_key(keys, k0, j))
                          ? __expf(s * scale - lse_r)
                          : 0.f;
      const float ds = p * (dp - dlt);
#pragma unroll
      for (int i = 0; i < NC; ++i) axpy4(acc[i], ds, ks[j][4 * i + t]);
    }
    __syncthreads();
  }

  if (row_ok) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      store4(dq + roff + 16 * i + 4 * t, scale4(acc[i], scale));
    }
  }
}

// dk and dv. Four threads share a key; thread t of the quad owns the same
// dims as in the dq kernel, so the eight keys of a warp read the same 64
// bytes of a shared query row.
template <typename T, int NC, typename Mask>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int KVH,
                     float scale, Mask mask) {
  constexpr int D = 16 * NC;
  constexpr int D4 = D / 4;
  __shared__ float4 qs[BM][D4];
  __shared__ float4 dos[BM][D4];
  __shared__ float lses[BM];
  __shared__ float dls[BM];
  __shared__ typename Mask::Tile rows;

  const int tid = threadIdx.x;
  const int j = tid / QUAD;
  const int t = tid % QUAD;
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
    const int c = 16 * i + 4 * t;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    kv[i] = col_ok ? load4(k + koff + c) : zero;
    vv[i] = col_ok ? load4(v + koff + c) : zero;
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
        if (rr < Sq) {
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
          s += dot4(qs[i][4 * c + t], kv[c]);
          dp += dot4(dos[i][4 * c + t], vv[c]);
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        const float p = mask.visible(mask.tile_row(rows, q0, i), cinfo)
                            ? __expf(s * scale - lses[i])
                            : 0.f;
        const float ds = p * (dp - dls[i]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          axpy4(av[c], p, dos[i][4 * c + t]);
          axpy4(ak[c], ds, qs[i][4 * c + t]);
        }
      }
      __syncthreads();
    }
  }

  if (col_ok) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = 16 * i + 4 * t;
      store4(dk + koff + c, scale4(ak[i], scale));
      store4(dv + koff + c, av[i]);
    }
  }
}

template <typename T, typename Mask>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float* delta, int B, int Sq,
                   int Sk, int H, int KVH, int D, float scale, Mask mask,
                   cudaStream_t stream) {
  const dim3 grid_q((Sq + BM - 1) / BM, B * H);
  const dim3 grid_k((Sk + BN - 1) / BN, B * KVH);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* oo = static_cast<const T*>(o);
  const T* gg = static_cast<const T*>(dout);
  T* dqq = static_cast<T*>(dq);
  T* dkk = static_cast<T*>(dk);
  T* dvv = static_cast<T*>(dv);
  cudaError_t err = cudaSuccess;
#define FLASH_BWD_CASE(NC)                                                 \
  case NC:                                                                 \
    flash_bwd_dq_kernel<T, NC, Mask><<<grid_q, THREADS, 0, stream>>>(      \
        qq, kk, vv, oo, gg, lse, dqq, delta, Sq, Sk, H, KVH, scale, mask); \
    err = cudaGetLastError();                                              \
    if (err != cudaSuccess) return err;                                    \
    flash_bwd_dkv_kernel<T, NC, Mask><<<grid_k, THREADS, 0, stream>>>(     \
        qq, kk, vv, gg, lse, delta, dkk, dvv, Sq, Sk, H, KVH, scale,       \
        mask);                                                             \
    break;
  switch (D / 16) {
    FLASH_BWD_CASE(1) FLASH_BWD_CASE(2) FLASH_BWD_CASE(3) FLASH_BWD_CASE(4)
    FLASH_BWD_CASE(5) FLASH_BWD_CASE(6) FLASH_BWD_CASE(7) FLASH_BWD_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
  return cudaGetLastError();
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

bool bad_shape(int B, int Sq, int Sk, int H, int KVH, int D) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || KVH <= 0 || H % KVH != 0 ||
         D % 16 != 0 || D < 16 || D > 128 || B * H > 65535 ||
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
  const DenseMask mask{Sq, Sk, Sk - Sq, causal};
  return dispatch(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H,
                  KVH, D, scale, mask, dtype, stream);
}

// The segment-masked backward: flash_bwd's arguments plus seg_q / pos_q
// int32 [B, Sq], seg_k / pos_k int32 [B, Sk] and the forward's tile
// extrema stats int32 [6, B, stride] at 32 x 32.
extern "C" int flash_bwd_seg(const void* q, const void* k, const void* v,
                             const void* o, const void* lse,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* delta, const void* seg_q,
                             const void* seg_k, const void* pos_q,
                             const void* pos_k, const void* stats, int B,
                             int Sq, int Sk, int H, int KVH, int D,
                             int stride, float scale, int causal, int dtype,
                             void* stream) {
  if (bad_shape(B, Sq, Sk, H, KVH, D) || stride < (Sq + BM - 1) / BM ||
      stride < (Sk + BN - 1) / BN) {
    return cudaErrorInvalidValue;
  }
  const SegmentMask mask{
      static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
      static_cast<const int*>(pos_q), static_cast<const int*>(pos_k),
      static_cast<const int*>(stats), B, Sq, Sk, stride, causal};
  return dispatch(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H,
                  KVH, D, scale, mask, dtype, stream);
}
