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
// 3.35 TB/s (float32 pages: twice the bf16 bytes; int8 pages: half, plus 8
// bytes of scales per page and kv head).
//
// Page types (the serving engine's kv_dtype): the full-precision entry takes
// pages of float32, bfloat16 or float16 under a float32 or bfloat16 q, the
// Pallas kernel's domain. Every pair computes q.k and the online softmax in
// float32. The pairs whose page type is not q's round p to a 2-byte page
// type before the P.V product, as the Pallas kernel's p.astype(v.dtype)
// does (float32 pages: p stays float32); the same-type pairs keep p in
// float32, as they always have.
//
// Design (split positions, flash-decoding). The grid is (splits, KVH * hg,
// B): a block takes one chunk of pages_per_split whole pages of one
// sequence and serves the group's query heads of one kv head, G at a time
// (G = 1, 2, 4 or 8 >= group; hg = ceil(group / 8) only for groups above
// 8), so each page is read once per kv head. The plan is
// paged_attention.decode_split_plan in the wrapper: 512 positions, halved
// down to 64 while the grid over the table has fewer than 1024 blocks
// (128 at the serving batch of 8, 512 at 32, 64 for one sequence). The
// grid is sized from the table width (maxp), never from lengths, so a
// launch needs no host sync; a block whose chunk starts at or past
// lengths[b] writes an empty partial (m = -inf, l = 0) and exits. Each
// other block writes a float32 partial (running max m and sum l in base
// 2, unnormalised acc [G, D]); a second kernel,
// paged_decode_combine_kernel, launched from the same entry, gives out =
// sum_i 2^(m_i - m) acc_i / sum_i 2^(m_i - m) l_i over the live chunks in
// split order (no atomics: the same bits every run). A sequence that fits
// in one chunk is written by its block directly and skipped by the
// combine; with one split in all the combine is not launched.
//
// Inside a block: at start it reads its chunk's page ids (and, for int8,
// the pages' scales) into shared memory, so no table lookup waits inside
// the loop. Each warp walks its own tiles of the chunk (tile t goes to
// warp t % 4) through its own ring of STAGES tiles in shared memory
// (STAGES - 1 in flight while one is computed; no block barrier until the
// end): cp.async copies of 16 bytes (8 or 4 where a row's bytes or a
// pointer are not a multiple of 16: int8 with D % 16 != 0), positions past
// lengths[b] zero-filled by the copy and never read from device memory. A
// row group is dtp = pow2ceil(D / 8) lanes, a lane holds 8 dims of a row,
// q for the block's G heads in registers (pre-scaled by scale * log2 e) and
// acc[G][8]; a tile is ROWS rows of each of the warp's row groups. Per
// tile a lane does G partial dots over its 8 dims for each of its ROWS
// rows, one butterfly over the row group per (row, head), an online
// softmax that rescales acc once per tile (not per position), and P.V into
// acc in registers; masking is a select (score = -inf), never a product
// with 0, and lanes past D read a zero row instead of branching. Row
// groups are combined once, in shared memory, at the end of the chunk.
// Tensor cores are not used: the arithmetic is 2 * G flop per page
// element on the CUDA cores. At 32 sequences over the full table the bf16
// arm reaches three quarters of the memory bound; the int8 arm, with half
// the bytes and the same arithmetic, is bound by instruction issue
// (float multiply-adds, the butterfly's shuffles, the code conversion),
// not by memory.
//
// The int8 arm is the same kernel instantiated on int8_t pages. A chunk
// holds whole pages and one scale covers a (page, kv head), so the scales
// fold as in the Pallas kernel: a page's k scale multiplies its positions'
// scores (dot(q, codes) * ks), its v scale multiplies p before P.V
// (p * vs * codes), and the codes are never dequantized element by
// element. Codes become floats by the byte-permute trick (code ^ 0x80 into
// the low byte of 0x4B000000 = 2^23, then subtract 2^23 + 128): one
// integer permute and one float add a code, where cvt (I2F) runs at an
// eighth of the FMA rate and would bound the arm before memory does.
//
// Layout: q [B, NH, D], out [B, NH, D], float32 or bfloat16; pages
// [P, KVH, ps, D] of float32, bfloat16 or float16, or int8 with scales
// float32 [P, KVH] (one per page and kv head); all contiguous; block_tables int32 [B, maxp];
// lengths int32 [B]; scratch float32, splits * B * NH * (D + 2) values
// (allocated by the caller; unused, and may be null, with one split).
// D % 8 == 0, D <= 128, group * D <= 1024; page pointers 4-byte aligned.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_u32;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;      // rows of each row group in a tile
constexpr int STAGES = 3;    // tiles in each warp's ring
constexpr int MAXO = 8;      // group * D <= MAXO * THREADS = 1024
constexpr int MAX_SPLIT_PAGES = 512;   // pages a chunk may hold
constexpr float LOG2E = 1.4426950408889634f;

// 8 bytes from global to shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// x / d for 0 <= x < 2^31 without a division: (umulhi(x, mul) + x) >> shift
// with shift = ceil(log2 d) and mul = 2^32 (2^shift - d) / d + 1
struct FastDiv {
  uint32_t mul;
  uint32_t shift;
  __device__ __forceinline__ int div(int x) const {
    return int((__umulhi(uint32_t(x), mul) + uint32_t(x)) >> shift);
  }
};

FastDiv make_div(int d) {
  uint32_t shift = 0;
  while ((1ull << shift) < uint64_t(d)) ++shift;
  return {uint32_t(((1ull << 32) * ((1ull << shift) - d)) / d + 1), shift};
}

// 2^x by the special-function unit (2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// p rounded to the page type (float32 pages: p itself)
__device__ __forceinline__ float round_to(float p, const float*) { return p; }
__device__ __forceinline__ float round_to(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}
__device__ __forceinline__ float round_to(float p, const __half*) {
  return __half2float(__float2half(p));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 8 consecutive page elements from shared memory, as floats
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {       // a bf16 is a float's high half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const __half* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __half22float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)   // 2^23 + (code + 128), exactly
      f[4 * i + j] =
          __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650u | j)) -
          8388736.f;
  }
}

// T: the type of q and out; PageT: the page element, float, bfloat16 or
// half (full precision) or int8_t (codes, with ksc / vsc, which are unused
// and may be null otherwise); G: query heads a block serves.
template <typename T, typename PageT, int G>
__global__ void __launch_bounds__(THREADS, G <= 4 ? 4 : 2)
paged_decode_kernel(const T* __restrict__ q, const PageT* __restrict__ kp,
                    const PageT* __restrict__ vp,
                    const float* __restrict__ ksc,
                    const float* __restrict__ vsc, const int* __restrict__ bt,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part, int B, int NH, int KVH, int ps,
                    FastDiv psd, int D, int dtp, int P, int maxp, int pps,
                    int vb, float qscale) {
  constexpr bool kQuant = std::is_same<PageT, int8_t>::value;
  // a pair whose page type is not q's rounds p to the page type before
  // P.V, as the Pallas kernel does; the same-type pairs keep p in float32
  constexpr bool kRoundP = !kQuant && !std::is_same<PageT, T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = NH / KVH;
  const int hgs = (g + G - 1) / G;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / hgs;
  const int h0 = (blockIdx.y % hgs) * G;
  const int gh = min(G, g - h0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int chunk = pps * ps;
  const int len = max(0, min(lengths[b], maxp * ps));
  const int n = min(len - split * chunk, chunk);   // live positions
  const size_t rows = size_t(B) * NH;
  const size_t row0 = size_t(b) * NH + size_t(kvh) * g + h0;
  float* part_m = part + size_t(split) * rows;
  float* part_l = part_m + size_t(gridDim.x) * rows;
  float* part_a = part + 2 * size_t(gridDim.x) * rows +
                  size_t(split) * rows * D;

  if (n <= 0 && split > 0) {          // an empty chunk adds nothing
    if (tid < gh) {
      part_m[row0 + tid] = -INFINITY;
      part_l[row0 + tid] = 0.f;
    }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rg = lane / dtp;          // the warp's row group
  const int c = lane % dtp;           // this lane's 8 dims of a row
  const int nrg = 32 / dtp;
  const int tile = nrg * ROWS;        // positions a warp takes at a time
  const bool lane_on = 8 * c < D;
  const int rowbytes = D * int(sizeof(PageT));
  const int tile_bytes = tile * rowbytes;      // keys, then values
  unsigned char* wring = smem + warp * STAGES * 2 * tile_bytes;
  int* spage = reinterpret_cast<int*>(smem + WARPS * STAGES * 2 * tile_bytes);
  float* sks = reinterpret_cast<float*>(spage + pps);
  float* svs = sks + pps;
  // 8 zeros that lanes past D read in place of a row, without a branch
  float4* zero = reinterpret_cast<float4*>(svs + pps + (-3 * pps & 3));
  if (tid < 2) zero[tid] = make_float4(0.f, 0.f, 0.f, 0.f);

  float qf[G][8];
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qf[h][e] = h < gh && lane_on
                     ? to_float(q[(row0 + h) * D + 8 * c + e]) * qscale
                     : 0.f;
  }

  const int live = max(n, 0);
  const int npg = psd.div(live + ps - 1);
  for (int i = tid; i < npg; i += THREADS) {
    const int pid =
        min(max(bt[size_t(b) * maxp + size_t(split) * pps + i], 0), P - 1);
    spage[i] = pid;
    if constexpr (kQuant) {
      sks[i] = ksc[size_t(pid) * KVH + kvh];
      svs[i] = vsc[size_t(pid) * KVH + kvh];
    }
  }
  __syncthreads();

  // the warp takes tiles warp, warp + WARPS, ... of the chunk, through its
  // own ring: no block barrier until the end
  const int nt = (live + tile - 1) / tile;
  const int mine = nt > warp ? (nt - warp + WARPS - 1) / WARPS : 0;
  const int cpr = rowbytes / vb;      // copies a row
  const int ncopy = tile * cpr;
  // this lane's first copy (row j0, byte cb0) and its step of 32 copies
  // (dj rows and dcb bytes)
  const int j0 = lane / cpr;
  const int cb0 = (lane - j0 * cpr) * vb;
  const int dj = 32 / cpr;
  const int dcb = (32 - dj * cpr) * vb;
  // a (page, kv head) row of ps * rowbytes bytes at page * pstride + kvoff
  const size_t pstride = size_t(KVH) * ps * rowbytes;
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(kp) + size_t(kvh) * ps * rowbytes;
  const unsigned char* vbp =
      reinterpret_cast<const unsigned char*>(vp) + size_t(kvh) * ps * rowbytes;
  const uint32_t ring = smem_u32(wring);
  // the warp's i-th tile into its slot of the ring; positions past the
  // chunk's live ones are zero-filled
  auto issue = [&](int i) {
    const int first = (warp + i * WARPS) * tile;
    const uint32_t kdst = ring + (i % STAGES) * 2 * tile_bytes;
    const uint32_t vdst = kdst + tile_bytes;
    int j = j0, cb = cb0;
    for (int k = lane; k < ncopy; k += 32) {
      const int pos = first + j;
      const bool ok = pos < live;
      size_t off = 0;
      if (ok) {
        const int pg = psd.div(pos);
        off = size_t(spage[pg]) * pstride +
              size_t((pos - pg * ps) * rowbytes + cb);
      }
      const uint32_t so = j * rowbytes + cb;
      if (vb == 16) {
        cp_async16(kdst + so, kb + off, ok);
        cp_async16(vdst + so, vbp + off, ok);
      } else if (vb == 8) {
        cp_async8(kdst + so, kb + off, ok);
        cp_async8(vdst + so, vbp + off, ok);
      } else {
        cp_async4(kdst + so, kb + off, ok);
        cp_async4(vdst + so, vbp + off, ok);
      }
      j += dj;
      cb += dcb;
      if (cb >= rowbytes) {
        cb -= rowbytes;
        ++j;
      }
    }
  };

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[h][e] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < mine) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();              // tile i landed; slot i - 1 is free
    if (i + STAGES - 1 < mine) issue(i + STAGES - 1);
    cp_async_commit();
    const PageT* kt =
        reinterpret_cast<const PageT*>(wring + (i % STAGES) * 2 * tile_bytes) +
        rg * D + 8 * c;
    const PageT* vt = kt + tile * D;
    const int first = (warp + i * WARPS) * tile;

    // s[r][h]: the score of row rg + r * nrg, head h; first this lane's
    // part (its 8 dims), then the row group's sum
    float s[ROWS][G];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float kf[8];
      load8(lane_on ? kt + r * nrg * D : reinterpret_cast<const PageT*>(zero),
            kf);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaf(qf[h][e], kf[e], a);
        s[r][h] = a;
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {  // a butterfly over the row group
      if (o < dtp) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
#pragma unroll
          for (int h = 0; h < G; ++h)
            s[r][h] += __shfl_xor_sync(0xffffffffu, s[r][h], o);
        }
      }
    }
    float vsr[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int pos = first + rg + r * nrg;
      const bool ok = pos < live;
      float ksr = 1.f;
      vsr[r] = 1.f;
      if constexpr (kQuant) {
        const int pg = ok ? psd.div(pos) : 0;
        ksr = sks[pg];
        vsr[r] = svs[pg];
      }
#pragma unroll
      for (int h = 0; h < G; ++h) s[r][h] = ok ? s[r][h] * ksr : -INFINITY;
    }
    // online softmax, once a tile: s becomes p (times the v scale)
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float mt = s[0][h];
#pragma unroll
      for (int r = 1; r < ROWS; ++r) mt = fmaxf(mt, s[r][h]);
      const float mn = fmaxf(m[h], mt);
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float alpha = ex2(m[h] - mu);
      m[h] = mn;
      float psum = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = ex2(s[r][h] - mu);
        psum += p;
        if constexpr (kQuant) {
          s[r][h] = p * vsr[r];
        } else if constexpr (kRoundP) {
          s[r][h] = round_to(p, static_cast<const PageT*>(nullptr));
        } else {
          s[r][h] = p;
        }
      }
      l[h] = l[h] * alpha + psum;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[h][e] *= alpha;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float vf[8];
      load8(lane_on ? vt + r * nrg * D : reinterpret_cast<const PageT*>(zero),
            vf);
#pragma unroll
      for (int h = 0; h < G; ++h) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[h][e] = fmaf(s[r][h], vf[e], acc[h][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // every ring is free

  // the row groups' partials, combined once in shared memory
  const int nrb = WARPS * nrg;        // row groups in the block
  const int grp = warp * nrg + rg;
  float* cm = reinterpret_cast<float*>(smem);     // [nrb][G]
  float* cl = cm + nrb * G;                       // [nrb][G]
  float* ca = cl + nrb * G;                       // [nrb][G][D]
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (c == 0) {
      cm[grp * G + h] = m[h];
      cl[grp * G + h] = l[h];
    }
    if (lane_on) {
      float4* dst = reinterpret_cast<float4*>(ca + (grp * G + h) * D + 8 * c);
      dst[0] = make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
      dst[1] = make_float4(acc[h][4], acc[h][5], acc[h][6], acc[h][7]);
    }
  }
  __syncthreads();
  const bool direct = len <= chunk;   // the sequence is this one chunk
  for (int o = tid; o < gh * D; o += THREADS) {
    const int h = o / D;
    const int d = o - h * D;
    float mx = -INFINITY;
    for (int r = 0; r < nrb; ++r) mx = fmaxf(mx, cm[r * G + h]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float ls = 0.f, as = 0.f;
    for (int r = 0; r < nrb; ++r) {
      const float w = ex2(cm[r * G + h] - mu);     // 0 for an empty group
      ls = fmaf(w, cl[r * G + h], ls);
      as = fmaf(w, ca[(r * G + h) * D + d], as);
    }
    const size_t row = row0 + h;
    if (direct) {
      store1(out + row * D + d, ls > 0.f ? as / ls : 0.f);
    } else {
      part_a[row * D + d] = as;
      if (d == 0) {
        part_m[row] = mx;
        part_l[row] = ls;
      }
    }
  }
}

// out from the live chunks' partials, in split order; rows whose sequence
// fits in one chunk were written by the split kernel. PageT only names the
// arm (the profiler classes this kernel's time with its split kernel's).
template <typename T, typename PageT>
__global__ void __launch_bounds__(128)
paged_decode_combine_kernel(const float* __restrict__ part,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, int B, int NH, int D,
                            int chunk, int maxlen) {
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int len = max(0, min(lengths[b], maxlen));
  if (len <= chunk || d >= D) return;
  const int n = (len + chunk - 1) / chunk;
  const int splits = (maxlen + chunk - 1) / chunk;
  const size_t rows = size_t(B) * NH;
  const size_t row = size_t(b) * NH + head;
  const float* pm = part;
  const float* pl = part + size_t(splits) * rows;
  const float* pa = part + 2 * size_t(splits) * rows;
  float mx = -INFINITY, ls = 0.f, as = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {        // online, in split order
    const float ms = pm[s * rows + row];
    const float mn = fmaxf(mx, ms);
    const float mu = mn == -INFINITY ? 0.f : mn;
    const float a = ex2(mx - mu);
    const float w = ex2(ms - mu);
    ls = ls * a + w * pl[s * rows + row];
    as = as * a + w * pa[(s * rows + row) * D + d];
    mx = mn;
  }
  store1(out + row * D + d, ls > 0.f ? as / ls : 0.f);
}

bool bad_shape(int B, int NH, int KVH, int ps, int D, int P, int maxp,
               int pps) {
  return B <= 0 || KVH <= 0 || NH % KVH != 0 || ps <= 0 || P <= 0 ||
         maxp <= 0 || D % 8 != 0 || D <= 0 || D > 128 ||
         (NH / KVH) * D > MAXO * THREADS || pps <= 0 ||
         pps > MAX_SPLIT_PAGES;
}

template <typename T, typename PageT, int G>
int launch_split(dim3 grid, size_t smem, cudaStream_t stream, const T* q,
                 const PageT* kp, const PageT* vp, const float* ksc,
                 const float* vsc, const int* bt, const int* lengths, T* out,
                 float* part, int B, int NH, int KVH, int ps, int D, int dtp,
                 int P, int maxp, int pps, int vb, float qscale) {
  auto kernel = paged_decode_kernel<T, PageT, G>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, THREADS, smem, stream>>>(
      q, kp, vp, ksc, vsc, bt, lengths, out, part, B, NH, KVH, ps,
      make_div(ps), D, dtp, P, maxp, pps, vb, qscale);
  return cudaGetLastError();
}

template <typename T, typename PageT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const float* ksc, const float* vsc, const void* block_tables,
           const void* lengths, void* out, void* scratch, int B, int NH,
           int KVH, int ps, int D, int P, int maxp, int pps, float scale,
           void* stream) {
  const int g = NH / KVH;
  const int G = g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
  const int hgs = (g + G - 1) / G;
  int dtp = 1;
  while (dtp < D / 8) dtp *= 2;
  const int nrg = THREADS / dtp;
  const int rowbytes = D * int(sizeof(PageT));
  const uintptr_t align = reinterpret_cast<uintptr_t>(k_pages) |
                          reinterpret_cast<uintptr_t>(v_pages) |
                          uintptr_t(rowbytes);
  const int vb = align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : 4;
  if (align % 4 != 0) return cudaErrorMisalignedAddress;
  const int splits = (maxp + pps - 1) / pps;
  if (splits > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  if (size_t(KVH) * hgs > 65535 || B > 65535 || NH > 65535)
    return cudaErrorInvalidValue;
  const size_t ring = size_t(STAGES) * 2 * nrg * ROWS * rowbytes +
                      sizeof(float) * (3 * pps + 3) + 32;
  const size_t comb = sizeof(float) * size_t(nrg) * G * (D + 2);
  const size_t smem = ring > comb ? ring : comb;
  const dim3 grid(splits, KVH * hgs, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const PageT* kt = static_cast<const PageT*>(k_pages);
  const PageT* vt = static_cast<const PageT*>(v_pages);
  const int* btp = static_cast<const int*>(block_tables);
  const int* lp = static_cast<const int*>(lengths);
  T* o = static_cast<T*>(out);
  float* part = static_cast<float*>(scratch);
  const float qscale = scale * LOG2E;
  int err;
  switch (G) {
    case 1:
      err = launch_split<T, PageT, 1>(grid, smem, st, qt, kt, vt, ksc, vsc,
                                      btp, lp, o, part, B, NH, KVH, ps, D,
                                      dtp, P, maxp, pps, vb, qscale);
      break;
    case 2:
      err = launch_split<T, PageT, 2>(grid, smem, st, qt, kt, vt, ksc, vsc,
                                      btp, lp, o, part, B, NH, KVH, ps, D,
                                      dtp, P, maxp, pps, vb, qscale);
      break;
    case 4:
      err = launch_split<T, PageT, 4>(grid, smem, st, qt, kt, vt, ksc, vsc,
                                      btp, lp, o, part, B, NH, KVH, ps, D,
                                      dtp, P, maxp, pps, vb, qscale);
      break;
    default:
      err = launch_split<T, PageT, 8>(grid, smem, st, qt, kt, vt, ksc, vsc,
                                      btp, lp, o, part, B, NH, KVH, ps, D,
                                      dtp, P, maxp, pps, vb, qscale);
  }
  if (err != cudaSuccess || splits == 1) return err;
  paged_decode_combine_kernel<T, PageT>
      <<<dim3(NH, B), (D + 31) / 32 * 32, 0, st>>>(part, lp, o, B, NH, D,
                                                   pps * ps, maxp * ps);
  return cudaGetLastError();
}

template <typename T>
int launch_pages(int page_dtype, const void* q, const void* k_pages,
                 const void* v_pages, const void* block_tables,
                 const void* lengths, void* out, void* scratch, int B, int NH,
                 int KVH, int ps, int D, int P, int maxp, int pps,
                 float scale, void* stream) {
  switch (page_dtype) {
    case 0:
      return launch<T, float>(q, k_pages, v_pages, nullptr, nullptr,
                              block_tables, lengths, out, scratch, B, NH,
                              KVH, ps, D, P, maxp, pps, scale, stream);
    case 1:
      return launch<T, __nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr,
                                      block_tables, lengths, out, scratch, B,
                                      NH, KVH, ps, D, P, maxp, pps, scale,
                                      stream);
    case 2:
      return launch<T, __half>(q, k_pages, v_pages, nullptr, nullptr,
                               block_tables, lengths, out, scratch, B, NH,
                               KVH, ps, D, P, maxp, pps, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16; page_dtype (of the
// pages): 0 = float32, 1 = bfloat16, 2 = float16.
// pages_per_split: the chunk a block takes (the wrapper's
// decode_split_plan); scratch: the partials, float32 [splits * B * NH *
// (D + 2)] with splits = ceil(maxp / pages_per_split). Returns the
// cudaError_t of the launches.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* block_tables,
                            const void* lengths, void* out, void* scratch,
                            int B, int NH, int KVH, int ps, int D, int P,
                            int maxp, int pages_per_split, float scale,
                            int dtype, int page_dtype, void* stream) {
  if (bad_shape(B, NH, KVH, ps, D, P, maxp, pages_per_split))
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    return launch_pages<float>(page_dtype, q, k_pages, v_pages,
                               block_tables, lengths, out, scratch, B, NH,
                               KVH, ps, D, P, maxp, pages_per_split, scale,
                               stream);
  }
  if (dtype == 1) {
    return launch_pages<__nv_bfloat16>(page_dtype, q, k_pages, v_pages,
                                       block_tables, lengths, out, scratch,
                                       B, NH, KVH, ps, D, P, maxp,
                                       pages_per_split, scale, stream);
  }
  return cudaErrorInvalidValue;
}

// int8 pages (codes) with float32 k_scales / v_scales [P, KVH]; dtype is
// that of q and out: 0 = float32, 1 = bfloat16. Same clamping, masking,
// zero-row, split and scratch contract as paged_decode.
extern "C" int paged_decode_int8(const void* q, const void* k_codes,
                                 const void* v_codes, const void* k_scales,
                                 const void* v_scales,
                                 const void* block_tables,
                                 const void* lengths, void* out,
                                 void* scratch, int B, int NH, int KVH,
                                 int ps, int D, int P, int maxp,
                                 int pages_per_split, float scale, int dtype,
                                 void* stream) {
  if (bad_shape(B, NH, KVH, ps, D, P, maxp, pages_per_split))
    return cudaErrorInvalidValue;
  const float* ksc = static_cast<const float*>(k_scales);
  const float* vsc = static_cast<const float*>(v_scales);
  if (dtype == 0) {
    return launch<float, int8_t>(q, k_codes, v_codes, ksc, vsc,
                                 block_tables, lengths, out, scratch, B, NH,
                                 KVH, ps, D, P, maxp, pages_per_split, scale,
                                 stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, int8_t>(
        q, k_codes, v_codes, ksc, vsc, block_tables, lengths, out, scratch,
        B, NH, KVH, ps, D, P, maxp, pages_per_split, scale, stream);
  }
  return cudaErrorInvalidValue;
}
