// Hopper (sm_90a) building blocks of the tensor-core flash kernels
// (flash_fwd.cu, flash_bwd.cu), written as inline PTX so that a build
// needs no header beyond the CUDA toolkit's and links nothing.
//
// Widths. A head dim D (64, 72 or 128) is computed at D and stored at
// DS = 64 ceil(D / 64) (stored_width): a tile is DS columns wide, so D 72
// takes D 128's tiles, descriptors, TMA boxes and shared-memory budgets.
// A product whose reduction runs over D takes ceil(D / 16) k16 slices
// (k_slices: 5 at D 72, whose last reads columns 64-79); one whose N is
// D runs at N = D (m64n72k16 at D 72). Columns D .. 16 ceil(D / 16) - 1
// of every tile hold zeros (TMA's out-of-bounds fill past the map's D
// columns, load_tile's zero chunks), so the fifth slice adds nothing;
// columns past them are never read.
//
// Types. Every tile and operand is of one 2-byte type T, __nv_bfloat16 or
// __half (float16): the products are the same wgmma at type bf16 or f16,
// the TMA maps are of either type, and P / dS are rounded to T (pack2).
//
// Shared-memory tiles. A tile of R rows of DS 2-byte values is stored
// as DS / 64 column blocks of R rows x 128 bytes, each row's eight
// 16-byte chunks permuted by the 128-byte swizzle (chunk c of row r at
// chunk c ^ (r % 8)), every block 1024-byte aligned. That is the layout
// that a wgmma descriptor of swizzle mode 128B reads, both as a K-major
// operand (rows are M or N, the row's D values are the reduction) and as
// an MN-major one (rows are the reduction, D is N; at N = 72 the product
// reads the first block whole and 8 columns of the second, one leading
// offset on). Tiles are filled by 16-byte cp.async copies (load_tile) or
// by TMA, whose 64-column box with the 128-byte swizzle writes the same
// layout; rows past the tensor's end read as zeros either way.
//
// Products: wgmma.mma_async m64nNk16 with bf16 or f16 operands and float32
// sums, A from shared memory (wgmma_ss, B K-major) or from registers
// (wgmma_rs, B MN-major). The accumulator of a warpgroup's 64 x N tile
// lies in N / 2 floats a thread: register i of thread t (warp w = t / 32,
// lane l = t % 32) holds row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2. The A fragment of a k16 slice has the
// same rows and columns, so a float accumulator becomes the A operand of
// the next product by packing register pairs to T (pack_a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

// the shared memory a block can take (227 KB of the SM's 256)
constexpr int MAX_SMEM = 232448;

// the stored width of head dim D: whole 64-column (128-byte) blocks
__host__ __device__ constexpr int stored_width(int D) {
  return 64 * ((D + 63) / 64);
}

// the k16 slices of a product whose reduction runs over head dim D
__host__ __device__ constexpr int k_slices(int D) { return (D + 15) / 16; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes (one float) from global to shared; zero when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes (cp.async, st.shared) made visible to wgmma's
// reads through the async proxy; each writing thread runs it before the
// barrier that publishes the tile
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator or A-fragment
// registers across an asynchronous product that reads or writes them:
// fence them before wgmma_fence and after wgmma_wait, or ptxas finds
// their arithmetic inside the products' window and serialises every
// wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two floats rounded to T (__nv_bfloat16 or __half), lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    return pack_f16(lo, hi);
  } else {
    return pack_bf16(lo, hi);
  }
}

// two T values (a 32-bit word) as floats
__device__ __forceinline__ float2 unpack2(uint32_t u, const __nv_bfloat16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ float2 unpack2(uint32_t u, const __half*) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// the A fragment of k16 slice kk of a float accumulator, rounded to T
template <typename T, int N>
__device__ __forceinline__ void pack_a(const float (&d)[N], int kk,
                                       uint32_t (&a)[4]) {
  a[0] = pack2<T>(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack2<T>(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2<T>(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2<T>(d[8 * kk + 6], d[8 * kk + 7]);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk c (of DS / 8) of row r in a tile of R rows
template <int R>
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Rows row0 .. row0 + R - 1 of a 2-byte (bf16 or f16) matrix of D
// columns (row i at g + i * stride elements) into the tile at smem address
// tile, by the block's nthreads threads, asynchronously: the 2 k_slices(D) 16-byte
// chunks of a row that the products read, of which the first D / 8 are
// copied and the rest, like rows >= rows_valid, read as zeros.
template <int R, int D, typename T>
__device__ __forceinline__ void load_tile(uint32_t tile, const T* g, int row0,
                                          int rows_valid, size_t stride,
                                          int tid, int nthreads) {
  constexpr int CH = 2 * k_slices(D);   // 16-byte chunks a row, filled
  constexpr int VALID = D / 8;          // of which hold data
#pragma unroll 4
  for (int idx = tid; idx < R * CH; idx += nthreads) {
    const int r = idx / CH;
    const int c = idx % CH;
    const int row = row0 + r;
    const bool ok = row < rows_valid && c < VALID;
    const T* src = g + size_t(ok ? row : 0) * stride +
                               (ok ? 8 * c : 0);
    cp_async16(tile + tile_offset<R>(r, c), src, ok);
  }
}

// ---- mbarriers, TMA and named barriers ----------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes initialised mbarriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival that also announces the bytes the phase's copies bring
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`. A
// wait that lasts ~20 s (2^35 clocks) traps, so that a protocol fault
// fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// TMA: the box at coordinates (c0 innermost .. c3) of a 4-d tensor map
// into shared memory; the transfer completes on the mbarrier
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the warpgroup of this thread, as a value the compiler knows to be
// uniform over the warp (a branch on it is not divergent)
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

// register budgets of warp-specialised roles; every warp of the
// warpgroup runs it, on a path that does not rejoin the other roles'
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// named barriers among `n` threads (a multiple of 32); id 0 is
// __syncthreads'
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// wgmma shared-memory descriptor, swizzle mode 128B: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

// K-major operand: rows r0 .. r0 + 63 (A) or all N rows (B) of a tile of
// R rows, k16 slice kk of its DS columns. Eight-row groups lie 1024 bytes
// apart; a slice is 32 bytes into its 128-byte row.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return make_desc(tile + (kk >> 2) * (R * 128) + r0 * 128 + (kk & 3) * 32,
                   16, 1024);
}

// MN-major B operand (the tile's rows are the reduction, its first D
// columns are N): rows 16 kk .. 16 kk + 15 of a tile of R rows. Eight-row groups
// along the reduction lie 1024 bytes apart (stride offset), the 64-column
// blocks along N R * 128 bytes apart (leading offset).
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, R * 128, 1024);
}

// D (64 x N, float32) op= A (64 x 16) . B (16 x N), operands of T
// (__nv_bfloat16 or __half: the same instruction at type bf16 or f16);
// scale_d = 0 overwrites D, 1 accumulates
template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

// the accumulators' operand lists and register names at N = 64, 72, 128
#define HOPPER_ACC64 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_REGS64 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
    "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_ACC72 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
#define HOPPER_REGS72 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
    "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
#define HOPPER_ACC128 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
    "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
    "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_REGS128 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
    "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
    "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
    "%60, %61, %62, %63"

// One specialisation of wgmma_ss (A and B from shared memory, B K-major)
// or wgmma_rs (A from registers, B MN-major) at width N and type T, whose
// PTX name is TY; PRED names the scale_d operand and AB the A / B ones.
#define HOPPER_WGMMA_SS(N, T, TY, PRED, AB)                               \
  template <>                                                             \
  __device__ __forceinline__ void wgmma_ss<N, T>(                         \
      float(&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"        \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." \
                 TY " {" HOPPER_REGS##N "}, " AB ", p, 1, 1, 0, 0;\n}\n"  \
                 : HOPPER_ACC##N                                          \
                 : "l"(da), "l"(db), "r"(scale_d));                       \
  }

#define HOPPER_WGMMA_RS(N, T, TY, PRED, AB)                               \
  template <>                                                             \
  __device__ __forceinline__ void wgmma_rs<N, T>(                         \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t db,               \
      int scale_d) {                                                      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"        \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." \
                 TY " {" HOPPER_REGS##N "}, " AB ", p, 1, 1, 1;\n}\n"     \
                 : HOPPER_ACC##N                                          \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),   \
                   "r"(scale_d));                                         \
  }

#define HOPPER_WGMMA_TYPE(T, TY)                                          \
  HOPPER_WGMMA_SS(64, T, TY, "%34", "%32, %33")                           \
  HOPPER_WGMMA_SS(128, T, TY, "%66", "%64, %65")                          \
  HOPPER_WGMMA_RS(64, T, TY, "%37", "{%32, %33, %34, %35}, %36")          \
  HOPPER_WGMMA_RS(72, T, TY, "%41", "{%36, %37, %38, %39}, %40")          \
  HOPPER_WGMMA_RS(128, T, TY, "%69", "{%64, %65, %66, %67}, %68")

HOPPER_WGMMA_TYPE(__nv_bfloat16, "bf16")
HOPPER_WGMMA_TYPE(__half, "f16")

#undef HOPPER_WGMMA_TYPE
#undef HOPPER_WGMMA_RS
#undef HOPPER_WGMMA_SS
#undef HOPPER_REGS64
#undef HOPPER_REGS72
#undef HOPPER_REGS128
#undef HOPPER_ACC64
#undef HOPPER_ACC72
#undef HOPPER_ACC128
}  // namespace hopper
