// Tile pairs of the segment-masked (sequence-packed) flash kernels
// (flash_fwd.cu, flash_bwd.cu): which pairs run, which need no element
// mask, and the per-block lists the tensor-core kernels walk.
//
// The wrapper computes per-tile extrema once a call
// (kernels.flash_attention._seg_block_stats): int32 [8, B, stride], q
// tiles at b * stride + qt and k tiles at b * stride + kt. Rows 0-5 are
// the reference's (_seg_block_stats in the JAX package); rows 6-7 add
// the q tiles' position minimum and the k tiles' position maximum.
//
// A tensor-core block builds, once, the list of tiles it walks: entries
// of a tile index and flags, one run flag and one edge flag for each of
// its two warpgroups (a warpgroup's 64 rows or keys, bit w of the pair).
// The predicate does not depend on the head, so a dkv block walks its
// list once for each query head of its group.
#pragma once

#include <stddef.h>

namespace seg {

// rows of the stats
enum { QSMIN, QSMAX, KSMIN, KSMAX, QPMAX, KPMIN, QPMIN, KPMAX };

// entry = tile | flags
constexpr int TILE = (1 << 24) - 1;
constexpr int RUN0 = 1 << 24;    // warpgroup 0 computes the pair (RUN1: 1)
constexpr int EDGE0 = 1 << 26;   // ... and masks it element by element

// The reference's _seg_run_predicate: the segment intervals
// [max(min, 0), max] overlap (conservative for any layout, exact for
// contiguous packing) and, when causal, some key is not in the future of
// every row (min pos_k <= max pos_q). st points at batch b's column.
__device__ __forceinline__ bool runs(const int* st, size_t plane, int qt,
                                     int kt, int causal) {
  const int qsmin = st[QSMIN * plane + qt], qsmax = st[QSMAX * plane + qt];
  const int ksmin = st[KSMIN * plane + kt], ksmax = st[KSMAX * plane + kt];
  bool run = qsmax >= 0 && ksmax >= 0 && max(qsmin, 0) <= ksmax &&
             max(ksmin, 0) <= qsmax;
  if (causal) run = run && st[KPMIN * plane + kt] <= st[QPMAX * plane + qt];
  return run;
}

// Every pair of the tile is visible: one segment >= 0 on both sides and,
// when causal, no key after any row (max pos_k <= min pos_q).
__device__ __forceinline__ bool full(const int* st, size_t plane, int qt,
                                     int kt, int causal) {
  const int s = st[QSMIN * plane + qt];
  bool all = s >= 0 && st[QSMAX * plane + qt] == s &&
             st[KSMIN * plane + kt] == s && st[KSMAX * plane + kt] == s;
  if (causal) all = all && st[KPMAX * plane + kt] <= st[QPMIN * plane + qt];
  return all;
}

// The flags of warpgroup w for the pair (qt, kt): it runs when the
// predicate says so, and masks element by element unless every pair is
// visible and the tile is not ragged.
__device__ __forceinline__ int flags(const int* st, size_t plane, int qt,
                                     int kt, int causal, bool ragged, int w) {
  if (!runs(st, plane, qt, kt, causal)) return 0;
  return (RUN0 | (ragged || !full(st, plane, qt, kt, causal) ? EDGE0 : 0))
         << w;
}

// Host check of an entry's stats: at the route's tiles (tq x tk) and
// covering both sides.
inline bool bad_tiles(int Sq, int Sk, int stride, int tile_q, int tile_k,
                      int tq, int tk) {
  return tile_q != tq || tile_k != tk || stride < (Sq + tq - 1) / tq ||
         stride < (Sk + tk - 1) / tk;
}

// One warp (lane = its lane) writes, in order, the entries f(t) >= 0 of
// t in [0, n) to list[1 ..] and their count to list[0]; returns the count.
template <typename F>
__device__ __forceinline__ int compact(int* list, int n, int lane, F f) {
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const int e = base + lane < n ? f(base + lane) : -1;
    const unsigned m = __ballot_sync(0xffffffffu, e >= 0);
    if (e >= 0) list[1 + count + __popc(m & ((1u << lane) - 1))] = e;
    count += __popc(m);
  }
  if (lane == 0) list[0] = count;
  return count;
}

}  // namespace seg
