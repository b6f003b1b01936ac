// Tile maps of the masked attention kernels: for each (query tile, key tile)
// of a batch row, whether the mask hides every pair (empty: the kernel never
// loads the key tile), shows every pair (full: the kernel skips the mask),
// or some of each (partial). The map is int8 [B, ceil(Lq/TQ), ceil(Lk/TK)]
// at the kernel's own tiles, built on the device by the launches below and
// read by the attention kernel that follows them; the plain versions are
// `inline_tile_classes_reference` and `bias_tile_classes_reference` in
// video_gpt_tpu_torch/ops/flash_attention.py.
//
// A tile is full only if it lies wholly inside [0, Lq) x [0, Lk): a kernel
// that skips the mask of a full tile needs no bounds check either. Rows past
// Lq and keys past Lk hold no pair, so an edge tile whose real pairs are all
// hidden is empty.
//
// Two classifiers, both templates on the tiles so that any kernel can take
// a map at its own tiles:
//   - metadata classes (K6): one O(L) pass writes per-tile summaries of the
//     query side (index, q_block, q_offset, is_pad) and the key side
//     (vis_start, noisy_block, noisy_role); a tile pair's class is then a
//     few integer compares (`classify_meta`), conservative by construction:
//     empty only if no pair inside can be visible, full only if every pair
//     is;
//   - bias classes (K9): one pass over the bf16 bias. Empty iff every entry
//     is at most BF16_NEG (the masked value of `precompute_bias`), full iff
//     every entry is 0. A row with no entry above BF16_NEG sees no key: its
//     softmax is not 0 (every logit is BF16_NEG, so it is uniform), so its
//     query tile is never empty. For every other row, an entry at most
//     BF16_NEG weighs exactly 0 in fp32, so skipping its tile is exact.
//
// The columnar-rank decode kernels (K1/K2) take no map from a launch of its
// own: their mask, visible(q, k) = q_off[q] >= rank[k], is exact from two
// ranges, so the producer of rank_attention.cu classifies each key tile as
// it loads its ranks (`rank_tile_class`; plain version
// `rank_tile_classes_reference`).
#pragma once

#include <math_constants.h>

#include "attention_common.cuh"

namespace vgt {

enum : int8_t { kTileEmpty = 0, kTilePartial = 1, kTileFull = 2 };
constexpr int kIntMax = 0x7fffffff;
constexpr int kIntMin = -kIntMax - 1;
// bf16 min / 2 (ops/flash_attention.py BF16_NEG), exactly
constexpr float kBf16Neg = -0x1.fep+126f;

// ---- metadata classes (K6) -------------------------------------------------

// Over the real rows of a query tile; the non-pad ones unless noted.
struct QuerySummary {
  int idx_min;   // min index (kIntMax: no non-pad row)
  int idx_max;   // max index over every real row
  int blk_min;   // min / max q_block >= 0 (kIntMax / -1: no noisy row)
  int blk_max;
  int off_min;   // min / max q_offset of the noisy rows
  int off_max;
  int pad_any;   // some real row is a pad row
  int all_noisy; // every non-pad row has q_block >= 0
};

// Over the real keys of a key tile.
struct KeySummary {
  int vis_min;          // min vis_start
  int vis_max_clean;    // max vis_start of the keys with noisy_block < 0
  int vis_max_noisy;    // ... and with noisy_block >= 0 (kIntMin: none)
  int blk_min;          // min / max noisy_block >= 0 (kIntMax / -1: none)
  int blk_max;
  int role_min;         // min / max noisy_role of the noisy keys
  int role_max;
  int any_noisy;
};

// The class of a tile pair from its summaries; `inside`: the pair lies
// wholly inside [0, Lq) x [0, Lk). visible(q, k) = q.index >= k.vis_start
// || (k.block >= 0 && k.block == q.block && q.offset >= k.role) || q.pad.
__device__ __forceinline__ int8_t classify_meta(const QuerySummary& q,
                                                const KeySummary& k,
                                                bool inside) {
  const bool block_never = k.blk_max < q.blk_min || q.blk_max < k.blk_min ||
                           q.off_max < k.role_min;
  if (!q.pad_any && q.idx_max < k.vis_min && block_never) return kTileEmpty;
  if (!inside || q.idx_min < k.vis_max_clean) return kTilePartial;
  const bool block_always = q.all_noisy && q.blk_min == q.blk_max &&
                            k.blk_min == q.blk_min && k.blk_max == q.blk_min &&
                            q.off_min >= k.role_max;
  return (!k.any_noisy || q.idx_min >= k.vis_max_noisy || block_always)
             ? kTileFull
             : kTilePartial;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

constexpr int kSummaryWarps = 4;

// One warp per tile: the query tiles of every batch row, then the key
// tiles. Args holds the inline kernels' metadata (qm / qm_sb: index,
// q_block, q_offset, is_pad; km / km_sb: vis_start, noisy_block,
// noisy_role, each [B, L] with contiguous rows and its batch stride) and
// batch, lq, lk.
template <int TQ, int TK, class Args>
__global__ void __launch_bounds__(32 * kSummaryWarps)
    tile_summary_kernel(const Args a, QuerySummary* qsum, KeySummary* ksum) {
  const int nq = (a.lq + TQ - 1) / TQ, nk = (a.lk + TK - 1) / TK;
  const int tile = blockIdx.x * kSummaryWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= a.batch * (nq + nk)) return;
  if (tile < a.batch * nq) {
    const int b = tile / nq, r0 = (tile % nq) * TQ;
    int idx_min = kIntMax, idx_max = kIntMin, blk_min = kIntMax, blk_max = -1;
    int off_min = kIntMax, off_max = kIntMin, pad = 0, clean = 0;
    for (int r = r0 + lane; r < min(r0 + TQ, a.lq); r += 32) {
      const int idx = a.qm[0][b * a.qm_sb[0] + r];
      const int blk = a.qm[1][b * a.qm_sb[1] + r];
      const int off = a.qm[2][b * a.qm_sb[2] + r];
      const bool is_pad = a.qm[3][b * a.qm_sb[3] + r] > 0;
      idx_max = max(idx_max, idx);
      if (is_pad) {
        pad = 1;
        continue;
      }
      idx_min = min(idx_min, idx);
      if (blk >= 0) {
        blk_min = min(blk_min, blk);
        blk_max = max(blk_max, blk);
        off_min = min(off_min, off);
        off_max = max(off_max, off);
      } else {
        clean = 1;
      }
    }
    QuerySummary s{warp_min(idx_min), warp_max(idx_max), warp_min(blk_min),
                   warp_max(blk_max), warp_min(off_min), warp_max(off_max),
                   __any_sync(0xffffffffu, pad), !__any_sync(0xffffffffu, clean)};
    if (lane == 0) qsum[tile] = s;
  } else {
    const int t = tile - a.batch * nq;
    const int b = t / nk, c0 = (t % nk) * TK;
    int vis_min = kIntMax, vmax_c = kIntMin, vmax_n = kIntMin;
    int blk_min = kIntMax, blk_max = -1, role_min = kIntMax, role_max = kIntMin;
    for (int c = c0 + lane; c < min(c0 + TK, a.lk); c += 32) {
      const int vis = a.km[0][b * a.km_sb[0] + c];
      const int blk = a.km[1][b * a.km_sb[1] + c];
      const int role = a.km[2][b * a.km_sb[2] + c];
      vis_min = min(vis_min, vis);
      if (blk >= 0) {
        vmax_n = max(vmax_n, vis);
        blk_min = min(blk_min, blk);
        blk_max = max(blk_max, blk);
        role_min = min(role_min, role);
        role_max = max(role_max, role);
      } else {
        vmax_c = max(vmax_c, vis);
      }
    }
    KeySummary s{warp_min(vis_min), warp_max(vmax_c), warp_max(vmax_n),
                 warp_min(blk_min), warp_max(blk_max), warp_min(role_min),
                 warp_max(role_max), 0};
    s.any_noisy = s.blk_max >= 0;
    if (lane == 0) ksum[t] = s;
  }
}

constexpr int kMapThreads = 128;

// One block per (batch row b, query tile): the map's row of key-tile
// classes, and its count of non-empty tiles in counts[b * nq + query tile].
// With a non-null `col_counts` (zeroed before the launch) it also adds each
// non-empty tile to its column's count, col_counts[b * nk + key tile].
template <int TQ, int TK>
__global__ void __launch_bounds__(kMapThreads)
    meta_tile_map_kernel(const QuerySummary* qsum, const KeySummary* ksum,
                         int lq, int lk, int8_t* map, int* counts,
                         int* col_counts) {
  const int nq = (lq + TQ - 1) / TQ, nk = (lk + TK - 1) / TK;
  const int b = blockIdx.y, qt = blockIdx.x;
  const QuerySummary q = qsum[b * nq + qt];
  const bool q_inside = (qt + 1) * TQ <= lq;
  int8_t* row = map + (static_cast<long long>(b) * nq + qt) * nk;
  int n = 0;
  for (int kt = threadIdx.x; kt < nk; kt += kMapThreads) {
    const int8_t c =
        classify_meta(q, ksum[b * nk + kt], q_inside && (kt + 1) * TK <= lk);
    row[kt] = c;
    n += c != kTileEmpty;
    if (col_counts != nullptr && c != kTileEmpty)
      atomicAdd(&col_counts[b * nk + kt], 1);
  }
  __shared__ int total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  atomicAdd(&total, n);
  __syncthreads();
  if (threadIdx.x == 0) counts[b * nq + qt] = total;
}

// ---- the window (a sliding layer's positions) --------------------------------

// A tile's positions: over the non-pad real rows of a query tile, over the
// real keys of a key tile (kIntMax / kIntMin: none).
struct PosRange {
  int lo, hi;
};

// One warp per tile, the query tiles of every batch row, then the key
// tiles, as tile_summary_kernel walks them: each tile's PosRange from
// a.qpos / a.kpos (and the query side's is_pad, a.qm[3]).
template <int TQ, int TK, class Args>
__global__ void __launch_bounds__(32 * kSummaryWarps)
    pos_range_kernel(const Args a, PosRange* qpr, PosRange* kpr) {
  const int nq = (a.lq + TQ - 1) / TQ, nk = (a.lk + TK - 1) / TK;
  const int tile = blockIdx.x * kSummaryWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= a.batch * (nq + nk)) return;
  int lo = kIntMax, hi = kIntMin;
  if (tile < a.batch * nq) {
    const int b = tile / nq, r0 = (tile % nq) * TQ;
    for (int r = r0 + lane; r < min(r0 + TQ, a.lq); r += 32) {
      if (a.qm[3][b * a.qm_sb[3] + r] > 0) continue;  // a pad row: any key
      const int p = a.qpos[b * a.qpos_sb + r];
      lo = min(lo, p);
      hi = max(hi, p);
    }
  } else {
    const int t = tile - a.batch * nq;
    const int b = t / nk, c0 = (t % nk) * TK;
    for (int c = c0 + lane; c < min(c0 + TK, a.lk); c += 32) {
      const int p = a.kpos[b * a.kpos_sb + c];
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
  const PosRange r{warp_min(lo), warp_max(hi)};
  if (lane == 0) {
    if (tile < a.batch * nq)
      qpr[tile] = r;
    else
      kpr[tile - a.batch * nq] = r;
  }
}

// The class of a tile pair under the rule and a window: the rule's class,
// made empty where no non-pad row is within the window of any key (and no
// row is a pad row, which sees every key), and partial where a full tile
// holds a pair outside it.
__device__ __forceinline__ int8_t classify_window(const QuerySummary& q,
                                                  const KeySummary& k,
                                                  bool inside,
                                                  const PosRange& qr,
                                                  const PosRange& kr,
                                                  int window) {
  const int8_t c = classify_meta(q, k, inside);
  if (c == kTileEmpty) return c;
  if (!q.pad_any && static_cast<long long>(qr.lo) - kr.hi >= window)
    return kTileEmpty;
  if (c == kTileFull && static_cast<long long>(qr.hi) - kr.lo >= window)
    return kTilePartial;
  return c;
}

// meta_tile_map_kernel's map, counts and column counts, under a window.
template <int TQ, int TK>
__global__ void __launch_bounds__(kMapThreads)
    window_tile_map_kernel(const QuerySummary* qsum, const KeySummary* ksum,
                           const PosRange* qpr, const PosRange* kpr,
                           int window, int lq, int lk, int8_t* map,
                           int* counts, int* col_counts) {
  const int nq = (lq + TQ - 1) / TQ, nk = (lk + TK - 1) / TK;
  const int b = blockIdx.y, qt = blockIdx.x;
  const QuerySummary q = qsum[b * nq + qt];
  const PosRange qr = qpr[b * nq + qt];
  const bool q_inside = (qt + 1) * TQ <= lq;
  int8_t* row = map + (static_cast<long long>(b) * nq + qt) * nk;
  int n = 0;
  for (int kt = threadIdx.x; kt < nk; kt += kMapThreads) {
    const int8_t cls =
        classify_window(q, ksum[b * nk + kt], q_inside && (kt + 1) * TK <= lk,
                        qr, kpr[b * nk + kt], window);
    row[kt] = cls;
    n += cls != kTileEmpty;
    if (col_counts != nullptr && cls != kTileEmpty)
      atomicAdd(&col_counts[b * nk + kt], 1);
  }
  __shared__ int total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  atomicAdd(&total, n);
  __syncthreads();
  if (threadIdx.x == 0) counts[b * nq + qt] = total;
}

// One block per (batch row b, group of `group` consecutive query tiles,
// the last group possibly shorter): the count of key tiles that some query
// tile of the group does not call empty, the key tiles that a block of K6
// covering the group loads, into counts[b * ceil(nq / group) + group].
__global__ void __launch_bounds__(kMapThreads)
    meta_tile_map_groups_kernel(const int8_t* map, int nq, int nk,
                                int group, int* counts) {
  const int ng = (nq + group - 1) / group;
  const int b = blockIdx.y, qt0 = blockIdx.x * group;
  const int rows = min(group, nq - qt0);
  const int8_t* m = map + (static_cast<long long>(b) * nq + qt0) * nk;
  int n = 0;
  for (int kt = threadIdx.x; kt < nk; kt += kMapThreads) {
    bool any = false;
    for (int r = 0; r < rows; ++r) any = any || m[r * nk + kt] != kTileEmpty;
    n += any;
  }
  __shared__ int total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  atomicAdd(&total, n);
  __syncthreads();
  if (threadIdx.x == 0) counts[b * ng + blockIdx.x] = total;
}

constexpr int kOrderThreads = 1024;

// One block: order[0 .. items) = the items 0 .. items-1 by decreasing
// counts[item] (each in [0, max_count]), so that a grid walking `order`
// starts the longest rows first. Ties come in any order. Dynamic shared
// memory: (max_count + 1) ints.
__global__ void __launch_bounds__(kOrderThreads)
    tile_order_kernel(const int* counts, int items, int max_count,
                      int* order) {
  extern __shared__ int start[];
  for (int i = threadIdx.x; i <= max_count; i += kOrderThreads) start[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < items; i += kOrderThreads)
    atomicAdd(&start[max_count - counts[i]], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int i = 0; i <= max_count; ++i) {
      const int n = start[i];
      start[i] = sum;
      sum += n;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < items; i += kOrderThreads)
    order[atomicAdd(&start[max_count - counts[i]], 1)] = i;
}

// ---- bias classes (K9) -----------------------------------------------------

constexpr int kBiasMapSteps = 4;  // key tiles per step of the bias pass

// One block of 2 TQ threads per (batch row b, query tile); thread 2r + h
// reads row r of the tile, columns h TK/2 .. (h+1) TK/2 - 1 of every key
// tile, kBiasMapSteps tiles per step. Writes the map's row, and for each
// real row q the softmax reference of the kernels that read the map:
// rowdead[b * lq + q] = -1 for a row with an entry above BF16_NEG, else
// log2 of its count of BF16_NEG entries (every logit of such a row is
// BF16_NEG in fp32: its softmax is uniform over those entries). `vec`:
// the bias rows allow 16-byte loads. The map row's count of non-empty
// tiles goes to counts[b * nq + query tile]. Dynamic shared memory: nk
// bytes.
template <int TQ, int TK>
__global__ void __launch_bounds__(2 * TQ)
    bias_tile_map_kernel(const bf16* bias, long long bias_sb,
                         long long bias_sq, int lq, int lk, bool vec,
                         int8_t* map, float* rowdead, int* counts) {
  constexpr int kThreadsB = 2 * TQ, kWarpsB = kThreadsB / 32;
  constexpr int kCols = TK / 2;
  static_assert(kCols % 8 == 0, "16-byte chunks per thread");
  extern __shared__ int8_t cls[];
  __shared__ uint32_t wflags[2][kBiasMapSteps][kWarpsB];

  const int nq = (lq + TQ - 1) / TQ, nk = (lk + TK - 1) / TK;
  const int b = blockIdx.y, qt = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = qt * TQ + (threadIdx.x >> 1);
  const int half = threadIdx.x & 1;
  const bool row_ok = r < lq;
  const bf16* brow = bias + b * bias_sb + (row_ok ? r : 0) * bias_sq;
  bool alive = false;
  int n_neg = 0;

  for (int kt0 = 0, step = 0; kt0 < nk; kt0 += kBiasMapSteps, ++step) {
    uint4 v[kBiasMapSteps][kCols / 8];
#pragma unroll
    for (int s = 0; s < kBiasMapSteps; ++s) {
      const int c0 = (kt0 + s) * TK + half * kCols;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int c = c0 + 8 * j;
        v[s][j] = make_uint4(0u, 0u, 0u, 0u);
        if (!row_ok || c >= lk) continue;
        if (vec) {
          v[s][j] = *reinterpret_cast<const uint4*>(brow + c);
        } else {
          bf16* e = reinterpret_cast<bf16*>(&v[s][j]);
          for (int i = 0; i < 8 && c + i < lk; ++i) e[i] = brow[c + i];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kBiasMapSteps; ++s) {
      const int c0 = (kt0 + s) * TK + half * kCols;
      bool all_neg = true, all_zero = row_ok && c0 + kCols <= lk;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const bf16* e = reinterpret_cast<const bf16*>(&v[s][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (!row_ok || c0 + 8 * j + i >= lk) continue;
          const float x = __bfloat162float(e[i]);
          all_neg = all_neg && x <= kBf16Neg;
          all_zero = all_zero && x == 0.f;
          alive = alive || x > kBf16Neg;
          n_neg += x == kBf16Neg;
        }
      }
      const uint32_t neg = __all_sync(0xffffffffu, all_neg);
      const uint32_t zero = __all_sync(0xffffffffu, all_zero);
      if (lane == 0) wflags[step & 1][s][warp] = neg | (zero << 1);
    }
    __syncthreads();
    if (threadIdx.x < kBiasMapSteps && kt0 + threadIdx.x < nk) {
      uint32_t f = 3u;
#pragma unroll
      for (int w = 0; w < kWarpsB; ++w) f &= wflags[step & 1][threadIdx.x][w];
      cls[kt0 + threadIdx.x] =
          (f & 2u) ? kTileFull : (f & 1u) ? kTileEmpty : kTilePartial;
    }
  }
  // the two threads of a row (every lane shuffles: no short circuit)
  const int alive_pair = __shfl_xor_sync(0xffffffffu, alive ? 1 : 0, 1);
  alive = alive || alive_pair;
  n_neg += __shfl_xor_sync(0xffffffffu, n_neg, 1);
  const bool dead = row_ok && !alive;
  if (row_ok && half == 0)
    rowdead[static_cast<long long>(b) * lq + r] =
        !dead ? -1.f : n_neg > 0 ? log2f(static_cast<float>(n_neg))
                                 : CUDART_INF_F;
  const bool any_dead = __syncthreads_or(dead);
  int8_t* out = map + (static_cast<long long>(b) * nq + qt) * nk;
  int n = 0;
  for (int kt = threadIdx.x; kt < nk; kt += kThreadsB) {
    const int8_t c = cls[kt];
    out[kt] = (any_dead && c == kTileEmpty) ? kTilePartial : c;
    n += out[kt] != kTileEmpty;
  }
  __shared__ int total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  if (n) atomicAdd(&total, n);
  __syncthreads();
  if (threadIdx.x == 0) counts[b * nq + qt] = total;
}

// Copy the bias tile of query rows q0.. and keys k0.. of one batch row
// (`bias` its first element, rows at stride bias_sq) into bs [TQ][ld]:
// cp.async when the rows allow 16-byte loads (`vec`), else plain loads.
// Rows past Lq are zero; keys past Lk hold whatever the row holds there and
// are masked by the caller. NT threads, this one `tid`.
template <int TQ, int TK, int NT>
__device__ __forceinline__ void load_bias_tile(bf16* bs, int ld,
                                               const bf16* bias,
                                               long long bias_sq, int lq,
                                               int lk, bool vec, int q0,
                                               int k0, int tid) {
  const bf16* src = bias + q0 * bias_sq + k0;
  const int rows = min(TQ, lq - q0);
  if (vec) {
    for (int i = tid; i < TQ * TK / 8; i += NT) {
      const int r = i / (TK / 8), c = (i % (TK / 8)) * 8;
      async_copy16(bs + r * ld + c, src + (r < rows ? r * bias_sq + c : 0),
                   r < rows && k0 + c < lk);
    }
  } else {
    for (int i = tid; i < TQ * TK; i += NT) {
      const int r = i / TK, c = i % TK;
      bs[r * ld + c] = (r < rows && k0 + c < lk) ? src[r * bias_sq + c]
                                                 : __float2bfloat16(0.f);
    }
  }
}

// ---- rank classes (K1/K2) --------------------------------------------------
//
// A query tile is the 64 rows of one consumer warpgroup, a key tile 64 keys
// of one key operand (the cache's tiles, then the tail's). Every pair of the
// tile is visible iff the least q_off of its rows is at least the largest
// rank of its keys, none iff the largest q_off is below the least rank:
// exact, not conservative. Keys past the operand count with rank kNever and
// rows past Lq not at all, so an edge tile is never full.

constexpr int kRankTile = 64;  // rows of a query tile, keys of a key tile

struct RankQueryRange {
  int lo, hi;  // least and largest q_off of the real rows (kIntMax, kIntMin:
               // none)
  bool whole;  // all 64 rows lie below Lq
};

// The q_off range of rows r0 .. r0 + 63 (of Lq), for every lane of a warp.
__device__ __forceinline__ RankQueryRange rank_query_range(const int* qoff,
                                                           int r0, int lq,
                                                           int lane) {
  int lo = kIntMax, hi = kIntMin;
  for (int i = lane; i < kRankTile; i += 32)
    if (r0 + i < lq) {
      const int v = qoff[r0 + i];
      lo = min(lo, v);
      hi = max(hi, v);
    }
  return {__reduce_min_sync(0xffffffffu, lo),
          __reduce_max_sync(0xffffffffu, hi), r0 + kRankTile <= lq};
}

// The ranks of keys k0 + lane and k0 + 32 + lane of an operand of `len`
// keys whose ranks are `rank` (kNever past `len`).
__device__ __forceinline__ void rank_tile_load(const int* rank, int k0,
                                               int len, int lane, int& ra,
                                               int& rb) {
  ra = k0 + lane < len ? rank[k0 + lane] : kNever;
  rb = k0 + 32 + lane < len ? rank[k0 + 32 + lane] : kNever;
}

// The class of a query tile against the key tile whose lanes hold ranks
// (ra, rb), for every lane of the warp.
__device__ __forceinline__ int8_t rank_tile_class(const RankQueryRange& q,
                                                  int ra, int rb) {
  const int rmin = __reduce_min_sync(0xffffffffu, min(ra, rb));
  const int rmax = __reduce_max_sync(0xffffffffu, max(ra, rb));
  if (q.hi < rmin) return kTileEmpty;
  return q.whole && q.lo >= rmax ? kTileFull : kTilePartial;
}

// ---- reading a map ---------------------------------------------------------

// Warp 0 of the block gathers the non-empty entries of `n` map entries at
// `map[i * stride]` into list[0 .. count) as (i << 2) | class, in order of
// i; returns count to every thread of the block (which must all call it).
__device__ __forceinline__ int gather_tiles(const int8_t* map, long long stride,
                                            int n, int* list) {
  __shared__ int count;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int total = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const int c = i < n ? map[i * stride] : kTileEmpty;
      const uint32_t hit = __ballot_sync(0xffffffffu, c != kTileEmpty);
      if (c != kTileEmpty)
        list[total + __popc(hit & ((1u << lane) - 1u))] = (i << 2) | c;
      total += __popc(hit);
    }
    if (lane == 0) count = total;
  }
  __syncthreads();
  return count;
}

}  // namespace vgt
