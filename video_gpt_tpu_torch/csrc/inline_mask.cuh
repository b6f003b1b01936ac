// The frame-block visibility rule of the metadata-inline attention kernels
// (K6 inline_attention.cu, K7 inline_attention_bwd.cu), evaluated per
// (query, key) pair from seven int32 vectors of token metadata: the TPU's
// `_inline_visible` / `_inline_visible_t` (video_gpt_tpu/ops/
// flash_attention.py). No [Lq, Lk] mask or bias exists anywhere: a block
// keeps its query rows' metadata in registers (or a query tile's in shared
// memory) and loads each key tile's metadata into shared memory beside the
// K/V tile. The tile map of the same rule (which tile pairs hold no visible
// pair, or only visible ones) is tile_map.cuh's metadata classifier.
#pragma once

#include "attention_common.cuh"
#include "tile_map.cuh"

namespace vgt {

// Query side, in the order of the `qm` pointer arrays: index, q_block,
// q_offset, is_pad. Key side (`km`): vis_start, noisy_block, noisy_role.
// Each vector is [B, L] with contiguous rows; its batch stride (0 for the
// broadcast `index`) comes beside it.
struct QueryMeta {
  int index, block, offset, pad;
};
struct KeyMeta {
  int vis_start, block, role;
};

// Clean and causal keys from vis_start on; noisy keys only within the
// query's own frame-block, gated by role; a pad row sees every key. The
// callers exclude keys past Lk themselves. kWindow: a sliding window over
// the positions besides (a sliding layer of the AFMoE trunk): a non-pad
// query at position qpos sees only the keys at kpos > qpos - window. The
// instance without it is the rule alone, as every other launch runs it.
template <bool kWindow = false>
__device__ __forceinline__ bool inline_visible(const QueryMeta& q,
                                               const KeyMeta& k, int qpos = 0,
                                               int kpos = 0, int window = 0) {
  const bool vis =
      q.index >= k.vis_start ||
      (k.block >= 0 && k.block == q.block && q.offset >= k.role) ||
      q.pad > 0;
  if constexpr (kWindow) return vis && (q.pad > 0 || qpos - kpos < window);
  return vis;
}

// The position of query row r (0 past Lq) or key column c of batch b.
__device__ __forceinline__ int token_pos(const int* pos, long long sb, int b,
                                         int i, int n) {
  return i < n ? pos[b * sb + i] : 0;
}

// Query row r of batch b; a row past Lq sees no key, so the tile rows that
// are never stored compute nothing but zeros.
__device__ __forceinline__ QueryMeta query_meta(const int* const* m,
                                                const long long* sb, int b,
                                                int r, int lq) {
  if (r >= lq) return {-kNever, -2, 0, 0};
  return {m[0][b * sb[0] + r], m[1][b * sb[1] + r], m[2][b * sb[2] + r],
          m[3][b * sb[3] + r]};
}

// Key column c of batch b; a column past Lk is never visible to a real row.
__device__ __forceinline__ KeyMeta key_meta(const int* const* m,
                                            const long long* sb, int b, int c,
                                            int lk) {
  if (c >= lk) return {kNever, -1, 0};
  return {m[0][b * sb[0] + c], m[1][b * sb[1] + c], m[2][b * sb[2] + c]};
}

// The metadata of the ROWS rows or columns from `start` into shared memory
// (all threads of the block take part; the caller synchronises).
template <int ROWS>
__device__ __forceinline__ void load_query_meta(QueryMeta* dst,
                                                const int* const* m,
                                                const long long* sb, int b,
                                                int start, int lq) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads)
    dst[i] = query_meta(m, sb, b, start + i, lq);
}

template <int ROWS>
__device__ __forceinline__ void load_key_meta(KeyMeta* dst,
                                              const int* const* m,
                                              const long long* sb, int b,
                                              int start, int lk) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads)
    dst[i] = key_meta(m, sb, b, start + i, lk);
}

// Under a window (a.window > 0), the map's classes of the rule with the
// window: the positions' range of each tile (`pos_range_kernel`, into
// `qpr`, then the key tiles' after the B nq query tiles'), then the classes
// (`window_tile_map_kernel`) with each row's (and, with `col_counts`, each
// column's) count of non-empty tiles. Returns the first nonzero
// cudaGetLastError() (0 = all launched).
template <class Args>
inline int launch_window_tile_map(const Args& a, cudaStream_t s,
                                  const QuerySummary* qsum,
                                  const KeySummary* ksum, PosRange* qpr,
                                  int* counts, int* col_counts) {
  const int nq = (a.lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a.lk + kBlockK - 1) / kBlockK;
  const long long tiles = static_cast<long long>(a.batch) * (nq + nk);
  PosRange* kpr = qpr + static_cast<long long>(a.batch) * nq;
  pos_range_kernel<kBlockQ, kBlockK, Args>
      <<<static_cast<unsigned>((tiles + kSummaryWarps - 1) / kSummaryWarps),
         32 * kSummaryWarps, 0, s>>>(a, qpr, kpr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_tile_map_kernel<kBlockQ, kBlockK>
      <<<dim3(nq, a.batch), kMapThreads, 0, s>>>(
          qsum, ksum, qpr, kpr, a.window, a.lq, a.lk, a.tile_map, counts,
          col_counts);
  return static_cast<int>(cudaGetLastError());
}

// The tile map of the metadata rule at the forward kernels' tiles (K6 and
// the fp32 kernel's inline mask), launched on `s`: the per-tile summaries
// (one O(L) pass), every (query tile, key tile) class into a.tile_map with
// each query tile's count of non-empty key tiles, then the query tiles
// ordered by that count, most first, into *order (in a.scratch: B (nq + nk)
// summaries of 8 ints, B nq counts, B nq order). With `group` > 1 (K6's
// blocks of that many query tiles) the counts are each group's instead, of
// the key tiles that some query tile of the group sees, and *order holds
// the B ceil(nq / group) groups. Returns the first nonzero
// cudaGetLastError() (0 = all launched).
template <class Args>
inline int launch_inline_tile_map(const Args& a, cudaStream_t s,
                                  const int** order, int group = 1) {
  const int nq = (a.lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a.lk + kBlockK - 1) / kBlockK;
  QuerySummary* qsum = reinterpret_cast<QuerySummary*>(a.scratch);
  KeySummary* ksum = reinterpret_cast<KeySummary*>(
      qsum + static_cast<long long>(a.batch) * nq);
  int* counts =
      reinterpret_cast<int*>(ksum + static_cast<long long>(a.batch) * nk);
  int* ord = counts + static_cast<long long>(a.batch) * nq;
  *order = ord;

  const long long tiles = static_cast<long long>(a.batch) * (nq + nk);
  tile_summary_kernel<kBlockQ, kBlockK, Args>
      <<<static_cast<unsigned>((tiles + kSummaryWarps - 1) / kSummaryWarps),
         32 * kSummaryWarps, 0, s>>>(a, qsum, ksum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.window > 0) {
    PosRange* qpr = reinterpret_cast<PosRange*>(
        ord + static_cast<long long>(a.batch) * nq);
    err = static_cast<cudaError_t>(launch_window_tile_map(
        a, s, qsum, ksum, qpr, counts, nullptr));
  } else {
    meta_tile_map_kernel<kBlockQ, kBlockK>
        <<<dim3(nq, a.batch), kMapThreads, 0, s>>>(
            qsum, ksum, a.lq, a.lk, a.tile_map, counts, nullptr);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ng = (nq + group - 1) / group;
  if (group > 1) {
    // the groups' counts over the query tiles' (which nothing else reads)
    meta_tile_map_groups_kernel<<<dim3(ng, a.batch), kMapThreads, 0,
                                  s>>>(a.tile_map, nq, nk, group, counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int order_smem = (nk + 1) * static_cast<int>(sizeof(int));
  err = cudaFuncSetAttribute(tile_order_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             order_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_order_kernel<<<1, kOrderThreads, order_smem, s>>>(
      counts, a.batch * ng, nk, ord);
  return static_cast<int>(cudaGetLastError());
}

// The same map for the backward kernels (K7 and the fp32 backward's inline
// mask), launched on `s`: the summaries, the classes with each query
// tile's and each key tile's count of non-empty tiles, then the query
// tiles and the key tiles each ordered by their count, most first, into
// *row_order and *col_order (in a.scratch: B (nq + nk) summaries of 8
// ints, B nq row counts, B nk column counts, B nq and B nk orders).
// Returns the first nonzero CUDA error (0 = all launched).
template <class Args>
inline int launch_inline_bwd_tile_map(const Args& a, cudaStream_t s,
                                      const int** row_order,
                                      const int** col_order) {
  const int nq = (a.lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a.lk + kBlockK - 1) / kBlockK;
  const long long bq = static_cast<long long>(a.batch) * nq;
  const long long bk = static_cast<long long>(a.batch) * nk;
  QuerySummary* qsum = reinterpret_cast<QuerySummary*>(a.scratch);
  KeySummary* ksum = reinterpret_cast<KeySummary*>(qsum + bq);
  int* row_counts = reinterpret_cast<int*>(ksum + bk);
  int* col_counts = row_counts + bq;
  int* rows = col_counts + bk;
  int* cols = rows + bq;
  *row_order = rows;
  *col_order = cols;

  cudaError_t err = cudaMemsetAsync(col_counts, 0, bk * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_summary_kernel<kBlockQ, kBlockK, Args>
      <<<static_cast<unsigned>((bq + bk + kSummaryWarps - 1) / kSummaryWarps),
         32 * kSummaryWarps, 0, s>>>(a, qsum, ksum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.window > 0) {
    err = static_cast<cudaError_t>(launch_window_tile_map(
        a, s, qsum, ksum, reinterpret_cast<PosRange*>(cols + bk), row_counts,
        col_counts));
  } else {
    meta_tile_map_kernel<kBlockQ, kBlockK>
        <<<dim3(nq, a.batch), kMapThreads, 0, s>>>(
            qsum, ksum, a.lq, a.lk, a.tile_map, row_counts, col_counts);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int order_smem = ((nq > nk ? nq : nk) + 1) *
                         static_cast<int>(sizeof(int));
  err = cudaFuncSetAttribute(tile_order_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             order_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_order_kernel<<<1, kOrderThreads, order_smem, s>>>(
      row_counts, static_cast<int>(bq), nk, rows);
  tile_order_kernel<<<1, kOrderThreads, order_smem, s>>>(
      col_counts, static_cast<int>(bk), nq, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vgt
