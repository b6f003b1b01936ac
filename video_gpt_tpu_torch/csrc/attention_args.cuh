// The arguments of the attention kernels, one struct per mask and
// direction: the columnar rank (K1/K2, rank_attention.cu), the bias (K3,
// bias_attention.cu; its backward K9, bias_attention_bwd.cu) and the inline
// metadata (K6, inline_attention.cu; its backward K7,
// inline_attention_bwd.cu). The fp32 kernels (fp32_attention.cu,
// fp32_attention_bwd.cu) take the same structs, their q, k, v, out (o,
// dout, dq, dk, dv) pointing at fp32 tensors; every other field means the
// same.
#pragma once

#include <stdint.h>

namespace vgt {

// Must match _RankArgs in video_gpt_tpu_torch/ops/flash_attention.py.
struct RankAttnArgs {
  const void* q;         // [B, Lq, H, D] (strided)
  const void* k[2];      // operand o: keys [B, L, Hkv, D] (strided)
  const void* v[2];      // values, same shape as the keys
  const int* rank[2];    // [B, len[o]] per-key rank (row stride rank_sb[o])
  const int* qoff;       // [B, Lq] per-query offset
  void* out;             // [B, Lq, H, D]
  long long q_sb, q_sl, q_sh;
  long long k_sb[2], k_sl[2], k_sh[2];
  long long v_sb[2], v_sl[2], v_sh[2];
  long long rank_sb[2];
  long long qoff_sb;
  long long o_sb, o_sl, o_sh;
  int len[2];
  int batch, heads, kv_heads, lq, head_dim;
  float kscale;          // head_dim^-0.5 * log2(e)
};

// Must match _BiasArgs in video_gpt_tpu_torch/ops/flash_attention.py.
struct BiasAttnArgs {
  const void* q;      // [B, Lq, H, D] (strided)
  const void* k;      // keys [B, Lk, Hkv, D] (strided)
  const void* v;      // values, same shape as the keys
  const void* bias;   // bf16 [B, Lq, Lk], rows at stride bias_sq
  void* out;          // [B, Lq, H, D]
  float* lse;         // [B, H, Lq] contiguous, or null: the logsumexp of
                      // each row's biased logits (natural log), which the
                      // backward (K9, bias_attention_bwd.cu) reads
  const int8_t* tile_map;  // [B, ceil(Lq/64), ceil(Lk/64)], vgt_bias_tile_map
  const int* order;        // [B ceil(Lq/64)] query tiles, most tiles first
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long bias_sb, bias_sq;
  long long o_sb, o_sl, o_sh;
  int batch, heads, kv_heads, lq, lk, head_dim;
  float scale_log2;   // head_dim^-0.5 * log2(e)
  int bias_vec;       // bias rows allow 16-byte loads
};

// Must match _InlineArgs in video_gpt_tpu_torch/ops/flash_attention.py.
struct InlineAttnArgs {
  const void* q;      // [B, Lq, H, D] (strided)
  const void* k;      // keys [B, Lk, Hkv, D] (strided: tokens- or heads-major)
  const void* v;      // values, same shape as the keys
  void* out;          // [B, Lq, H, D]
  float* lse;         // [B, H, Lq] contiguous, or null: each row's
                      // logsumexp (natural log), which K7 reads
  const int* qm[4];   // index, q_block, q_offset, is_pad [B, Lq]
  const int* km[3];   // vis_start, noisy_block, noisy_role [B, Lk]
  long long qm_sb[4], km_sb[3];
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
  int batch, heads, kv_heads, lq, lk, head_dim;
  float scale_log2;   // head_dim^-0.5 * log2(e)
  int8_t* tile_map;   // [B, ceil(Lq/64), ceil(Lk/64)] tile classes (written)
  int* scratch;       // B (nq + nk) 8 + 2 B nq ints (written): the query-
                      // and key-tile summaries, each query tile's count of
                      // non-empty key tiles, the launch order; under a
                      // window B (nq + nk) 2 more: each tile's positions
  int map_only;       // 1: build the tile map and stop
  const int* qpos;    // a sliding window's positions [B, Lq] and [B, Lk]
  const int* kpos;    // (contiguous rows), read where window > 0
  long long qpos_sb, kpos_sb;
  int window;         // the window in positions (inline_mask.cuh); 0: none
};

// Must match _BiasBwdArgs in video_gpt_tpu_torch/ops/flash_attention.py.
struct BiasAttnBwdArgs {
  const void* q;      // [B, Lq, H, D] (strided)
  const void* k;      // keys [B, Lk, Hkv, D] (strided)
  const void* v;      // values, same shape as the keys
  const void* bias;   // bf16 [B, Lq, Lk], rows at stride bias_sq
  const void* o;      // forward output [B, Lq, H, D]
  const void* dout;   // its cotangent [B, Lq, H, D]
  const float* lse;   // [B, H, Lq] contiguous, from the forward
  float* delta;       // [B, H, Lq] contiguous scratch: rowsum(o * do)
  void* dq;           // [B, Lq, H, D]
  void* dk;           // [B, Lk, Hkv, D]
  void* dv;           // [B, Lk, Hkv, D], the strides of dk
  const int8_t* tile_map;  // [B, ceil(Lq/64), ceil(Lk/64)] tile classes and
  const float* rowdead;    // [B, Lq] each row's dead-row count (see
                           // bias_tile_map_kernel), from vgt_bias_tile_map
  float* rowref;      // [B, H, Lq, 2] scratch: each row's softmax reference
                      // (x_ref, off): p = exp2((x - x_ref) - off)
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long bias_sb, bias_sq;
  long long o_sb, o_sl, o_sh;
  long long do_sb, do_sl, do_sh;
  long long dq_sb, dq_sl, dq_sh;
  long long dkv_sb, dkv_sl, dkv_sh;
  int batch, heads, kv_heads, lq, lk, head_dim;
  float scale;        // head_dim^-0.5
  float scale_log2;   // head_dim^-0.5 * log2(e)
  int bias_vec;       // bias rows allow 16-byte loads
};

// Must match _InlineBwdArgs in video_gpt_tpu_torch/ops/flash_attention.py.
struct InlineAttnBwdArgs {
  const void* q;      // [B, Lq, H, D] (strided)
  const void* k;      // keys [B, Lk, Hkv, D] (strided)
  const void* v;      // values, same shape as the keys
  const void* o;      // forward output [B, Lq, H, D]
  const void* dout;   // its cotangent [B, Lq, H, D]
  const float* lse;   // [B, H, Lq] contiguous, from the forward
  float* delta;       // [B, H, Lq] contiguous scratch: rowsum(o * do)
  void* dq;           // [B, Lq, H, D]
  void* dk;           // [B, Lk, Hkv, D]
  void* dv;           // [B, Lk, Hkv, D], the strides of dk
  const int* qm[4];   // index, q_block, q_offset, is_pad [B, Lq]
  const int* km[3];   // vis_start, noisy_block, noisy_role [B, Lk]
  long long qm_sb[4], km_sb[3];
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
  long long do_sb, do_sl, do_sh;
  long long dq_sb, dq_sl, dq_sh;
  long long dkv_sb, dkv_sl, dkv_sh;
  int batch, heads, kv_heads, lq, lk, head_dim;
  float scale;        // head_dim^-0.5
  float scale_log2;   // head_dim^-0.5 * log2(e)
  int8_t* tile_map;   // [B, ceil(Lq/64), ceil(Lk/64)] tile classes (written)
  int* scratch;       // 8 B (nq + nk) + 2 B (nq + nk) ints (written): the
                      // query- and key-tile summaries, the non-empty tiles
                      // of each row and each column, the two launch orders;
                      // under a window 2 B (nq + nk) more: tile positions
  int map_only;       // 1: build the tile map and stop
  const int* qpos;    // a sliding window's positions [B, Lq] and [B, Lk]
  const int* kpos;    // (contiguous rows), read where window > 0
  long long qpos_sb, kpos_sb;
  int window;         // the window in positions (inline_mask.cuh); 0: none
};

}  // namespace vgt
