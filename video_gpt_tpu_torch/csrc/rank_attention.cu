// Columnar-rank decode attention for Hopper (sm_90a): kernels K1 and K2.
//
// Replaces the TPU kernels `_decode_split_kernel` (K1, the cond-row decode
// step and the cache extend; two key operands, cache then tail) and
// `_decode_kernel` (K2, the uncond row; one key operand) of
// video_gpt_tpu/ops/flash_attention.py. One kernel serves both: K2 is K1
// with an empty second operand. Keys stream through shared memory with no
// length cap, so it also computes the function of the TPU's k-tiled
// variants past 8192 keys, `_stream_decode_split_kernel` (K4: the long
// rollout's cond row, 5,328 queries over 12,432 cached + 5,328 new keys)
// and `_stream_decode_kernel` (K5). Offsets are 64-bit products of int
// indices and long long strides (a 2 x 32 x 17,760 x 96 operand is 109M
// elements; no int product reaches 2^31).
//
// Function, per (batch b, head h, query q):
//   visible(q, k) = q_off[q] >= rank[k]
//   p(q, k)      = visible ? exp2(clamp(q.k * scale * log2(e), -100, 100)) : 0
//   out(q)       = sum_k bf16(p) v_k / max(sum_k p, 1e-30)
// The softmax is NOT max-shifted (the TPU kernels' semantics, kept exactly:
// no running max, so no rescale and no cross-tile reduction beyond sums).
// GQA: key/value head = h / (H / Hkv).
//
// What bounds it on the card: at the flagship shapes (Lq 3552, 1776 cache +
// 3552 tail keys, 32 heads of 96) the work is ~2.3e11 visible-pair FLOPs
// against ~0.11 GB of operands, far above the ~295 FLOP/byte ridge: tensor
// throughput bounds it. Design: each block owns 64 query rows of one head
// (16 per warp) and streams K/V tiles of 64 keys through shared memory;
// S = Q.K^T and O += P.V run on bf16 tensor cores (mma.sync, fp32
// accumulate), the probabilities stay in registers between the two
// products, and the denominator is one quad reduction at the end. Loads are
// synchronous (no cp.async/TMA pipeline, no wgmma): a simple first kernel.
#include "attention_common.cuh"

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    rank_attention_kernel(const RankAttnArgs a) {
  constexpr int LDS = D + 8;          // padded row: conflict-free fragments
  constexpr int KS = D / 16;          // k16 steps over head_dim
  constexpr int NO = D / 8;           // n8 tiles of the output row
  constexpr int NS = kBlockK / 8;     // n8 tiles of one score tile
  __shared__ __align__(16) bf16 qs[kBlockQ * LDS];
  __shared__ __align__(16) bf16 ks[kBlockK * LDS];
  __shared__ __align__(16) bf16 vs[kBlockK * LDS];
  __shared__ int rank_s[kBlockK];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int hk = h / (a.heads / a.kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
                   q0 * a.q_sl;
  load_tile<D, kBlockQ, LDS>(qs, qp, a.q_sl, min(kBlockQ, a.lq - q0));
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int* qo = a.qoff + b * a.qoff_sb;
  const int qoff0 = r0 < a.lq ? qo[r0] : kNever;
  const int qoff1 = r1 < a.lq ? qo[r1] : kNever;
  __syncthreads();

  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    load_a(qa[kk], qs + warp * 16 * LDS + kk * 16, LDS, lane);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;

  for (int op = 0; op < 2; ++op) {
    const int len = a.len[op];
    const bf16* kp = static_cast<const bf16*>(a.k[op]) + b * a.k_sb[op] +
                     hk * a.k_sh[op];
    const bf16* vp = static_cast<const bf16*>(a.v[op]) + b * a.v_sb[op] +
                     hk * a.v_sh[op];
    const int* rp = a.rank[op] + b * a.rank_sb[op];
    const long long ksl = a.k_sl[op], vsl = a.v_sl[op];
    for (int k0 = 0; k0 < len; k0 += kBlockK) {
      const int valid = min(kBlockK, len - k0);
      __syncthreads();  // the previous tile is fully consumed
      load_tile<D, kBlockK, LDS>(ks, kp + k0 * ksl, ksl, valid);
      load_tile<D, kBlockK, LDS>(vs, vp + k0 * vsl, vsl, valid);
      for (int i = threadIdx.x; i < kBlockK; i += kThreads)
        rank_s[i] = i < valid ? rp[k0 + i] : kNever;
      __syncthreads();

      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          uint32_t b0, b1;
          load_b_kt(b0, b1, ks + n * 8 * LDS + kk * 16, LDS, lane);
          mma_16816(s[n], qa[kk], b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int rk0 = rank_s[n * 8 + 2 * t], rk1 = rank_s[n * 8 + 2 * t + 1];
        const bool vis[4] = {qoff0 >= rk0, qoff0 >= rk1, qoff1 >= rk0,
                             qoff1 >= rk1};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = vis[e] ? exp2f(fminf(fmaxf(s[n][e] * a.kscale, -100.f),
                                         100.f))
                           : 0.f;
        l0 += s[n][0] + s[n][1];
        l1 += s[n][2] + s[n][3];
      }
#pragma unroll
      for (int j = 0; j < kBlockK / 16; ++j) {
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t b0, b1;
          load_b_v(b0, b1, vs + j * 16 * LDS + n * 8, LDS, lane);
          mma_16816(o[n], pa, b0, b1);
        }
      }
    }
  }

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  bf16* out = static_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r0 * a.o_sl + c) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r1 * a.o_sl + c) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace vgt

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int vgt_rank_attention(const vgt::RankAttnArgs* a, void* stream) {
  const dim3 grid((a->lq + vgt::kBlockQ - 1) / vgt::kBlockQ, a->heads,
                  a->batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->head_dim != vgt::kHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  vgt::rank_attention_kernel<vgt::kHeadDim>
      <<<grid, vgt::kThreads, 0, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
