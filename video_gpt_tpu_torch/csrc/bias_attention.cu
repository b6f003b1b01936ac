// Biased softmax attention for Hopper (sm_90a): kernel K3.
//
// Replaces the TPU kernel `_bias_kernel` (video_gpt_tpu/ops/flash_attention.py,
// called by `flash_mha` with a bias): the prefill's attention over the clean
// prefix, with the additive bf16 bias from `precompute_bias` (0 where
// visible, BF16_NEG = bf16 min / 2 where masked).
//
// Function, per (batch b, head h, query q):
//   logits(q, k) = q.k * head_dim^-0.5 + bias[b, q, k]
//   out(q)       = softmax_k(logits) . v          (max-subtracted softmax)
// The TPU kernel holds the whole key row in VMEM; here the key row streams
// through shared memory in 64-key tiles with an online softmax (running max
// and rescale), which computes the same function in another summation
// order. Masked logits are finite (BF16_NEG, never -inf), so a query whose
// first tiles are fully masked gets a finite running max and no NaN; key
// columns past Lk are -inf and weigh exactly 0. This recurrence is the
// TPU's k-tiled `_stream_kernel` (K10, `flash_mha_streaming`, its route
// past 8192 keys), so the kernel serves that too: the long rollout's
// prefill at B = 1 is 12,432^2 with a 309 MB bias, whose row offsets
// (r * bias_sq, up to 1.5e8) are 64-bit products.
//
// What bounds it on the card: at the flagship prefill (Lq = Lk = 1776,
// 32 heads of 96) ~2e10 visible-pair FLOPs against ~0.05 GB of operands
// (q, k, v, the bias once, out): tensor throughput bounds it, though the
// bias tile, read once per head from L2, is the largest operand stream.
// With a non-null `lse` it also writes each row's logsumexp, the residual
// of the backward kernel; a null pointer leaves the serving launch as it was.
// Design: as the rank kernel (rank_attention.cu) -- 64 query rows of one head
// per block, K/V tiles through shared memory, bf16 mma.sync with fp32
// accumulate, probabilities kept in registers -- plus the per-row running
// max, whose rescale of the output accumulators is a register multiply
// because the mma fragment layout fixes which two rows each thread holds.
#include <math_constants.h>

#include "attention_common.cuh"

namespace vgt {

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
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long bias_sb, bias_sq;
  long long o_sb, o_sl, o_sh;
  int batch, heads, kv_heads, lq, lk, head_dim;
  float scale_log2;   // head_dim^-0.5 * log2(e)
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    bias_attention_kernel(const BiasAttnArgs a) {
  constexpr int LDS = D + 8;
  constexpr int KS = D / 16;
  constexpr int NO = D / 8;
  constexpr int NS = kBlockK / 8;
  constexpr float kLog2e = 1.4426950408889634f;
  __shared__ __align__(16) bf16 qs[kBlockQ * LDS];
  __shared__ __align__(16) bf16 ks[kBlockK * LDS];
  __shared__ __align__(16) bf16 vs[kBlockK * LDS];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int hk = h / (a.heads / a.kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
                   q0 * a.q_sl;
  load_tile<D, kBlockQ, LDS>(qs, qp, a.q_sl, min(kBlockQ, a.lq - q0));
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  // rows past Lq read no bias (their output is never stored)
  const bf16* bias = static_cast<const bf16*>(a.bias) + b * a.bias_sb;
  const bf16* brow0 = r0 < a.lq ? bias + r0 * a.bias_sq : nullptr;
  const bf16* brow1 = r1 < a.lq ? bias + r1 * a.bias_sq : nullptr;
  __syncthreads();

  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    load_a(qa[kk], qs + warp * 16 * LDS + kk * 16, LDS, lane);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the denominators

  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  for (int k0 = 0; k0 < a.lk; k0 += kBlockK) {
    const int valid = min(kBlockK, a.lk - k0);
    __syncthreads();
    load_tile<D, kBlockK, LDS>(ks, kp + k0 * a.k_sl, a.k_sl, valid);
    load_tile<D, kBlockK, LDS>(vs, vp + k0 * a.v_sl, a.v_sl, valid);
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
    // logits in log2 units; key columns past Lk weigh nothing
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const bf16* brow = (e < 2) ? brow0 : brow1;
        float x = -CUDART_INF_F;
        if (col < valid) {
          const float bb =
              brow ? __bfloat162float(brow[k0 + col]) : 0.f;
          x = s[n][e] * a.scale_log2 + bb * kLog2e;
        }
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      ls0 += s[n][0] + s[n][1];
      ls1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
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

  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  if (a.lse != nullptr && t == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    float* lse = a.lse + (static_cast<long long>(b) * a.heads + h) * a.lq;
    if (r0 < a.lq) lse[r0] = (m0 + log2f(sum0)) * kLn2;
    if (r1 < a.lq) lse[r1] = (m1 + log2f(sum1)) * kLn2;
  }
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
extern "C" int vgt_bias_attention(const vgt::BiasAttnArgs* a, void* stream) {
  const dim3 grid((a->lq + vgt::kBlockQ - 1) / vgt::kBlockQ, a->heads,
                  a->batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->head_dim != vgt::kHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  vgt::bias_attention_kernel<vgt::kHeadDim>
      <<<grid, vgt::kThreads, 0, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
