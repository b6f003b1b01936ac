// Metadata-masked softmax attention for Hopper (sm_90a): kernel K6.
//
// Replaces the TPU kernel `_stream_inline_kernel` (video_gpt_tpu/ops/
// flash_attention.py, called by `_stream_inline_fwd`): the forward of every
// training attention whose bias would be too large to precompute (stages
// 2-4, 48-80 frames), with the visibility rule evaluated per tile from the
// seven int32 metadata vectors (inline_mask.cuh). It also computes the
// function of the resident `_inline_kernel` (K8, `flash_mha` with bias=None):
// the TPU split the two by whether a key row fits VMEM; here keys always
// stream through shared memory, so one kernel serves both.
//
// Function, per (batch b, head h, query q), with visible(q, k) the rule:
//   logits(q, k) = q.k * head_dim^-0.5          where visible(q, k)
//   out(q)       = softmax over the visible k of logits . v
//   lse(q)       = log sum over the visible k of exp(logits)  (fp32)
// A row that sees no key gets out 0 and lse -inf (no layout has one: every
// real row sees itself, and pad rows see every key).
//
// The TPU kernel replaces masked scores by -1e30 and starts the running max
// at -1e30, so a row whose first key tiles are all masked accumulates
// exp(0) terms that a later rescale by exp(-1e30 - m) = 0 removes. Here
// masked scores are -inf and the max subtracted is 0 while a row has seen
// no visible key, so masked keys weigh exactly 0 on every path.
//
// What bounds it on the card: at stage 4 (B 1, L 35520, 32 heads of 96)
// about 1.26e9 x 0.27 visible pairs per head, 4 FLOPs x 96 each: ~16 TFLOP
// of visible-pair products against ~0.2 GB of operands, so tensor
// throughput bounds it. This first version computes every tile, masked or
// not (no tile skipping), with mma.sync and no wgmma or TMA.
// Design: K3's (bias_attention.cu) -- 64 query rows of one head per block,
// K/V tiles through shared memory with the tile's key metadata beside them,
// bf16 mma.sync with fp32 accumulate, online softmax with the probabilities
// kept in registers -- with the bias read replaced by the rule.
#include <math_constants.h>

#include "inline_mask.cuh"

namespace vgt {

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
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    inline_attention_kernel(const InlineAttnArgs a) {
  constexpr int LDS = D + 8;
  constexpr int KS = D / 16;
  constexpr int NO = D / 8;
  constexpr int NS = kBlockK / 8;
  __shared__ __align__(16) bf16 qs[kBlockQ * LDS];
  __shared__ __align__(16) bf16 ks[kBlockK * LDS];
  __shared__ __align__(16) bf16 vs[kBlockK * LDS];
  __shared__ KeyMeta kmeta[kBlockK];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int hk = h / (a.heads / a.kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
                   q0 * a.q_sl;
  load_tile<D, kBlockQ, LDS>(qs, qp, a.q_sl, min(kBlockQ, a.lq - q0));
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const QueryMeta qm0 = query_meta(a.qm, a.qm_sb, b, r0, a.lq);
  const QueryMeta qm1 = query_meta(a.qm, a.qm_sb, b, r1, a.lq);
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
    load_key_meta<kBlockK>(kmeta, a.km, a.km_sb, b, k0, a.lk);
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
    // logits in log2 units; masked keys and columns past Lk are -inf
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const bool vis =
            col < valid && inline_visible(e < 2 ? qm0 : qm1, kmeta[col]);
        s[n][e] = vis ? s[n][e] * a.scale_log2 : -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    // while a row has seen no visible key its max is -inf: subtract 0, so
    // exp2 gives 0 for the masked keys and for the rescale, never NaN
    const float ms0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float ms1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float alpha0 = exp2f(m0 - ms0), alpha1 = exp2f(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = exp2f(s[n][0] - ms0);
      s[n][1] = exp2f(s[n][1] - ms0);
      s[n][2] = exp2f(s[n][2] - ms1);
      s[n][3] = exp2f(s[n][3] - ms1);
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
  const float inv0 = sum0 > 0.f ? 1.f / sum0 : 0.f;
  const float inv1 = sum1 > 0.f ? 1.f / sum1 : 0.f;
  if (a.lse != nullptr && t == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    float* lse = a.lse + (static_cast<long long>(b) * a.heads + h) * a.lq;
    if (r0 < a.lq)
      lse[r0] = sum0 > 0.f ? (m0 + log2f(sum0)) * kLn2 : -CUDART_INF_F;
    if (r1 < a.lq)
      lse[r1] = sum1 > 0.f ? (m1 + log2f(sum1)) * kLn2 : -CUDART_INF_F;
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
extern "C" int vgt_inline_attention(const vgt::InlineAttnArgs* a,
                                    void* stream) {
  const dim3 grid((a->lq + vgt::kBlockQ - 1) / vgt::kBlockQ, a->heads,
                  a->batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->head_dim != vgt::kHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  vgt::inline_attention_kernel<vgt::kHeadDim>
      <<<grid, vgt::kThreads, 0, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
