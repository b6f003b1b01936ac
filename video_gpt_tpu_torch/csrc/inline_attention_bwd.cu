// Backward of the metadata-masked attention for Hopper (sm_90a): kernel K7.
//
// Replaces the TPU kernels `_stream_dq_kernel` (K7a) and `_stream_dkv_kernel`
// (K7b) (video_gpt_tpu/ops/flash_attention.py, called by
// `_stream_inline_bwd_impl`, the custom VJP of `flash_mha_streaming_inline`):
// the attention backward of every training layer whose bias would be too
// large to precompute (stages 2-4), with the visibility rule evaluated per
// tile from the seven int32 metadata vectors (inline_mask.cuh; the dK/dV
// kernel evaluates it transposed, as `_inline_visible_t` does).
//
// Function, per (batch b, head h), with scale = head_dim^-0.5 and
// visible(q, k) the rule:
//   p(q, k)  = exp(q.k * scale - lse(q))  where visible(q, k), else 0
//   di(q)    = sum_d o(q, d) * do(q, d)
//   ds(q, k) = p(q, k) * (do(q) . v(k) - di(q)) * scale
//   dq = ds . K,   dk = ds^T . Q,   dv = p^T . dO
// with lse the forward's (K6, inline_attention.cu) fp32 logsumexp, and the
// q heads of a GQA group summed into their shared kv head.
//
// Three launches, in order, the scheme of K9 (bias_attention_bwd.cu):
//   1. delta: di = rowsum(o * do) in fp32 (the TPU computes it in XLA);
//   2. dK/dV (K7b): one block per (b, kv head, 64-key tile); it loops over
//      the group's q heads and all 64-row query tiles and keeps dK and dV in
//      fp32 registers, so the GQA sum falls out of the loop, as the TPU
//      kernel's revisited f32 output block does, and no atomics are needed;
//   3. dQ (K7a): one block per (b, head, 64-row query tile), looping over the
//      key tiles, as the forward does.
// Products are bf16 mma.sync with fp32 accumulation: p and ds are rounded to
// bf16 before the products that consume them (the TPU keeps them in fp32),
// and dq, dk, dv are written in the inputs' dtype from fp32 accumulators.
//
// What bounds it on the card: at stage 4 (B 1, L 35520, 32 heads of 96) the
// five matrix products of the visible pairs are ~40 TFLOP against ~0.4 GB of
// operands: tensor throughput bounds it. This first version skips no fully
// masked tile and uses no wgmma or TMA.
#include <math_constants.h>

#include "inline_mask.cuh"

namespace vgt {

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
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDeltaWarps = 8;

// 1. di = rowsum(o * do): one warp per (b, h, query row).
__global__ void __launch_bounds__(32 * kDeltaWarps)
    inline_attention_delta_kernel(const InlineAttnBwdArgs a) {
  const long long row = (static_cast<long long>(blockIdx.x) * kDeltaWarps +
                         (threadIdx.x >> 5));
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(a.batch) * a.heads * a.lq) return;
  const int r = static_cast<int>(row % a.lq);
  const long long bh = row / a.lq;
  const int h = static_cast<int>(bh % a.heads);
  const int b = static_cast<int>(bh / a.heads);
  const bf16* o = static_cast<const bf16*>(a.o) + b * a.o_sb + r * a.o_sl +
                  h * a.o_sh;
  const bf16* d = static_cast<const bf16*>(a.dout) + b * a.do_sb +
                  r * a.do_sl + h * a.do_sh;
  float s = 0.f;
  for (int c = lane; c < a.head_dim; c += 32)
    s += __bfloat162float(o[c]) * __bfloat162float(d[c]);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) a.delta[row] = s;
}

// Pack the 16x16 A fragment of keys-or-queries j*16..j*16+15 from two
// neighbouring C tiles (attention_common.cuh: the C layout of two n-tiles is
// exactly one A fragment).
__device__ __forceinline__ void pack_a(uint32_t pa[4], const float c0[4],
                                       const float c1[4]) {
  pa[0] = pack_bf16(c0[0], c0[1]);
  pa[1] = pack_bf16(c0[2], c0[3]);
  pa[2] = pack_bf16(c1[0], c1[1]);
  pa[3] = pack_bf16(c1[2], c1[3]);
}

template <int D>
constexpr int dkdv_smem_bytes() {
  // K, V, Q, dO tiles [64][D+8] bf16; the query tile's metadata, lse and
  // delta
  return (2 * kBlockK + 2 * kBlockQ) * (D + 8) * 2 +
         kBlockQ * (static_cast<int>(sizeof(QueryMeta)) + 2 * 4);
}

// 2. dK/dV (K7b) of one 64-key tile of one kv head; warp w owns keys
// w*16..+15, whose metadata it keeps in registers. Per query tile it forms
// the transposed products, rows = keys:
//   S^T = K.Q^T, P^T = exp2(S^T scale_log2 - lse log2e) where visible,
//   dV += P^T.dO, dP^T = V.dO^T, dS^T = P^T (dP^T - di) scale, dK += dS^T.Q
template <int D>
__global__ void __launch_bounds__(kThreads)
    inline_attention_dkdv_kernel(const InlineAttnBwdArgs a) {
  constexpr int LDS = D + 8;
  constexpr int KS = D / 16;
  constexpr int NO = D / 8;
  constexpr int NQ = kBlockQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kBlockK * LDS;
  bf16* qs = vs + kBlockK * LDS;
  bf16* dos = qs + kBlockQ * LDS;
  QueryMeta* qmeta = reinterpret_cast<QueryMeta*>(dos + kBlockQ * LDS);
  float* lse_s = reinterpret_cast<float*>(qmeta + kBlockQ);
  float* dl_s = lse_s + kBlockQ;

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kBlockK;
  const int group = a.heads / a.kv_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kvalid = min(kBlockK, a.lk - k0);
  const int kr0 = warp * 16 + g, kr1 = kr0 + 8;  // this thread's key rows
  const KeyMeta km0 = key_meta(a.km, a.km_sb, b, k0 + kr0, a.lk);
  const KeyMeta km1 = key_meta(a.km, a.km_sb, b, k0 + kr1, a.lk);

  load_tile<D, kBlockK, LDS>(
      ks, static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh +
              k0 * a.k_sl, a.k_sl, kvalid);
  load_tile<D, kBlockK, LDS>(
      vs, static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh +
              k0 * a.v_sl, a.v_sl, kvalid);

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = 0; i < group; ++i) {
    const int h = hk * group + i;
    const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const bf16* dop =
        static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const long long row0 = (static_cast<long long>(b) * a.heads + h) * a.lq;
    for (int q0 = 0; q0 < a.lq; q0 += kBlockQ) {
      const int qvalid = min(kBlockQ, a.lq - q0);
      __syncthreads();  // the previous tile's reads are done
      load_tile<D, kBlockQ, LDS>(qs, qp + q0 * a.q_sl, a.q_sl, qvalid);
      load_tile<D, kBlockQ, LDS>(dos, dop + q0 * a.do_sl, a.do_sl, qvalid);
      load_query_meta<kBlockQ>(qmeta, a.qm, a.qm_sb, b, q0, a.lq);
      if (threadIdx.x < kBlockQ) {
        const int r = threadIdx.x;
        lse_s[r] = r < qvalid ? a.lse[row0 + q0 + r] * kLog2e : 0.f;
        dl_s[r] = r < qvalid ? a.delta[row0 + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4];
        load_a(ka, ks + warp * 16 * LDS + kk * 16, LDS, lane);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t b0, b1;
          load_b_kt(b0, b1, qs + n * 8 * LDS + kk * 16, LDS, lane);
          mma_16816(s[n], ka, b0, b1);
        }
      }
      // P^T; masked pairs, queries past Lq and keys past Lk weigh nothing
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t + (e & 1);
          const bool vis = (e < 2 ? kr0 : kr1) < kvalid && qc < qvalid &&
                           inline_visible(qmeta[qc], e < 2 ? km0 : km1);
          s[n][e] = vis ? exp2f(s[n][e] * a.scale_log2 - lse_s[qc]) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kBlockQ / 16; ++j) {
        uint32_t pa[4];
        pack_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t b0, b1;
          load_b_v(b0, b1, dos + j * 16 * LDS + n * 8, LDS, lane);
          mma_16816(dv[n], pa, b0, b1);
        }
      }
      float dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t va[4];
        load_a(va, vs + warp * 16 * LDS + kk * 16, LDS, lane);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t b0, b1;
          load_b_kt(b0, b1, dos + n * 8 * LDS + kk * 16, LDS, lane);
          mma_16816(dp[n], va, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] *= (dp[n][e] - dl_s[n * 8 + 2 * t + (e & 1)]) * a.scale;
#pragma unroll
      for (int j = 0; j < kBlockQ / 16; ++j) {
        uint32_t pa[4];
        pack_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t b0, b1;
          load_b_v(b0, b1, qs + j * 16 * LDS + n * 8, LDS, lane);
          mma_16816(dk[n], pa, b0, b1);
        }
      }
    }
  }

  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.dkv_sb + hk * a.dkv_sh;
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.dkv_sb + hk * a.dkv_sh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    if (kr0 < kvalid) {
      const long long off = (k0 + kr0) * a.dkv_sl + c;
      *reinterpret_cast<uint32_t*>(dkp + off) = pack_bf16(dk[n][0], dk[n][1]);
      *reinterpret_cast<uint32_t*>(dvp + off) = pack_bf16(dv[n][0], dv[n][1]);
    }
    if (kr1 < kvalid) {
      const long long off = (k0 + kr1) * a.dkv_sl + c;
      *reinterpret_cast<uint32_t*>(dkp + off) = pack_bf16(dk[n][2], dk[n][3]);
      *reinterpret_cast<uint32_t*>(dvp + off) = pack_bf16(dv[n][2], dv[n][3]);
    }
  }
}

// 3. dQ (K7a) of one 64-row query tile of one head; warp w owns rows
// w*16..+15, keys stream through shared memory in 64-key tiles with their
// metadata:
//   S = Q.K^T, P = exp2(S scale_log2 - lse log2e) where visible,
//   dP = dO.V^T, dS = P (dP - di) scale, dQ += dS.K
template <int D>
__global__ void __launch_bounds__(kThreads)
    inline_attention_dq_kernel(const InlineAttnBwdArgs a) {
  constexpr int LDS = D + 8;
  constexpr int KS = D / 16;
  constexpr int NO = D / 8;
  constexpr int NS = kBlockK / 8;
  // Q and dO pass through these tiles first, then K and V
  __shared__ __align__(16) bf16 ks[kBlockK * LDS];
  __shared__ __align__(16) bf16 vs[kBlockK * LDS];
  __shared__ KeyMeta kmeta[kBlockK];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int hk = h / (a.heads / a.kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qvalid = min(kBlockQ, a.lq - q0);

  load_tile<D, kBlockQ, LDS>(
      ks, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
              q0 * a.q_sl, a.q_sl, qvalid);
  load_tile<D, kBlockQ, LDS>(
      vs, static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh +
              q0 * a.do_sl, a.do_sl, qvalid);
  __syncthreads();
  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a(qa[kk], ks + warp * 16 * LDS + kk * 16, LDS, lane);
    load_a(da[kk], vs + warp * 16 * LDS + kk * 16, LDS, lane);
  }

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const long long row0 = (static_cast<long long>(b) * a.heads + h) * a.lq;
  const float lse0 = r0 < a.lq ? a.lse[row0 + r0] * kLog2e : 0.f;
  const float lse1 = r1 < a.lq ? a.lse[row0 + r1] * kLog2e : 0.f;
  const float dl0 = r0 < a.lq ? a.delta[row0 + r0] : 0.f;
  const float dl1 = r1 < a.lq ? a.delta[row0 + r1] : 0.f;
  const QueryMeta qm0 = query_meta(a.qm, a.qm_sb, b, r0, a.lq);
  const QueryMeta qm1 = query_meta(a.qm, a.qm_sb, b, r1, a.lq);

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  for (int k0 = 0; k0 < a.lk; k0 += kBlockK) {
    const int valid = min(kBlockK, a.lk - k0);
    __syncthreads();
    load_tile<D, kBlockK, LDS>(ks, kp + k0 * a.k_sl, a.k_sl, valid);
    load_tile<D, kBlockK, LDS>(vs, vp + k0 * a.v_sl, a.v_sl, valid);
    load_key_meta<kBlockK>(kmeta, a.km, a.km_sb, b, k0, a.lk);
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t b0, b1;
        load_b_kt(b0, b1, ks + n * 8 * LDS + kk * 16, LDS, lane);
        mma_16816(s[n], qa[kk], b0, b1);
        load_b_kt(b0, b1, vs + n * 8 * LDS + kk * 16, LDS, lane);
        mma_16816(dp[n], da[kk], b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        float ds = 0.f;
        if (col < valid && inline_visible(e < 2 ? qm0 : qm1, kmeta[col])) {
          const float p =
              exp2f(s[n][e] * a.scale_log2 - (e < 2 ? lse0 : lse1));
          ds = p * (dp[n][e] - (e < 2 ? dl0 : dl1)) * a.scale;
        }
        s[n][e] = ds;
      }
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      uint32_t pa[4];
      pack_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b0, b1;
        load_b_v(b0, b1, ks + j * 16 * LDS + n * 8, LDS, lane);
        mma_16816(dq[n], pa, b0, b1);
      }
    }
  }

  bf16* out = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r0 * a.dq_sl + c) =
          pack_bf16(dq[n][0], dq[n][1]);
    if (r1 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r1 * a.dq_sl + c) =
          pack_bf16(dq[n][2], dq[n][3]);
  }
}

}  // namespace vgt

// Launches the three kernels on `stream`, in order; returns the first
// nonzero cudaGetLastError() (0 = all launched).
extern "C" int vgt_inline_attention_bwd(const vgt::InlineAttnBwdArgs* a,
                                        void* stream) {
  using namespace vgt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->head_dim != kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(a->batch) * a->heads * a->lq;
  inline_attention_delta_kernel<<<
      static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps),
      32 * kDeltaWarps, 0, s>>>(*a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int smem = dkdv_smem_bytes<kHeadDim>();
  err = cudaFuncSetAttribute(inline_attention_dkdv_kernel<kHeadDim>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((a->lk + kBlockK - 1) / kBlockK, a->kv_heads, a->batch);
  inline_attention_dkdv_kernel<kHeadDim><<<grid_kv, kThreads, smem, s>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q((a->lq + kBlockQ - 1) / kBlockQ, a->heads, a->batch);
  inline_attention_dq_kernel<kHeadDim><<<grid_q, kThreads, 0, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
