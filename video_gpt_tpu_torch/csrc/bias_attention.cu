// Biased softmax attention for Hopper (sm_90a): kernel K3.
//
// Replaces the TPU kernel `_bias_kernel` (video_gpt_tpu/ops/flash_attention.py,
// called by `flash_mha` with a bias): the prefill's attention over the clean
// prefix and the stage-1 training forward, with the additive bf16 bias from
// `precompute_bias` (0 where visible, BF16_NEG = bf16 min / 2 where masked).
// The TPU's k-tiled `_stream_kernel` (K10, `flash_mha_streaming`, its route
// past 8192 keys) computes the same function, so this kernel serves that too:
// the long rollout's prefill at B = 1 is 12,432^2 with a 309 MB bias, whose
// row offsets (r * bias_sq, up to 1.5e8) are 64-bit products.
//
// Function, per (batch b, head h, query q):
//   logits(q, k) = q.k * head_dim^-0.5 + bias[b, q, k]
//   out(q)       = softmax_k(logits) . v          (max-subtracted softmax)
//   lse(q)       = log sum_k exp(logits)          (fp32, when asked for)
// The TPU kernel holds the whole key row in VMEM; here the key row streams
// through shared memory in 64-key tiles with an online softmax (running max
// and rescale), which computes the same function in another summation order.
// Masked logits are finite (BF16_NEG, never -inf), so a query whose first
// tiles are fully masked gets a finite running max and no NaN; key columns
// past Lk are -inf and weigh exactly 0. A row whose bias is BF16_NEG
// everywhere sees no key: every logit of it is BF16_NEG in fp32 (the bias
// absorbs q.k), so its softmax is uniform over every key, as on the TPU.
// With a non-null `lse` the kernel writes each row's logsumexp, which the
// backward (K9, bias_attention_bwd.cu) reads; a null pointer (serving)
// writes nothing.
//
// Head widths: a template on the padded head width DP (32, 64, 96 or 128,
// attention_common.cuh `padded_head_dim`); the head dims from head_dim to
// DP are zero-filled by cp.async (src-size 0) and never stored, and the
// scale is head_dim's own. A head_dim equal to its DP runs an instance
// without those checks (kPadded false), so head_dim 96 runs the code it
// ran before the widths were added.
//
// What bounds it on the card: at the stage-1 training shape (B 1, L 7104,
// 32 heads of 96) 0.281 of the pairs are visible: the two products over them
// are 0.17 TFLOP against ~0.27 GB of operands (q, k, v, the bias once, out),
// so tensor throughput bounds it (0.18 ms at 989 TFLOP/s, against 0.08 ms
// for the bytes); the flagship prefill (1776^2) and K10 (12,432^2) alike.
//
// Design. The tile map of the bias (tile_map.cuh's bias classifier, launched
// by vgt_bias_tile_map below) is built once per bias, where the bias is
// built, and read by every layer's K3 and K9: the class of each (64-query,
// 64-key) tile, each row's softmax reference for K9, and the query tiles
// ordered by their count of non-empty key tiles, most first. At stage 1
// 0.375 of the tiles are non-empty (0.220 full). The attention: one block
// (one warpgroup, 4 warps) per (query tile, head), the query tiles in that
// order, so that the long rows start first. The block gathers the non-empty
// key tiles of its row of the map and streams only those: K and V through a
// two-stage ring in shared memory filled by cp.async one tile ahead of the
// products, with the 64x64 bias tile beside them for partial tiles only
// (a full tile's bias is 0 everywhere: it reads none, and it lies inside
// [0, Lq) x [0, Lk), so it needs no bounds check). S = Q.K^T and O += P.V
// are wgmma (m64n64k16 from shared memory; m64nDPk16 with P from registers,
// V MN-major), fp32 accumulate, online softmax in registers between them.
// A skipped (empty) tile holds only entries at most BF16_NEG of rows that
// see some key: each of them weighs exactly 0 in fp32 against the row's
// max, so skipping changes no sum; the map never empties a tile of a query
// tile that holds a row which sees no key.
#include <math_constants.h>

#include "attention_args.cuh"
#include "tile_map.cuh"

namespace vgt {

// Must match _BiasMapArgs in video_gpt_tpu_torch/ops/flash_attention.py.
struct BiasMapArgs {
  const void* bias;   // bf16 [B, Lq, Lk], rows at stride bias_sq
  int8_t* tile_map;   // [B, ceil(Lq/64), ceil(Lk/64)] tile classes (written)
  float* rowdead;     // [B, Lq] (written): see bias_tile_map_kernel
  int* counts;        // [B ceil(Lq/64)] scratch: non-empty tiles per row
  int* order;         // [B ceil(Lq/64)] (written): query tiles, most first
  long long bias_sb, bias_sq;
  int batch, lq, lk;
  int bias_vec;
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;                  // K/V ring depth
constexpr int kBiasLd = kBlockK + 8;        // bias tile row stride (elements)
// one core-matrix tile at padded head width DP (elements)
template <int DP>
__host__ __device__ constexpr int bias_tile() {
  return kBlockK * DP;
}
// one ring stage: K, V, the bias tile (elements)
template <int DP>
__host__ __device__ constexpr int bias_stage() {
  return 2 * bias_tile<DP>() + kBlockQ * kBiasLd;
}

template <int DP>
__host__ __device__ constexpr int bias_smem_bytes(int nk) {
  // Q, the ring, the block's list of non-empty key tiles
  return (bias_tile<DP>() + kStages * bias_stage<DP>()) * 2 + nk * 4;
}

// At padded head width DP (32, 64, 96, 128): the head dims from head_dim
// to DP are zero-filled on load, add 0 to every product and are not stored.
template <int DP, bool kPadded>
__global__ void __launch_bounds__(kThreads)
    bias_attention_kernel(const BiasAttnArgs a) {
  static_assert(kBlockQ == kBlockK, "Q and K tiles share kTile");
  constexpr int NO = DP / 8;
  constexpr int kTile = bias_tile<DP>();
  constexpr int kStage = bias_stage<DP>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = qs + kTile;  // [kStages][K, V, bias]
  int* list = reinterpret_cast<int*>(ring + kStages * kStage);

  const int nq = (a.lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a.lk + kBlockK - 1) / kBlockK;
  const int item = a.order[blockIdx.x];
  const int b = item / nq, qt = item % nq, q0 = qt * kBlockQ;
  const int h = blockIdx.y, hk = h / (a.heads / a.kv_heads);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  async_copy_tile_dp<kBlockQ, kThreads, DP, kPadded>(
      qs, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
              q0 * a.q_sl, a.q_sl, min(kBlockQ, a.lq - q0), a.head_dim, tid);
  async_commit();
  const int n = gather_tiles(
      a.tile_map + (static_cast<long long>(b) * nq + qt) * nk, 1, nk, list);

  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const bf16* bp = static_cast<const bf16*>(a.bias) + b * a.bias_sb;
  // the loads of the i-th listed key tile into stage i % kStages
  auto prefetch = [&](int i) {
    bf16* st = ring + (i % kStages) * kStage;
    const int e = list[i], k0 = (e >> 2) * kBlockK;
    const int valid = min(kBlockK, a.lk - k0);
    async_copy_tile_dp<kBlockK, kThreads, DP, kPadded>(
        st, kp + k0 * a.k_sl, a.k_sl, valid, a.head_dim, tid);
    async_copy_tile_dp<kBlockK, kThreads, DP, kPadded>(
        st + kTile, vp + k0 * a.v_sl, a.v_sl, valid, a.head_dim, tid);
    if ((e & 3) == kTilePartial)
      load_bias_tile<kBlockQ, kBlockK, kThreads>(
          st + 2 * kTile, kBiasLd, bp, a.bias_sq, a.lq, a.lk,
          a.bias_vec != 0, q0, k0, tid);
  };
  for (int p = 0; p < kStages - 1; ++p) {  // the ring's first tiles
    if (p < n) prefetch(p);
    async_commit();
  }

  const int lr0 = warp * 16 + g;  // this thread's rows: lr0, lr0 + 8
  float o[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) o[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the denominators

  for (int i = 0; i < n; ++i) {
    if (i + kStages - 1 < n) prefetch(i + kStages - 1);
    async_commit();
    async_wait<kStages - 1>();  // all but the tiles still ahead have landed
    fence_async_shared();
    __syncthreads();
    const int e = list[i], k0 = (e >> 2) * kBlockK;
    const bf16* kt = ring + (i % kStages) * kStage;
    const bf16* vt = kt + kTile;
    const bf16* bs = kt + 2 * kTile;

    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_64x64_ss(s, desc_k_major_dp<DP>(qs, kk), desc_k_major_dp<DP>(kt, kk),
                     1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // logits in log2 units; in a partial tile the bias is added and key
    // columns past Lk are -inf (a full tile lies inside Lk, its bias is 0)
    const bool partial = (e & 3) == kTilePartial;
    if (partial) {
      const int valid = min(kBlockK, a.lk - k0);
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int col = n8 * 8 + 2 * t;
          const float2 bb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  bs + (lr0 + 8 * hi) * kBiasLd + col));
          const int j = 4 * n8 + 2 * hi;
          s[j] = col < valid ? s[j] * a.scale_log2 + bb.x * kLog2e
                             : -CUDART_INF_F;
          s[j + 1] = col + 1 < valid ? s[j + 1] * a.scale_log2 + bb.y * kLog2e
                                     : -CUDART_INF_F;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] *= a.scale_log2;
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n8], s[4 * n8 + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n8 + 2], s[4 * n8 + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    // every tile gives a row a finite logit (its first key lies inside Lk),
    // so the max is finite from the first tile on; subtract 0 before that
    // all the same, so that exp2 never sees -inf - -inf
    const float ms0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float ms1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float alpha0 = exp2f(m0 - ms0), alpha1 = exp2f(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      s[4 * n8] = exp2f(s[4 * n8] - ms0);
      s[4 * n8 + 1] = exp2f(s[4 * n8 + 1] - ms0);
      s[4 * n8 + 2] = exp2f(s[4 * n8 + 2] - ms1);
      s[4 * n8 + 3] = exp2f(s[4 * n8 + 3] - ms1);
      ls0 += s[4 * n8] + s[4 * n8 + 1];
      ls1 += s[4 * n8 + 2] + s[4 * n8 + 3];
    }
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
    uint32_t pa[kBlockK / 16][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) acc_to_a(pa[j], s + 8 * j);
#pragma unroll
    for (int n8 = 0; n8 < NO; ++n8) {
      o[4 * n8] *= alpha0;
      o[4 * n8 + 1] *= alpha0;
      o[4 * n8 + 2] *= alpha1;
      o[4 * n8 + 3] *= alpha1;
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j)
      wgmma_pv<DP>(o, pa[j], desc_mn_major_dp<DP>(vt, j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();  // every warp is done with this stage before its refill
  }
  async_wait<0>();

  const int r0 = q0 + lr0, r1 = r0 + 8;
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
  for (int n8 = 0; n8 < NO; ++n8) {
    const int c = n8 * 8 + 2 * t;
    // the padded head dims are not stored
    if (kPadded && n8 * 8 >= a.head_dim) break;
    if (r0 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r0 * a.o_sl + c) =
          pack_bf16(o[4 * n8] * inv0, o[4 * n8 + 1] * inv0);
    if (r1 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r1 * a.o_sl + c) =
          pack_bf16(o[4 * n8 + 2] * inv1, o[4 * n8 + 3] * inv1);
  }
}

template <int DP, bool kPadded>
int launch_bias(const BiasAttnArgs* a, cudaStream_t s) {
  const int nq = (a->lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a->lk + kBlockK - 1) / kBlockK;
  const int smem = bias_smem_bytes<DP>(nk);
  cudaError_t err = cudaFuncSetAttribute(
      bias_attention_kernel<DP, kPadded>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bias_attention_kernel<DP, kPadded>
      <<<dim3(a->batch * nq, a->heads), kThreads, smem, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vgt

// The tile map of a bias, once per bias: the classes and each row's
// softmax reference (bias_tile_map_kernel), then the query tiles ordered by
// their count of non-empty key tiles. Launches on `stream`; returns the
// first nonzero cudaGetLastError() (0 = all launched).
extern "C" int vgt_bias_tile_map(const vgt::BiasMapArgs* a, void* stream) {
  using namespace vgt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nq = (a->lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a->lk + kBlockK - 1) / kBlockK;
  cudaError_t err = cudaFuncSetAttribute(
      bias_tile_map_kernel<kBlockQ, kBlockK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, nk);
  if (err != cudaSuccess) return static_cast<int>(err);
  bias_tile_map_kernel<kBlockQ, kBlockK>
      <<<dim3(nq, a->batch), 2 * kBlockQ, nk, s>>>(
          static_cast<const bf16*>(a->bias), a->bias_sb, a->bias_sq, a->lq,
          a->lk, a->bias_vec != 0, a->tile_map, a->rowdead, a->counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int order_smem = (nk + 1) * static_cast<int>(sizeof(int));
  err = cudaFuncSetAttribute(tile_order_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             order_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_order_kernel<<<1, kOrderThreads, order_smem, s>>>(
      a->counts, a->batch * nq, nk, a->order);
  return static_cast<int>(cudaGetLastError());
}

// The attention over a map from vgt_bias_tile_map. Launches on `stream`;
// returns cudaGetLastError() (0 = launched).
extern "C" int vgt_bias_attention(const vgt::BiasAttnArgs* a, void* stream) {
  using namespace vgt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a head_dim below its padded width takes the instance that zero-fills
  // the dims past it; the exact widths take their own
  const int dp = padded_head_dim(a->head_dim);
  const bool pad = a->head_dim != dp;
  switch (dp) {
    case 32: return pad ? launch_bias<32, true>(a, s)
                        : launch_bias<32, false>(a, s);
    case 64: return pad ? launch_bias<64, true>(a, s)
                        : launch_bias<64, false>(a, s);
    case 96: return pad ? launch_bias<96, true>(a, s)
                        : launch_bias<96, false>(a, s);
    case 128: return pad ? launch_bias<128, true>(a, s)
                         : launch_bias<128, false>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
