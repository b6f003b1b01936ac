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
// Head widths: a template on the padded head width DP (32, 64, 96 or 128,
// attention_common.cuh `padded_head_dim`); the head dims from head_dim to
// DP are zero-filled by cp.async (src-size 0) and never stored, and the
// scale is head_dim's own. A head_dim equal to its DP runs an instance
// without those checks (kPadded false), so head_dim 96 runs the code it
// ran before the widths were added.
//
// What bounds it on the card: at stage 4 (B 1, L 35520, 32 heads of 96)
// 0.261 of the 1.26e9 pairs per head are visible: 4 FLOPs x 96 each over
// 32 heads is 4.04 TFLOP of visible-pair products against ~0.2 GB of
// operands, so tensor throughput bounds it (4.09 ms at 989 TFLOP/s).
//
// Design. One launch sequence per call:
//   1. tile_map.cuh's metadata classifier: per-tile summaries of the query
//      and key metadata (O(L)), then the class of every (64-row query tile,
//      64-key tile) pair, and the query tiles ordered by their count of
//      non-empty key tiles, most first, so that the long rows start first
//      and the grid does not end on a few of them;
//   2. the attention: one block (one warpgroup, 4 warps) per (query tile,
//      head), the query tiles in that order. The block gathers the
//      non-empty key tiles of its row of the map and streams only those:
//      K and V through a two-stage ring in shared memory filled by cp.async
//      one tile ahead of the products (the key metadata beside them, for
//      partial tiles only). S = Q.K^T and O += P.V are wgmma (m64n64k16
//      from shared memory; m64nDPk16 with P from registers, V MN-major),
//      fp32 accumulate, online softmax in registers between them. Partial
//      tiles evaluate the rule per element; full tiles skip it. At stage 4
//      0.301 of the 64x64 tiles are non-empty (0.211 full).
// Masked keys are skipped or weigh exactly 0, so skipping a tile changes no
// sum: an empty tile holds only pairs that would add exp2(-inf) = 0.
#include <math_constants.h>

#include "attention_args.cuh"
#include "inline_mask.cuh"

namespace vgt {

constexpr int kStages = 2;  // K/V ring depth

template <int DP>
__host__ __device__ constexpr int inline_smem_bytes(int nk) {
  // Q, the K and V ring (core-matrix tiles), the ring's key metadata, the
  // block's list of non-empty key tiles
  return (kBlockQ + 2 * kStages * kBlockK) * DP * 2 +
         kStages * 3 * kBlockK * 4 + nk * 4;
}

template <int DP, bool kPadded>
__global__ void __launch_bounds__(kThreads)
    inline_attention_kernel(const InlineAttnArgs a, const int* order) {
  constexpr int NO = DP / 8;
  constexpr int kTile = kBlockK * DP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBlockQ * DP;           // [kStages][kTile]
  bf16* vs = ks + kStages * kTile;        // [kStages][kTile]
  int* kmeta = reinterpret_cast<int*>(vs + kStages * kTile);  // [st][3][64]
  int* list = kmeta + kStages * 3 * kBlockK;

  const int nq = (a.lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a.lk + kBlockK - 1) / kBlockK;
  const int item = order[blockIdx.x];
  const int b = item / nq, q0 = (item % nq) * kBlockQ, h = blockIdx.y;
  const int hk = h / (a.heads / a.kv_heads);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  async_copy_tile_dp<kBlockQ, kThreads, DP, kPadded>(
      qs, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
              q0 * a.q_sl, a.q_sl, min(kBlockQ, a.lq - q0), a.head_dim, tid);
  async_commit();
  const int n = gather_tiles(
      a.tile_map + (static_cast<long long>(b) * nq + q0 / kBlockQ) * nk, 1,
      nk, list);

  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  // the loads of the i-th listed key tile into stage i % kStages
  auto prefetch = [&](int i) {
    const int e = list[i], k0 = (e >> 2) * kBlockK, st = i % kStages;
    const int valid = min(kBlockK, a.lk - k0);
    async_copy_tile_dp<kBlockK, kThreads, DP, kPadded>(
        ks + st * kTile, kp + k0 * a.k_sl, a.k_sl, valid, a.head_dim, tid);
    async_copy_tile_dp<kBlockK, kThreads, DP, kPadded>(
        vs + st * kTile, vp + k0 * a.v_sl, a.v_sl, valid, a.head_dim, tid);
    if ((e & 3) == kTilePartial) {
      for (int c = tid; c < 3 * kBlockK; c += kThreads) {
        const int m = c / kBlockK, j = c % kBlockK;
        const bool ok = j < valid;
        async_copy4(kmeta + (st * 3 + m) * kBlockK + j,
                  a.km[m] + b * a.km_sb[m] + (ok ? k0 + j : 0), ok);
      }
    }
  };
  for (int p = 0; p < kStages - 1; ++p) {  // the ring's first tiles
    if (p < n) prefetch(p);
    async_commit();
  }

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const QueryMeta qm0 = query_meta(a.qm, a.qm_sb, b, r0, a.lq);
  const QueryMeta qm1 = query_meta(a.qm, a.qm_sb, b, r1, a.lq);

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
    const int e = list[i], k0 = (e >> 2) * kBlockK, st = i % kStages;
    const bf16* kt = ks + st * kTile;
    const bf16* vt = vs + st * kTile;

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

    // logits in log2 units; in a partial tile masked keys and columns past
    // Lk are -inf (a full tile lies inside Lk and is wholly visible)
    if ((e & 3) == kTilePartial) {
      const int valid = min(kBlockK, a.lk - k0);
      const int* kv = kmeta + st * 3 * kBlockK;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = (j >> 2) * 8 + 2 * t + (j & 1);
        const KeyMeta km{kv[col], kv[kBlockK + col], kv[2 * kBlockK + col]};
        const bool vis =
            col < valid && inline_visible((j & 2) ? qm1 : qm0, km);
        s[j] = vis ? s[j] * a.scale_log2 : -CUDART_INF_F;
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
    // while a row has seen no visible key its max is -inf: subtract 0, so
    // exp2 gives 0 for the masked keys and for the rescale, never NaN
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
int launch_inline(const InlineAttnArgs* a, const int* order,
                  cudaStream_t s) {
  const int nq = (a->lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a->lk + kBlockK - 1) / kBlockK;
  const int smem = inline_smem_bytes<DP>(nk);
  cudaError_t err = cudaFuncSetAttribute(
      inline_attention_kernel<DP, kPadded>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  inline_attention_kernel<DP, kPadded>
      <<<dim3(a->batch * nq, a->heads), kThreads, smem, s>>>(*a, order);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vgt

// Launches on `stream`: the tile map (summaries, classes, order), then,
// unless map_only, the attention; returns the first nonzero
// cudaGetLastError() (0 = all launched).
extern "C" int vgt_inline_attention(const vgt::InlineAttnArgs* a,
                                    void* stream) {
  using namespace vgt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = padded_head_dim(a->head_dim);
  if (dp == 0 && !a->map_only) return static_cast<int>(cudaErrorInvalidValue);
  const int* order = nullptr;
  const int err = launch_inline_tile_map(*a, s, &order);
  if (err != 0 || a->map_only) return err;
  // a head_dim below its padded width takes the instance that zero-fills
  // the dims past it; the exact widths take their own
  const bool pad = a->head_dim != dp;
  switch (dp) {
    case 32: return pad ? launch_inline<32, true>(a, order, s)
                        : launch_inline<32, false>(a, order, s);
    case 64: return pad ? launch_inline<64, true>(a, order, s)
                        : launch_inline<64, false>(a, order, s);
    case 96: return pad ? launch_inline<96, true>(a, order, s)
                        : launch_inline<96, false>(a, order, s);
    default: return pad ? launch_inline<128, true>(a, order, s)
                        : launch_inline<128, false>(a, order, s);
  }
}
