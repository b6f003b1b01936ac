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
// 0.261 of the 1.26e9 pairs per head are visible: 4 FLOPs x 96 each over
// 32 heads is 4.04 TFLOP of visible-pair products against ~0.2 GB of
// operands, so tensor throughput bounds it (4.09 ms at 989 TFLOP/s). The
// kernel computes whole 64 x 64 tiles, 0.301 of them at stage 4 (0.211
// full), 4.67 TFLOP. What it must also move is K/V from L2 to the SMs: a
// 64-key K/V tile (24.6 KB at head width 96) loaded for 64 query rows
// carries 64 FLOPs a byte, so at that reuse one launch at stage 4 moves
// ~73 GB, and 14 ms would need ~5 TB/s of L2, at or past what the H100's
// L2 gives. So a block shares each loaded tile across C 64-row query
// tiles: ~37 GB at C 2, ~25 GB at C 3.
//
// Design. One launch sequence per call:
//   1. tile_map.cuh's metadata classifier: per-tile summaries of the query
//      and key metadata (O(L)), then the class of every (64-row query tile,
//      64-key tile) pair; each group of C consecutive query tiles counts
//      the key tiles that some tile of the group sees, and the groups are
//      ordered by that count, most first, so that the long rows start first
//      and the grid does not end on a few of them;
//   2. the attention: one block per (group, head), the groups in that
//      order, of 1 + C warpgroups (as K1, rank_attention.cu). The producer
//      warpgroup (its registers lowered with setmaxnreg; one warp works,
//      one thread issues) loads each consumer's Q tile once by TMA, then
//      walks the union of the group's rows of the map, key tile by key
//      tile, and streams each tile that some consumer sees, K and V by TMA
//      in wgmma's 64-byte swizzle, into a ring of kStages stages guarded by
//      full / empty mbarriers; with them go the tile's index and each
//      consumer's class, and, where the tile is partial for a consumer, the
//      three key-metadata vectors. No __syncthreads in the key loop. Each
//      consumer warpgroup (64 query rows) takes every stage: on a tile
//      that is empty for it, it only releases the stage; otherwise S = Q.K^T
//      (wgmma m64n64k16, Q and K from shared memory), the online softmax in
//      registers (the rule per element on a partial tile, none on a full
//      one), O += P.V (m64nDPk16, P from registers, V MN-major), and the
//      stage released. The consumers' products and softmaxes interleave on
//      the SM. The tiles computed stay the map's (0.301 at stage 4); only
//      the loads are shared.
//
// The block shape adapts to what the launch can see, in one kernel: C is
// the most consumer warpgroups that the registers allow at the padded head
// width (3 at DP 64 and 96; 2 at DP 128, where a consumer's O takes 64
// registers a thread; 4 at DP 32, where the softmax outweighs the products
// and a fourth warpgroup hides more of its latency), lowered while batch x
// ceil(nq / C) x heads would give the grid fewer than two blocks an SM,
// down to C 1 (a small launch, such as a seq-mesh rank's prefill of 8 heads
// at L 1,776). The ring takes up to kMaxStages stages, as many as the
// shared memory of the block's share of an SM holds (two blocks an SM at
// C 1, one otherwise).
//
// Measured (one H100, stage 4, with lse): 13.4 ms a launch, 3.3x the
// bound. With parts removed it took 6.6 ms without the softmax and 11.9
// without the products: the softmax's instructions, not the loads, bound
// it, hence 2^x on MUFU.EX2 with the scale fused into its argument, and a
// partial tile's key metadata read in pairs.
//
// Head widths: a template on the padded head width DP (32, 64, 96 or 128,
// attention_common.cuh `padded_head_dim`); the tensor maps' inner dimension
// is head_dim, so TMA zero-fills the dims from head_dim to DP; those are
// never stored, and the scale is head_dim's own.
//
// Masked keys are skipped or weigh exactly 0, so skipping a tile changes no
// sum: an empty tile holds only pairs that would add exp2(-inf) = 0. Each
// block writes its own rows and nothing else: no atomics, the output is
// the same on every run.
#include <math_constants.h>

#include <atomic>
#include <cstring>

#include "attention_args.cuh"
#include "inline_mask.cuh"

namespace vgt {

constexpr int kMaxStages = 4;        // K/V ring depth, at most
constexpr int kMaxConsumers = 4;     // consumer warpgroups a block
constexpr int kInlineProducerRegs = 40;
constexpr int kSmPerBlockSmem = 232448;  // a block's most dynamic smem
constexpr int kSmSmem = 233472;          // an SM's, 1 KB of it per block

// The shape of a block of C consumer warpgroups at padded head width DP;
// kWin: under a sliding window (a stage carries the keys' positions too).
template <int DP, int C, bool kWin = false>
struct InlineCfg {
  static constexpr int kThreads = 128 * (1 + C);
  // two blocks an SM at one consumer, one otherwise; setmaxnreg moves
  // registers within the block, so the producer's and the consumers'
  // counts add up to the launch's
  static constexpr int kMinBlocks = C == 1 ? 2 : 1;
  static constexpr int kLaunchRegs = 65536 / (kThreads * kMinBlocks) / 8 * 8;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * (1 + C) - kInlineProducerRegs) / C / 8 * 8;
  static_assert(kConsumerRegs <= 256, "setmaxnreg takes at most 256");
  static constexpr int kTileBytes = kBlockK * DP * 2;  // K, V or a Q tile
  // one stage: K, V (64-byte swizzle), the key metadata [3][64] (and under
  // a window the positions [64]), the words (done flag, key tile, the
  // consumers' classes 2 bits each), padded to keep every stage 1024-byte
  // aligned
  static constexpr int kMetaVecs = kWin ? 4 : 3;
  static constexpr int kMetaOff = 2 * kTileBytes;
  static constexpr int kWordsOff = kMetaOff + kMetaVecs * kBlockK * 4;
  static constexpr int kStageBytes = (kWordsOff + 16 + 1023) / 1024 * 1024;
  static constexpr int kQBytes = C * kTileBytes;
  static constexpr int kFixed = 1024 + kQBytes + (2 * kMaxStages + 1) * 8;
  static constexpr int kBudget =
      C == 1 ? kSmSmem / 2 - 1024 : kSmPerBlockSmem;
  static constexpr int kFit = (kBudget - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static_assert(kStages >= 2, "a ring of two stages at least");
  static constexpr int kQOff = kStages * kStageBytes;
  static constexpr int kBarOff = kQOff + kQBytes;
  static constexpr int kSmem = 1024 + kBarOff + (2 * kStages + 1) * 8;
};

// The tensor maps of a launch: Q [B, H, Lq, D], K and V [B, Hkv, Lk, D].
struct alignas(64) InlineMaps {
  CUtensorMap q, k, v;
};

// The producer warpgroup: the consumers' Q tiles, then every key tile that
// some consumer sees, in order, through the ring; then a stage with the
// done flag. Only warp 0 works (lane 0 issues).
template <int DP, int C, bool kWin>
__device__ __forceinline__ void inline_producer(
    const InlineAttnArgs& a, const InlineMaps& maps, unsigned char* smem,
    uint64_t* full, uint64_t* empty, uint64_t* qbar, int b, int h, int qt0,
    int nc) {
  using Cfg = InlineCfg<DP, C, kWin>;
  constexpr int NM = Cfg::kMetaVecs;
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int nq = (a.lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a.lk + kBlockK - 1) / kBlockK;
  const int hk = h / (a.heads / a.kv_heads);
  if (lane == 0) {
    mbar_arrive_tx(qbar, nc * Cfg::kTileBytes);
    for (int w = 0; w < nc; ++w)
#pragma unroll
      for (int at = 0; at < DP / 32; ++at)
        tma_load_4d(smem + Cfg::kQOff + w * Cfg::kTileBytes + at * kSw64Atom,
                    &maps.q, qbar, 32 * at, (qt0 + w) * kBlockQ, h, b);
  }
  const int8_t* rows =
      a.tile_map + (static_cast<long long>(b) * nq + qt0) * nk;
  // the classes of key tile kt for each consumer, 2 bits each (0: a key
  // tile past Lk, or seen by none)
  auto classes = [&](int kt) {
    int c = 0;
    if (kt < nk)
#pragma unroll
      for (int w = 0; w < C; ++w)
        if (w < nc) c |= rows[w * nk + kt] << (2 * w);
    return c;
  };
  int stage = 0;
  uint32_t phase = 0;
  auto acquire = [&]() -> unsigned char* {
    if (lane == 0) mbar_wait(&empty[stage], phase ^ 1);
    __syncwarp();
    return smem + stage * Cfg::kStageBytes;
  };
  int cur = classes(lane);
  for (int kt0 = 0; kt0 < nk; kt0 += 32) {
    const int nxt = classes(kt0 + 32 + lane);  // in flight meanwhile
    uint32_t hits = __ballot_sync(0xffffffffu, cur != 0);
    while (hits) {
      const int j = __ffs(hits) - 1;
      hits &= hits - 1;
      const int cls = __shfl_sync(0xffffffffu, cur, j);
      const int k0 = (kt0 + j) * kBlockK;
      // partial for some consumer: a class of 1 (its low bit)
      const bool partial = (cls & 0x55) != 0;
      int km[NM][2];
      if (partial) {  // loaded before the wait for a free stage
#pragma unroll
        for (int m = 0; m < NM; ++m)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = k0 + lane + 32 * e;
            const int* src = m < 3 ? a.km[m] + b * a.km_sb[m]
                                   : a.kpos + b * a.kpos_sb;
            km[m][e] = c < a.lk ? src[c] : 0;
          }
      }
      unsigned char* st = acquire();
      if (partial) {
        int* kv = reinterpret_cast<int*>(st + Cfg::kMetaOff);
#pragma unroll
        for (int m = 0; m < NM; ++m)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            kv[m * kBlockK + lane + 32 * e] = km[m][e];
      }
      if (lane == 0) {
        int* words = reinterpret_cast<int*>(st + Cfg::kWordsOff);
        words[0] = 0;
        words[1] = kt0 + j;
        words[2] = cls;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_tx(&full[stage], 2 * Cfg::kTileBytes);
#pragma unroll
        for (int at = 0; at < DP / 32; ++at) {
          tma_load_4d(st + at * kSw64Atom, &maps.k, &full[stage], 32 * at,
                      k0, hk, b);
          tma_load_4d(st + Cfg::kTileBytes + at * kSw64Atom, &maps.v,
                      &full[stage], 32 * at, k0, hk, b);
        }
      }
      if (++stage == Cfg::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    cur = nxt;
  }
  unsigned char* st = acquire();
  if (lane == 0) {
    reinterpret_cast<int*>(st + Cfg::kWordsOff)[0] = 1;
    mbar_arrive(&full[stage]);
  }
}

// Consumer warpgroup w (query tile qt, rows 64 qt ..): drain the ring.
template <int DP, int C, bool kWin>
__device__ __forceinline__ void inline_consumer(
    const InlineAttnArgs& a, unsigned char* smem, uint64_t* full,
    uint64_t* empty, uint64_t* qbar, int b, int h, int qt, int w) {
  using Cfg = InlineCfg<DP, C, kWin>;
  constexpr int NO = DP / 8;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qt * kBlockQ + warp * 16 + g, r1 = r0 + 8;
  const QueryMeta qm0 = query_meta(a.qm, a.qm_sb, b, r0, a.lq);
  const QueryMeta qm1 = query_meta(a.qm, a.qm_sb, b, r1, a.lq);
  int qp0 = 0, qp1 = 0;  // the rows' positions, under a window
  if constexpr (kWin) {
    qp0 = token_pos(a.qpos, a.qpos_sb, b, r0, a.lq);
    qp1 = token_pos(a.qpos, a.qpos_sb, b, r1, a.lq);
  }
  const bf16* qs =
      reinterpret_cast<const bf16*>(smem + Cfg::kQOff + w * Cfg::kTileBytes);

  float o[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) o[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the denominators
  mbar_wait(qbar, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&full[stage], phase);
    const unsigned char* st = smem + stage * Cfg::kStageBytes;
    const int* words = reinterpret_cast<const int*>(st + Cfg::kWordsOff);
    // the same words in every thread: broadcast, so that the compiler sees
    // the branches as uniform
    if (__shfl_sync(0xffffffffu, words[0], 0)) break;
    const int k0 = __shfl_sync(0xffffffffu, words[1], 0) * kBlockK;
    const int cls = (__shfl_sync(0xffffffffu, words[2], 0) >> (2 * w)) & 3;
    if (cls != kTileEmpty) {
      const bf16* kt = reinterpret_cast<const bf16*>(st);
      const bf16* vt = reinterpret_cast<const bf16*>(st + Cfg::kTileBytes);
      float s[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_64x64_ss(s, desc_sw64_k(qs, kk), desc_sw64_k(kt, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // the raw logits; in a partial tile masked keys and columns past Lk
      // are -inf (a full tile lies inside Lk and is wholly visible). This
      // thread's columns come in pairs, 2t and 2t + 1 of each 8: one 8-byte
      // load of each metadata vector serves a pair in both rows
      if (cls == kTilePartial) {
        const int valid = min(kBlockK, a.lk - k0);
        const int* kv = reinterpret_cast<const int*>(st + Cfg::kMetaOff);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c0 = n * 8 + 2 * t;
          const int2 vs = *reinterpret_cast<const int2*>(kv + c0);
          const int2 bl = *reinterpret_cast<const int2*>(kv + kBlockK + c0);
          const int2 ro = *reinterpret_cast<const int2*>(kv + 2 * kBlockK + c0);
          int2 po{0, 0};
          if constexpr (kWin)
            po = *reinterpret_cast<const int2*>(kv + 3 * kBlockK + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const KeyMeta km = (e & 1) ? KeyMeta{vs.y, bl.y, ro.y}
                                       : KeyMeta{vs.x, bl.x, ro.x};
            const bool vis =
                c0 + (e & 1) < valid &&
                inline_visible<kWin>((e & 2) ? qm1 : qm0, km,
                                     (e & 2) ? qp1 : qp0,
                                     (e & 1) ? po.y : po.x, a.window);
            s[4 * n + e] = vis ? s[4 * n + e] : -CUDART_INF_F;
          }
        }
      }
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * n8], s[4 * n8 + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n8 + 2], s[4 * n8 + 3]));
      }
      // the running max in log2 units: the scale is positive, so the max of
      // the scaled logits is the scaled max
      const float mn0 = fmaxf(m0, quad_max(mx0) * a.scale_log2);
      const float mn1 = fmaxf(m1, quad_max(mx1) * a.scale_log2);
      // while a row has seen no visible key its max is -inf: subtract 0, so
      // exp2 gives 0 for the masked keys and for the rescale, never NaN
      const float ms0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
      const float ms1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
      // 2^x on MUFU.EX2, x = logit * scale - max in one rounding; a result
      // below 2^-126 flushes to 0, which no sum can tell from what the
      // row's largest term (1) makes it
      const float alpha0 = ex2_approx(m0 - ms0);
      const float alpha1 = ex2_approx(m1 - ms1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        s[4 * n8] = ex2_approx(fmaf(s[4 * n8], a.scale_log2, -ms0));
        s[4 * n8 + 1] = ex2_approx(fmaf(s[4 * n8 + 1], a.scale_log2, -ms0));
        s[4 * n8 + 2] = ex2_approx(fmaf(s[4 * n8 + 2], a.scale_log2, -ms1));
        s[4 * n8 + 3] = ex2_approx(fmaf(s[4 * n8 + 3], a.scale_log2, -ms1));
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
        wgmma_pv<DP>(o, pa[j], desc_sw64_mn(vt, j));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    // every warp signals once it is done with the stage (4 per consumer)
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == Cfg::kStages) {
      stage = 0;
      phase ^= 1;
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
  for (int n8 = 0; n8 < NO; ++n8) {
    const int c = n8 * 8 + 2 * t;
    if (n8 * 8 >= a.head_dim) break;  // the padded head dims are not stored
    if (r0 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r0 * a.o_sl + c) =
          pack_bf16(o[4 * n8] * inv0, o[4 * n8 + 1] * inv0);
    if (r1 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r1 * a.o_sl + c) =
          pack_bf16(o[4 * n8 + 2] * inv1, o[4 * n8 + 3] * inv1);
  }
}

template <int DP, int C, bool kWin>
__global__ void __launch_bounds__(InlineCfg<DP, C, kWin>::kThreads,
                                  InlineCfg<DP, C, kWin>::kMinBlocks)
    inline_attention_kernel(const __grid_constant__ InlineAttnArgs a,
                            const __grid_constant__ InlineMaps maps,
                            const int* order) {
  using Cfg = InlineCfg<DP, C, kWin>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::kBarOff);
  uint64_t* empty = full + Cfg::kStages;
  uint64_t* qbar = empty + Cfg::kStages;
  const int nq = (a.lq + kBlockQ - 1) / kBlockQ;
  const int ng = (nq + C - 1) / C;
  const int item = order[blockIdx.x];
  const int b = item / ng, qt0 = (item % ng) * C, h = blockIdx.y;
  const int nc = min(C, nq - qt0);  // the consumers with rows below Lq
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      // the producer's one arrival (+ the bytes of its TMA boxes)
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * nc);
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  // warp-uniform in the compiler's view (a shuffle), as wgmma wants
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    setmaxnreg_dec<kInlineProducerRegs>();
    inline_producer<DP, C, kWin>(a, maps, smem, full, empty, qbar, b, h, qt0,
                                 nc);
  } else {
    setmaxnreg_inc<Cfg::kConsumerRegs>();
    if (wg - 1 < nc)
      inline_consumer<DP, C, kWin>(a, smem, full, empty, qbar, b, h,
                                   qt0 + wg - 1, wg - 1);
  }
}

// Consumer warpgroups a block for a launch of this shape on a card of `sms`
// SMs: the most that the registers allow at the padded head width (a
// consumer's O takes DP / 2 a thread: four at DP 32, three at 64 and 96,
// two at 128), lowered while the grid would hold fewer than two blocks an
// SM.
inline int inline_consumers(int batch, int lq, int heads, int dp, int sms) {
  const long long nq = (lq + kBlockQ - 1) / kBlockQ;
  for (int c = dp > 96 ? 2 : dp > 32 ? 3 : 4; c > 1; --c)
    if (batch * ((nq + c - 1) / c) * heads >= 2LL * sms) return c;
  return 1;
}

inline int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

constexpr int kMaxDevices = 64;

namespace {
// Each instance's shared-memory opt-in, set once per device. Internal
// linkage, not a static of the template: those are process-wide unique
// symbols, which a second copy of this library (a rebuilt one loaded
// beside it) would share without having set its own.
std::atomic<bool> smem_ready[2 * 4 * kMaxConsumers][kMaxDevices];
}  // namespace

template <int DP, int C, bool kWin>
int launch_inline(const InlineAttnArgs* a, const InlineMaps& maps,
                  const int* order, cudaStream_t s) {
  using Cfg = InlineCfg<DP, C, kWin>;
  auto kernel = inline_attention_kernel<DP, C, kWin>;
  std::atomic<bool>* ready =
      smem_ready[(kWin * 4 + DP / 32 - 1) * kMaxConsumers + C - 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !ready[dev].load()) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) ready[dev].store(true);
  }
  const int nq = (a->lq + kBlockQ - 1) / kBlockQ;
  const dim3 grid(a->batch * ((nq + C - 1) / C), a->heads);
  kernel<<<grid, Cfg::kThreads, Cfg::kSmem, s>>>(*a, maps, order);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, bool kWin>
int launch_inline_c(const InlineAttnArgs* a, const InlineMaps& maps,
                    const int* order, int c, cudaStream_t s) {
  switch (c) {
    case 1: return launch_inline<DP, 1, kWin>(a, maps, order, s);
    case 2: return launch_inline<DP, 2, kWin>(a, maps, order, s);
    case 3:
      if constexpr (DP > 96) return static_cast<int>(cudaErrorInvalidValue);
      else return launch_inline<DP, 3, kWin>(a, maps, order, s);
    default:
      if constexpr (DP > 32) return static_cast<int>(cudaErrorInvalidValue);
      else return launch_inline<DP, 4, kWin>(a, maps, order, s);
  }
}

// The windowless instances (every launch but a sliding layer's) and the
// windowed ones.
template <int DP>
int launch_inline_dp(const InlineAttnArgs* a, const InlineMaps& maps,
                     const int* order, int c, cudaStream_t s) {
  return a->window > 0 ? launch_inline_c<DP, true>(a, maps, order, c, s)
                       : launch_inline_c<DP, false>(a, maps, order, c, s);
}

}  // namespace vgt

// The query rows a block of the attention covers (64 per consumer
// warpgroup) at this launch shape on the current device; 0 for a head_dim
// the kernel does not take.
extern "C" int vgt_inline_block_rows(int batch, int lq, int heads,
                                     int head_dim) {
  using namespace vgt;
  const int dp = padded_head_dim(head_dim);
  if (dp == 0) return 0;
  return kBlockQ * inline_consumers(batch, lq, heads, dp, device_sms());
}

// Launches on `stream`: the tile map (summaries, classes, the groups'
// counts and order), then, unless map_only, the attention; returns the
// first nonzero cudaGetLastError() (0 = all launched), or 100000 + the
// CUresult of a tensor map that failed to encode. With map_only and no
// head_dim the order is the query tiles'.
extern "C" int vgt_inline_attention(const vgt::InlineAttnArgs* a,
                                    void* stream) {
  using namespace vgt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = padded_head_dim(a->head_dim);
  if (dp == 0 && !a->map_only) return static_cast<int>(cudaErrorInvalidValue);
  const int c =
      dp == 0 ? 1
              : inline_consumers(a->batch, a->lq, a->heads, dp, device_sms());
  const int* order = nullptr;
  const int err = launch_inline_tile_map(*a, s, &order, c);
  if (err != 0 || a->map_only) return err;
  InlineMaps maps;
  memset(&maps, 0, sizeof(maps));
  CUresult r = encode_operand(&maps.q, a->q, a->batch, a->heads, a->lq,
                              a->head_dim, a->q_sb, a->q_sh, a->q_sl);
  if (r == CUDA_SUCCESS)
    r = encode_operand(&maps.k, a->k, a->batch, a->kv_heads, a->lk,
                       a->head_dim, a->k_sb, a->k_sh, a->k_sl);
  if (r == CUDA_SUCCESS)
    r = encode_operand(&maps.v, a->v, a->batch, a->kv_heads, a->lk,
                       a->head_dim, a->v_sb, a->v_sh, a->v_sl);
  if (r != CUDA_SUCCESS) return 100000 + static_cast<int>(r);
  switch (dp) {
    case 32: return launch_inline_dp<32>(a, maps, order, c, s);
    case 64: return launch_inline_dp<64>(a, maps, order, c, s);
    case 96: return launch_inline_dp<96>(a, maps, order, c, s);
    default: return launch_inline_dp<128>(a, maps, order, c, s);
  }
}
