// fp32 attention for Hopper (sm_90a): the forward kernels K1/K2, K3 and K6
// at fp32 operands, on the tensor cores as split-precision products.
//
// Replaces the TPU kernels `_decode_split_kernel` / `_decode_kernel` (K1,
// K2; past 8192 keys K4, K5), `_bias_kernel` (K3; K10) and
// `_stream_inline_kernel` (K6; K8) of video_gpt_tpu/ops/flash_attention.py
// where their operands are fp32: the Pallas kernels keep the operands'
// dtype (p.astype(v.dtype) before P.V), so `generate --dtype fp32` runs
// them in fp32 end to end, and the TPU computes each fp32 dot at HIGHEST
// precision as bf16 pieces. The bf16 kernels (rank_attention.cu,
// bias_attention.cu, inline_attention.cu) serve bf16 operands; the
// wrappers in ops/flash_attention.py choose by dtype. One kernel body, a
// template on the mask:
//   kMaskRank   K1/K2: visible(q, k) = q_off[q] >= rank[k] over one or two
//               key operands (the cache, then the tail: no concatenation);
//               p = exp2(clamp(q.k * scale * log2(e), -100, 100)), NOT
//               max-shifted; out = sum p v / max(sum p, 1e-30);
//   kMaskBias   K3: logits = q.k * scale + bias (the bf16 bias and its tile
//               map, the BiasMap that K3 reads); max-shifted online softmax,
//               the lse when asked for;
//   kMaskInline K6: the metadata rule (inline_mask.cuh) and its tile map
//               (built here, as K6 builds it); masked keys -inf, online
//               softmax, out 0 and lse -inf for a row that sees no key.
// exp2f is the accurate one, not ex2.approx; p stays fp32 (its pieces carry
// it whole into P.V). The sums run in another order than the plain
// versions'.
//
// Products. S = Q.K^T and O += P.V are bf16 wgmma with fp32 accumulation,
// each as the six kept products of three bf16 pieces per operand
// (fp32_split.cuh: exact pieces; the dropped ml, lm, ll are at most 2^-24
// |a||b|, fp32's own rounding; each tile's products summed in a fresh
// accumulator, hh last, then added in fp32).
//
// What bounds it on the card: six bf16 products per fp32 product, 989 / 6
// = 165 TFLOP/s against the visible pairs' 4 FLOPs per head dim (K1 at the
// flagship: 0.23 TFLOP, 1.4 ms), far above the bytes (0.2 GB, 0.07 ms).
// Measured, the products run near the tensor rate and the CUDA-core work
// beside them holds the kernel: the split of every K and V element (once
// per query block), the softmax and P's split (PERF.md section 6).
//
// Design (the bf16 K3's, bias_attention.cu, with split operands). One block
// of one warpgroup (128 threads) per (64 query rows, head), over the 64-key
// tiles that its tile map (bias, inline) or its own classes (rank:
// tile_map.cuh `rank_tile_class` per key tile, computed by the block before
// the loop) do not call empty, each as two sub-tiles of 32 keys; full tiles
// skip the mask. Q is split once: up to DP 96 into this thread's A
// fragments in registers (S = Q.K^T with Q from registers, m64n32k16: no
// product re-reads Q from shared memory, whose bandwidth the products and
// the splits share), at DP 128, where they do not fit beside O and its
// tile's sum, into three piece tiles in shared memory. Each key sub-tile
// arrives by TMA in fp32 into a staging tile (K and V apart; boxes of 32
// head dims in the 128-byte swizzle, zero past the operand's length and
// head_dim: fp32_split.cuh; one thread issues a tile and an mbarrier
// counts its bytes, where per-thread cp.async address arithmetic held a
// first version by ~20%) and is split into three piece tiles; the split
// overlaps the products: V's split runs while S is in flight, the next
// sub-tile's K split while O += P.V is. P comes from registers (its three
// pieces split from the accumulator, as the bf16 kernels feed P), V
// MN-major (m64nDPk16). A block holds 65 KB of shared memory at DP 96 (K's
// and V's pieces 36 KB, their staging 24 KB), so that two blocks share an
// SM and one's softmax and splits run under the other's products (DP 128:
// 133 KB, one block). The mask's extras come by cp.async. The padded head
// width DP is 32, 64, 96 or 128 (padded_head_dim); the head dims past
// head_dim are zero-filled on load and never stored.
#include <math_constants.h>

#include <cstring>

#include "attention_args.cuh"
#include "fp32_split.cuh"
#include "inline_mask.cuh"

namespace vgt {

enum { kMaskRank = 0, kMaskBias = 1, kMaskInline = 2 };

template <int MASK>
struct F32Args;
template <>
struct F32Args<kMaskRank> {
  using T = RankAttnArgs;
};
template <>
struct F32Args<kMaskBias> {
  using T = BiasAttnArgs;
};
template <>
struct F32Args<kMaskInline> {
  using T = InlineAttnArgs;
};

constexpr int kF32Threads = 128;
constexpr int kF32Tile = 64;   // query rows of a block; keys of a map tile
constexpr int kF32Keys = 32;   // keys of a streamed sub-tile
constexpr int kF32BiasLd = kF32Keys + 8;
constexpr float kF32Log2e = 1.4426950408889634f;

// The tensor maps of a launch: Q (boxes of 64 rows), K and V of each key
// operand (boxes of 32 rows; the rank mask's cache and tail, else one).
struct alignas(64) F32Maps {
  CUtensorMap q;
  CUtensorMap kv[2][2];  // [operand][K, V]
};

// The shared memory of a block at padded head width DP, from a 1024-byte
// boundary: the K and V staging sub-tiles (fp32, by TMA; together Q's
// staging tile), at DP 128 the Q piece tiles (up to DP 96 Q's pieces live
// in registers), the K and V piece sub-tiles (bf16), the mask's extras of
// a sub-tile (the bias tile, the key metadata or the ranks), the two
// staging mbarriers, then the list of key tiles and (rank) their classes
// (nk entries). DP 96: 65 KB.
template <int DP, int MASK>
struct F32Cfg {
  // Q's split A fragments in registers (3 DP / 4 a thread) up to DP 96
  static constexpr bool kQRegs = DP <= 96;
  static constexpr int kTile = kF32Tile * DP;  // elements of Q's tile
  static constexpr int kSub = kF32Keys * DP;   // of a K or V sub-tile
  static constexpr int kExtra =
      MASK == kMaskBias ? kF32Tile * kF32BiasLd * 2
      : MASK == kMaskInline ? 3 * kF32Keys * 4 : kF32Keys * 4;  // bytes
  static constexpr int kFixed = 2 * kSub * 4 + (kQRegs ? 0 : 3 * kTile * 2) +
                                6 * kSub * 2 + kExtra + 16;
  static constexpr int smem(int nk) { return 1024 + kFixed + nk * 5 + 16; }
};

template <int DP, int MASK>
__global__ void __launch_bounds__(kF32Threads, 2)
    fp32_attention_kernel(const __grid_constant__ typename F32Args<MASK>::T a,
                          const __grid_constant__ F32Maps maps,
                          const int* order) {
  using C = F32Cfg<DP, MASK>;
  constexpr int kSub = C::kSub;
  constexpr int NO = DP / 8;
  constexpr int NS = kF32Keys / 2;  // a thread's entries of S (64 x 32)
  constexpr int R = kF32Keys / 16;  // reduction steps of P.V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* kst = reinterpret_cast<float*>(smem);  // staging, by TMA
  float* vst = kst + kSub;
  bf16* qp = reinterpret_cast<bf16*>(vst + kSub);  // DP 128: [3][kTile]
  bf16* kp = qp + (C::kQRegs ? 0 : 3 * C::kTile);  // [3][kSub] pieces
  bf16* vp = kp + 3 * kSub;
  unsigned char* extra = reinterpret_cast<unsigned char*>(vp + 3 * kSub);
  uint64_t* bars = reinterpret_cast<uint64_t*>(extra + C::kExtra);
  uint64_t* kbar = bars;      // K's staging (first Q's)
  uint64_t* vbar = bars + 1;  // V's staging
  int* list = reinterpret_cast<int*>(bars + 2);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, hk = h / (a.heads / a.kv_heads);
  const int head_dim = a.head_dim;

  // ---- which block, and the list of key tiles it computes ---------------
  int b, q0, n;
  if constexpr (MASK == kMaskRank) {
    b = blockIdx.z;
    q0 = blockIdx.x * kF32Tile;
    const int nk0 = (a.len[0] + kF32Tile - 1) / kF32Tile;
    const int nk = nk0 + (a.len[1] + kF32Tile - 1) / kF32Tile;
    int8_t* cls = reinterpret_cast<int8_t*>(list + nk);
    const RankQueryRange qr =
        rank_query_range(a.qoff + b * a.qoff_sb, q0, a.lq, lane);
    for (int t0 = 0; t0 < nk; t0 += 4) {
      const int tt = t0 + warp;  // warp-uniform
      if (tt < nk) {
        const int op = tt < nk0 ? 0 : 1;
        const int k0 = (tt - (op ? nk0 : 0)) * kF32Tile;
        int ra, rb;
        rank_tile_load(a.rank[op] + b * a.rank_sb[op], k0, a.len[op], lane,
                       ra, rb);
        const int8_t k = rank_tile_class(qr, ra, rb);
        if (lane == 0) cls[tt] = k;
      }
    }
    __syncthreads();
    n = gather_tiles(cls, 1, nk, list);
  } else {
    const int nq = (a.lq + kF32Tile - 1) / kF32Tile;
    const int nk = (a.lk + kF32Tile - 1) / kF32Tile;
    const int item = order[blockIdx.x];
    b = item / nq;
    q0 = (item % nq) * kF32Tile;
    n = gather_tiles(
        a.tile_map + (static_cast<long long>(b) * nq + item % nq) * nk, 1, nk,
        list);
  }

  // Q by TMA into the two staging sub-tiles (64 rows together)
  if (tid == 0) {
    mbar_init(kbar, 1);
    mbar_init(vbar, 1);
    fence_mbar_init();
    mbar_arrive_tx(kbar, C::kTile * 4);
    tma_tile_f32<kF32Tile, DP>(kst, &maps.q, kbar, q0, h, b);
  }

  // sub-tile i: the half i % 2 of listed key tile i / 2; its key operand,
  // first key, keys inside (none past the end of a key operand)
  auto tile_of = [&](int i, int& op, int& k0, int& valid) {
    const int tt = list[i >> 1] >> 2, half = (i & 1) * kF32Keys;
    if constexpr (MASK == kMaskRank) {
      const int nk0 = (a.len[0] + kF32Tile - 1) / kF32Tile;
      op = tt < nk0 ? 0 : 1;
      k0 = (tt - (op ? nk0 : 0)) * kF32Tile + half;
      valid = min(kF32Keys, a.len[op] - k0);
    } else {
      op = 0;
      k0 = tt * kF32Tile + half;
      valid = min(kF32Keys, a.lk - k0);
    }
  };
  // the TMA boxes of sub-tile i's K or V (one thread)
  auto load_k = [&](int i) {
    int op, k0, valid;
    tile_of(i, op, k0, valid);
    mbar_arrive_tx(kbar, kSub * 4);
    tma_tile_f32<kF32Keys, DP>(kst, &maps.kv[op][0], kbar, k0, hk, b);
  };
  auto load_v = [&](int i) {
    int op, k0, valid;
    tile_of(i, op, k0, valid);
    mbar_arrive_tx(vbar, kSub * 4);
    tma_tile_f32<kF32Keys, DP>(vst, &maps.kv[op][1], vbar, k0, hk, b);
  };
  // the mask's extras of sub-tile i, for a partial tile (cp.async)
  auto load_extra = [&](int i) {
    const int e = list[i >> 1];
    int op, k0, valid;
    tile_of(i, op, k0, valid);
    if ((e & 3) != kTilePartial) return;
    if constexpr (MASK == kMaskRank) {
      const int* rp = a.rank[op] + b * a.rank_sb[op] + k0;
      for (int j = tid; j < kF32Keys; j += kF32Threads)
        async_copy4(reinterpret_cast<int*>(extra) + j,
                    rp + (j < valid ? j : 0), j < valid);
    } else if constexpr (MASK == kMaskBias) {
      load_bias_tile<kF32Tile, kF32Keys, kF32Threads>(
          reinterpret_cast<bf16*>(extra), kF32BiasLd,
          static_cast<const bf16*>(a.bias) + b * a.bias_sb, a.bias_sq, a.lq,
          a.lk, a.bias_vec != 0, q0, k0, tid);
    } else {
      for (int x = tid; x < 3 * kF32Keys; x += kF32Threads) {
        const int m = x / kF32Keys, j = x % kF32Keys;
        const bool ok = j < valid;
        async_copy4(reinterpret_cast<int*>(extra) + x,
                    a.km[m] + b * a.km_sb[m] + (ok ? k0 + j : 0), ok);
      }
    }
  };

  const int items = 2 * n;  // key sub-tiles
  __syncthreads();          // the barriers initialised
  mbar_wait(kbar, 0);       // Q
  // up to DP 96 this thread's split A fragments of Q (rows warp 16 + g (+
  // 8), head dims 16 kk + 2 t (+ 8)) from the staging tile; at DP 128
  // Q's piece tiles
  uint32_t qf[3][C::kQRegs ? DP / 16 : 1][4];
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + g + (e & 1) * 8;
        const int c = kk * 16 + (e >> 1) * 8 + 2 * t;
        const float2 x =
            *reinterpret_cast<const float2*>(sw128_at<kF32Tile>(kst, r, c));
        split_pair(x.x, x.y, qf[0][kk][e], qf[1][kk][e], qf[2][kk][e]);
      }
  } else {
    split_tile_sw<kF32Tile, kF32Threads, DP>(kst, qp, tid);
  }
  fence_async_shared();
  __syncthreads();  // the staging sub-tiles are free
  // kbar completes for Q, then K(0), K(1), ... (K(j)'s phase parity (j +
  // 1) % 2), vbar for V(0), V(1), ... (parity j % 2); K(i + 1) is issued
  // after K(i)'s split, V(i + 1) after sub-tile i's softmax, the extras
  // (cp.async) with V
  if (tid == 0 && items > 0) {
    load_k(0);
    load_v(0);
  }
  if (items > 0) load_extra(0);
  async_commit();
  if (items > 0) {
    mbar_wait(kbar, 1);
    split_tile_sw<kF32Keys, kF32Threads, DP>(kst, kp, tid);
  }
  fence_async_shared();
  __syncthreads();  // Q's and K(0)'s pieces visible; the staging tile free
  if (tid == 0 && items > 1) load_k(1);

  // this thread's rows (lr0, lr0 + 8) and their mask state
  const int lr0 = warp * 16 + g;
  const int r0 = q0 + lr0, r1 = r0 + 8;
  int qo0 = kNever, qo1 = kNever;
  QueryMeta qm0, qm1;
  if constexpr (MASK == kMaskRank) {
    if (r0 < a.lq) qo0 = a.qoff[b * a.qoff_sb + r0];
    if (r1 < a.lq) qo1 = a.qoff[b * a.qoff_sb + r1];
  }
  if constexpr (MASK == kMaskInline) {
    qm0 = query_meta(a.qm, a.qm_sb, b, r0, a.lq);
    qm1 = query_meta(a.qm, a.qm_sb, b, r1, a.lq);
  }

  float o[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) o[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the denominators

  for (int it = 0; it < items; ++it) {
    const bool partial = (list[it >> 1] & 3) == kTilePartial;
    int valid;
    {
      int op, k0;
      tile_of(it, op, k0, valid);
    }

    // S = Q.K^T, six products into a fresh accumulator
    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
    wgmma_fence();
    if constexpr (C::kQRegs)
      split_product_rs_k<DP>(s, qf, kp);
    else
      split_product_ss<DP, kF32Keys>(s, qp, kp);
    wgmma_commit();

    // meanwhile V(it)'s split (P.V of the previous sub-tile is done: every
    // warp waited for it before this barrier)
    async_wait<0>();  // V(it)'s extras
    mbar_wait(vbar, it & 1);
    __syncthreads();
    split_tile_sw<kF32Keys, kF32Threads, DP>(vst, vp, tid);
    fence_async_shared();
    wgmma_wait<0>();
    fence_regs(s);

    // the tile's weights; col = (j / 4) 8 + 2 t + j % 2, row lr0 + 8
    // ((j / 2) % 2)
    float alpha0 = 1.f, alpha1 = 1.f;
    if constexpr (MASK == kMaskRank) {
      // unshifted exp2 of the clamped logits; masked pairs weigh 0
      const int* rk = reinterpret_cast<const int*>(extra);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int col = (j >> 2) * 8 + 2 * t + (j & 1);
        float x = exp2f(fminf(fmaxf(s[j] * a.kscale, -100.f), 100.f));
        if (partial) {
          const int rank = col < valid ? rk[col] : kNever;
          if (((j & 2) ? qo1 : qo0) < rank) x = 0.f;
        }
        s[j] = x;
        if (j & 2)
          l1 += x;
        else
          l0 += x;
      }
    } else {
      // logits in log2 units; in a partial tile the mask (the bias, or the
      // rule's -inf) and keys past Lk (-inf); a full tile lies inside Lk
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int col = (j >> 2) * 8 + 2 * t + (j & 1);
        const int hi = (j >> 1) & 1;
        float x = s[j] * a.scale_log2;
        if (partial) {
          if constexpr (MASK == kMaskBias) {
            const bf16* bs = reinterpret_cast<const bf16*>(extra);
            x = col < valid
                    ? x + __bfloat162float(bs[(lr0 + 8 * hi) * kF32BiasLd +
                                              col]) *
                              kF32Log2e
                    : -CUDART_INF_F;
          } else {
            const int* kmv = reinterpret_cast<const int*>(extra);
            const KeyMeta km{kmv[col], kmv[kF32Keys + col],
                             kmv[2 * kF32Keys + col]};
            x = col < valid && inline_visible(hi ? qm1 : qm0, km)
                    ? x
                    : -CUDART_INF_F;
          }
        }
        s[j] = x;
      }
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int n8 = 0; n8 < NS / 4; ++n8) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * n8], s[4 * n8 + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n8 + 2], s[4 * n8 + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      // while a row has seen no finite logit its max is -inf: subtract 0,
      // so exp2 gives 0 for the masked keys and the rescale, never NaN
      const float ms0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
      const float ms1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
      alpha0 = exp2f(m0 - ms0);
      alpha1 = exp2f(m1 - ms1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < NS / 4; ++n8) {
        s[4 * n8] = exp2f(s[4 * n8] - ms0);
        s[4 * n8 + 1] = exp2f(s[4 * n8 + 1] - ms0);
        s[4 * n8 + 2] = exp2f(s[4 * n8 + 2] - ms1);
        s[4 * n8 + 3] = exp2f(s[4 * n8 + 3] - ms1);
        ls0 += s[4 * n8] + s[4 * n8 + 1];
        ls1 += s[4 * n8 + 2] + s[4 * n8 + 3];
      }
      l0 = l0 * alpha0 + ls0;
      l1 = l1 * alpha1 + ls1;
    }
    uint32_t pa[3][R][4];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      uint32_t f[3][4];
      split_frag(f, s + 8 * j);
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int x = 0; x < 4; ++x) pa[k][j][x] = f[k][x];
    }
    __syncthreads();  // V(it)'s pieces visible; its staging and extras free
    if (it + 1 < items) {
      if (tid == 0) load_v(it + 1);
      load_extra(it + 1);
    }
    async_commit();

    // O += P.V, six products into a fresh accumulator
    float ot[NO * 4];
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) ot[i] = 0.f;
    wgmma_fence();
    split_product_rs<DP, R>(ot, pa, vp);
    wgmma_commit();

    // meanwhile K(it + 1)'s split (S of this sub-tile is done: every warp
    // waited for it before the barrier above)
    if (it + 1 < items) {
      mbar_wait(kbar, it & 1);  // K(it + 1)
      split_tile_sw<kF32Keys, kF32Threads, DP>(kst, kp, tid);
    }
    fence_async_shared();
    __syncthreads();  // K(it + 1)'s pieces visible; its staging tile free
    if (tid == 0 && it + 2 < items) load_k(it + 2);
    wgmma_wait<0>();
    fence_regs(ot);
    fence_split_frags(pa);
#pragma unroll
    for (int n8 = 0; n8 < NO; ++n8) {
      o[4 * n8] = fmaf(o[4 * n8], alpha0, ot[4 * n8]);
      o[4 * n8 + 1] = fmaf(o[4 * n8 + 1], alpha0, ot[4 * n8 + 1]);
      o[4 * n8 + 2] = fmaf(o[4 * n8 + 2], alpha1, ot[4 * n8 + 2]);
      o[4 * n8 + 3] = fmaf(o[4 * n8 + 3], alpha1, ot[4 * n8 + 3]);
    }
  }
  async_wait<0>();

  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  float inv0, inv1;
  if constexpr (MASK == kMaskRank) {
    inv0 = 1.f / fmaxf(sum0, 1e-30f);
    inv1 = 1.f / fmaxf(sum1, 1e-30f);
  } else {
    inv0 = sum0 > 0.f ? 1.f / sum0 : 0.f;
    inv1 = sum1 > 0.f ? 1.f / sum1 : 0.f;
    if (a.lse != nullptr && t == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      float* lse = a.lse + (static_cast<long long>(b) * a.heads + h) * a.lq;
      if (r0 < a.lq)
        lse[r0] = sum0 > 0.f ? (m0 + log2f(sum0)) * kLn2 : -CUDART_INF_F;
      if (r1 < a.lq)
        lse[r1] = sum1 > 0.f ? (m1 + log2f(sum1)) * kLn2 : -CUDART_INF_F;
    }
  }
  float* out = static_cast<float*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int n8 = 0; n8 < NO; ++n8) {
    const int c = n8 * 8 + 2 * t;
    if (n8 * 8 >= head_dim) break;  // the padded head dims are not stored
    if (r0 < a.lq)
      *reinterpret_cast<float2*>(out + r0 * a.o_sl + c) =
          make_float2(o[4 * n8] * inv0, o[4 * n8 + 1] * inv0);
    if (r1 < a.lq)
      *reinterpret_cast<float2*>(out + r1 * a.o_sl + c) =
          make_float2(o[4 * n8 + 2] * inv1, o[4 * n8 + 3] * inv1);
  }
}

template <int DP, int MASK>
int launch_fp32(const typename F32Args<MASK>::T& a, const F32Maps& maps,
                const int* order, dim3 grid, int nk, cudaStream_t s) {
  const int smem = F32Cfg<DP, MASK>::smem(nk);
  cudaError_t err = cudaFuncSetAttribute(
      fp32_attention_kernel<DP, MASK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fp32_attention_kernel<DP, MASK>
      <<<grid, kF32Threads, smem, s>>>(a, maps, order);
  return static_cast<int>(cudaGetLastError());
}

// Q's map and the maps of the key operands (`ops` of them), then the
// launch at the padded width; 100000 + the CUresult of a map that failed
// to encode.
template <int MASK>
int launch_fp32_dp(const typename F32Args<MASK>::T& a, F32Maps& maps,
                   const int* order, dim3 grid, int nk, cudaStream_t s) {
  const CUresult r = encode_f32_operand(&maps.q, a.q, a.batch, a.heads, a.lq,
                                        a.head_dim, a.q_sb, a.q_sh, a.q_sl,
                                        kF32Tile);
  if (r != CUDA_SUCCESS) return 100000 + static_cast<int>(r);
  switch (padded_head_dim(a.head_dim)) {
    case 32: return launch_fp32<32, MASK>(a, maps, order, grid, nk, s);
    case 64: return launch_fp32<64, MASK>(a, maps, order, grid, nk, s);
    case 96: return launch_fp32<96, MASK>(a, maps, order, grid, nk, s);
    case 128: return launch_fp32<128, MASK>(a, maps, order, grid, nk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The maps of K and V [B][L][Hkv][D] (bias, inline).
template <class Args>
int encode_kv(const Args& a, F32Maps& maps) {
  for (int kv = 0; kv < 2; ++kv) {
    const CUresult r = encode_f32_operand(
        &maps.kv[0][kv], kv ? a.v : a.k, a.batch, a.kv_heads, a.lk,
        a.head_dim, kv ? a.v_sb : a.k_sb, kv ? a.v_sh : a.k_sh,
        kv ? a.v_sl : a.k_sl, kF32Keys);
    if (r != CUDA_SUCCESS) return 100000 + static_cast<int>(r);
  }
  return 0;
}

}  // namespace vgt

// K1/K2 at fp32 operands. Launches on `stream`; returns cudaGetLastError()
// (0 = launched), or 100000 + the CUresult of a tensor map that failed to
// encode.
extern "C" int vgt_fp32_rank_attention(const vgt::RankAttnArgs* a,
                                       void* stream) {
  using namespace vgt;
  if (padded_head_dim(a->head_dim) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  F32Maps maps;
  memset(&maps, 0, sizeof(maps));
  for (int op = 0; op < 2; ++op) {
    if (a->len[op] == 0) continue;
    for (int kv = 0; kv < 2; ++kv) {
      const CUresult r = encode_f32_operand(
          &maps.kv[op][kv], kv ? a->v[op] : a->k[op], a->batch, a->kv_heads,
          a->len[op], a->head_dim, kv ? a->v_sb[op] : a->k_sb[op],
          kv ? a->v_sh[op] : a->k_sh[op], kv ? a->v_sl[op] : a->k_sl[op],
          kF32Keys);
      if (r != CUDA_SUCCESS) return 100000 + static_cast<int>(r);
    }
  }
  const int nk = (a->len[0] + kF32Tile - 1) / kF32Tile +
                 (a->len[1] + kF32Tile - 1) / kF32Tile;
  const dim3 grid((a->lq + kF32Tile - 1) / kF32Tile, a->heads, a->batch);
  return launch_fp32_dp<kMaskRank>(*a, maps, nullptr, grid, nk,
                                   static_cast<cudaStream_t>(stream));
}

// K3 at fp32 operands, over the bias's map from vgt_bias_tile_map (the
// bf16 kernel's). Launches on `stream`; returns cudaGetLastError(), or
// 100000 + the CUresult of a tensor map that failed to encode.
extern "C" int vgt_fp32_bias_attention(const vgt::BiasAttnArgs* a,
                                       void* stream) {
  using namespace vgt;
  if (padded_head_dim(a->head_dim) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  F32Maps maps;
  memset(&maps, 0, sizeof(maps));
  const int err = encode_kv(*a, maps);
  if (err != 0) return err;
  const int nq = (a->lq + kF32Tile - 1) / kF32Tile;
  const int nk = (a->lk + kF32Tile - 1) / kF32Tile;
  return launch_fp32_dp<kMaskBias>(*a, maps, a->order,
                                   dim3(a->batch * nq, a->heads), nk,
                                   static_cast<cudaStream_t>(stream));
}

// K6 at fp32 operands: the metadata's tile map (as K6 builds it), then,
// unless map_only, the attention. Launches on `stream`; returns the first
// nonzero cudaGetLastError(), or 100000 + the CUresult of a tensor map
// that failed to encode.
extern "C" int vgt_fp32_inline_attention(const vgt::InlineAttnArgs* a,
                                         void* stream) {
  using namespace vgt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (padded_head_dim(a->head_dim) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* order = nullptr;
  int err = launch_inline_tile_map(*a, s, &order);
  if (err != 0 || a->map_only) return err;
  F32Maps maps;
  memset(&maps, 0, sizeof(maps));
  err = encode_kv(*a, maps);
  if (err != 0) return err;
  const int nq = (a->lq + kF32Tile - 1) / kF32Tile;
  const int nk = (a->lk + kF32Tile - 1) / kF32Tile;
  return launch_fp32_dp<kMaskInline>(*a, maps, order,
                                     dim3(a->batch * nq, a->heads), nk, s);
}
