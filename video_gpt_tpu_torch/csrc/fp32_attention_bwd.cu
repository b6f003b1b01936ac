// fp32 attention backward for Hopper (sm_90a): K9 and K7 at fp32 operands,
// on the tensor cores as split-precision products.
//
// Replaces the TPU kernels `_bwd_kernel` (K9, the backward of the biased
// attention) and `_stream_dq_kernel` / `_stream_dkv_kernel` (K7a/K7b, the
// backward of the metadata-masked attention) of
// video_gpt_tpu/ops/flash_attention.py where their operands are fp32: the
// Pallas kernels keep the operands' dtype, so `train --mixed_precision no`
// runs them in fp32 end to end. The bf16 kernels (bias_attention_bwd.cu,
// inline_attention_bwd.cu) serve bf16 operands; the wrappers in
// ops/flash_attention.py choose by dtype (`backward_kernel`). One kernel
// body, a template on the mask:
//   kMaskBias   K9: p = exp2((q.k scale log2e + bias log2e - x_ref) - off),
//               the bf16 bias and the tile map that the forward read (the
//               BiasMap), each row's softmax reference from its lse and
//               dead-row count, as K9 derives it;
//   kMaskInline K7: p = exp2(q.k scale log2e - lse log2e) where the
//               metadata rule (inline_mask.cuh) makes the pair visible, the
//               rule's tile map with its column counts built here, as K7
//               builds it; lse is the forward's (fp32_attention.cu) or, on
//               a ring, the global one of the whole key row.
// Then, as in both TPU kernels, di = rowsum(o * do), ds = p (dp - di)
// scale, dq = ds K, dk = ds^T Q, dv = p^T dO, the q heads of a GQA group
// summed into their kv head. exp2f is the accurate one. The sums run in
// another order than the plain versions'.
//
// Products. The five products (S, dP, dV += P^T.dO, dK += dS^T.Q, dQ +=
// dS.K) are bf16 wgmma with fp32 accumulation, each as the six kept
// products of three bf16 pieces per operand (fp32_split.cuh: exact pieces;
// the dropped ml, lm, ll are at most 2^-24 |a||b|; each tile's products
// summed in a fresh accumulator, hh last, and added to the gradient in
// fp32, so no tensor-core addition chain grows with the column or row).
//
// What bounds it on the card: six bf16 products per fp32 product, 989 / 6
// = 165 TFLOP/s against the five products' 2 FLOPs per head dim and
// visible pair (K9 at stage 1, L 7104, 32 heads of 96: 0.44 TFLOP, 2.6 ms),
// far above the bytes (0.5 GB, 0.15 ms); this design computes 7 products a
// pair (dQ's kernel recomputes S and dP), and splits every streamed tile
// and every P^T, dS^T, dS on the CUDA cores, which, with the steps that
// one warpgroup waits for the other in dK/dV, hold it (PERF.md section 6).
//
// Design, the bf16 K9's and K7's scheme (bias_attention_bwd.cu,
// inline_attention_bwd.cu) with split operands. Three launches (after the
// inline mask's map): delta (di and the softmax references, fp32 on the
// CUDA cores), dK/dV and dQ; no atomics, so the result is deterministic.
//   dK/dV: one block of two warpgroups per (64-key tile, kv head), over (q
//     head of the group) x (query sub-tile of the non-empty query tiles of
//     its column of the map), so the GQA sum falls out of the loop. K and V
//     are split once into piece tiles; Q and dO arrive by TMA in fp32 into
//     staging tiles and are split per sub-tile. Warpgroup 0 computes
//     S^T = K.Q^T, warpgroup 1 dP^T = V.dO^T (the same instruction on other
//     tiles), both m64nSk16 from shared memory; warpgroup 0 turns S^T into
//     P^T and hands it to warpgroup 1 through shared memory, which forms
//     dS^T = P^T (dP^T - di) scale; each splits its operand in registers
//     and accumulates its gradient, dV += P^T.dO (warpgroup 0) or dK +=
//     dS^T.Q (warpgroup 1), m64nDPk16 with dO, Q MN-major. Two warpgroups
//     because one cannot hold dK, dV and their tiles' sums beside the split
//     operands (DP 128: 256 fp32 registers a thread).
//   dQ: one block of one warpgroup per (64-row query tile, head), over the
//     32-key sub-tiles of the non-empty key tiles of its row of the map; Q
//     and dO are split once (up to DP 96 dO into this thread's A fragments
//     in registers), K and V stream and are split per sub-tile. S = Q.K^T
//     and dP = dO.V^T (m64n32k16), dS in registers, split, dQ += dS.K (K
//     MN-major). A block holds 101 KB at DP 96, two blocks an SM.
// Every fp32 tile arrives by TMA (fp32_split.cuh: boxes of 32 head dims in
// the 128-byte swizzle, zero past the operand's rows and head_dim; one
// thread issues a tile, an mbarrier counts its bytes): per-thread cp.async
// address arithmetic held a first version by ~25%. The mask's data (the
// bias tile, the metadata) and the rows' di and references come by
// cp.async. dK/dV's query sub-tile is 64 rows up to DP 96 and 32 at DP 128
// (64 would pass the 227 KB of shared memory a block may hold: DP 96's
// dK/dV block holds 219 KB). Partial tiles evaluate the mask per element (and
// bounds: keys past Lk and rows past Lq weigh nothing); full tiles skip
// it. The padded head width DP is 32, 64, 96 or 128 (padded_head_dim); the
// head dims past head_dim are zero-filled on load and never stored.
#include <math_constants.h>

#include <cstring>

#include "attention_args.cuh"
#include "fp32_split.cuh"
#include "inline_mask.cuh"

namespace vgt {

enum { kMaskBias = 1, kMaskInline = 2 };

template <int MASK>
struct F32BwdArgs;
template <>
struct F32BwdArgs<kMaskBias> {
  using T = BiasAttnBwdArgs;
};
template <>
struct F32BwdArgs<kMaskInline> {
  using T = InlineAttnBwdArgs;
};

constexpr int kKvThreads = 256;       // dK/dV: two warpgroups
constexpr int kDqThreads = 128;       // dQ: one warpgroup
constexpr int kT = 64;                // query rows and keys of a map tile
constexpr int kDeltaWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

// The sub-tiles and shared memory of the two kernels at padded head width
// DP under MASK.
template <int DP, int MASK>
struct BwdCfg {
  // rows of a streamed sub-tile: dK/dV's query sub-tile (64 up to DP 96),
  // dQ's key sub-tile (QS)
  static constexpr int S = DP > 96 ? 32 : 64;
  static constexpr int QS = 32;
  // dQ: dO's split A fragments in registers (3 DP / 4 a thread) up to DP 96
  static constexpr bool kDoRegs = DP <= 96;
  static constexpr int kFull = kT * DP;  // elements of a 64-row tile
  static constexpr int kSub = S * DP;    // of a dK/dV sub-tile
  static constexpr int kQSub = QS * DP;  // of a dQ sub-tile
  // dK/dV: a partial sub-tile's mask data: the bias tile [S][64 + 8] bf16,
  // or the query metadata (4 vectors of S)
  static constexpr int kKvMask =
      MASK == kMaskBias ? S * (kT + 8) * 2 : 4 * S * 4;
  // from a 1024-byte boundary: Q, dO staging (by TMA; together K's, then
  // V's); K, V pieces; Q, dO pieces; the P^T hand-over; di and the
  // references of two sub-tiles; the mask data; the key metadata; the
  // staging's mbarrier
  static constexpr int kKvFixed = 2 * kSub * 4 + 6 * kFull * 2 +
                                  6 * kSub * 2 + kT * S * 4 + 6 * S * 4 +
                                  kKvMask + 3 * kT * 4 + 16;
  static constexpr int dkdv_smem(int nq) { return 1024 + kKvFixed + nq * 4; }
  // dQ: the bias tile [64][QS + 8] bf16, or the key metadata (3 vectors)
  static constexpr int kQMask =
      MASK == kMaskBias ? kT * (QS + 8) * 2 : 3 * QS * 4;
  // from a 1024-byte boundary: K, V staging (by TMA; together Q's, then
  // dO's); Q's pieces (and dO's at DP 128); K, V pieces; the mask data; the
  // staging's mbarrier. DP 96: 101 KB.
  static constexpr int kQFixed = 2 * kQSub * 4 +
                                 (kDoRegs ? 3 : 6) * kFull * 2 +
                                 6 * kQSub * 2 + kQMask + 16;
  static constexpr int dq_smem(int nk) { return 1024 + kQFixed + nk * 4; }
};

// The tensor maps of a launch: Q, dO, K and V in boxes of 64 rows (each
// kernel's fixed tiles) and of a streamed sub-tile's rows (dK/dV's Q and
// dO: S; dQ's K and V: QS).
struct alignas(64) BwdMaps {
  CUtensorMap q, dout, k, v;          // 64 rows
  CUtensorMap q_s, dout_s, k_s, v_s;  // a sub-tile's rows
};

// 1. di = rowsum(o * do), and for the bias each row's softmax reference
// (x_ref, off), as K9's delta pass: (lse log2e, 0), or for a row that sees
// no key (BF16_NEG log2e, log2 n). One warp per (b, h, query row).
template <int MASK>
__global__ void __launch_bounds__(32 * kDeltaWarps)
    fp32_bwd_delta_kernel(const typename F32BwdArgs<MASK>::T a) {
  const long long row = (static_cast<long long>(blockIdx.x) * kDeltaWarps +
                         (threadIdx.x >> 5));
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(a.batch) * a.heads * a.lq) return;
  const int r = static_cast<int>(row % a.lq);
  const long long bh = row / a.lq;
  const int h = static_cast<int>(bh % a.heads);
  const int b = static_cast<int>(bh / a.heads);
  const float* o = static_cast<const float*>(a.o) + b * a.o_sb +
                   r * a.o_sl + h * a.o_sh;
  const float* d = static_cast<const float*>(a.dout) + b * a.do_sb +
                   r * a.do_sl + h * a.do_sh;
  float s = 0.f;
  for (int c = lane; c < a.head_dim; c += 32) s = fmaf(o[c], d[c], s);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) {
    a.delta[row] = s;
    if constexpr (MASK == kMaskBias) {
      const float dead = a.rowdead[static_cast<long long>(b) * a.lq + r];
      a.rowref[2 * row] =
          dead >= 0.f ? kBf16Neg * kLog2e : a.lse[row] * kLog2e;
      a.rowref[2 * row + 1] = dead >= 0.f ? dead : 0.f;
    }
  }
}

// The (x_ref, off) of query row `row` (flat over b, h, Lq) in log2 units:
// the bias's from its rowref, the inline mask's (lse log2e, 0).
template <int MASK>
__device__ __forceinline__ void row_ref(const typename F32BwdArgs<MASK>::T& a,
                                        long long row, float& xr,
                                        float& off) {
  if constexpr (MASK == kMaskBias) {
    xr = a.rowref[2 * row];
    off = a.rowref[2 * row + 1];
  } else {
    xr = a.lse[row] * kLog2e;
    off = 0.f;
  }
}

// The split A operand of a gradient product from a 64 x (16 R) accumulator.
template <int R>
__device__ __forceinline__ void split_acc(uint32_t (&fa)[3][R][4],
                                          const float* x) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    uint32_t f[3][4];
    split_frag(f, x + 8 * j);
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) fa[k][j][e] = f[k][e];
  }
}

// 2. dK/dV of one 64-key tile of one kv head (see the file's comment).
template <int DP, int MASK>
__global__ void __launch_bounds__(kKvThreads, 1)
    fp32_bwd_dkdv_kernel(const __grid_constant__ typename F32BwdArgs<MASK>::T a,
                         const __grid_constant__ BwdMaps maps,
                         const int* order) {
  using C = BwdCfg<DP, MASK>;
  constexpr int S = C::S, kFull = C::kFull, kSub = C::kSub;
  constexpr int NO = DP / 8;
  constexpr int NS = S / 2;   // a thread's entries of a 64 x S accumulator
  constexpr int R = S / 16;   // reduction steps of a gradient product
  constexpr int SUB = kT / S;  // sub-tiles of a map tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* stg = reinterpret_cast<float*>(smem);  // [2][kSub], by TMA
  bf16* kvp = reinterpret_cast<bf16*>(stg + 2 * kSub);  // [2][3][kFull]
  bf16* qdp = kvp + 6 * kFull;                 // [2][3][kSub]: Q, dO pieces
  float* xchg = reinterpret_cast<float*>(qdp + 6 * kSub);  // P^T
  float* rowd = xchg + kT * S;    // [2][3 S]: di, then references or lse
  unsigned char* mk = reinterpret_cast<unsigned char*>(rowd + 6 * S);
  int* kmeta = reinterpret_cast<int*>(mk + C::kKvMask);  // [3][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(kmeta + 3 * kT);
  int* list = reinterpret_cast<int*>(bar + 1);

  const int nq = (a.lq + kT - 1) / kT;
  const int nk = (a.lk + kT - 1) / kT;
  const int item = order != nullptr ? order[blockIdx.x] : blockIdx.x;
  const int b = item / nk, kt = item % nk, k0 = kt * kT;
  const int hk = blockIdx.y, group = a.heads / a.kv_heads;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kvalid = min(kT, a.lk - k0);
  const int head_dim = a.head_dim;

  // K, then V, through the staging tiles into their pieces; `bar`
  // completes for K (0), V (1), then each sub-tile's Q and dO (2 + i)
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
    mbar_arrive_tx(bar, kFull * 4);
    tma_tile_f32<kT, DP>(stg, &maps.k, bar, k0, hk, b);
  }
  if constexpr (MASK == kMaskInline)
    for (int x = tid; x < 3 * kT; x += kKvThreads) {
      const int m = x / kT, j = x % kT;
      const bool ok = j < kvalid;
      async_copy4(kmeta + x, a.km[m] + b * a.km_sb[m] + (ok ? k0 + j : 0),
                  ok);
    }
  async_commit();
  async_wait<0>();
  __syncthreads();  // the key metadata; the barrier initialised
  mbar_wait(bar, 0);
  split_tile_sw<kT, kKvThreads, DP>(stg, kvp, tid);
  fence_async_shared();
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_tx(bar, kFull * 4);
    tma_tile_f32<kT, DP>(stg, &maps.v, bar, k0, hk, b);
  }
  mbar_wait(bar, 1);
  split_tile_sw<kT, kKvThreads, DP>(stg, kvp + 3 * kFull, tid);
  fence_async_shared();
  const int n = gather_tiles(
      a.tile_map + static_cast<long long>(b) * nq * nk + kt, nk, nq, list);
  // streamed items: (q head, query sub-tile), head-major
  const int pairs = n * group * SUB;

  auto sub_of = [&](int i, int& h, int& q0, int& e) {
    const int per = n * SUB, r = i % per;
    h = hk * group + i / per;
    e = list[r / SUB];
    q0 = (e >> 2) * kT + (r % SUB) * S;
  };
  // Q and dO of sub-tile i into the staging tiles (TMA, one thread), its
  // di and references into rowd[i % 2] (cp.async)
  auto load_qdo = [&](int i) {
    int h, q0, e;
    sub_of(i, h, q0, e);
    const int qvalid = min(S, a.lq - q0);
    if (tid == 0) {
      mbar_arrive_tx(bar, 2 * kSub * 4);
      tma_tile_f32<S, DP>(stg, &maps.q_s, bar, q0, h, b);
      tma_tile_f32<S, DP>(stg + kSub, &maps.dout_s, bar, q0, h, b);
    }
    float* rd = rowd + (i & 1) * 3 * S;
    const long long row0 =
        (static_cast<long long>(b) * a.heads + h) * a.lq + q0;
    for (int x = tid; x < 3 * S; x += kKvThreads) {
      if (x < S) {
        const bool ok = x < qvalid;
        async_copy4(rd + x, a.delta + (ok ? row0 + x : 0), ok);
      } else if constexpr (MASK == kMaskBias) {
        const bool ok = (x - S) >> 1 < qvalid;
        async_copy4(rd + x, a.rowref + (ok ? 2 * row0 + x - S : 0), ok);
      } else if (x < 2 * S) {
        const bool ok = x - S < qvalid;
        async_copy4(rd + x, a.lse + (ok ? row0 + x - S : 0), ok);
      }
    }
  };
  // a partial sub-tile's mask data
  auto load_mask = [&](int i) {
    int h, q0, e;
    sub_of(i, h, q0, e);
    if ((e & 3) != kTilePartial) return;
    if constexpr (MASK == kMaskBias) {
      load_bias_tile<S, kT, kKvThreads>(
          reinterpret_cast<bf16*>(mk), kT + 8,
          static_cast<const bf16*>(a.bias) + b * a.bias_sb, a.bias_sq, a.lq,
          a.lk, a.bias_vec != 0, q0, k0, tid);
    } else {
      const int qvalid = min(S, a.lq - q0);
      for (int x = tid; x < 4 * S; x += kKvThreads) {
        const int m = x / S, j = x % S;
        const bool ok = j < qvalid;
        async_copy4(reinterpret_cast<int*>(mk) + x,
                    a.qm[m] + b * a.qm_sb[m] + (ok ? q0 + j : 0), ok);
      }
    }
  };
  if (pairs > 0) {
    load_qdo(0);
    load_mask(0);
  }
  async_commit();

  // warpgroup 0 accumulates dV, warpgroup 1 dK
  float grad[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) grad[i] = 0.f;

  for (int it = 0; it < pairs; ++it) {
    int h, q0, e;
    sub_of(it, h, q0, e);
    const bool partial = (e & 3) == kTilePartial;
    const int qvalid = min(S, a.lq - q0);
    async_wait<0>();
    mbar_wait(bar, it & 1);
    // sub-tile it has landed; every warp is done with the previous one's
    // pieces and hand-over
    __syncthreads();
    split_tile_sw<S, kKvThreads, DP>(stg, qdp, tid);
    split_tile_sw<S, kKvThreads, DP>(stg + kSub, qdp + 3 * kSub, tid);
    fence_async_shared();
    __syncthreads();  // the pieces visible; the staging tiles free
    if (it + 1 < pairs) load_qdo(it + 1);
    async_commit();

    // S^T = K.Q^T (warpgroup 0) or dP^T = V.dO^T (1), rows the keys
    float x[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) x[j] = 0.f;
    wgmma_fence();
    split_product_ss<DP, S>(x, kvp + wg * 3 * kFull, qdp + wg * 3 * kSub);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);

    // P^T; in a partial tile, queries past Lq and keys past Lk weigh
    // nothing. Entry j: key warp 16 + g + 8 ((j / 2) % 2), query (j / 4) 8
    // + 2 t + j % 2.
    const float* rd = rowd + (it & 1) * 3 * S;
    float4* xch = reinterpret_cast<float4*>(xchg);
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int kr = warp * 16 + g + ((j & 2) ? 8 : 0);
        const int qc = (j >> 2) * 8 + 2 * t + (j & 1);
        float xs = x[j] * a.scale_log2;
        bool ok = true;
        if (partial) {
          ok = kr < kvalid && qc < qvalid;
          if constexpr (MASK == kMaskBias) {
            xs += __bfloat162float(
                      reinterpret_cast<const bf16*>(mk)[qc * (kT + 8) + kr]) *
                  kLog2e;
          } else {
            const int* qm = reinterpret_cast<const int*>(mk);
            ok = ok && inline_visible(
                           QueryMeta{qm[qc], qm[S + qc], qm[2 * S + qc],
                                     qm[3 * S + qc]},
                           KeyMeta{kmeta[kr], kmeta[kT + kr],
                                   kmeta[2 * kT + kr]});
          }
        }
        float xr, off;
        if constexpr (MASK == kMaskBias) {
          xr = rd[S + 2 * qc];
          off = rd[S + 2 * qc + 1];
        } else {
          xr = rd[S + qc] * kLog2e;
          off = 0.f;
        }
        x[j] = ok ? exp2f((xs - xr) - off) : 0.f;
      }
#pragma unroll
      for (int j4 = 0; j4 < NS / 4; ++j4)
        xch[j4 * 128 + wtid] = make_float4(x[4 * j4], x[4 * j4 + 1],
                                           x[4 * j4 + 2], x[4 * j4 + 3]);
    }
    __syncthreads();  // P^T to warpgroup 1; the mask data free
    if (it + 1 < pairs) load_mask(it + 1);
    async_commit();
    if (wg == 1) {
      // dS^T = P^T (dP^T - di) scale
#pragma unroll
      for (int j4 = 0; j4 < NS / 4; ++j4) {
        const float4 p4 = xch[j4 * 128 + wtid];
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = 4 * j4 + u;
          const int qc = (j >> 2) * 8 + 2 * t + (j & 1);
          x[j] = p[u] * (x[j] - rd[qc]) * a.scale;
        }
      }
    }

    // dV += P^T.dO (warpgroup 0) or dK += dS^T.Q (1)
    uint32_t fa[3][R][4];
    split_acc<R>(fa, x);
    float gt[NO * 4];
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) gt[i] = 0.f;
    wgmma_fence();
    split_product_rs<DP, R>(gt, fa, qdp + (1 - wg) * 3 * kSub);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(gt);
    fence_split_frags(fa);
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) grad[i] += gt[i];
  }
  async_wait<0>();

  const int kr0 = warp * 16 + g, kr1 = kr0 + 8;  // this thread's key rows
  float* out = static_cast<float*>(wg ? a.dk : a.dv) + b * a.dkv_sb +
               hk * a.dkv_sh;
#pragma unroll
  for (int n8 = 0; n8 < NO; ++n8) {
    const int c = n8 * 8 + 2 * t;
    if (n8 * 8 >= head_dim) break;  // the padded dims are not stored
    if (kr0 < kvalid)
      *reinterpret_cast<float2*>(out + (k0 + kr0) * a.dkv_sl + c) =
          make_float2(grad[4 * n8], grad[4 * n8 + 1]);
    if (kr1 < kvalid)
      *reinterpret_cast<float2*>(out + (k0 + kr1) * a.dkv_sl + c) =
          make_float2(grad[4 * n8 + 2], grad[4 * n8 + 3]);
  }
}

// 3. dQ of one 64-row query tile of one head (see the file's comment).
template <int DP, int MASK>
__global__ void __launch_bounds__(kDqThreads, 2)
    fp32_bwd_dq_kernel(const __grid_constant__ typename F32BwdArgs<MASK>::T a,
                       const __grid_constant__ BwdMaps maps,
                       const int* order) {
  using C = BwdCfg<DP, MASK>;
  constexpr int S = C::QS, kFull = C::kFull, kSub = C::kQSub;
  constexpr int NO = DP / 8;
  constexpr int NS = S / 2;
  constexpr int R = S / 16;
  constexpr int SUB = kT / S;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* stg = reinterpret_cast<float*>(smem);  // [2][kSub], by TMA
  // [3][kFull] Q pieces, then at DP 128 [3][kFull] dO pieces
  bf16* qdp = reinterpret_cast<bf16*>(stg + 2 * kSub);
  bf16* kvp = qdp + (C::kDoRegs ? 3 : 6) * kFull;  // [2][3][kSub]: K, V
  unsigned char* mk = reinterpret_cast<unsigned char*>(kvp + 6 * kSub);
  uint64_t* bar = reinterpret_cast<uint64_t*>(mk + C::kQMask);
  int* list = reinterpret_cast<int*>(bar + 1);

  const int nq = (a.lq + kT - 1) / kT;
  const int nk = (a.lk + kT - 1) / kT;
  const int item = order != nullptr ? order[blockIdx.x] : blockIdx.x;
  const int b = item / nq, qt = item % nq, q0 = qt * kT;
  const int h = blockIdx.y, hk = h / (a.heads / a.kv_heads);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int head_dim = a.head_dim;

  // Q, then dO, through the staging tiles (2 x 32 rows) into their
  // pieces (dO up to DP 96 into registers); `bar` completes for Q (0), dO
  // (1), then each key sub-tile's K and V (2 + i)
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
    mbar_arrive_tx(bar, kFull * 4);
    tma_tile_f32<kT, DP>(stg, &maps.q, bar, q0, h, b);
  }
  __syncthreads();  // the barrier initialised
  mbar_wait(bar, 0);
  split_tile_sw<kT, kDqThreads, DP>(stg, qdp, tid);
  fence_async_shared();
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_tx(bar, kFull * 4);
    tma_tile_f32<kT, DP>(stg, &maps.dout, bar, q0, h, b);
  }
  mbar_wait(bar, 1);
  // up to DP 96 this thread's split A fragments of dO (rows warp 16 + g
  // (+ 8), head dims 16 kk + 2 t (+ 8)) from the staging tile; at DP 128
  // dO's piece tiles
  uint32_t dof[3][C::kDoRegs ? DP / 16 : 1][4];
  if constexpr (C::kDoRegs) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + g + (e & 1) * 8;
        const int c = kk * 16 + (e >> 1) * 8 + 2 * t;
        const float2 x =
            *reinterpret_cast<const float2*>(sw128_at<kT>(stg, r, c));
        split_pair(x.x, x.y, dof[0][kk][e], dof[1][kk][e], dof[2][kk][e]);
      }
  } else {
    split_tile_sw<kT, kDqThreads, DP>(stg, qdp + 3 * kFull, tid);
  }
  fence_async_shared();
  const int n = gather_tiles(
      a.tile_map + (static_cast<long long>(b) * nq + qt) * nk, 1, nk, list);
  const int items = n * SUB;  // key sub-tiles

  auto sub_of = [&](int i, int& k0, int& e) {
    e = list[i / SUB];
    k0 = (e >> 2) * kT + (i % SUB) * S;
  };
  // K and V of sub-tile i into the staging tiles (TMA, one thread)
  auto load_kv = [&](int i) {
    int k0, e;
    sub_of(i, k0, e);
    mbar_arrive_tx(bar, 2 * kSub * 4);
    tma_tile_f32<S, DP>(stg, &maps.k_s, bar, k0, hk, b);
    tma_tile_f32<S, DP>(stg + kSub, &maps.v_s, bar, k0, hk, b);
  };
  auto load_mask = [&](int i) {
    int k0, e;
    sub_of(i, k0, e);
    if ((e & 3) != kTilePartial) return;
    if constexpr (MASK == kMaskBias) {
      load_bias_tile<kT, S, kDqThreads>(
          reinterpret_cast<bf16*>(mk), S + 8,
          static_cast<const bf16*>(a.bias) + b * a.bias_sb, a.bias_sq, a.lq,
          a.lk, a.bias_vec != 0, q0, k0, tid);
    } else {
      const int valid = min(S, a.lk - k0);
      for (int x = tid; x < 3 * S; x += kDqThreads) {
        const int m = x / S, j = x % S;
        const bool ok = j < valid;
        async_copy4(reinterpret_cast<int*>(mk) + x,
                    a.km[m] + b * a.km_sb[m] + (ok ? k0 + j : 0), ok);
      }
    }
  };
  if (items > 0) {
    if (tid == 0) load_kv(0);
    load_mask(0);
  }
  async_commit();

  // this thread's rows: local lr0 / lr0 + 8, their di, references, metadata
  const int lr0 = warp * 16 + g;
  const int r0 = q0 + lr0, r1 = r0 + 8;
  const long long row0 = (static_cast<long long>(b) * a.heads + h) * a.lq;
  float dl[2] = {0.f, 0.f}, xr[2] = {0.f, 0.f}, off[2] = {0.f, 0.f};
  if (r0 < a.lq) {
    dl[0] = a.delta[row0 + r0];
    row_ref<MASK>(a, row0 + r0, xr[0], off[0]);
  }
  if (r1 < a.lq) {
    dl[1] = a.delta[row0 + r1];
    row_ref<MASK>(a, row0 + r1, xr[1], off[1]);
  }
  QueryMeta qm[2];
  if constexpr (MASK == kMaskInline) {
    qm[0] = query_meta(a.qm, a.qm_sb, b, r0, a.lq);
    qm[1] = query_meta(a.qm, a.qm_sb, b, r1, a.lq);
  }

  float dq[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) dq[i] = 0.f;

  for (int it = 0; it < items; ++it) {
    int k0, e;
    sub_of(it, k0, e);
    const bool partial = (e & 3) == kTilePartial;
    const int kvalid = min(S, a.lk - k0);
    async_wait<0>();
    mbar_wait(bar, it & 1);
    __syncthreads();  // sub-tile it has landed; the previous one's pieces
                      // are free
    split_tile_sw<S, kDqThreads, DP>(stg, kvp, tid);
    split_tile_sw<S, kDqThreads, DP>(stg + kSub, kvp + 3 * kSub, tid);
    fence_async_shared();
    __syncthreads();  // the pieces visible; the staging tiles free
    if (tid == 0 && it + 1 < items) load_kv(it + 1);

    // S = Q.K^T and dP = dO.V^T
    float s[NS], dp[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
    wgmma_fence();
    split_product_ss<DP, S>(s, qdp, kvp);
    if constexpr (C::kDoRegs)
      split_product_rs_k<DP>(dp, dof, kvp + 3 * kSub);
    else
      split_product_ss<DP, S>(dp, qdp + 3 * kFull, kvp + 3 * kSub);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS; entry j: row lr0 + 8 ((j / 2) % 2), key (j / 4) 8 + 2 t + j % 2
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int hi = (j >> 1) & 1;
      const int col = (j >> 2) * 8 + 2 * t + (j & 1);
      float x = s[j] * a.scale_log2;
      bool ok = true;
      if (partial) {
        ok = col < kvalid;
        if constexpr (MASK == kMaskBias) {
          ok = ok && (hi ? r1 : r0) < a.lq;
          x += __bfloat162float(reinterpret_cast<const bf16*>(
                   mk)[(lr0 + 8 * hi) * (S + 8) + col]) *
               kLog2e;
        } else {
          const int* km = reinterpret_cast<const int*>(mk);
          ok = ok && inline_visible(qm[hi], KeyMeta{km[col], km[S + col],
                                                     km[2 * S + col]});
        }
      }
      const float p = ok ? exp2f((x - xr[hi]) - off[hi]) : 0.f;
      s[j] = p * (dp[j] - dl[hi]) * a.scale;
    }
    __syncthreads();  // the mask data free
    if (it + 1 < items) load_mask(it + 1);
    async_commit();

    // dQ += dS.K
    uint32_t fa[3][R][4];
    split_acc<R>(fa, s);
    float gt[NO * 4];
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) gt[i] = 0.f;
    wgmma_fence();
    split_product_rs<DP, R>(gt, fa, kvp);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(gt);
    fence_split_frags(fa);
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) dq[i] += gt[i];
  }
  async_wait<0>();

  float* out = static_cast<float*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int n8 = 0; n8 < NO; ++n8) {
    const int c = n8 * 8 + 2 * t;
    if (n8 * 8 >= head_dim) break;  // the padded dims are not stored
    if (r0 < a.lq)
      *reinterpret_cast<float2*>(out + r0 * a.dq_sl + c) =
          make_float2(dq[4 * n8], dq[4 * n8 + 1]);
    if (r1 < a.lq)
      *reinterpret_cast<float2*>(out + r1 * a.dq_sl + c) =
          make_float2(dq[4 * n8 + 2], dq[4 * n8 + 3]);
  }
}

// delta, dK/dV over the key tiles (in `col_order`, or in turn), dQ over the
// query tiles (in `row_order`, or in turn) at padded head width DP, after
// the tensor maps of Q, dO, K and V; returns the first nonzero
// cudaGetLastError() (0 = all launched), or 100000 + the CUresult of a map
// that failed to encode.
template <int DP, int MASK>
int launch_fp32_bwd(const typename F32BwdArgs<MASK>::T& a,
                    const int* row_order, const int* col_order,
                    cudaStream_t s) {
  using C = BwdCfg<DP, MASK>;
  BwdMaps maps;
  memset(&maps, 0, sizeof(maps));
  for (int sub = 0; sub < 2; ++sub) {
    // 64 rows, then the streamed sub-tiles' (dK/dV's Q, dO; dQ's K, V)
    const int qrows = sub ? C::S : kT, krows = sub ? C::QS : kT;
    const CUresult r[4] = {
        encode_f32_operand(sub ? &maps.q_s : &maps.q, a.q, a.batch, a.heads,
                           a.lq, a.head_dim, a.q_sb, a.q_sh, a.q_sl, qrows),
        encode_f32_operand(sub ? &maps.dout_s : &maps.dout, a.dout, a.batch,
                           a.heads, a.lq, a.head_dim, a.do_sb, a.do_sh,
                           a.do_sl, qrows),
        encode_f32_operand(sub ? &maps.k_s : &maps.k, a.k, a.batch,
                           a.kv_heads, a.lk, a.head_dim, a.k_sb, a.k_sh,
                           a.k_sl, krows),
        encode_f32_operand(sub ? &maps.v_s : &maps.v, a.v, a.batch,
                           a.kv_heads, a.lk, a.head_dim, a.v_sb, a.v_sh,
                           a.v_sl, krows)};
    for (const CUresult x : r)
      if (x != CUDA_SUCCESS) return 100000 + static_cast<int>(x);
  }
  const int nq = (a.lq + kT - 1) / kT;
  const int nk = (a.lk + kT - 1) / kT;
  const long long rows = static_cast<long long>(a.batch) * a.heads * a.lq;
  fp32_bwd_delta_kernel<MASK><<<
      static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps),
      32 * kDeltaWarps, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  int smem = C::dkdv_smem(nq);
  err = cudaFuncSetAttribute(fp32_bwd_dkdv_kernel<DP, MASK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fp32_bwd_dkdv_kernel<DP, MASK>
      <<<dim3(a.batch * nk, a.kv_heads), kKvThreads, smem, s>>>(a, maps,
                                                                 col_order);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  smem = C::dq_smem(nk);
  err = cudaFuncSetAttribute(fp32_bwd_dq_kernel<DP, MASK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fp32_bwd_dq_kernel<DP, MASK>
      <<<dim3(a.batch * nq, a.heads), kDqThreads, smem, s>>>(a, maps,
                                                              row_order);
  return static_cast<int>(cudaGetLastError());
}

template <int MASK>
int launch_fp32_bwd_dp(const typename F32BwdArgs<MASK>::T& a,
                       const int* row_order, const int* col_order,
                       cudaStream_t s) {
  switch (padded_head_dim(a.head_dim)) {
    case 32: return launch_fp32_bwd<32, MASK>(a, row_order, col_order, s);
    case 64: return launch_fp32_bwd<64, MASK>(a, row_order, col_order, s);
    case 96: return launch_fp32_bwd<96, MASK>(a, row_order, col_order, s);
    case 128: return launch_fp32_bwd<128, MASK>(a, row_order, col_order, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace vgt

// K9 at fp32 operands, over the bias's map from vgt_bias_tile_map (the one
// the forward read). Launches on `stream`; returns the first nonzero
// cudaGetLastError() (0 = all launched), or 100000 + the CUresult of a
// tensor map that failed to encode.
extern "C" int vgt_fp32_bias_attention_bwd(const vgt::BiasAttnBwdArgs* a,
                                           void* stream) {
  using namespace vgt;
  return launch_fp32_bwd_dp<kMaskBias>(*a, nullptr, nullptr,
                                       static_cast<cudaStream_t>(stream));
}

// K7 at fp32 operands: the metadata's tile map with its column counts and
// both orders (as K7 builds it), then delta, dK/dV and dQ. Launches on
// `stream`; returns the first nonzero CUDA error, or 100000 + the CUresult
// of a tensor map that failed to encode.
extern "C" int vgt_fp32_inline_attention_bwd(const vgt::InlineAttnBwdArgs* a,
                                             void* stream) {
  using namespace vgt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (padded_head_dim(a->head_dim) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int *row_order, *col_order;
  const int err = launch_inline_bwd_tile_map(*a, s, &row_order, &col_order);
  if (err != 0) return err;
  return launch_fp32_bwd_dp<kMaskInline>(*a, row_order, col_order, s);
}
