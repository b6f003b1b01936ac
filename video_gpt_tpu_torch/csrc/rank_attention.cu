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
// no running max, so no rescale and no cross-tile reduction beyond sums);
// the row sum is taken in fp32 from the unrounded p. GQA: key/value head =
// h / (H / Hkv).
//
// What bounds it on the card: at the flagship shapes (Lq 3552, 1776 cache +
// 3552 tail keys, 32 heads of 96) the work is ~2.3e11 visible-pair FLOPs
// against ~0.11 GB of operands, far above the ~295 FLOP/byte ridge: tensor
// throughput bounds it, and beside it the exp2 of every pair (one per 384
// tensor FLOPs at head_dim 96) and the L2 traffic of re-reading a head's
// K/V for every block of query rows.
//
// Head widths. The kernel is a template on the padded head width DP (32,
// 64, 96 or 128, attention_common.cuh `padded_head_dim`): a tile is DP / 32
// swizzle atoms, and the tensor maps' inner dimension is the true head_dim,
// so TMA fills the head dims past it with zeros (they add 0 to every
// product; the output's are never stored). The scale is head_dim's own. At
// DP 128 a consumer's Q fragments and output take 96 registers, so the block
// has two consumers (128 rows) with more registers each instead of three.
//
// Design (head_dim 96). One block owns 192 query rows of one head (grid:
// query blocks
// fastest, so the blocks that run together share their head's K/V in L2)
// and is four warpgroups: a producer (its registers lowered with
// setmaxnreg) and three consumers of 64 rows each, so that each K/V tile in
// shared memory serves 192 rows. The producer walks the key tiles of both
// operands (64 keys each), loads each tile's ranks and classifies it for
// each consumer from two ranges (tile_map.cuh `rank_tile_class`, exact for
// this mask): a tile that no consumer sees is never loaded; the others go
// into a ring of kRankStages stages, K and V by TMA in wgmma's 64-byte
// swizzle, the ranks and the classes beside them, each stage guarded by
// full/empty mbarriers. A consumer holds
// its Q rows in registers and runs S = Q.K^T (wgmma m64n64k16, Q from
// registers, K from shared memory) and O += P.V (m64nDPk16, P from
// registers, V MN-major) on every tile of the ring, by its class: all
// visible, no compare; some, compare per element; none (a tile that only
// another consumer sees), P = 0. The products overlap
// the softmax: S of a tile is issued with P.V of the previous one, and the
// softmax of the tile runs while that P.V is in flight; the three
// consumers' products and softmaxes interleave on the SM. The row sums stay
// in registers and are quad-reduced once at the end.
#include <cstring>

#include "attention_args.cuh"
#include "tile_map.cuh"

namespace vgt {

constexpr int kRankStages = 3;
// registers a thread (setmaxnreg): the producer few, the consumers the
// rest of the SM's 64K
constexpr int kProducerRegs = 40;

// The shape of a block at padded head width DP.
template <int DP>
struct RankCfg {
  static constexpr int kConsumers = DP > 96 ? 2 : 3;  // warpgroups of 64 rows
  static constexpr int kRows = kRankTile * kConsumers;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kConsumerRegs = kConsumers == 3 ? 152 : 232;
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
                "the block's registers exceed the SM's");
  static constexpr int kTileBytes = kRankTile * DP * 2;   // K or V
  // one stage: K, V (64-byte swizzle), 64 ranks, the meta words (done flag,
  // one class per consumer), padded to keep every stage 1024-byte aligned
  static constexpr int kRanksOff = 2 * kTileBytes;
  static constexpr int kMetaOff = kRanksOff + kRankTile * 4;
  static constexpr int kStageBytes = (kMetaOff + 16 + 1023) / 1024 * 1024;
  static constexpr int kSmem = kRankStages * kStageBytes +
                               2 * kRankStages * 8 + 1024;  // + barriers, align
};

// The tensor maps of the key operands, [operand][K, V].
struct alignas(64) RankMaps {
  CUtensorMap kv[2][2];
};

// The producer warpgroup: classify every key tile for every consumer and
// fill the ring with the tiles that one of them sees; then a stage with the
// done flag. Only warp 0 works.
template <int DP>
__device__ __forceinline__ void rank_producer(const RankAttnArgs& a,
                                              const RankMaps& maps,
                                              unsigned char* smem,
                                              uint64_t* full, uint64_t* empty,
                                              int b, int h, int q0) {
  using C = RankCfg<DP>;
  constexpr int NC = C::kConsumers;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  const int hk = h / (a.heads / a.kv_heads);
  const int* qo = a.qoff + b * a.qoff_sb;
  RankQueryRange qr[NC];
#pragma unroll
  for (int w = 0; w < NC; ++w)
    qr[w] = rank_query_range(qo, q0 + w * kRankTile, a.lq, lane);

  int stage = 0;
  uint32_t phase = 0;
  // wait for the stage to be free
  auto acquire = [&]() -> unsigned char* {
    if (lane == 0) mbar_wait(&empty[stage], phase ^ 1);
    __syncwarp();
    return smem + stage * C::kStageBytes;
  };
  auto advance = [&]() {
    if (++stage == kRankStages) {
      stage = 0;
      phase ^= 1;
    }
  };
  // the key tiles in order: operand 0's, then operand 1's
  auto next = [&](int& op, int& k0) {
    k0 += kRankTile;
    while (op < 2 && k0 >= a.len[op]) {
      ++op;
      k0 = 0;
    }
  };
  auto ranks_of = [&](int op, int k0, int& ra, int& rb) {
    if (op < 2)
      rank_tile_load(a.rank[op] + b * a.rank_sb[op], k0, a.len[op], lane,
                     ra, rb);
  };
  int op = 0, k0 = -kRankTile;
  next(op, k0);
  int ra = kNever, rb = kNever;
  ranks_of(op, k0, ra, rb);
  while (op < 2) {
    int nop = op, nk0 = k0, na = kNever, nb = kNever;
    next(nop, nk0);
    ranks_of(nop, nk0, na, nb);  // the next tile's ranks, in flight
    int8_t cls[NC];
    bool any = false;
#pragma unroll
    for (int w = 0; w < NC; ++w) {
      cls[w] = rank_tile_class(qr[w], ra, rb);
      any = any || cls[w] != kTileEmpty;
    }
    if (any) {
      unsigned char* st = acquire();
      int* rk = reinterpret_cast<int*>(st + C::kRanksOff);
      rk[lane] = ra;
      rk[lane + 32] = rb;
      if (lane == 0) {
        int* meta = reinterpret_cast<int*>(st + C::kMetaOff);
        meta[0] = 0;
#pragma unroll
        for (int w = 0; w < NC; ++w) meta[1 + w] = cls[w];
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_tx(&full[stage], 2 * C::kTileBytes);
#pragma unroll
        for (int at = 0; at < DP / 32; ++at) {
          tma_load_4d(st + at * kSw64Atom, &maps.kv[op][0], &full[stage],
                      32 * at, k0, hk, b);
          tma_load_4d(st + C::kTileBytes + at * kSw64Atom, &maps.kv[op][1],
                      &full[stage], 32 * at, k0, hk, b);
        }
      }
      advance();
    }
    op = nop;
    k0 = nk0;
    ra = na;
    rb = nb;
  }
  unsigned char* st = acquire();
  if (lane == 0) {
    reinterpret_cast<int*>(st + C::kMetaOff)[0] = 1;
    mbar_arrive(&full[stage]);
  }
}

// The probabilities of one S tile (this thread's 32 accumulators), in
// place, their row sums added to l0 / l1. kMask: compare each pair's q_off
// (qo0: row g, qo1: row g + 8) with its key's rank (rk: the tile's 64
// ranks).
template <bool kMask>
__device__ __forceinline__ void rank_probs(float (&s)[32], const int* rk,
                                           int qo0, int qo1, float kscale,
                                           int t, float& l0, float& l1) {
#pragma unroll
  for (int n = 0; n < kRankTile / 8; ++n) {
    int2 rr = make_int2(0, 0);
    if (kMask) rr = *reinterpret_cast<const int2*>(rk + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = ex2_approx(
          fminf(fmaxf(s[4 * n + e] * kscale, -100.f), 100.f));
      if (kMask)
        x = ((e >> 1) ? qo1 : qo0) >= ((e & 1) ? rr.y : rr.x) ? x : 0.f;
      s[4 * n + e] = x;
    }
    l0 += s[4 * n] + s[4 * n + 1];
    l1 += s[4 * n + 2] + s[4 * n + 3];
  }
}

// A consumer warpgroup (wg 0 .. kConsumers - 1: rows q0 + 64 wg ..): drain
// the ring.
template <int DP>
__device__ __forceinline__ void rank_consumer(const RankAttnArgs& a,
                                              unsigned char* smem,
                                              uint64_t* full, uint64_t* empty,
                                              int b, int h, int q0, int wg) {
  using C = RankCfg<DP>;
  constexpr int NO = DP / 8;
  constexpr int KS = DP / 16;
  constexpr int NP = kRankTile / 16;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + wg * kRankTile + warp * 16 + g, r1 = r0 + 8;

  // this thread's Q fragments (the mma.m16n8k16 A layout of the warp's 16
  // rows), zero past Lq and past head_dim, and the two rows' offsets
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e & 1) ? r1 : r0;
      const int c = kk * 16 + 2 * t + (e >> 1) * 8;
      qa[kk][e] = r < a.lq && c < a.head_dim
                      ? *reinterpret_cast<const uint32_t*>(qp + r * a.q_sl + c)
                      : 0u;
    }
  }
  const int* qo = a.qoff + b * a.qoff_sb;
  const int qo0 = r0 < a.lq ? qo[r0] : kNever;
  const int qo1 = r1 < a.lq ? qo[r1] : kNever;

  float o[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) o[i] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  // P of the tile in stage `held`, whose P.V is issued with the next
  // tile's S. Before the first tile P is 0 and its P.V, against any landed
  // V (finite), adds nothing: every product is issued on every path, and
  // no branch of the compiler's view lies between a product and its fence
  uint32_t pa[NP][4];
#pragma unroll
  for (int j = 0; j < NP; ++j) pa[j][0] = pa[j][1] = pa[j][2] = pa[j][3] = 0u;
  int held = -1;
  int stage = 0;
  uint32_t phase = 0;
  // every warp signals once it is done with a stage (4 per consumer)
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  auto issue_pv = [&](int s) {
    const bf16* vt = reinterpret_cast<const bf16*>(
        smem + s * C::kStageBytes + C::kTileBytes);
#pragma unroll
    for (int j = 0; j < NP; ++j) wgmma_pv<DP>(o, pa[j], desc_sw64_mn(vt, j));
    wgmma_commit();
  };
  for (;;) {
    mbar_wait(&full[stage], phase);
    const unsigned char* st = smem + stage * C::kStageBytes;
    const int* meta = reinterpret_cast<const int*>(st + C::kMetaOff);
    // the same words in every thread: broadcast, so that the compiler sees
    // the branches as uniform
    if (__shfl_sync(0xffffffffu, meta[0], 0)) break;
    const int cls = __shfl_sync(0xffffffffu, meta[1 + wg], 0);
    // a tile that only another consumer sees takes the same steps with P =
    // 0: so this consumer holds at most one stage while it waits for the
    // next, and the ring cannot wrap around a stage it holds
    const bf16* kt = reinterpret_cast<const bf16*>(st);
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    // the products' register operands pinned before their fence, so that
    // no copy of theirs lands between the fence and the last wait
    fence_regs(s);
    fence_frags(qa);
    fence_regs(o);
    fence_frags(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_64x64_rs(s, qa[kk], desc_sw64_k(kt, kk), 1);
    wgmma_commit();
    issue_pv(held >= 0 ? held : stage);
    wgmma_wait<1>();  // S has landed; the previous tile's P.V runs on
    fence_regs(s);
    const int* rk = reinterpret_cast<const int*>(st + C::kRanksOff);
    if (cls == kTileFull) {
      rank_probs<false>(s, rk, qo0, qo1, a.kscale, t, l0, l1);
    } else {
      // an empty tile compares against offsets that see no key
      const bool none = cls == kTileEmpty;
      rank_probs<true>(s, rk, none ? kIntMin : qo0, none ? kIntMin : qo1,
                       a.kscale, t, l0, l1);
    }
    wgmma_wait<0>();
    fence_regs(o);
    fence_frags(pa);
    if (held >= 0) release(held);
    // P in bf16 only now, once the P.V that reads the old P is done
#pragma unroll
    for (int j = 0; j < NP; ++j) acc_to_a(pa[j], s + 8 * j);
    held = stage;
    if (++stage == kRankStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // the last tile's P.V; with no tile at all, P is 0 against stage 0's V,
  // which the kernel zeroed before the producer started
  fence_regs(o);
  fence_frags(pa);
  wgmma_fence();
  issue_pv(held >= 0 ? held : 0);
  wgmma_wait<0>();
  fence_regs(o);
  if (held >= 0) release(held);

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  bf16* out = static_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    if (n * 8 >= a.head_dim) break;  // the padded head dims are not stored
    if (r0 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r0 * a.o_sl + c) =
          pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    if (r1 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r1 * a.o_sl + c) =
          pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
}

template <int DP>
__global__ void __launch_bounds__(RankCfg<DP>::kThreads, 1)
    rank_attention_kernel(const __grid_constant__ RankAttnArgs a,
                          const __grid_constant__ RankMaps maps) {
  using C = RankCfg<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kRankStages * C::kStageBytes);
  uint64_t* empty = full + kRankStages;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * C::kRows;
  // stage 0's V, read with P = 0 by a consumer that sees no tile: finite
  for (int i = threadIdx.x; i < C::kTileBytes / 16; i += C::kThreads)
    reinterpret_cast<uint4*>(smem + C::kTileBytes)[i] =
        make_uint4(0u, 0u, 0u, 0u);
  fence_async_shared();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRankStages; ++s) {
      // the producer's one arrival (+ the bytes of its TMA boxes)
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();
  // warp-uniform in the compiler's view (a shuffle), as wgmma wants
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    rank_producer<DP>(a, maps, smem, full, empty, b, h, q0);
  } else {
    setmaxnreg_inc<C::kConsumerRegs>();
    rank_consumer<DP>(a, smem, full, empty, b, h, q0, wg - 1);
  }
}

template <int DP>
int launch_rank(const RankAttnArgs* a, const RankMaps& maps,
                cudaStream_t s) {
  using C = RankCfg<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      rank_attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a->lq + C::kRows - 1) / C::kRows, a->heads, a->batch);
  rank_attention_kernel<DP><<<grid, C::kThreads, C::kSmem, s>>>(*a, maps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vgt

// Launches the attention on `stream`. Returns cudaGetLastError() (0 =
// launched), or 100000 + the CUresult of a tensor map that failed to encode.
extern "C" int vgt_rank_attention(const vgt::RankAttnArgs* a, void* stream) {
  using namespace vgt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = padded_head_dim(a->head_dim);
  if (dp == 0) return static_cast<int>(cudaErrorInvalidValue);
  RankMaps maps;
  memset(&maps, 0, sizeof(maps));
  for (int op = 0; op < 2; ++op) {
    if (a->len[op] == 0) continue;
    for (int kv = 0; kv < 2; ++kv) {
      const CUresult r = encode_operand(
          &maps.kv[op][kv], kv ? a->v[op] : a->k[op], a->batch, a->kv_heads,
          a->len[op], a->head_dim, kv ? a->v_sb[op] : a->k_sb[op],
          kv ? a->v_sh[op] : a->k_sh[op], kv ? a->v_sl[op] : a->k_sl[op]);
      if (r != CUDA_SUCCESS) return 100000 + static_cast<int>(r);
    }
  }
  switch (dp) {
    case 32: return launch_rank<32>(a, maps, s);
    case 64: return launch_rank<64>(a, maps, s);
    case 96: return launch_rank<96>(a, maps, s);
    default: return launch_rank<128>(a, maps, s);
  }
}

// The dynamic shared memory of an attention block at `head_dim`, in bytes
// (0: a head_dim the kernel does not take).
extern "C" int vgt_rank_attention_smem(int head_dim) {
  using namespace vgt;
  switch (padded_head_dim(head_dim)) {
    case 32: return RankCfg<32>::kSmem;
    case 64: return RankCfg<64>::kSmem;
    case 96: return RankCfg<96>::kSmem;
    case 128: return RankCfg<128>::kSmem;
    default: return 0;
  }
}
