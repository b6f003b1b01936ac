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
// q heads of a GQA group summed into their shared kv head. A row that sees
// no key (K6 gives it out 0 and lse -inf) keeps a zero gradient.
//
// What bounds it on the card: at stage 4 (B 1, L 35520, 32 heads of 96)
// 0.261 of the pairs are visible; the five products over them are 10.1
// TFLOP against ~0.4 GB of operands: tensor throughput bounds it (10.2 ms at
// 989 TFLOP/s).
//
// Design, the scheme of K9 (bias_attention_bwd.cu) on K6's tile map. One
// launch sequence per call:
//   1. tile_map.cuh's metadata classifier, as K6 builds it: per-tile
//      summaries of the query and key metadata (O(L)), the class of every
//      (64-row query tile, 64-key tile) pair with each row's and each
//      column's count of non-empty tiles, then the query tiles and the key
//      tiles each ordered by their count, most first. At stage 4 0.301 of
//      the tiles are non-empty (0.211 full); every later query sees the
//      clean prefix, so the columns differ in length far more than the rows
//      do, and the long ones start first;
//   2. delta: di = rowsum(o * do) in fp32 (the TPU computes it in XLA);
//   3. dK/dV (K7b): one block per (b, kv head, 64-key tile), the key tiles
//      in their order. It gathers the non-empty query tiles of its column
//      of the map and walks (q head of the group) x (listed query tile),
//      keeping dK and dV in fp32 registers, so the GQA sum falls out of the
//      loop, as the TPU kernel's revisited f32 output block does, and no
//      atomics are needed. Q and dO stream through a two-stage ring in
//      shared memory filled by cp.async one tile ahead of the products, with
//      the tile's lse and delta beside them and, for partial tiles only, its
//      four query-metadata vectors. S^T = K.Q^T and dP^T = V.dO^T from shared
//      memory (wgmma m64n64k16); dV += P^T.dO and dK += dS^T.Q with P^T,
//      dS^T from registers and dO, Q MN-major (m64n96k16);
//   4. dQ (K7a): one block per (b, head, 64-row query tile), the query
//      tiles in their order, over the non-empty key tiles of its row: K and
//      V (and, for partial tiles only, the three key-metadata vectors)
//      through the ring; S = Q.K^T, dP = dO.V^T (m64n64k16), dQ += dS.K
//      (m64n96k16). It recomputes S and dP (7 products per tile, not 5) to
//      keep dq free of atomics, so the result is deterministic.
// Partial tiles evaluate the rule per element; full tiles skip it, and need
// no bounds check (a full tile lies inside [0, Lq) x [0, Lk)). An empty
// tile holds no visible pair, so skipping it changes no sum. A key tile
// whose column is empty, or a query tile whose row is, still stores its
// zeros: the stores follow the loop. Products are bf16 wgmma with fp32
// accumulation: p and ds are rounded to bf16 before the products that
// consume them (the TPU keeps them in fp32), and dq, dk, dv are written in
// the inputs' dtype from fp32 accumulators.
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
  int8_t* tile_map;   // [B, ceil(Lq/64), ceil(Lk/64)] tile classes (written)
  int* scratch;       // 8 B (nq + nk) + 2 B (nq + nk) ints (written): the
                      // query- and key-tile summaries, the non-empty tiles
                      // of each row and each column, the two launch orders
  int map_only;       // 1: build the tile map and stop
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDeltaWarps = 8;
constexpr int kStages = 2;                  // ring depth of the streamed tiles
constexpr int kTile = kBlockK * kHeadDim;   // one core-matrix tile (elements)

// 2. di = rowsum(o * do): one warp per (b, h, query row).
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

// dK/dV kernel shared memory: K, V, the key tile's metadata; per stage Q,
// dO, the query tile's lse and delta and its four metadata vectors; the
// list of query tiles.
constexpr int kDkdvStage = 2 * kTile * 2 + 2 * kBlockQ * 4 + 4 * kBlockQ * 4;
__host__ __device__ constexpr int dkdv_smem_bytes(int nq) {
  return 2 * kTile * 2 + 3 * kBlockK * 4 + kStages * kDkdvStage + nq * 4;
}

// 3. dK/dV (K7b) of one 64-key tile of one kv head; warp w owns keys
// w*16..+15. Per (q head of the group, non-empty query tile of the map's
// column), the transposed products, rows = keys:
//   S^T = K.Q^T, P^T = exp2(S^T scale_log2 - lse log2e) where visible,
//   dV += P^T.dO, dP^T = V.dO^T, dS^T = P^T (dP^T - di) scale, dK += dS^T.Q
template <int D>
__global__ void __launch_bounds__(kThreads)
    inline_attention_dkdv_kernel(const InlineAttnBwdArgs a, const int* order) {
  static_assert(D == kHeadDim, "tiles are laid out for kHeadDim");
  static_assert(kBlockQ == kBlockK, "Q and K tiles share kTile");
  constexpr int NO = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile;
  int* kmeta = reinterpret_cast<int*>(vs + kTile);  // [3][64]
  unsigned char* stages = reinterpret_cast<unsigned char*>(kmeta + 3 * kBlockK);
  int* list = reinterpret_cast<int*>(stages + kStages * kDkdvStage);

  const int nq = (a.lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a.lk + kBlockK - 1) / kBlockK;
  const int item = order[blockIdx.x];
  const int b = item / nk, kt = item % nk, k0 = kt * kBlockK;
  const int hk = blockIdx.y, group = a.heads / a.kv_heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kvalid = min(kBlockK, a.lk - k0);

  async_copy_tile<kBlockK, kThreads>(
      ks, static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh +
              k0 * a.k_sl, a.k_sl, kvalid, tid);
  async_copy_tile<kBlockK, kThreads>(
      vs, static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh +
              k0 * a.v_sl, a.v_sl, kvalid, tid);
  for (int c = tid; c < 3 * kBlockK; c += kThreads) {
    const int m = c / kBlockK, j = c % kBlockK;
    const bool ok = j < kvalid;
    async_copy4(kmeta + c, a.km[m] + b * a.km_sb[m] + (ok ? k0 + j : 0), ok);
  }
  async_commit();
  const int n = gather_tiles(
      a.tile_map + static_cast<long long>(b) * nq * nk + kt, nk, nq, list);
  const int pairs = n * group;  // (q head, query tile), head-major

  auto stage = [&](int st, bf16*& qs, bf16*& dos, float*& lse, float*& dl,
                   int*& qmeta) {
    unsigned char* p = stages + st * kDkdvStage;
    qs = reinterpret_cast<bf16*>(p);
    dos = qs + kTile;
    lse = reinterpret_cast<float*>(dos + kTile);
    dl = lse + kBlockQ;
    qmeta = reinterpret_cast<int*>(dl + kBlockQ);  // [4][64]
  };
  auto prefetch = [&](int i) {
    bf16 *qs, *dos;
    float *lse, *dl;
    int* qmeta;
    stage(i % kStages, qs, dos, lse, dl, qmeta);
    const int e = list[i % n], q0 = (e >> 2) * kBlockQ;
    const int h = hk * group + i / n;
    const int qvalid = min(kBlockQ, a.lq - q0);
    async_copy_tile<kBlockQ, kThreads>(
        qs, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
                q0 * a.q_sl, a.q_sl, qvalid, tid);
    async_copy_tile<kBlockQ, kThreads>(
        dos, static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh +
                 q0 * a.do_sl, a.do_sl, qvalid, tid);
    const long long row0 =
        (static_cast<long long>(b) * a.heads + h) * a.lq + q0;
    for (int c = tid; c < 2 * kBlockQ; c += kThreads) {
      const int r = c % kBlockQ;
      const bool ok = r < qvalid;
      const float* src = c < kBlockQ ? a.lse : a.delta;
      async_copy4(lse + c, src + (ok ? row0 + r : 0), ok);
    }
    if ((e & 3) == kTilePartial) {
      for (int c = tid; c < 4 * kBlockQ; c += kThreads) {
        const int m = c / kBlockQ, j = c % kBlockQ;
        const bool ok = j < qvalid;
        async_copy4(qmeta + c, a.qm[m] + b * a.qm_sb[m] + (ok ? q0 + j : 0),
                    ok);
      }
    }
  };
  for (int p = 0; p < kStages - 1; ++p) {  // the ring's first tiles
    if (p < pairs) prefetch(p);
    async_commit();
  }

  const int kr0 = warp * 16 + g, kr1 = kr0 + 8;  // this thread's key rows
  float dk[NO * 4], dv[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) dk[i] = dv[i] = 0.f;

  for (int i = 0; i < pairs; ++i) {
    if (i + kStages - 1 < pairs) prefetch(i + kStages - 1);
    async_commit();
    async_wait<kStages - 1>();
    fence_async_shared();
    __syncthreads();
    bf16 *qs, *dos;
    float *lse, *dl;
    int* qmeta;
    stage(i % kStages, qs, dos, lse, dl, qmeta);
    const int e = list[i % n], q0 = (e >> 2) * kBlockQ;

    float st[32], dpt[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_64x64_ss(st, desc_k_major(ks, kk), desc_k_major(qs, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_64x64_ss(dpt, desc_k_major(vs, kk), desc_k_major(dos, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T; in a partial tile masked pairs, queries past Lq and
    // keys past Lk weigh nothing (a full tile is visible and inside both)
    const bool partial = (e & 3) == kTilePartial;
    const int qvalid = min(kBlockQ, a.lq - q0);
    KeyMeta km0{}, km1{};
    if (partial) {
      km0 = KeyMeta{kmeta[kr0], kmeta[kBlockK + kr0], kmeta[2 * kBlockK + kr0]};
      km1 = KeyMeta{kmeta[kr1], kmeta[kBlockK + kr1], kmeta[2 * kBlockK + kr1]};
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int hi = (j >> 1) & 1;  // 0: key row kr0, 1: kr1
      const int qc = (j >> 2) * 8 + 2 * t + (j & 1);
      bool ok = true;
      if (partial) {
        const QueryMeta qm{qmeta[qc], qmeta[kBlockQ + qc],
                           qmeta[2 * kBlockQ + qc], qmeta[3 * kBlockQ + qc]};
        ok = (hi ? kr1 : kr0) < kvalid && qc < qvalid &&
             inline_visible(qm, hi ? km1 : km0);
      }
      const float p =
          ok ? exp2f(st[j] * a.scale_log2 - lse[qc] * kLog2e) : 0.f;
      st[j] = p;
      dpt[j] = p * (dpt[j] - dl[qc]) * a.scale;
    }
    uint32_t pa[kBlockQ / 16][4], da[kBlockQ / 16][4];
#pragma unroll
    for (int j = 0; j < kBlockQ / 16; ++j) {
      acc_to_a(pa[j], st + 8 * j);
      acc_to_a(da[j], dpt + 8 * j);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBlockQ / 16; ++j)
      wgmma_64x96_rs(dv, pa[j], desc_mn_major(dos, j));
#pragma unroll
    for (int j = 0; j < kBlockQ / 16; ++j)
      wgmma_64x96_rs(dk, da[j], desc_mn_major(qs, j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // every warp is done with this stage before its refill
  }
  async_wait<0>();

  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.dkv_sb + hk * a.dkv_sh;
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.dkv_sb + hk * a.dkv_sh;
#pragma unroll
  for (int n8 = 0; n8 < NO; ++n8) {
    const int c = n8 * 8 + 2 * t;
    if (kr0 < kvalid) {
      const long long off = (k0 + kr0) * a.dkv_sl + c;
      *reinterpret_cast<uint32_t*>(dkp + off) =
          pack_bf16(dk[4 * n8], dk[4 * n8 + 1]);
      *reinterpret_cast<uint32_t*>(dvp + off) =
          pack_bf16(dv[4 * n8], dv[4 * n8 + 1]);
    }
    if (kr1 < kvalid) {
      const long long off = (k0 + kr1) * a.dkv_sl + c;
      *reinterpret_cast<uint32_t*>(dkp + off) =
          pack_bf16(dk[4 * n8 + 2], dk[4 * n8 + 3]);
      *reinterpret_cast<uint32_t*>(dvp + off) =
          pack_bf16(dv[4 * n8 + 2], dv[4 * n8 + 3]);
    }
  }
}

// dQ kernel shared memory: Q, dO; per stage K, V and the key tile's three
// metadata vectors; the list of key tiles.
constexpr int kDqStage = 2 * kTile * 2 + 3 * kBlockK * 4;
__host__ __device__ constexpr int dq_smem_bytes(int nk) {
  return 2 * kTile * 2 + kStages * kDqStage + nk * 4;
}

// 4. dQ (K7a) of one 64-row query tile of one head; warp w owns rows
// w*16..+15; the non-empty key tiles of the map's row stream through the
// ring:
//   S = Q.K^T, P = exp2(S scale_log2 - lse log2e) where visible,
//   dP = dO.V^T, dS = P (dP - di) scale, dQ += dS.K
template <int D>
__global__ void __launch_bounds__(kThreads)
    inline_attention_dq_kernel(const InlineAttnBwdArgs a, const int* order) {
  static_assert(D == kHeadDim, "tiles are laid out for kHeadDim");
  constexpr int NO = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kTile;
  unsigned char* stages = smem + 2 * kTile * 2;
  int* list = reinterpret_cast<int*>(stages + kStages * kDqStage);

  const int nq = (a.lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a.lk + kBlockK - 1) / kBlockK;
  const int item = order[blockIdx.x];
  const int b = item / nq, qt = item % nq, q0 = qt * kBlockQ;
  const int h = blockIdx.y, hk = h / (a.heads / a.kv_heads);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qvalid = min(kBlockQ, a.lq - q0);

  async_copy_tile<kBlockQ, kThreads>(
      qs, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
              q0 * a.q_sl, a.q_sl, qvalid, tid);
  async_copy_tile<kBlockQ, kThreads>(
      dos, static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh +
               q0 * a.do_sl, a.do_sl, qvalid, tid);
  async_commit();
  const int n = gather_tiles(
      a.tile_map + (static_cast<long long>(b) * nq + qt) * nk, 1, nk, list);

  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  auto prefetch = [&](int i) {
    bf16* kt = reinterpret_cast<bf16*>(stages + (i % kStages) * kDqStage);
    const int e = list[i], k0 = (e >> 2) * kBlockK;
    const int valid = min(kBlockK, a.lk - k0);
    async_copy_tile<kBlockK, kThreads>(kt, kp + k0 * a.k_sl, a.k_sl, valid,
                                       tid);
    async_copy_tile<kBlockK, kThreads>(kt + kTile, vp + k0 * a.v_sl, a.v_sl,
                                       valid, tid);
    if ((e & 3) == kTilePartial) {
      int* kmeta = reinterpret_cast<int*>(kt + 2 * kTile);
      for (int c = tid; c < 3 * kBlockK; c += kThreads) {
        const int m = c / kBlockK, j = c % kBlockK;
        const bool ok = j < valid;
        async_copy4(kmeta + c, a.km[m] + b * a.km_sb[m] + (ok ? k0 + j : 0),
                    ok);
      }
    }
  };
  for (int p = 0; p < kStages - 1; ++p) {  // the ring's first tiles
    if (p < n) prefetch(p);
    async_commit();
  }

  // this thread's rows r0 / r1: their metadata, di and lse (log2 units)
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const long long row0 = (static_cast<long long>(b) * a.heads + h) * a.lq;
  const QueryMeta qm0 = query_meta(a.qm, a.qm_sb, b, r0, a.lq);
  const QueryMeta qm1 = query_meta(a.qm, a.qm_sb, b, r1, a.lq);
  const float dl[2] = {r0 < a.lq ? a.delta[row0 + r0] : 0.f,
                       r1 < a.lq ? a.delta[row0 + r1] : 0.f};
  const float ls[2] = {r0 < a.lq ? a.lse[row0 + r0] * kLog2e : 0.f,
                       r1 < a.lq ? a.lse[row0 + r1] * kLog2e : 0.f};

  float dq[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) dq[i] = 0.f;

  for (int i = 0; i < n; ++i) {
    if (i + kStages - 1 < n) prefetch(i + kStages - 1);
    async_commit();
    async_wait<kStages - 1>();
    fence_async_shared();
    __syncthreads();
    const bf16* kt = reinterpret_cast<const bf16*>(stages +
                                                   (i % kStages) * kDqStage);
    const bf16* vt = kt + kTile;
    const int* kmeta = reinterpret_cast<const int*>(kt + 2 * kTile);
    const int e = list[i], k0 = (e >> 2) * kBlockK;

    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_64x64_ss(s, desc_k_major(qs, kk), desc_k_major(kt, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_64x64_ss(dp, desc_k_major(dos, kk), desc_k_major(vt, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS; in a partial tile masked pairs and keys past Lk weigh nothing
    // (a row past Lq sees no key); a full tile is visible and inside both
    const bool partial = (e & 3) == kTilePartial;
    const int kvalid = min(kBlockK, a.lk - k0);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int hi = (j >> 1) & 1;  // 0: row r0, 1: row r1
      const int col = (j >> 2) * 8 + 2 * t + (j & 1);
      bool ok = true;
      if (partial) {
        const KeyMeta km{kmeta[col], kmeta[kBlockK + col],
                         kmeta[2 * kBlockK + col]};
        ok = col < kvalid && inline_visible(hi ? qm1 : qm0, km);
      }
      const float p = ok ? exp2f(s[j] * a.scale_log2 - ls[hi]) : 0.f;
      s[j] = p * (dp[j] - dl[hi]) * a.scale;
    }
    uint32_t da[kBlockK / 16][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) acc_to_a(da[j], s + 8 * j);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j)
      wgmma_64x96_rs(dq, da[j], desc_mn_major(kt, j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncthreads();
  }
  async_wait<0>();

  bf16* out = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int n8 = 0; n8 < NO; ++n8) {
    const int c = n8 * 8 + 2 * t;
    if (r0 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r0 * a.dq_sl + c) =
          pack_bf16(dq[4 * n8], dq[4 * n8 + 1]);
    if (r1 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r1 * a.dq_sl + c) =
          pack_bf16(dq[4 * n8 + 2], dq[4 * n8 + 3]);
  }
}

}  // namespace vgt

// Launches on `stream`: the tile map (summaries, classes with the row and
// column counts, the two orders), then, unless map_only, delta, dK/dV and
// dQ; returns the first nonzero CUDA error (0 = all launched).
extern "C" int vgt_inline_attention_bwd(const vgt::InlineAttnBwdArgs* a,
                                        void* stream) {
  using namespace vgt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->head_dim != kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  const int nq = (a->lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a->lk + kBlockK - 1) / kBlockK;
  const long long bq = static_cast<long long>(a->batch) * nq;
  const long long bk = static_cast<long long>(a->batch) * nk;
  QuerySummary* qsum = reinterpret_cast<QuerySummary*>(a->scratch);
  KeySummary* ksum = reinterpret_cast<KeySummary*>(qsum + bq);
  int* row_counts = reinterpret_cast<int*>(ksum + bk);
  int* col_counts = row_counts + bq;
  int* row_order = col_counts + bk;
  int* col_order = row_order + bq;

  cudaError_t err = cudaMemsetAsync(col_counts, 0, bk * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_summary_kernel<kBlockQ, kBlockK, InlineAttnBwdArgs>
      <<<static_cast<unsigned>((bq + bk + kSummaryWarps - 1) / kSummaryWarps),
         32 * kSummaryWarps, 0, s>>>(*a, qsum, ksum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  meta_tile_map_kernel<kBlockQ, kBlockK>
      <<<dim3(nq, a->batch), kMapThreads, 0, s>>>(
          qsum, ksum, a->lq, a->lk, a->tile_map, row_counts, col_counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int order_smem = ((nq > nk ? nq : nk) + 1) *
                         static_cast<int>(sizeof(int));
  err = cudaFuncSetAttribute(tile_order_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             order_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_order_kernel<<<1, kOrderThreads, order_smem, s>>>(
      row_counts, static_cast<int>(bq), nk, row_order);
  tile_order_kernel<<<1, kOrderThreads, order_smem, s>>>(
      col_counts, static_cast<int>(bk), nq, col_order);
  err = cudaGetLastError();
  if (err != cudaSuccess || a->map_only) return static_cast<int>(err);

  const long long rows = static_cast<long long>(a->batch) * a->heads * a->lq;
  inline_attention_delta_kernel<<<
      static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps),
      32 * kDeltaWarps, 0, s>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  int smem = dkdv_smem_bytes(nq);
  err = cudaFuncSetAttribute(inline_attention_dkdv_kernel<kHeadDim>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  inline_attention_dkdv_kernel<kHeadDim>
      <<<dim3(static_cast<unsigned>(bk), a->kv_heads), kThreads, smem, s>>>(
          *a, col_order);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  smem = dq_smem_bytes(nk);
  err = cudaFuncSetAttribute(inline_attention_dq_kernel<kHeadDim>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  inline_attention_dq_kernel<kHeadDim>
      <<<dim3(static_cast<unsigned>(bq), a->heads), kThreads, smem, s>>>(
          *a, row_order);
  return static_cast<int>(cudaGetLastError());
}
