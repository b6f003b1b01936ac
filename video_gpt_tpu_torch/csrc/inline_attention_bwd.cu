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
// Head widths: the dK/dV and dQ kernels are templates on the padded head
// width DP (32, 64, 96 or 128), as K9's are (bias_attention_bwd.cu): the
// tiles, the core-matrix layout and the wgmma extents follow DP, the head
// dims past head_dim are zero-filled by cp.async and never stored, head_dim
// 96 runs an instance without those checks, and at DP 128 the dK/dV kernel
// runs two warpgroups, one accumulating dV and one dK.
// Partial tiles evaluate the rule per element; full tiles skip it, and need
// no bounds check (a full tile lies inside [0, Lq) x [0, Lk)). An empty
// tile holds no visible pair, so skipping it changes no sum. A key tile
// whose column is empty, or a query tile whose row is, still stores its
// zeros: the stores follow the loop. Products are bf16 wgmma with fp32
// accumulation: p and ds are rounded to bf16 before the products that
// consume them (the TPU keeps them in fp32), and dq, dk, dv are written in
// the inputs' dtype from fp32 accumulators.
#include <math_constants.h>

#include "attention_args.cuh"
#include "inline_mask.cuh"

namespace vgt {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDeltaWarps = 8;
constexpr int kStages = 2;                  // ring depth of the streamed tiles
// one core-matrix tile at padded head width DP (elements)
template <int DP>
__host__ __device__ constexpr int bwd_tile() {
  return kBlockK * DP;
}
// the dK/dV kernel's warpgroups: two at DP 128, one owning dV and one dK
template <int DP>
__host__ __device__ constexpr bool dkdv_split() {
  return DP > 96;
}

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

// The metadata vectors a key tile and a query tile carry: three and four,
// and under a window (kWin) the positions besides.
template <bool kWin>
__host__ __device__ constexpr int key_vecs() {
  return kWin ? 4 : 3;
}
template <bool kWin>
__host__ __device__ constexpr int query_vecs() {
  return kWin ? 5 : 4;
}

// Row b of key metadata vector m (3: the positions) and of query metadata
// vector m (4: the positions).
template <bool kWin>
__device__ __forceinline__ const int* key_vec(const InlineAttnBwdArgs& a,
                                              int m, int b) {
  if constexpr (kWin)
    if (m == 3) return a.kpos + b * a.kpos_sb;
  return a.km[m] + b * a.km_sb[m];
}
template <bool kWin>
__device__ __forceinline__ const int* query_vec(const InlineAttnBwdArgs& a,
                                                int m, int b) {
  if constexpr (kWin)
    if (m == 4) return a.qpos + b * a.qpos_sb;
  return a.qm[m] + b * a.qm_sb[m];
}

// dK/dV kernel shared memory: K, V, the key tile's metadata; per stage Q,
// dO, the query tile's lse and delta and its metadata vectors; the list of
// query tiles.
template <int DP, bool kWin>
__host__ __device__ constexpr int dkdv_stage() {
  return 2 * bwd_tile<DP>() * 2 + 2 * kBlockQ * 4 +
         query_vecs<kWin>() * kBlockQ * 4;
}
template <int DP, bool kWin>
__host__ __device__ constexpr int dkdv_smem_bytes(int nq) {
  return 2 * bwd_tile<DP>() * 2 + key_vecs<kWin>() * kBlockK * 4 +
         kStages * dkdv_stage<DP, kWin>() + nq * 4;
}

// 3. dK/dV (K7b) of one 64-key tile of one kv head; warp w (of a
// warpgroup) owns keys w*16..+15. Per (q head of the group, non-empty query
// tile of the map's column), the transposed products, rows = keys:
//   S^T = K.Q^T, P^T = exp2(S^T scale_log2 - lse log2e) where visible,
//   dV += P^T.dO, dP^T = V.dO^T, dS^T = P^T (dP^T - di) scale, dK += dS^T.Q
// At padded head width DP; kPadded: head_dim < DP; kWin: under a window.
template <int DP, bool kPadded, bool kWin>
__global__ void __launch_bounds__(dkdv_split<DP>() ? 2 * kThreads : kThreads)
    inline_attention_dkdv_kernel(const InlineAttnBwdArgs a, const int* order) {
  static_assert(kBlockQ == kBlockK, "Q and K tiles share kTile");
  constexpr bool kSplit = dkdv_split<DP>();
  constexpr int NT = kSplit ? 2 * kThreads : kThreads;
  constexpr int NO = DP / 8;
  constexpr int NK = key_vecs<kWin>(), NQ = query_vecs<kWin>();
  constexpr int kTile = bwd_tile<DP>();
  constexpr int kDkdvStage = dkdv_stage<DP, kWin>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile;
  int* kmeta = reinterpret_cast<int*>(vs + kTile);  // [NK][64]
  unsigned char* stages = reinterpret_cast<unsigned char*>(kmeta + NK * kBlockK);
  int* list = reinterpret_cast<int*>(stages + kStages * kDkdvStage);

  const int nq = (a.lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a.lk + kBlockK - 1) / kBlockK;
  const int item = order[blockIdx.x];
  const int b = item / nk, kt = item % nk, k0 = kt * kBlockK;
  const int hk = blockIdx.y, group = a.heads / a.kv_heads;
  // kSplit: warpgroup 0 accumulates dV, warpgroup 1 dK
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = kSplit ? (tid >> 5) & 3 : tid >> 5;
  const int wg = kSplit ? tid >> 7 : 0;
  const int g = lane >> 2, t = lane & 3;
  const int kvalid = min(kBlockK, a.lk - k0);

  async_copy_tile_dp<kBlockK, NT, DP, kPadded>(
      ks, static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh +
              k0 * a.k_sl, a.k_sl, kvalid, a.head_dim, tid);
  async_copy_tile_dp<kBlockK, NT, DP, kPadded>(
      vs, static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh +
              k0 * a.v_sl, a.v_sl, kvalid, a.head_dim, tid);
  for (int c = tid; c < NK * kBlockK; c += NT) {
    const int m = c / kBlockK, j = c % kBlockK;
    const bool ok = j < kvalid;
    async_copy4(kmeta + c, key_vec<kWin>(a, m, b) + (ok ? k0 + j : 0), ok);
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
    qmeta = reinterpret_cast<int*>(dl + kBlockQ);  // [NQ][64]
  };
  auto prefetch = [&](int i) {
    bf16 *qs, *dos;
    float *lse, *dl;
    int* qmeta;
    stage(i % kStages, qs, dos, lse, dl, qmeta);
    const int e = list[i % n], q0 = (e >> 2) * kBlockQ;
    const int h = hk * group + i / n;
    const int qvalid = min(kBlockQ, a.lq - q0);
    async_copy_tile_dp<kBlockQ, NT, DP, kPadded>(
        qs, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
                q0 * a.q_sl, a.q_sl, qvalid, a.head_dim, tid);
    async_copy_tile_dp<kBlockQ, NT, DP, kPadded>(
        dos, static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh +
                 q0 * a.do_sl, a.do_sl, qvalid, a.head_dim, tid);
    const long long row0 =
        (static_cast<long long>(b) * a.heads + h) * a.lq + q0;
    for (int c = tid; c < 2 * kBlockQ; c += NT) {
      const int r = c % kBlockQ;
      const bool ok = r < qvalid;
      const float* src = c < kBlockQ ? a.lse : a.delta;
      async_copy4(lse + c, src + (ok ? row0 + r : 0), ok);
    }
    if ((e & 3) == kTilePartial) {
      for (int c = tid; c < NQ * kBlockQ; c += NT) {
        const int m = c / kBlockQ, j = c % kBlockQ;
        const bool ok = j < qvalid;
        async_copy4(qmeta + c, query_vec<kWin>(a, m, b) + (ok ? q0 + j : 0),
                    ok);
      }
    }
  };
  for (int p = 0; p < kStages - 1; ++p) {  // the ring's first tiles
    if (p < pairs) prefetch(p);
    async_commit();
  }

  const int kr0 = warp * 16 + g, kr1 = kr0 + 8;  // this thread's key rows
  // kSplit: one accumulator a thread, dV (warpgroup 0) or dK (1)
  float dk[kSplit ? 1 : NO * 4], dv[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) dv[i] = 0.f;
  if constexpr (!kSplit) {
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) dk[i] = 0.f;
  }

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
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_64x64_ss(st, desc_k_major_dp<DP>(ks, kk),
                     desc_k_major_dp<DP>(qs, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_64x64_ss(dpt, desc_k_major_dp<DP>(vs, kk),
                     desc_k_major_dp<DP>(dos, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T; in a partial tile masked pairs, queries past Lq and
    // keys past Lk weigh nothing (a full tile is visible and inside both)
    const bool partial = (e & 3) == kTilePartial;
    const int qvalid = min(kBlockQ, a.lq - q0);
    KeyMeta km0{}, km1{};
    int kp0 = 0, kp1 = 0;
    if (partial) {
      km0 = KeyMeta{kmeta[kr0], kmeta[kBlockK + kr0], kmeta[2 * kBlockK + kr0]};
      km1 = KeyMeta{kmeta[kr1], kmeta[kBlockK + kr1], kmeta[2 * kBlockK + kr1]};
      if constexpr (kWin) {
        kp0 = kmeta[3 * kBlockK + kr0];
        kp1 = kmeta[3 * kBlockK + kr1];
      }
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
             inline_visible<kWin>(qm, hi ? km1 : km0,
                                  kWin ? qmeta[4 * kBlockQ + qc] : 0,
                                  hi ? kp1 : kp0, a.window);
      }
      const float p =
          ok ? exp2f(st[j] * a.scale_log2 - lse[qc] * kLog2e) : 0.f;
      st[j] = p;
      dpt[j] = p * (dpt[j] - dl[qc]) * a.scale;
    }
    if constexpr (kSplit) {
      // the A operand of this warpgroup's product: P^T (dV) or dS^T (dK),
      // against dO or Q
#pragma unroll
      for (int j = 0; j < 32; ++j) st[j] = wg ? dpt[j] : st[j];
      uint32_t fa[kBlockQ / 16][4];
#pragma unroll
      for (int j = 0; j < kBlockQ / 16; ++j) acc_to_a(fa[j], st + 8 * j);
      const bf16* bt = wg ? qs : dos;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBlockQ / 16; ++j)
        wgmma_pv<DP>(dv, fa[j], desc_mn_major_dp<DP>(bt, j));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
    } else {
      uint32_t pa[kBlockQ / 16][4], da[kBlockQ / 16][4];
#pragma unroll
      for (int j = 0; j < kBlockQ / 16; ++j) {
        acc_to_a(pa[j], st + 8 * j);
        acc_to_a(da[j], dpt + 8 * j);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBlockQ / 16; ++j)
        wgmma_pv<DP>(dv, pa[j], desc_mn_major_dp<DP>(dos, j));
#pragma unroll
      for (int j = 0; j < kBlockQ / 16; ++j)
        wgmma_pv<DP>(dk, da[j], desc_mn_major_dp<DP>(qs, j));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  async_wait<0>();

  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.dkv_sb + hk * a.dkv_sh;
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.dkv_sb + hk * a.dkv_sh;
  if constexpr (kSplit) {
    bf16* out = wg ? dkp : dvp;
#pragma unroll
    for (int n8 = 0; n8 < NO; ++n8) {
      const int c = n8 * 8 + 2 * t;
      if (kPadded && n8 * 8 >= a.head_dim) break;  // padded dims: not stored
      if (kr0 < kvalid)
        *reinterpret_cast<uint32_t*>(out + (k0 + kr0) * a.dkv_sl + c) =
            pack_bf16(dv[4 * n8], dv[4 * n8 + 1]);
      if (kr1 < kvalid)
        *reinterpret_cast<uint32_t*>(out + (k0 + kr1) * a.dkv_sl + c) =
            pack_bf16(dv[4 * n8 + 2], dv[4 * n8 + 3]);
    }
  } else {
#pragma unroll
    for (int n8 = 0; n8 < NO; ++n8) {
      const int c = n8 * 8 + 2 * t;
      if (kPadded && n8 * 8 >= a.head_dim) break;  // padded dims: not stored
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
}

// dQ kernel shared memory: Q, dO; per stage K, V and the key tile's
// metadata vectors; the list of key tiles.
template <int DP, bool kWin>
__host__ __device__ constexpr int dq_stage() {
  return 2 * bwd_tile<DP>() * 2 + key_vecs<kWin>() * kBlockK * 4;
}
template <int DP, bool kWin>
__host__ __device__ constexpr int dq_smem_bytes(int nk) {
  return 2 * bwd_tile<DP>() * 2 + kStages * dq_stage<DP, kWin>() + nk * 4;
}

// 4. dQ (K7a) of one 64-row query tile of one head; warp w owns rows
// w*16..+15; the non-empty key tiles of the map's row stream through the
// ring:
//   S = Q.K^T, P = exp2(S scale_log2 - lse log2e) where visible,
//   dP = dO.V^T, dS = P (dP - di) scale, dQ += dS.K
template <int DP, bool kPadded, bool kWin>
__global__ void __launch_bounds__(kThreads)
    inline_attention_dq_kernel(const InlineAttnBwdArgs a, const int* order) {
  constexpr int NO = DP / 8;
  constexpr int NK = key_vecs<kWin>();
  constexpr int kTile = bwd_tile<DP>();
  constexpr int kDqStage = dq_stage<DP, kWin>();
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

  async_copy_tile_dp<kBlockQ, kThreads, DP, kPadded>(
      qs, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
              q0 * a.q_sl, a.q_sl, qvalid, a.head_dim, tid);
  async_copy_tile_dp<kBlockQ, kThreads, DP, kPadded>(
      dos, static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh +
               q0 * a.do_sl, a.do_sl, qvalid, a.head_dim, tid);
  async_commit();
  const int n = gather_tiles(
      a.tile_map + (static_cast<long long>(b) * nq + qt) * nk, 1, nk, list);

  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  auto prefetch = [&](int i) {
    bf16* kt = reinterpret_cast<bf16*>(stages + (i % kStages) * kDqStage);
    const int e = list[i], k0 = (e >> 2) * kBlockK;
    const int valid = min(kBlockK, a.lk - k0);
    async_copy_tile_dp<kBlockK, kThreads, DP, kPadded>(
        kt, kp + k0 * a.k_sl, a.k_sl, valid, a.head_dim, tid);
    async_copy_tile_dp<kBlockK, kThreads, DP, kPadded>(
        kt + kTile, vp + k0 * a.v_sl, a.v_sl, valid, a.head_dim, tid);
    if ((e & 3) == kTilePartial) {
      int* kmeta = reinterpret_cast<int*>(kt + 2 * kTile);
      for (int c = tid; c < NK * kBlockK; c += kThreads) {
        const int m = c / kBlockK, j = c % kBlockK;
        const bool ok = j < valid;
        async_copy4(kmeta + c, key_vec<kWin>(a, m, b) + (ok ? k0 + j : 0),
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
  int qp[2] = {0, 0};  // the rows' positions, under a window
  if constexpr (kWin) {
    qp[0] = token_pos(a.qpos, a.qpos_sb, b, r0, a.lq);
    qp[1] = token_pos(a.qpos, a.qpos_sb, b, r1, a.lq);
  }
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
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_64x64_ss(s, desc_k_major_dp<DP>(qs, kk),
                     desc_k_major_dp<DP>(kt, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_64x64_ss(dp, desc_k_major_dp<DP>(dos, kk),
                     desc_k_major_dp<DP>(vt, kk), 1);
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
        ok = col < kvalid &&
             inline_visible<kWin>(hi ? qm1 : qm0, km, qp[hi],
                                  kWin ? kmeta[3 * kBlockK + col] : 0,
                                  a.window);
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
      wgmma_pv<DP>(dq, da[j], desc_mn_major_dp<DP>(kt, j));
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
    if (kPadded && n8 * 8 >= a.head_dim) break;  // padded dims: not stored
    if (r0 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r0 * a.dq_sl + c) =
          pack_bf16(dq[4 * n8], dq[4 * n8 + 1]);
    if (r1 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r1 * a.dq_sl + c) =
          pack_bf16(dq[4 * n8 + 2], dq[4 * n8 + 3]);
  }
}

// dK/dV over the key tiles in `col_order`, then dQ over the query tiles in
// `row_order`, at padded head width DP; returns the first nonzero
// cudaGetLastError() (0 = both launched).
template <int DP, bool kPadded, bool kWin>
int launch_inline_bwd_w(const InlineAttnBwdArgs* a, const int* row_order,
                        const int* col_order, cudaStream_t s) {
  const long long bq = static_cast<long long>(a->batch) *
                       ((a->lq + kBlockQ - 1) / kBlockQ);
  const long long bk = static_cast<long long>(a->batch) *
                       ((a->lk + kBlockK - 1) / kBlockK);
  int smem = dkdv_smem_bytes<DP, kWin>((a->lq + kBlockQ - 1) / kBlockQ);
  cudaError_t err = cudaFuncSetAttribute(
      inline_attention_dkdv_kernel<DP, kPadded, kWin>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  inline_attention_dkdv_kernel<DP, kPadded, kWin>
      <<<dim3(static_cast<unsigned>(bk), a->kv_heads),
         dkdv_split<DP>() ? 2 * kThreads : kThreads, smem, s>>>(*a,
                                                               col_order);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  smem = dq_smem_bytes<DP, kWin>((a->lk + kBlockK - 1) / kBlockK);
  err = cudaFuncSetAttribute(inline_attention_dq_kernel<DP, kPadded, kWin>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  inline_attention_dq_kernel<DP, kPadded, kWin>
      <<<dim3(static_cast<unsigned>(bq), a->heads), kThreads, smem, s>>>(
          *a, row_order);
  return static_cast<int>(cudaGetLastError());
}

// The windowless instances (every launch but a sliding layer's) and the
// windowed ones.
template <int DP, bool kPadded>
int launch_inline_bwd(const InlineAttnBwdArgs* a, const int* row_order,
                      const int* col_order, cudaStream_t s) {
  return a->window > 0
             ? launch_inline_bwd_w<DP, kPadded, true>(a, row_order, col_order,
                                                      s)
             : launch_inline_bwd_w<DP, kPadded, false>(a, row_order,
                                                       col_order, s);
}

}  // namespace vgt

// Launches on `stream`: the tile map (summaries, classes with the row and
// column counts, the two orders), then, unless map_only, delta, dK/dV and
// dQ; returns the first nonzero CUDA error (0 = all launched).
extern "C" int vgt_inline_attention_bwd(const vgt::InlineAttnBwdArgs* a,
                                        void* stream) {
  using namespace vgt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = padded_head_dim(a->head_dim);
  if (dp == 0 && !a->map_only) return static_cast<int>(cudaErrorInvalidValue);
  const int *row_order, *col_order;
  cudaError_t err = static_cast<cudaError_t>(
      launch_inline_bwd_tile_map(*a, s, &row_order, &col_order));
  if (err != cudaSuccess || a->map_only) return static_cast<int>(err);

  const long long rows = static_cast<long long>(a->batch) * a->heads * a->lq;
  inline_attention_delta_kernel<<<
      static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps),
      32 * kDeltaWarps, 0, s>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a head_dim below its padded width takes the instance that zero-fills
  // the dims past it; the exact widths take their own
  const bool pad = a->head_dim != dp;
  switch (dp) {
    case 32: return pad ? launch_inline_bwd<32, true>(a, row_order, col_order, s)
                        : launch_inline_bwd<32, false>(a, row_order, col_order, s);
    case 64: return pad ? launch_inline_bwd<64, true>(a, row_order, col_order, s)
                        : launch_inline_bwd<64, false>(a, row_order, col_order, s);
    case 96: return pad ? launch_inline_bwd<96, true>(a, row_order, col_order, s)
                        : launch_inline_bwd<96, false>(a, row_order, col_order, s);
    default: return pad ? launch_inline_bwd<128, true>(a, row_order, col_order, s)
                        : launch_inline_bwd<128, false>(a, row_order, col_order, s);
  }
}
