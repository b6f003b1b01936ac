// Backward of the biased softmax attention for Hopper (sm_90a): kernel K9.
//
// Replaces the TPU kernel `_bwd_kernel` (video_gpt_tpu/ops/flash_attention.py,
// called by `_flash_bwd`, the custom VJP of `flash_mha_biased`): the
// attention backward of every training layer, with the additive bf16 bias
// of `precompute_bias`.
//
// Function, per (batch b, head h), with scale = head_dim^-0.5:
//   p(q, k)  = softmax_k(q.k * scale + bias[b, q, k])
//   di(q)    = sum_d o(q, d) * do(q, d)
//   ds(q, k) = p(q, k) * (do(q) . v(k) - di(q)) * scale
//   dq = ds . K,   dk = ds^T . Q,   dv = p^T . dO
// with the q heads of a GQA group summed into their shared kv head.
//
// The TPU kernel recomputes the softmax over the whole VMEM-resident key row
// per query block. Here the forward (K3, bias_attention.cu) keeps each row's
// logsumexp `lse`, and every tile recomputes p = exp(s + bias - lse) on its
// own: the same function without holding a row. It reads the tile map of
// the bias that K3 read (tile_map.cuh's bias classifier, built once per
// bias by vgt_bias_tile_map in bias_attention.cu). Three launches, in order:
//   1. delta: di = rowsum(o * do) in fp32 (part of the TPU kernel's body),
//      and each row's softmax reference;
//   2. dK/dV: one block per (b, kv head, 64-key tile); it loops over the
//      group's q heads and the non-empty 64-row query tiles of its column of
//      the map and keeps dK and dV in fp32 registers, so the GQA sum falls
//      out of the loop, as the TPU kernel's revisited output block does, and
//      no atomics are needed;
//   3. dQ: one block per (b, head, 64-row query tile), looping over the
//      non-empty key tiles of its row of the map, as the forward does.
// Products are bf16 wgmma with fp32 accumulation: p and ds are rounded to
// bf16 before the products that consume them (the TPU keeps them in fp32),
// and dq, dk, dv are written in the inputs' dtype from fp32 accumulators
// (the TPU accumulates dK/dV in bf16 for want of VMEM; that is not copied).
// No atomics: dq, dk and dv are each summed by one block in a fixed order,
// so the result is deterministic.
//
// What bounds it on the card: at stage 1 (B 1, L 7104, 32 heads of 96)
// 0.281 of the pairs are visible; the five products over them are 0.44
// TFLOP against ~0.3 GB of operands: tensor throughput bounds it (0.44 ms
// at 989 TFLOP/s).
//
// Design. Once per bias (one per training step), tile_map.cuh's bias
// classifier reads the bias (100 MB at stage 1) and writes the class of every
// (64-query, 64-key) tile and each row's softmax reference; at stage 1
// 0.375 of the tiles are non-empty (0.220 full). Each kernel gathers the
// non-empty tiles of its column or row of the map and computes only those:
// Q/dO tiles (dK/dV kernel) or K/V tiles (dQ kernel) stream through a
// two-stage ring in shared memory, filled by cp.async one tile ahead of the
// products, with the bias tile beside them for partial tiles only (full
// tiles skip the bias). All products are wgmma over 64 rows:
//   dK/dV: S^T = K.Q^T and dP^T = V.dO^T from shared memory (m64n64k16);
//          dV += P^T.dO and dK += dS^T.Q with P^T, dS^T from registers and
//          dO, Q MN-major (m64n96k16);
//   dQ:    S = Q.K^T, dP = dO.V^T (m64n64k16); dQ += dS.K (m64n96k16).
// The dQ kernel recomputes S and dP (7 products per tile, not 5) to keep
// dq free of atomics.
//
// Head widths: the dK/dV and dQ kernels are templates on the padded head
// width DP (32, 64, 96 or 128, attention_common.cuh `padded_head_dim`), as
// the forward is: the tiles, the core-matrix layout (no swizzle at any DP)
// and the wgmma N / K extents (m64nDPk16, DP / 16 K-steps) follow DP; the
// head dims from head_dim to DP are zero-filled by cp.async (src-size 0),
// add 0 to every product and are never stored, and the scale is
// head_dim's own. A head_dim equal to its DP runs an instance without
// those checks (kPadded false), so head_dim 96 runs the code it ran when
// it was the only width. At DP 128 one warpgroup cannot hold dK and dV
// (128 fp32 registers a thread) beside S^T and dP^T: the dK/dV kernel runs
// two warpgroups there (kSplit), both computing S^T and dP^T of the tile,
// the first accumulating dV = P^T.dO, the second dK = dS^T.Q, with the
// same instructions (the operand and the stored gradient picked by the
// warpgroup's index), so no product sits in a branch.
//
// A row whose bias is BF16_NEG everywhere sees no key; in fp32 every logit
// of it is the same (the bias absorbs q.k), so its softmax is uniform over
// its keys, while K3's lse of it carries no trace of the count. The
// classifier gives each such row its count n: p = exp2((x - x_neg) -
// log2 n) with x_neg the row's common logit, in place of exp2(x - lse).
#include <math_constants.h>

#include "attention_args.cuh"
#include "tile_map.cuh"

namespace vgt {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDeltaWarps = 8;
constexpr int kBiasLd = kBlockK + 8;  // bias tile row stride (elements)

// 1. di = rowsum(o * do), and each row's softmax reference (x_ref, off):
// (lse log2e, 0), or for a row that sees no key (BF16_NEG log2e, log2 n).
// One warp per (b, h, query row).
__global__ void __launch_bounds__(32 * kDeltaWarps)
    bias_attention_delta_kernel(const BiasAttnBwdArgs a) {
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
  if (lane == 0) {
    a.delta[row] = s;
    const float dead = a.rowdead[static_cast<long long>(b) * a.lq + r];
    a.rowref[2 * row] = dead >= 0.f ? kBf16Neg * kLog2e : a.lse[row] * kLog2e;
    a.rowref[2 * row + 1] = dead >= 0.f ? dead : 0.f;
  }
}

constexpr int kStages = 2;  // ring depth of the streamed tiles
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

// dK/dV kernel shared memory: K, V; per stage Q, dO, the bias tile, delta
// and the softmax references of the query tile; the list of query tiles.
template <int DP>
__host__ __device__ constexpr int dkdv_stage() {
  return 2 * bwd_tile<DP>() * 2 + kBlockQ * kBiasLd * 2 + 3 * kBlockQ * 4;
}
template <int DP>
__host__ __device__ constexpr int dkdv_smem_bytes(int nq) {
  return 2 * bwd_tile<DP>() * 2 + kStages * dkdv_stage<DP>() + nq * 4;
}

// 2. dK/dV of one 64-key tile of one kv head; warp w (of a warpgroup) owns
// keys w*16..+15. Per non-empty query tile of the map's column, for each q
// head of the group, the transposed products, rows = keys:
//   S^T = K.Q^T, P^T = exp2(S^T scale_log2 + bias^T log2e - x_ref) 2^-off,
//   dV += P^T.dO, dP^T = V.dO^T, dS^T = P^T (dP^T - di) scale, dK += dS^T.Q
// At padded head width DP; kPadded: head_dim < DP (dims past it zero-filled
// on load, never stored).
template <int DP, bool kPadded>
__global__ void __launch_bounds__(dkdv_split<DP>() ? 2 * kThreads : kThreads)
    bias_attention_dkdv_kernel(const BiasAttnBwdArgs a) {
  constexpr bool kSplit = dkdv_split<DP>();
  constexpr int NT = kSplit ? 2 * kThreads : kThreads;
  constexpr int NO = DP / 8;
  constexpr int kTile = bwd_tile<DP>();
  constexpr int kDkdvStage = dkdv_stage<DP>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile;
  unsigned char* stages = smem + 2 * kTile * 2;
  int* list = reinterpret_cast<int*>(stages + kStages * kDkdvStage);

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kBlockK;
  const int group = a.heads / a.kv_heads;
  const int nq = (a.lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a.lk + kBlockK - 1) / kBlockK;
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
  async_commit();
  const int n = gather_tiles(
      a.tile_map + static_cast<long long>(b) * nq * nk + blockIdx.x, nk, nq,
      list);
  const int pairs = n * group;  // (q head, query tile), head-major

  auto stage = [&](int st, bf16*& qs, bf16*& dos, bf16*& bs, float*& dl,
                   float*& ref) {
    unsigned char* p = stages + st * kDkdvStage;
    qs = reinterpret_cast<bf16*>(p);
    dos = qs + kTile;
    bs = dos + kTile;
    dl = reinterpret_cast<float*>(bs + kBlockQ * kBiasLd);
    ref = dl + kBlockQ;
  };
  auto prefetch = [&](int i) {
    bf16 *qs, *dos, *bs;
    float *dl, *ref;
    stage(i % kStages, qs, dos, bs, dl, ref);
    const int e = list[i % n], q0 = (e >> 2) * kBlockQ;
    const int h = hk * group + i / n;
    const int qvalid = min(kBlockQ, a.lq - q0);
    async_copy_tile_dp<kBlockQ, NT, DP, kPadded>(
        qs, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
                q0 * a.q_sl, a.q_sl, qvalid, a.head_dim, tid);
    async_copy_tile_dp<kBlockQ, NT, DP, kPadded>(
        dos, static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh +
                 q0 * a.do_sl, a.do_sl, qvalid, a.head_dim, tid);
    const long long row0 = (static_cast<long long>(b) * a.heads + h) * a.lq + q0;
    for (int c = tid; c < 3 * kBlockQ; c += NT) {
      const int r = c < kBlockQ ? c : (c - kBlockQ) >> 1;
      const bool ok = r < qvalid;
      if (c < kBlockQ)
        async_copy4(dl + c, a.delta + (ok ? row0 + c : 0), ok);
      else
        async_copy4(ref + (c - kBlockQ), a.rowref + (ok ? 2 * row0 + c - kBlockQ : 0),
                  ok);
    }
    if ((e & 3) == kTilePartial)
      load_bias_tile<kBlockQ, kBlockK, NT>(
          bs, kBiasLd, static_cast<const bf16*>(a.bias) + b * a.bias_sb,
          a.bias_sq, a.lq, a.lk, a.bias_vec != 0, q0, k0, tid);
  };
  for (int p = 0; p < kStages - 1; ++p) {  // the ring's first tiles
    if (p < pairs) prefetch(p);
    async_commit();
  }

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
    bf16 *qs, *dos, *bs;
    float *dl, *ref;
    stage(i % kStages, qs, dos, bs, dl, ref);
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

    // P^T and dS^T; in a partial tile, queries past Lq and keys past Lk
    // weigh nothing
    const bool partial = (e & 3) == kTilePartial;
    const int qvalid = min(kBlockQ, a.lq - q0);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kr = warp * 16 + g + ((j & 2) ? 8 : 0);
      const int qc = (j >> 2) * 8 + 2 * t + (j & 1);
      float x = st[j] * a.scale_log2;
      bool ok = true;
      if (partial) {
        ok = kr < kvalid && qc < qvalid;
        x += __bfloat162float(bs[qc * kBiasLd + kr]) * kLog2e;
      }
      const float p = ok ? exp2f((x - ref[2 * qc]) - ref[2 * qc + 1]) : 0.f;
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

  const int kr0 = warp * 16 + g, kr1 = kr0 + 8;  // this thread's key rows
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

// dQ kernel shared memory: Q, dO; per stage K, V and the bias tile; the
// list of key tiles.
template <int DP>
__host__ __device__ constexpr int dq_stage() {
  return 2 * bwd_tile<DP>() * 2 + kBlockQ * kBiasLd * 2;
}
template <int DP>
__host__ __device__ constexpr int dq_smem_bytes(int nk) {
  return 2 * bwd_tile<DP>() * 2 + kStages * dq_stage<DP>() + nk * 4;
}

// 3. dQ of one 64-row query tile of one head; warp w owns rows w*16..+15;
// the non-empty key tiles of the map's row stream through the ring:
//   S = Q.K^T, P = exp2(S scale_log2 + bias log2e - x_ref) 2^-off,
//   dP = dO.V^T, dS = P (dP - di) scale, dQ += dS.K
template <int DP, bool kPadded>
__global__ void __launch_bounds__(kThreads)
    bias_attention_dq_kernel(const BiasAttnBwdArgs a) {
  constexpr int NO = DP / 8;
  constexpr int kTile = bwd_tile<DP>();
  constexpr int kDqStage = dq_stage<DP>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kTile;
  unsigned char* stages = smem + 2 * kTile * 2;
  int* list = reinterpret_cast<int*>(stages + kStages * kDqStage);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int hk = h / (a.heads / a.kv_heads);
  const int nq = (a.lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a.lk + kBlockK - 1) / kBlockK;
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
      a.tile_map + (static_cast<long long>(b) * nq + blockIdx.x) * nk, 1, nk,
      list);

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
    if ((e & 3) == kTilePartial)
      load_bias_tile<kBlockQ, kBlockK, kThreads>(
          kt + 2 * kTile, kBiasLd,
          static_cast<const bf16*>(a.bias) + b * a.bias_sb, a.bias_sq, a.lq,
          a.lk, a.bias_vec != 0, q0, k0, tid);
  };
  for (int p = 0; p < kStages - 1; ++p) {  // the ring's first tiles
    if (p < n) prefetch(p);
    async_commit();
  }

  // this thread's rows: local lr0 / lr0 + 8, their di and softmax reference
  const int lr0 = warp * 16 + g;
  const int r0 = q0 + lr0, r1 = r0 + 8;
  const long long row0 = (static_cast<long long>(b) * a.heads + h) * a.lq;
  float dl[2] = {0.f, 0.f}, xr[2] = {0.f, 0.f}, off[2] = {0.f, 0.f};
  if (r0 < a.lq) {
    dl[0] = a.delta[row0 + r0];
    xr[0] = a.rowref[2 * (row0 + r0)];
    off[0] = a.rowref[2 * (row0 + r0) + 1];
  }
  if (r1 < a.lq) {
    dl[1] = a.delta[row0 + r1];
    xr[1] = a.rowref[2 * (row0 + r1)];
    off[1] = a.rowref[2 * (row0 + r1) + 1];
  }

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
    const bf16* bs = kt + 2 * kTile;
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

    const bool partial = (e & 3) == kTilePartial;
    const int kvalid = min(kBlockK, a.lk - k0);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int hi = (j >> 1) & 1;  // 0: row lr0, 1: row lr0 + 8
      const int col = (j >> 2) * 8 + 2 * t + (j & 1);
      float x = s[j] * a.scale_log2;
      bool ok = true;
      if (partial) {
        ok = col < kvalid && (hi ? r1 : r0) < a.lq;
        x += __bfloat162float(bs[(lr0 + 8 * hi) * kBiasLd + col]) * kLog2e;
      }
      const float p = ok ? exp2f((x - xr[hi]) - off[hi]) : 0.f;
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

// dK/dV, then dQ, at padded head width DP; returns the first nonzero
// cudaGetLastError() (0 = both launched).
template <int DP, bool kPadded>
int launch_bias_bwd(const BiasAttnBwdArgs* a, cudaStream_t s) {
  const int nq = (a->lq + kBlockQ - 1) / kBlockQ;
  const int nk = (a->lk + kBlockK - 1) / kBlockK;
  int smem = dkdv_smem_bytes<DP>(nq);
  cudaError_t err = cudaFuncSetAttribute(
      bias_attention_dkdv_kernel<DP, kPadded>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(nk, a->kv_heads, a->batch);
  bias_attention_dkdv_kernel<DP, kPadded>
      <<<grid_kv, dkdv_split<DP>() ? 2 * kThreads : kThreads, smem, s>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  smem = dq_smem_bytes<DP>(nk);
  err = cudaFuncSetAttribute(bias_attention_dq_kernel<DP, kPadded>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(nq, a->heads, a->batch);
  bias_attention_dq_kernel<DP, kPadded><<<grid_q, kThreads, smem, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vgt

// Launches on `stream`, in order: the delta pre-pass, dK/dV and dQ, over
// the map of vgt_bias_tile_map; returns the first nonzero
// cudaGetLastError() (0 = all launched).
extern "C" int vgt_bias_attention_bwd(const vgt::BiasAttnBwdArgs* a,
                                      void* stream) {
  using namespace vgt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a head_dim below its padded width takes the instance that zero-fills
  // the dims past it; the exact widths take their own
  const int dp = padded_head_dim(a->head_dim);
  if (dp == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool pad = a->head_dim != dp;
  const long long rows = static_cast<long long>(a->batch) * a->heads * a->lq;
  bias_attention_delta_kernel<<<
      static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps),
      32 * kDeltaWarps, 0, s>>>(*a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dp) {
    case 32: return pad ? launch_bias_bwd<32, true>(a, s)
                        : launch_bias_bwd<32, false>(a, s);
    case 64: return pad ? launch_bias_bwd<64, true>(a, s)
                        : launch_bias_bwd<64, false>(a, s);
    case 96: return pad ? launch_bias_bwd<96, true>(a, s)
                        : launch_bias_bwd<96, false>(a, s);
    default: return pad ? launch_bias_bwd<128, true>(a, s)
                        : launch_bias_bwd<128, false>(a, s);
  }
}
