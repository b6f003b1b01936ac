// fp32 attention backward for Hopper (sm_90a): K9 and K7 at fp32 operands,
// on the CUDA cores.
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
// summed into their kv head. Every product and sum is fp32 FFMA (no TF32);
// exp2f is the accurate one. The sums run in another order than the plain
// versions'.
//
// What bounds it on the card: fp32 has no tensor-core path but TF32, so the
// bound is the CUDA cores' 66.9 TFLOP/s against the five products' 2 FLOPs
// per head dim and visible pair (K9 at stage 1, L 7104, 32 heads of 96:
// 0.44 TFLOP, 6.6 ms), far above the bytes (0.5 GB, 0.15 ms).
//
// Design, K9's and K7's scheme on the CUDA cores. Three launches (after
// the inline mask's map): delta (di and the softmax references), dK/dV and
// dQ; no atomics, so the result is deterministic.
//   dK/dV: one block of 256 threads per (64-key tile, kv head), over (q
//     head of the group) x (non-empty query tile of its column of the map),
//     so the GQA sum falls out of the loop. K and V stay in shared memory;
//     Q, dO and the query tile's di, references and mask data stream
//     through a cp.async ring ([64][DP + 4] floats: the 4-float pad puts
//     the 8 rows that 8 neighbouring threads read in 8 banks). Phase 1,
//     every thread: S^T = K.Q^T and dP^T = V.dO^T for its 2 keys x 8
//     queries, then P^T and dS^T into shared memory, query-major. Phase 2,
//     two halves of 128 threads: the first dV += P^T.dO, the second dK +=
//     dS^T.Q, a thread 4 keys x DP / 8 head dims of its gradient in
//     registers (64 at DP 128).
//   dQ: one block of 256 threads per (64-row query tile, head), over the
//     non-empty key tiles of its row of the map; Q and dO stay, K, V and
//     the key tile's mask data stream. Phase 1: S = Q.K^T and dP = dO.V^T
//     for 2 rows x 8 keys, dS into shared memory, key-major; phase 2: dQ +=
//     dS.K, a thread 2 rows x DP / 8 head dims.
// The ring is two stages deep up to DP 96 and one at DP 128 (two would
// pass the 227 KB of shared memory a block may hold). Partial tiles
// evaluate the mask per element (and bounds: keys past Lk and rows past Lq
// weigh nothing); full tiles skip it. The padded head width DP is 32, 64,
// 96 or 128 (padded_head_dim); the head dims past head_dim are zero-filled
// on load and never stored.
#include <math_constants.h>

#include "attention_args.cuh"
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

constexpr int kBT = 256;              // threads a block
constexpr int kT = 64;                // query rows and keys of a tile
constexpr int kPLd = kT + 4;          // P^T / dS^T / dS row stride (floats)
constexpr int kBiasLd = kT + 8;       // bias tile row stride (bf16)
constexpr int kDeltaWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

// The shared memory of the two kernels at padded head width DP under MASK.
template <int DP, int MASK>
struct BwdCfg {
  static constexpr int kLd = DP + 4;             // Q/K/V/dO row stride
  static constexpr int kTile = kT * kLd * 4;     // bytes of one [64][kLd]
  static constexpr int kStages = DP > 96 ? 1 : 2;
  // a streamed tile's mask data for a partial tile: the bias tile, or the
  // metadata (4 query vectors in dK/dV, 3 key vectors in dQ)
  static constexpr int kMaskBytes =
      MASK == kMaskBias ? kT * kBiasLd * 2 : 4 * kT * 4;
  // dK/dV: K, V, the key tile's metadata (3 x 64 ints), P^T and dS^T; per
  // stage Q, dO, the query tile's di and references (3 x 64 floats) and
  // its mask data; the list of query tiles
  static constexpr int kDkdvStage = 2 * kTile + 3 * kT * 4 + kMaskBytes;
  static constexpr int kDkdvFixed = 2 * kTile + 3 * kT * 4 + 2 * kT * kPLd * 4;
  static constexpr int dkdv_smem(int nq) {
    return kDkdvFixed + kStages * kDkdvStage + nq * 4;
  }
  // dQ: Q, dO, dS; per stage K, V and the mask data; the list of key tiles
  static constexpr int kDqStage = 2 * kTile + kMaskBytes;
  static constexpr int kDqFixed = 2 * kTile + kT * kPLd * 4;
  static constexpr int dq_smem(int nk) {
    return kDqFixed + kStages * kDqStage + nk * 4;
  }
};

// 16-byte copies of the rows_valid x cols_valid floats at `src` (row stride
// `row_stride`, 16-byte aligned rows) into `dst` [64][ld], zero-filling the
// rest of the 64 x DP tile.
template <int DP>
__device__ __forceinline__ void f32_bwd_copy_tile(float* dst, int ld,
                                                  const float* src,
                                                  long long row_stride,
                                                  int rows_valid,
                                                  int cols_valid, int tid) {
  constexpr int kChunks = DP / 4;
  for (int i = tid; i < kT * kChunks; i += kBT) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = r < rows_valid && c < cols_valid;
    async_copy16(dst + r * ld + c, src + (ok ? r * row_stride + c : 0), ok);
  }
}

// acc[i][j] += A[2 rg + i] . B[c + 8 j] over DP: A and B [64][kLd] tiles.
// B's rows are read four at a time, so that a step holds 6 float4s.
template <int DP>
__device__ __forceinline__ void f32_scores(float (&acc)[2][8],
                                           const float* A, const float* B,
                                           int rg, int c) {
  constexpr int kLd = DP + 4;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 av[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (2 * rg + i) * kLd + d);
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += 4) {
      float4 bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(B + (c + 8 * (j0 + j)) * kLd
                                                 + d);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& x = acc[i][j0 + j];
          x = fmaf(av[i].x, bv[j].x, x);
          x = fmaf(av[i].y, bv[j].y, x);
          x = fmaf(av[i].z, bv[j].z, x);
          x = fmaf(av[i].w, bv[j].w, x);
        }
    }
  }
}

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

// 2. dK/dV of one 64-key tile of one kv head (see the file's comment).
template <int DP, int MASK>
__global__ void __launch_bounds__(kBT, 1)
    fp32_bwd_dkdv_kernel(const typename F32BwdArgs<MASK>::T a,
                         const int* order) {
  using C = BwdCfg<DP, MASK>;
  constexpr int kLd = C::kLd;
  constexpr int S = C::kStages;
  constexpr int NM = DP / 32;  // float4 column groups of a thread's gradient
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kT * kLd;
  int* kmeta = reinterpret_cast<int*>(vs + kT * kLd);          // [3][64]
  float* ps = reinterpret_cast<float*>(kmeta + 3 * kT);        // [q][kPLd]
  float* dss = ps + kT * kPLd;                                 // [q][kPLd]
  unsigned char* stages = reinterpret_cast<unsigned char*>(dss + kT * kPLd);
  int* list = reinterpret_cast<int*>(stages + S * C::kDkdvStage);

  const int nq = (a.lq + kT - 1) / kT;
  const int nk = (a.lk + kT - 1) / kT;
  const int item = order != nullptr ? order[blockIdx.x] : blockIdx.x;
  const int b = item / nk, kt = item % nk, k0 = kt * kT;
  const int hk = blockIdx.y, group = a.heads / a.kv_heads;
  const int tid = threadIdx.x, rg = tid >> 3, c = tid & 7;
  const int kvalid = min(kT, a.lk - k0);

  f32_bwd_copy_tile<DP>(ks, kLd,
                        static_cast<const float*>(a.k) + b * a.k_sb +
                            hk * a.k_sh + k0 * a.k_sl,
                        a.k_sl, kvalid, a.head_dim, tid);
  f32_bwd_copy_tile<DP>(vs, kLd,
                        static_cast<const float*>(a.v) + b * a.v_sb +
                            hk * a.v_sh + k0 * a.v_sl,
                        a.v_sl, kvalid, a.head_dim, tid);
  if constexpr (MASK == kMaskInline)
    for (int x = tid; x < 3 * kT; x += kBT) {
      const int m = x / kT, j = x % kT;
      const bool ok = j < kvalid;
      async_copy4(kmeta + x, a.km[m] + b * a.km_sb[m] + (ok ? k0 + j : 0),
                  ok);
    }
  async_commit();
  const int n = gather_tiles(
      a.tile_map + static_cast<long long>(b) * nq * nk + kt, nk, nq, list);
  const int pairs = n * group;  // (q head, query tile), head-major

  // a stage: Q, dO [64][kLd]; di [64], the references [128] (bias: x_ref,
  // off pairs; inline: lse [64]); the mask data
  auto stage = [&](int st, float*& qs, float*& dos, float*& qi,
                   unsigned char*& mk) {
    unsigned char* p = stages + st * C::kDkdvStage;
    qs = reinterpret_cast<float*>(p);
    dos = qs + kT * kLd;
    qi = dos + kT * kLd;
    mk = reinterpret_cast<unsigned char*>(qi + 3 * kT);
  };
  auto prefetch = [&](int i) {
    float *qs, *dos, *qi;
    unsigned char* mk;
    stage(i % S, qs, dos, qi, mk);
    const int e = list[i % n], q0 = (e >> 2) * kT;
    const int h = hk * group + i / n;
    const int qvalid = min(kT, a.lq - q0);
    f32_bwd_copy_tile<DP>(qs, kLd,
                          static_cast<const float*>(a.q) + b * a.q_sb +
                              h * a.q_sh + q0 * a.q_sl,
                          a.q_sl, qvalid, a.head_dim, tid);
    f32_bwd_copy_tile<DP>(dos, kLd,
                          static_cast<const float*>(a.dout) + b * a.do_sb +
                              h * a.do_sh + q0 * a.do_sl,
                          a.do_sl, qvalid, a.head_dim, tid);
    const long long row0 =
        (static_cast<long long>(b) * a.heads + h) * a.lq + q0;
    for (int x = tid; x < 3 * kT; x += kBT) {
      if (x < kT) {
        const bool ok = x < qvalid;
        async_copy4(qi + x, a.delta + (ok ? row0 + x : 0), ok);
      } else if constexpr (MASK == kMaskBias) {
        const bool ok = (x - kT) >> 1 < qvalid;
        async_copy4(qi + x, a.rowref + (ok ? 2 * row0 + x - kT : 0), ok);
      } else if (x < 2 * kT) {
        const bool ok = x - kT < qvalid;
        async_copy4(qi + x, a.lse + (ok ? row0 + x - kT : 0), ok);
      }
    }
    if ((e & 3) != kTilePartial) return;
    if constexpr (MASK == kMaskBias) {
      load_bias_tile<kT, kT, kBT>(
          reinterpret_cast<bf16*>(mk), kBiasLd,
          static_cast<const bf16*>(a.bias) + b * a.bias_sb, a.bias_sq, a.lq,
          a.lk, a.bias_vec != 0, q0, k0, tid);
    } else {
      for (int x = tid; x < 4 * kT; x += kBT) {
        const int m = x / kT, j = x % kT;
        const bool ok = j < qvalid;
        async_copy4(reinterpret_cast<int*>(mk) + x,
                    a.qm[m] + b * a.qm_sb[m] + (ok ? q0 + j : 0), ok);
      }
    }
  };
  for (int p = 0; p < S - 1; ++p) {  // the ring's first tiles
    if (p < pairs) prefetch(p);
    async_commit();
  }

  // phase 2: half 0 accumulates dV (from P^T, dO), half 1 dK (dS^T, Q);
  // a thread keys 4 r2 .. 4 r2 + 3, head dims 4 c + 32 m
  const int half = tid >> 7, r2 = (tid & 127) >> 3;
  float acc[4][NM][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][m][x] = 0.f;

  for (int it = 0; it < pairs; ++it) {
    if (it + S - 1 < pairs) prefetch(it + S - 1);
    async_commit();
    async_wait<S - 1>();
    __syncthreads();
    float *qs, *dos, *qi;
    unsigned char* mk;
    stage(it % S, qs, dos, qi, mk);
    const int e = list[it % n], q0 = (e >> 2) * kT;
    const bool partial = (e & 3) == kTilePartial;
    const int qvalid = min(kT, a.lq - q0);

    // phase 1: keys 2 rg + i, queries c + 8 j
    float s[2][8], dp[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    f32_scores<DP>(s, ks, qs, rg, c);
    f32_scores<DP>(dp, vs, dos, rg, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qc = c + 8 * j;
      float xr, off;
      if constexpr (MASK == kMaskBias) {
        xr = qi[kT + 2 * qc];
        off = qi[kT + 2 * qc + 1];
      } else {
        xr = qi[kT + qc] * kLog2e;
        off = 0.f;
      }
      float p2[2], d2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kr = 2 * rg + i;
        float x = s[i][j] * a.scale_log2;
        bool ok = true;
        if (partial) {
          ok = kr < kvalid && qc < qvalid;
          if constexpr (MASK == kMaskBias) {
            x += __bfloat162float(
                     reinterpret_cast<const bf16*>(mk)[qc * kBiasLd + kr]) *
                 kLog2e;
          } else {
            const int* qm = reinterpret_cast<const int*>(mk);
            ok = ok && inline_visible(
                           QueryMeta{qm[qc], qm[kT + qc], qm[2 * kT + qc],
                                     qm[3 * kT + qc]},
                           KeyMeta{kmeta[kr], kmeta[kT + kr],
                                   kmeta[2 * kT + kr]});
          }
        }
        const float p = ok ? exp2f((x - xr) - off) : 0.f;
        p2[i] = p;
        d2[i] = p * (dp[i][j] - qi[qc]) * a.scale;
      }
      *reinterpret_cast<float2*>(ps + qc * kPLd + 2 * rg) =
          make_float2(p2[0], p2[1]);
      *reinterpret_cast<float2*>(dss + qc * kPLd + 2 * rg) =
          make_float2(d2[0], d2[1]);
    }
    __syncthreads();

    // phase 2: dV += P^T.dO (half 0), dK += dS^T.Q (half 1)
    const float* xt = half ? dss : ps;
    const float* bt = half ? qs : dos;
#pragma unroll 4
    for (int q = 0; q < kT; ++q) {
      const float4 x4 = *reinterpret_cast<const float4*>(xt + q * kPLd + 4 * r2);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const float4 bb =
            *reinterpret_cast<const float4*>(bt + q * kLd + 4 * c + 32 * m);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][m][0] = fmaf(xv[i], bb.x, acc[i][m][0]);
          acc[i][m][1] = fmaf(xv[i], bb.y, acc[i][m][1]);
          acc[i][m][2] = fmaf(xv[i], bb.z, acc[i][m][2]);
          acc[i][m][3] = fmaf(xv[i], bb.w, acc[i][m][3]);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage and P^T / dS^T
  }
  async_wait<0>();

  float* out = static_cast<float*>(half ? a.dk : a.dv) + b * a.dkv_sb +
               hk * a.dkv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = 4 * r2 + i;
    if (kr >= kvalid) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int col = 4 * c + 32 * m;
      if (col < a.head_dim)  // the padded dims are not stored
        *reinterpret_cast<float4*>(out + (k0 + kr) * a.dkv_sl + col) =
            make_float4(acc[i][m][0], acc[i][m][1], acc[i][m][2],
                        acc[i][m][3]);
    }
  }
}

// 3. dQ of one 64-row query tile of one head (see the file's comment).
template <int DP, int MASK>
__global__ void __launch_bounds__(kBT, 1)
    fp32_bwd_dq_kernel(const typename F32BwdArgs<MASK>::T a,
                       const int* order) {
  using C = BwdCfg<DP, MASK>;
  constexpr int kLd = C::kLd;
  constexpr int S = C::kStages;
  constexpr int NM = DP / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kT * kLd;
  float* dss = dos + kT * kLd;  // dS, [key][kPLd]
  unsigned char* stages = reinterpret_cast<unsigned char*>(dss + kT * kPLd);
  int* list = reinterpret_cast<int*>(stages + S * C::kDqStage);

  const int nq = (a.lq + kT - 1) / kT;
  const int nk = (a.lk + kT - 1) / kT;
  const int item = order != nullptr ? order[blockIdx.x] : blockIdx.x;
  const int b = item / nq, qt = item % nq, q0 = qt * kT;
  const int h = blockIdx.y, hk = h / (a.heads / a.kv_heads);
  const int tid = threadIdx.x, rg = tid >> 3, c = tid & 7;
  const int qvalid = min(kT, a.lq - q0);

  f32_bwd_copy_tile<DP>(qs, kLd,
                        static_cast<const float*>(a.q) + b * a.q_sb +
                            h * a.q_sh + q0 * a.q_sl,
                        a.q_sl, qvalid, a.head_dim, tid);
  f32_bwd_copy_tile<DP>(dos, kLd,
                        static_cast<const float*>(a.dout) + b * a.do_sb +
                            h * a.do_sh + q0 * a.do_sl,
                        a.do_sl, qvalid, a.head_dim, tid);
  async_commit();
  const int n = gather_tiles(
      a.tile_map + (static_cast<long long>(b) * nq + qt) * nk, 1, nk, list);

  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  auto stage = [&](int st, float*& kt, float*& vt, unsigned char*& mk) {
    kt = reinterpret_cast<float*>(stages + st * C::kDqStage);
    vt = kt + kT * kLd;
    mk = reinterpret_cast<unsigned char*>(vt + kT * kLd);
  };
  auto prefetch = [&](int i) {
    float *kt, *vt;
    unsigned char* mk;
    stage(i % S, kt, vt, mk);
    const int e = list[i], k0 = (e >> 2) * kT;
    const int valid = min(kT, a.lk - k0);
    f32_bwd_copy_tile<DP>(kt, kLd, kp + k0 * a.k_sl, a.k_sl, valid,
                          a.head_dim, tid);
    f32_bwd_copy_tile<DP>(vt, kLd, vp + k0 * a.v_sl, a.v_sl, valid,
                          a.head_dim, tid);
    if ((e & 3) != kTilePartial) return;
    if constexpr (MASK == kMaskBias) {
      load_bias_tile<kT, kT, kBT>(
          reinterpret_cast<bf16*>(mk), kBiasLd,
          static_cast<const bf16*>(a.bias) + b * a.bias_sb, a.bias_sq, a.lq,
          a.lk, a.bias_vec != 0, q0, k0, tid);
    } else {
      for (int x = tid; x < 3 * kT; x += kBT) {
        const int m = x / kT, j = x % kT;
        const bool ok = j < valid;
        async_copy4(reinterpret_cast<int*>(mk) + x,
                    a.km[m] + b * a.km_sb[m] + (ok ? k0 + j : 0), ok);
      }
    }
  };
  for (int p = 0; p < S - 1; ++p) {  // the ring's first tiles
    if (p < n) prefetch(p);
    async_commit();
  }

  // phase 1 rows 2 rg + i: their di, references and metadata
  const long long row0 = (static_cast<long long>(b) * a.heads + h) * a.lq;
  float dl[2], xr[2], off[2];
  QueryMeta qm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + 2 * rg + i;
    dl[i] = xr[i] = off[i] = 0.f;
    if (r < a.lq) {
      dl[i] = a.delta[row0 + r];
      row_ref<MASK>(a, row0 + r, xr[i], off[i]);
    }
    if constexpr (MASK == kMaskInline)
      qm[i] = query_meta(a.qm, a.qm_sb, b, r, a.lq);
  }

  // phase 2: rows 2 rg + i, head dims 4 c + 32 m
  float dq[2][NM][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int x = 0; x < 4; ++x) dq[i][m][x] = 0.f;

  for (int it = 0; it < n; ++it) {
    if (it + S - 1 < n) prefetch(it + S - 1);
    async_commit();
    async_wait<S - 1>();
    __syncthreads();
    float *kt, *vt;
    unsigned char* mk;
    stage(it % S, kt, vt, mk);
    const int e = list[it], k0 = (e >> 2) * kT;
    const bool partial = (e & 3) == kTilePartial;
    const int kvalid = min(kT, a.lk - k0);

    // phase 1: rows 2 rg + i, keys c + 8 j
    float s[2][8], dp[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    f32_scores<DP>(s, qs, kt, rg, c);
    f32_scores<DP>(dp, dos, vt, rg, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c + 8 * j;
      float d2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x = s[i][j] * a.scale_log2;
        bool ok = true;
        if (partial) {
          ok = col < kvalid;
          if constexpr (MASK == kMaskBias) {
            ok = ok && q0 + 2 * rg + i < a.lq;
            x += __bfloat162float(reinterpret_cast<const bf16*>(
                     mk)[(2 * rg + i) * kBiasLd + col]) *
                 kLog2e;
          } else {
            const int* km = reinterpret_cast<const int*>(mk);
            ok = ok && inline_visible(qm[i], KeyMeta{km[col], km[kT + col],
                                                      km[2 * kT + col]});
          }
        }
        const float p = ok ? exp2f((x - xr[i]) - off[i]) : 0.f;
        d2[i] = p * (dp[i][j] - dl[i]) * a.scale;
      }
      *reinterpret_cast<float2*>(dss + col * kPLd + 2 * rg) =
          make_float2(d2[0], d2[1]);
    }
    __syncthreads();

    // phase 2: dQ += dS.K
#pragma unroll 4
    for (int k = 0; k < kT; ++k) {
      const float2 x2 = *reinterpret_cast<const float2*>(dss + k * kPLd + 2 * rg);
      const float xv[2] = {x2.x, x2.y};
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const float4 kk =
            *reinterpret_cast<const float4*>(kt + k * kLd + 4 * c + 32 * m);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dq[i][m][0] = fmaf(xv[i], kk.x, dq[i][m][0]);
          dq[i][m][1] = fmaf(xv[i], kk.y, dq[i][m][1]);
          dq[i][m][2] = fmaf(xv[i], kk.z, dq[i][m][2]);
          dq[i][m][3] = fmaf(xv[i], kk.w, dq[i][m][3]);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage and dS
  }
  async_wait<0>();

  float* out = static_cast<float*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + 2 * rg + i;
    if (r >= a.lq) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int col = 4 * c + 32 * m;
      if (col < a.head_dim)  // the padded dims are not stored
        *reinterpret_cast<float4*>(out + r * a.dq_sl + col) =
            make_float4(dq[i][m][0], dq[i][m][1], dq[i][m][2], dq[i][m][3]);
    }
  }
}

// delta, dK/dV over the key tiles (in `col_order`, or in turn), dQ over the
// query tiles (in `row_order`, or in turn) at padded head width DP; returns
// the first nonzero cudaGetLastError() (0 = all launched).
template <int DP, int MASK>
int launch_fp32_bwd(const typename F32BwdArgs<MASK>::T& a,
                    const int* row_order, const int* col_order,
                    cudaStream_t s) {
  using C = BwdCfg<DP, MASK>;
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
      <<<dim3(a.batch * nk, a.kv_heads), kBT, smem, s>>>(a, col_order);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  smem = C::dq_smem(nk);
  err = cudaFuncSetAttribute(fp32_bwd_dq_kernel<DP, MASK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fp32_bwd_dq_kernel<DP, MASK>
      <<<dim3(a.batch * nq, a.heads), kBT, smem, s>>>(a, row_order);
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
// cudaGetLastError() (0 = all launched).
extern "C" int vgt_fp32_bias_attention_bwd(const vgt::BiasAttnBwdArgs* a,
                                           void* stream) {
  using namespace vgt;
  return launch_fp32_bwd_dp<kMaskBias>(*a, nullptr, nullptr,
                                       static_cast<cudaStream_t>(stream));
}

// K7 at fp32 operands: the metadata's tile map with its column counts and
// both orders (as K7 builds it), then delta, dK/dV and dQ. Launches on
// `stream`; returns the first nonzero CUDA error.
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
