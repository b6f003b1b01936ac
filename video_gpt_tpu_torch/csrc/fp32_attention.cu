// fp32 attention for Hopper (sm_90a): the forward kernels K1/K2, K3 and K6
// at fp32 operands, on the CUDA cores.
//
// Replaces the TPU kernels `_decode_split_kernel` / `_decode_kernel` (K1,
// K2; past 8192 keys K4, K5), `_bias_kernel` (K3; K10) and
// `_stream_inline_kernel` (K6; K8) of video_gpt_tpu/ops/flash_attention.py
// where their operands are fp32: the Pallas kernels keep the operands'
// dtype (p.astype(v.dtype) before P.V), so `generate --dtype fp32` runs
// them in fp32 end to end. The bf16 kernels (rank_attention.cu,
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
// Every product and sum is fp32 FFMA (no TF32: its 10-bit mantissa is far
// from the fp32 plain version's bar); exp2f is the accurate one, not
// ex2.approx. The sums run in another order than the plain versions'.
//
// What bounds it on the card: fp32 has no tensor-core path but TF32, so
// the bound is the CUDA cores' 66.9 TFLOP/s against the visible pairs' 4
// FLOPs per head dim (K1 at the flagship: 0.23 TFLOP, 3.5 ms), far above
// the bytes (0.2 GB, 0.07 ms).
//
// Design. One block of 128 threads per (64 query rows, head), over the
// 64-key tiles that its tile map (bias, inline) or its own classes (rank:
// tile_map.cuh `rank_tile_class` per key tile, computed by the block
// before the loop) do not call empty; full tiles skip the mask. Q stays in
// shared memory, K and V stream through a two-stage cp.async ring ([64][DP
// + 4] floats: the 4-float pad puts the 8 keys that 8 neighbouring threads
// read in 8 different banks). Thread (rg, c) = (tid / 8, tid % 8) owns rows
// 4 rg .. 4 rg + 3: in S = Q.K^T the keys c + 8 j (j < 8), 32 sums of
// 16-byte loads; its row max and sum are reduced over the 8 lanes of its
// rows by shuffles. P goes through shared memory ([key][row], a 68-float
// stride) to O += P.V, where the thread owns head dims 4 c + 32 m (m < DP /
// 32) of its 4 rows. P is written and read by the 8 threads of a row group,
// which share a warp: a warp barrier orders them. The padded head width DP
// is 32, 64, 96 or 128 (padded_head_dim); the head dims past head_dim are
// zero-filled on load and never stored.
#include <math_constants.h>

#include "attention_args.cuh"
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
constexpr int kF32Tile = 64;          // query rows and keys of a tile
constexpr int kF32PLd = kF32Tile + 4;  // P's row stride (floats)
constexpr int kF32BiasLd = kF32Tile + 8;
constexpr float kF32Log2e = 1.4426950408889634f;

// The shared memory of a block at padded head width DP: Q, the K/V ring,
// P (floats), then per stage the mask's key-tile extras (the bias tile, the
// key metadata or the ranks), then the tile classes and list (nk entries).
template <int DP, int MASK>
struct F32Cfg {
  static constexpr int kLd = DP + 4;                 // Q/K/V row stride
  static constexpr int kTile = kF32Tile * kLd;       // floats
  static constexpr int kExtra =
      MASK == kMaskBias ? kF32Tile * kF32BiasLd * 2
      : MASK == kMaskInline ? 3 * kF32Tile * 4 : kF32Tile * 4;  // bytes
  static constexpr int kFixed = (5 * kTile + kF32Tile * kF32PLd) * 4 +
                                2 * kExtra;
  static constexpr int smem(int nk) { return kFixed + nk * 5 + 16; }
};

// 16-byte copies of the rows_valid x cols_valid floats at `src` (row stride
// `row_stride`, 16-byte aligned rows) into `dst` [64][ld], zero-filling the
// rest of the 64 x DP tile.
template <int DP>
__device__ __forceinline__ void f32_copy_tile(float* dst, int ld,
                                              const float* src,
                                              long long row_stride,
                                              int rows_valid, int cols_valid,
                                              int tid) {
  constexpr int kChunks = DP / 4;
  for (int i = tid; i < kF32Tile * kChunks; i += kF32Threads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = r < rows_valid && c < cols_valid;
    async_copy16(dst + r * ld + c, src + (ok ? r * row_stride + c : 0), ok);
  }
}

template <int DP, int MASK>
__global__ void __launch_bounds__(kF32Threads)
    fp32_attention_kernel(const typename F32Args<MASK>::T a,
                          const int* order) {
  using C = F32Cfg<DP, MASK>;
  constexpr int kLd = C::kLd;
  constexpr int NM = DP / 32;  // float4 column groups of a thread's output
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + C::kTile;           // [2][kTile]
  float* vs = ks + 2 * C::kTile;       // [2][kTile]
  float* ps = vs + 2 * C::kTile;       // [64 keys][kF32PLd]
  unsigned char* extra =
      reinterpret_cast<unsigned char*>(ps + kF32Tile * kF32PLd);  // [2]
  int* list = reinterpret_cast<int*>(extra + 2 * C::kExtra);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = tid >> 3, c = tid & 7;
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
      const int t = t0 + warp;  // warp-uniform
      if (t < nk) {
        const int op = t < nk0 ? 0 : 1;
        const int k0 = (t - (op ? nk0 : 0)) * kF32Tile;
        int ra, rb;
        rank_tile_load(a.rank[op] + b * a.rank_sb[op], k0, a.len[op], lane,
                       ra, rb);
        const int8_t k = rank_tile_class(qr, ra, rb);
        if (lane == 0) cls[t] = k;
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

  f32_copy_tile<DP>(qs, kLd,
                    static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh +
                        q0 * a.q_sl,
                    a.q_sl, min(kF32Tile, a.lq - q0), head_dim, tid);
  async_commit();

  // the key tile of list entry e: its K/V rows, first key, keys inside
  auto tile_of = [&](int e, const float*& kp, const float*& vp,
                     long long& k_sl, long long& v_sl, int& k0, int& valid) {
    const int t = e >> 2;
    if constexpr (MASK == kMaskRank) {
      const int nk0 = (a.len[0] + kF32Tile - 1) / kF32Tile;
      const int op = t < nk0 ? 0 : 1;
      k0 = (t - (op ? nk0 : 0)) * kF32Tile;
      valid = min(kF32Tile, a.len[op] - k0);
      k_sl = a.k_sl[op];
      v_sl = a.v_sl[op];
      kp = static_cast<const float*>(a.k[op]) + b * a.k_sb[op] +
           hk * a.k_sh[op] + k0 * k_sl;
      vp = static_cast<const float*>(a.v[op]) + b * a.v_sb[op] +
           hk * a.v_sh[op] + k0 * v_sl;
    } else {
      k0 = t * kF32Tile;
      valid = min(kF32Tile, a.lk - k0);
      k_sl = a.k_sl;
      v_sl = a.v_sl;
      kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh +
           k0 * k_sl;
      vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh +
           k0 * v_sl;
    }
  };
  // the loads of the i-th listed key tile into stage i % 2: K, V and, for a
  // partial tile, the mask's extras
  auto prefetch = [&](int i) {
    const int e = list[i], st = i & 1;
    const float *kp, *vp;
    long long k_sl, v_sl;
    int k0, valid;
    tile_of(e, kp, vp, k_sl, v_sl, k0, valid);
    f32_copy_tile<DP>(ks + st * C::kTile, kLd, kp, k_sl, valid, head_dim,
                      tid);
    f32_copy_tile<DP>(vs + st * C::kTile, kLd, vp, v_sl, valid, head_dim,
                      tid);
    if ((e & 3) != kTilePartial) return;
    unsigned char* ex = extra + st * C::kExtra;
    if constexpr (MASK == kMaskRank) {
      const int op = (e >> 2) < (a.len[0] + kF32Tile - 1) / kF32Tile ? 0 : 1;
      const int* rp = a.rank[op] + b * a.rank_sb[op] + k0;
      for (int j = tid; j < kF32Tile; j += kF32Threads)
        async_copy4(reinterpret_cast<int*>(ex) + j, rp + (j < valid ? j : 0),
                    j < valid);
    } else if constexpr (MASK == kMaskBias) {
      load_bias_tile<kF32Tile, kF32Tile, kF32Threads>(
          reinterpret_cast<bf16*>(ex), kF32BiasLd,
          static_cast<const bf16*>(a.bias) + b * a.bias_sb, a.bias_sq, a.lq,
          a.lk, a.bias_vec != 0, q0, k0, tid);
    } else {
      for (int x = tid; x < 3 * kF32Tile; x += kF32Threads) {
        const int m = x / kF32Tile, j = x % kF32Tile;
        const bool ok = j < valid;
        async_copy4(reinterpret_cast<int*>(ex) + x,
                    a.km[m] + b * a.km_sb[m] + (ok ? k0 + j : 0), ok);
      }
    }
  };
  if (n > 0) prefetch(0);
  async_commit();

  // this thread's rows and their mask state
  int rr[4];
  int qo[4];
  QueryMeta qm[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rr[i] = q0 + 4 * rg + i;
    if constexpr (MASK == kMaskRank)
      qo[i] = rr[i] < a.lq ? a.qoff[b * a.qoff_sb + rr[i]] : kNever;
    if constexpr (MASK == kMaskInline)
      qm[i] = query_meta(a.qm, a.qm_sb, b, rr[i], a.lq);
  }

  float o[4][NM][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][m][e] = 0.f;
  float mrow[4], l[4];  // running max (log2 units) and this thread's sums
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) prefetch(it + 1);
    async_commit();
    async_wait<1>();  // all but the tile still ahead have landed
    __syncthreads();
    const int e = list[it], st = it & 1;
    const bool partial = (e & 3) == kTilePartial;
    const float* kt = ks + st * C::kTile;
    const float* vt = vs + st * C::kTile;
    const unsigned char* ex = extra + st * C::kExtra;
    int valid;
    {
      const float *kp, *vp;
      long long k_sl, v_sl;
      int k0;
      tile_of(e, kp, vp, k_sl, v_sl, k0, valid);
    }

    // S = Q.K^T: rows 4 rg + i, keys c + 8 j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * rg + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kt + (c + 8 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    if constexpr (MASK == kMaskRank) {
      // unshifted exp2 of the clamped logits; masked pairs weigh 0
      const int* rk = reinterpret_cast<const int*>(ex);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c + 8 * j;
        const int rank = partial ? (col < valid ? rk[col] : kNever) : 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = exp2f(fminf(fmaxf(s[i][j] * a.kscale, -100.f), 100.f));
          if (partial && qo[i] < rank) x = 0.f;
          s[i][j] = x;
          l[i] += x;
        }
      }
    } else {
      // logits in log2 units; in a partial tile the mask (the bias, or the
      // rule's -inf) and keys past Lk (-inf); a full tile lies inside Lk
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c + 8 * j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[i][j] * a.scale_log2;
          if (partial) {
            if constexpr (MASK == kMaskBias) {
              const bf16* bs = reinterpret_cast<const bf16*>(ex);
              x = col < valid
                      ? x + __bfloat162float(
                                bs[(4 * rg + i) * kF32BiasLd + col]) *
                                kF32Log2e
                      : -CUDART_INF_F;
            } else {
              const int* kmv = reinterpret_cast<const int*>(ex);
              const KeyMeta km{kmv[col], kmv[kF32Tile + col],
                               kmv[2 * kF32Tile + col]};
              x = col < valid && inline_visible(qm[i], km) ? x
                                                          : -CUDART_INF_F;
            }
          }
          s[i][j] = x;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float mn = fmaxf(mrow[i], mx);
        // while a row has seen no finite logit its max is -inf: subtract 0,
        // so exp2 gives 0 for the masked keys and the rescale, never NaN
        const float ms = mn == -CUDART_INF_F ? 0.f : mn;
        const float alpha = exp2f(mrow[i] - ms);
        mrow[i] = mn;
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = exp2f(s[i][j] - ms);
          ls += s[i][j];
        }
        l[i] = l[i] * alpha + ls;
#pragma unroll
        for (int m = 0; m < NM; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) o[i][m][q] *= alpha;
      }
    }

    // P to shared memory: key c + 8 j, rows 4 rg .. 4 rg + 3
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(ps + (c + 8 * j) * kF32PLd + 4 * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();

    // O += P.V: rows 4 rg + i, head dims 4 c + 32 m
#pragma unroll 8
    for (int k = 0; k < kF32Tile; ++k) {
      const float4 p =
          *reinterpret_cast<const float4*>(ps + k * kF32PLd + 4 * rg);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const float4 v =
            *reinterpret_cast<const float4*>(vt + k * kLd + 4 * c + 32 * m);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][m][0] = fmaf(pr[i], v.x, o[i][m][0]);
          o[i][m][1] = fmaf(pr[i], v.y, o[i][m][1]);
          o[i][m][2] = fmaf(pr[i], v.z, o[i][m][2]);
          o[i][m][3] = fmaf(pr[i], v.w, o[i][m][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  async_wait<0>();

  float* lse = nullptr;
  if constexpr (MASK != kMaskRank)
    if (a.lse != nullptr)
      lse = a.lse + (static_cast<long long>(b) * a.heads + h) * a.lq;
  float* out = static_cast<float*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    float inv;
    if constexpr (MASK == kMaskRank) {
      inv = 1.f / fmaxf(sum, 1e-30f);
    } else {
      inv = sum > 0.f ? 1.f / sum : 0.f;
      if (lse != nullptr && c == 0 && rr[i] < a.lq) {
        constexpr float kLn2 = 0.6931471805599453f;
        lse[rr[i]] =
            sum > 0.f ? (mrow[i] + log2f(sum)) * kLn2 : -CUDART_INF_F;
      }
    }
    if (rr[i] >= a.lq) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int col = 4 * c + 32 * m;
      if (col < head_dim)
        *reinterpret_cast<float4*>(out + rr[i] * a.o_sl + col) =
            make_float4(o[i][m][0] * inv, o[i][m][1] * inv,
                        o[i][m][2] * inv, o[i][m][3] * inv);
    }
  }
}

template <int DP, int MASK>
int launch_fp32(const typename F32Args<MASK>::T& a, const int* order,
                dim3 grid, int nk, cudaStream_t s) {
  const int smem = F32Cfg<DP, MASK>::smem(nk);
  cudaError_t err = cudaFuncSetAttribute(
      fp32_attention_kernel<DP, MASK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fp32_attention_kernel<DP, MASK>
      <<<grid, kF32Threads, smem, s>>>(a, order);
  return static_cast<int>(cudaGetLastError());
}

template <int MASK>
int launch_fp32_dp(const typename F32Args<MASK>::T& a, const int* order,
                   dim3 grid, int nk, cudaStream_t s) {
  switch (padded_head_dim(a.head_dim)) {
    case 32: return launch_fp32<32, MASK>(a, order, grid, nk, s);
    case 64: return launch_fp32<64, MASK>(a, order, grid, nk, s);
    case 96: return launch_fp32<96, MASK>(a, order, grid, nk, s);
    case 128: return launch_fp32<128, MASK>(a, order, grid, nk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace vgt

// K1/K2 at fp32 operands. Launches on `stream`; returns cudaGetLastError()
// (0 = launched).
extern "C" int vgt_fp32_rank_attention(const vgt::RankAttnArgs* a,
                                       void* stream) {
  using namespace vgt;
  const int nk = (a->len[0] + kF32Tile - 1) / kF32Tile +
                 (a->len[1] + kF32Tile - 1) / kF32Tile;
  const dim3 grid((a->lq + kF32Tile - 1) / kF32Tile, a->heads, a->batch);
  return launch_fp32_dp<kMaskRank>(*a, nullptr, grid, nk,
                                   static_cast<cudaStream_t>(stream));
}

// K3 at fp32 operands, over the bias's map from vgt_bias_tile_map (the
// bf16 kernel's). Launches on `stream`; returns cudaGetLastError().
extern "C" int vgt_fp32_bias_attention(const vgt::BiasAttnArgs* a,
                                       void* stream) {
  using namespace vgt;
  const int nq = (a->lq + kF32Tile - 1) / kF32Tile;
  const int nk = (a->lk + kF32Tile - 1) / kF32Tile;
  return launch_fp32_dp<kMaskBias>(*a, a->order,
                                   dim3(a->batch * nq, a->heads), nk,
                                   static_cast<cudaStream_t>(stream));
}

// K6 at fp32 operands: the metadata's tile map (as K6 builds it), then,
// unless map_only, the attention. Launches on `stream`; returns the first
// nonzero cudaGetLastError().
extern "C" int vgt_fp32_inline_attention(const vgt::InlineAttnArgs* a,
                                         void* stream) {
  using namespace vgt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (padded_head_dim(a->head_dim) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* order = nullptr;
  const int err = launch_inline_tile_map(*a, s, &order);
  if (err != 0 || a->map_only) return err;
  const int nq = (a->lq + kF32Tile - 1) / kF32Tile;
  const int nk = (a->lk + kF32Tile - 1) / kF32Tile;
  return launch_fp32_dp<kMaskInline>(*a, order,
                                     dim3(a->batch * nq, a->heads), nk, s);
}
